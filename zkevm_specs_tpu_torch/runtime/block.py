"""Whole-block verification on the card: the block verifier.

Counterpart of ``zkevm_specs_tpu/runtime/block.py`` (:49-625):

1. steps are grouped by (execution_state, is_first, is_last) as in
   ``evm/main.verify_steps``;
2. each group is partitioned into signature-uniform subgroups by one eager
   pass on the host, whose columns and hint stream are captured and sliced
   into chunks of at most ``max_group_lanes`` lanes, padded (lane 0
   repeated) to powers of two; a chunk of fewer than ``min_jit_lanes``
   lanes is verified on the host, as the JAX package does;
3. the state circuit proves the rw table, and the prologue, bytecode,
   keccak, copy (when the block copied), exp (when it ran an EXP), tx and
   sig (when its txs are signed), ecc (when it called a bn254 precompile),
   sig_trace (the sig rows of its recovered ecRecover calls), withdrawal
   and pi circuits run as ``CircuitKernel`` checks, the withdrawal and pi
   circuits on every block;
4. ``prepare`` uploads every input leaf once (kernel K9, ``transfer.py``);
   ``run_device`` runs the checks one by one and reads each verdict back;
   ``run_device_combined`` replays the whole device pass as one CUDA graph,
   captured once per prepared block, whose last kernel (K10) gathers every
   verdict into one buffer fetched by one copy;
5. ``verify_lookups`` proves every lookup family by the logUp argument
   (``parallel/logup_shard.py``) from the lookups that step 2's eager pass
   logged (``lookup_log``) and the table columns ``prepare`` uploaded.

The verdicts are the JAX verifier's, key for key, its ``("pi", row)``
and ``("sig_trace", row)`` keys included.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..circuits import pi as pi_circuit
from ..circuits.bytecode import assign_bytecode_circuit, assign_keccak_table, bytecode_kernel, unroll
from ..circuits.copy import copy_kernel
from ..circuits.ecc import circuit2rows, ecc_kernel
from ..circuits.exp import exp_kernel
from ..circuits.keccak import keccak_kernel
from ..circuits.state import (
    assign_state_circuit,
    make_state_check_fn,
    mpt_table_from_ops,
    pack_state_inputs,
)
from ..circuits.super_circuit import (
    prologue_kernel,
    public_data_from_witness,
    rw_rows_to_state_ops,
    sig_witness_from_txs,
)
from ..circuits.sig import KeccakTable as SigKeccakTable
from ..circuits.sig import Witness as SigWitness
from ..circuits.sig import sig_kernel
from ..circuits.tx import tx_kernel, txs2witness
from ..circuits.withdrawal import withdrawal_kernel, withdrawals2witness
from ..config import DEFAULT_CONFIG
from ..dsl.cs import ConstraintSystem, LaneSplit
from ..dsl.value import Ctx
from ..evm.execution import EXECUTION_STATE_IMPL
from ..evm.instruction import Instruction
from ..evm.main import DUMMY_STEP_STATE, verify_step
from ..evm.step import StepState, StepStateBatch
from ..ops import limbs as L
from ..ops.ecc import secp256k1
from ..tables.container import Tables
from ..witness.tracer import BlockWitness
from ..witness.typing import copy_circuit_to_table, exp_circuit_to_table
from .jit import CompiledGroupVerifier, tables_meta, tables_to_pytree
from .kernels import require_device
from .transfer import upload, verdict_pack, verdict_table, verdict_unpack


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _partition_by_signature(tables: Tables, steps: List[StepState], state, is_first: bool,
                            is_last: bool, idxs: List[int], decisions: List,
                            out: List[Tuple[List[int], List, dict]], lookup_log: List,
                            depth: int = 0) -> None:
    """Split a (state, flags) group into signature-uniform lane subsets by
    the eager trace, recursing on LaneSplit (evm/main._run_group's control
    flow); the pass over each uniform subset is captured (columns, hint
    stream, bounds), so the chunks' verifiers never run the gadget again.
    Every lookup appends to ``lookup_log``, those of a pass cut short by a
    LaneSplit included, as in the JAX package's ``block_lookup_log``."""
    assert depth <= 64, "lane-split recursion exceeded bound"
    ctx = Ctx("cpu", len(idxs), "eager")
    cs = ConstraintSystem(ctx)
    cs.decisions = list(decisions)
    cs.hint_record, cs.hint_bits = [], []
    cs.lookup_log = lookup_log
    curr = StepStateBatch(ctx, [steps[i] for i in idxs], state)
    nxt = StepStateBatch(ctx, [steps[i + 1] for i in idxs])
    inst = Instruction(ctx, cs, tables.with_ctx(ctx), curr, nxt, is_first, is_last)
    try:
        verify_step(inst)
    except LaneSplit as split:
        taken = [i for i, m in zip(idxs, split.mask) if m]
        not_taken = [i for i, m in zip(idxs, split.mask) if not m]
        prefix = list(cs.decisions[: cs._decision_idx])
        for sub in (taken, not_taken):
            _partition_by_signature(tables, steps, state, is_first, is_last, sub, prefix, out,
                                    lookup_log, depth + 1)
        return
    out.append((idxs, list(cs.decisions), {
        "hint_record": list(cs.hint_record),
        "hint_bits": list(cs.hint_bits),
        "curr_cols": curr.to_columns(),
        "next_cols": nxt.to_columns(),
        "curr_bits": curr.column_bits(),
        "next_bits": nxt.column_bits(),
        "n_constraints": len(cs.records),
    }))


def _leaves(tree, out: Dict[int, object]) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.setdefault(id(tree), tree)


def _remap(tree, by_id: Dict[int, torch.Tensor]):
    if isinstance(tree, dict):
        return {k: _remap(v, by_id) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_remap(v, by_id) for v in tree)
    return by_id[id(tree)]


class CompiledBlockVerifier:
    """Whole-block witness verification on ``device`` ("cuda" unless the
    caller asks for "cpu"; there is no fallback): every EVM step group, the
    state circuit over the rw table, and the prologue, bytecode, keccak,
    copy, exp, tx, sig, ecc, sig_trace, withdrawal and pi circuits.  Every
    circuit the JAX verifier runs is ported (``not_ported`` is empty)."""

    not_ported = ()

    def __init__(self, witness: BlockWitness, min_jit_lanes: int = 4,
                 max_group_lanes: int = 1 << 16, device="cuda"):
        self.device = require_device(device, "CompiledBlockVerifier")
        r = DEFAULT_CONFIG.keccak_randomness
        # grow k to fit the block's unrolled bytecodes (DEFAULT_CONFIG's
        # bytecode_k is the floor; 2^k must exceed the rows and the trailing
        # Header)
        n_rows = sum(len(bc.code) + 1 for bc in witness.bytecodes) + 1
        k_bytecode = max(DEFAULT_CONFIG.bytecode_k, n_rows.bit_length())

        self.witness = witness
        codes = [bytes(bc.code) for bc in witness.bytecodes]
        keccak_data = codes + list(witness.sha3_preimages)
        keccak_rows = assign_keccak_table(keccak_data, r)
        kwargs = witness.tables_kwargs()
        if witness.copy_circuit is not None:
            kwargs["copy_table"] = copy_circuit_to_table(witness.copy_circuit)
        if witness.exp_circuit is not None:
            kwargs["exp_table"] = exp_circuit_to_table(witness.exp_circuit)
        ecc_rows = None
        if witness.ecc_circuit is not None:
            ecc_rows = circuit2rows(witness.ecc_circuit, r)
            kwargs["ecc_table"] = [row.row for row in ecc_rows]
        if witness.sig_rows:
            kwargs["sig_table"] = [row.table_row() for row in witness.sig_rows]
        kwargs["keccak_table"] = keccak_rows
        self.tables = Tables(**kwargs)

        # in-circuit prologue, then the producer circuits of the tables the
        # EVM circuit reads and the tx and sig circuits (the JAX verifier's
        # order), then the withdrawal and pi circuits (run on every block,
        # one padding withdrawal when the block has none)
        self.circuit_kernels: List[Tuple[str, object]] = [
            ("prologue", prologue_kernel(witness, self.tables, device=self.device))]
        bc_rows = assign_bytecode_circuit(k_bytecode, [unroll(c) for c in codes], r)
        self.circuit_kernels.append(("bytecode", bytecode_kernel(bc_rows, keccak_rows, r,
                                                                 device=self.device)))
        kk = keccak_kernel(keccak_data, keccak_rows, r, device=self.device)
        if kk is not None:
            self.circuit_kernels.append(("keccak", kk))
        if witness.copy_circuit is not None:
            self.circuit_kernels.append(("copy", copy_kernel(witness.copy_circuit, self.tables, r,
                                                             device=self.device)))
        if witness.exp_circuit is not None:
            self.circuit_kernels.append(("exp", exp_kernel(witness.exp_circuit,
                                                           device=self.device)))
        signed = witness.signed_txs
        if signed is not None:
            # the tx circuit's capacities scale to the block (the config's
            # are floors)
            max_txs, max_cd, chain_id = DEFAULT_CONFIG.tx_circuit_params()
            max_txs = max(max_txs, len(signed))
            max_cd = max(max_cd, sum(len(t.data) for t in signed))
            tx_witness = txs2witness(signed, chain_id, max_txs, max_cd, r)
            self.circuit_kernels.append(("tx", tx_kernel(
                tx_witness, max_txs, r, evm_callers=[tx.caller_address for tx in witness.txs],
                device=self.device)))
            sk = sig_kernel(sig_witness_from_txs(signed, chain_id, r), r, device=self.device)
            if sk is not None:
                self.circuit_kernels.append(("sig", sk))
        if witness.ecc_circuit is not None:
            ek = ecc_kernel(witness.ecc_circuit, r, device=self.device, rows=ecc_rows)
            if ek is not None:
                self.circuit_kernels.append(("ecc", ek))
        if witness.sig_rows:
            # the sig rows of the traced ecRecover calls, with their own
            # table of the public keys' hashes
            kt = SigKeccakTable()
            for row in witness.sig_rows:
                kt.add(secp256k1.pubkey_bytes(row.pub_key), r)
            self.circuit_kernels.append(("sig_trace", sig_kernel(
                SigWitness(list(witness.sig_rows), kt), r, device=self.device)))
        n_wd = max(1, len(witness.withdrawals))
        wd_witness = withdrawals2witness(witness.withdrawals, n_wd, r, kwargs["block_table"])
        self.circuit_kernels.append(("withdrawal", withdrawal_kernel(wd_witness, n_wd, r,
                                                                     device=self.device)))
        max_txs = len(witness.txs)
        max_calldata = max(1, sum(len(tx.call_data) for tx in witness.txs))
        pi_witness = pi_circuit.public_data2witness(public_data_from_witness(witness, n_wd),
                                                    max_txs, max_calldata, n_wd)
        self.circuit_kernels.append(("pi", pi_circuit.pi_kernel(
            pi_witness, max_txs, max_calldata, n_wd, device=self.device)))

        steps = list(witness.steps) + [DUMMY_STEP_STATE]
        n_pairs = len(steps) - 1
        groups: Dict[Tuple[object, bool, bool], List[int]] = {}
        for i in range(n_pairs):
            key = (steps[i].execution_state, False, i == n_pairs - 1)
            groups.setdefault(key, []).append(i)

        tables_tree = tables_meta_ = None
        self.groups: List[dict] = []
        log: List[tuple] = []
        for (state, is_first, is_last), idxs in groups.items():
            if state not in EXECUTION_STATE_IMPL:
                raise NotImplementedError(f"no gadget for {state!r} is ported")
            parts: List[Tuple[List[int], List, dict]] = []
            _partition_by_signature(self.tables, steps, state, is_first, is_last, idxs, [], parts,
                                    log)
            for sub_idxs, signature, trace in parts:
                for local0 in range(0, len(sub_idxs), max_group_lanes):
                    chunk = sub_idxs[local0:local0 + max_group_lanes]
                    n_real = len(chunk)
                    g = {"state": state, "is_first": is_first, "is_last": is_last,
                         "idxs": chunk, "signature": signature, "verifier": None}
                    self.groups.append(g)
                    if n_real < min_jit_lanes:
                        # too few lanes to earn a device replay: verified on
                        # the host by _run_eager_group
                        g["curr"] = [steps[i] for i in chunk]
                        g["next"] = [steps[i + 1] for i in chunk]
                        continue
                    n_padded = _next_pow2(n_real)
                    padded = chunk + [chunk[0]] * (n_padded - n_real)
                    g["curr"] = [steps[i] for i in padded]
                    g["next"] = [steps[i + 1] for i in padded]
                    if tables_tree is None:
                        tables_tree, tables_meta_ = (tables_to_pytree(self.tables),
                                                     tables_meta(self.tables))
                    trace["tables_tree"], trace["meta"] = tables_tree, tables_meta_
                    lane_idx = (list(range(local0, local0 + n_real))
                                + [local0] * (n_padded - n_real))
                    g["verifier"] = CompiledGroupVerifier.from_trace(
                        self.tables, state, g["curr"], g["next"], is_first, is_last,
                        signature, trace, lane_idx, device=self.device)

        # the partition pass's lookups, per table: the logUp query side
        # ([(row index, enabled)], parallel/logup_shard.py)
        self.lookup_log: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
        for name, idx, en in log:
            self.lookup_log.setdefault(name, []).append((idx, en))

        # state circuit over the rw table
        ops = rw_rows_to_state_ops(witness.rw.rws)
        self._state_rows = assign_state_circuit(ops)
        self._state_mpt = mpt_table_from_ops(ops)
        self._state_packed = None
        self.upload_stats: Dict[str, int] = {}

    # -- two-phase execution -------------------------------------------------

    def prepare(self) -> dict:
        """Host pass and upload: every group's inputs (the captured hints),
        the state circuit's packed columns and the circuit checks' inputs,
        deduplicated by identity (the groups share one table tree) and
        uploaded in one pass (``transfer.upload``: one staging copy per
        source kind, one K9 launch).  Returns when the upload is done."""
        host_groups = [None if g["verifier"] is None
                       else g["verifier"].host_inputs(g["curr"], g["next"]) for g in self.groups]
        if self._state_packed is None:
            cols, mpt_tree, meta = pack_state_inputs(self._state_rows, self._state_mpt)
            self._state_packed = (cols, mpt_tree, make_state_check_fn(meta, device=self.device))
        cols, mpt_tree, state_fn = self._state_packed
        host_state = (cols, mpt_tree)
        host_circuits = [(name, k, k.args) for name, k in self.circuit_kernels]

        unique: Dict[int, object] = {}
        for args in host_groups:
            if args is not None:
                _leaves(args, unique)
        _leaves(host_state, unique)
        for _n, _k, args in host_circuits:
            _leaves(args, unique)
        keys = list(unique)
        dev_leaves, plan = upload([unique[k] for k in keys], self.device)
        by_id = dict(zip(keys, dev_leaves))
        if self.device.type == "cuda":
            torch.cuda.current_stream().synchronize()
        self.upload_stats = {"leaves": len(keys), "narrow_bytes": plan.narrow_bytes,
                             "wide_bytes": plan.wide_bytes, "arena_bytes": plan.arena_bytes}
        return {
            "groups": [None if a is None else _remap(a, by_id) for a in host_groups],
            "state_fn": state_fn,
            "state_args": _remap(host_state, by_id),
            "circuits": [(name, k, _remap(a, by_id)) for name, k, a in host_circuits],
        }

    def _device_pass(self, prepared) -> List[torch.Tensor]:
        """Every device check in verdict order: the device-scheduled groups,
        the state check, the circuit checks; their fail vectors."""
        outs = [g["verifier"](*args) for g, args in zip(self.groups, prepared["groups"])
                if g["verifier"] is not None]
        outs.append(prepared["state_fn"](*prepared["state_args"]))
        outs += [k(args) for _n, k, args in prepared["circuits"]]
        return outs

    def host_group_fails(self) -> List[np.ndarray]:
        """The per-lane fail bits of the host-scheduled groups, in group
        order.  The passes below run them while the card works on the
        device pass."""
        return [self._run_eager_group(g) for g in self.groups if g["verifier"] is None]

    def _failures(self, device_fails: List[np.ndarray],
                  host_fails: List[np.ndarray]) -> Dict[object, bool]:
        """{step index | (circuit, row): True} from the per-check fail bits
        in ``_device_pass`` order and the host groups' bits."""
        failures: Dict[object, bool] = {}
        it, host_it = iter(device_fails), iter(host_fails)
        for g in self.groups:
            fail = next(host_it) if g["verifier"] is None else next(it)
            for lane in np.flatnonzero(fail[:len(g["idxs"])]):  # padding lanes ignored
                failures[g["idxs"][lane]] = True
        for r in np.nonzero(next(it))[0]:
            failures[("state", int(r))] = True
        for name, _k in self.circuit_kernels:
            for r in np.nonzero(next(it))[0]:
                failures[(name, int(r))] = True
        return failures

    def run_device(self, prepared) -> Dict[object, bool]:
        """The per-kernel pass: every check launched from Python, each
        verdict read back on its own.  Returns {step index | ('state', row)
        | (circuit, row): True} for every failing lane or row."""
        outs = self._device_pass(prepared)
        host_fails = self.host_group_fails()
        return self._failures([f.cpu().numpy() for f in outs], host_fails)

    def run_device_combined(self, prepared) -> Dict[object, bool]:
        """The same verdicts from one CUDA-graph replay of the whole device
        pass and one copy of the K10 buffer into pinned memory; the graph is
        captured on the first call for ``prepared``.  On the CPU the same
        pass runs with K10's plain version and no graph."""
        if self.device.type != "cuda":
            flat = verdict_pack(self._device_pass(prepared)).numpy()
            host_fails = self.host_group_fails()
        else:
            if "graph" not in prepared:
                prepared["graph"] = self._capture(prepared)
            cap = prepared["graph"]
            cap["graph"].replay()
            cap["host"].copy_(cap["flat"], non_blocking=True)
            host_fails = self.host_group_fails()
            torch.cuda.current_stream().synchronize()
            flat = cap["host"].numpy()
        sizes = [len(g["curr"]) for g in self.groups if g["verifier"] is not None]
        sizes += [len(self._state_rows)] + [k.n for _n, k in self.circuit_kernels]
        return self._failures(verdict_unpack(flat, sizes), host_fails)

    def _capture(self, prepared) -> dict:
        """Capture the device pass and K10 into one CUDA graph.  A warm-up
        pass with K10 on a side stream first builds and loads every kernel
        and fills the per-device constant caches, so the capture records
        launches only.  The graph keeps its fail vectors and its K10 buffer alive;
        K10's table of their addresses is written after the capture.  A
        failed capture raises: there is no fallback to the per-kernel
        pass."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            verdict_pack(self._device_pass(prepared))
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        n_vectors = sum(g["verifier"] is not None for g in self.groups) + 1 + len(self.circuit_kernels)
        table = torch.empty(4 * n_vectors, dtype=torch.int64, device=self.device)
        graph = torch.cuda.CUDAGraph()
        before = Counter(L.LAUNCHES)
        with torch.cuda.graph(graph):
            outs = self._device_pass(prepared)
            flat = verdict_pack(outs, table)
        launches = Counter(L.LAUNCHES)
        launches.subtract(before)
        table.copy_(verdict_table(outs))
        torch.cuda.synchronize()
        return {"graph": graph, "outs": outs, "flat": flat, "table": table,
                "host": torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True),
                "launches": {k: v for k, v in launches.items() if v}}

    def table_parts_on_device(self, prepared, name: str):
        """Table ``name``'s column parts as ``prepare`` uploaded them (the
        device-scheduled groups share one table tree), in
        ``logup_shard.table_parts`` order; None when no group runs on the
        device."""
        from ..parallel.logup_shard import part_names

        tree = next((args[2] for args in prepared["groups"] if args is not None), None)
        if tree is None:
            return None
        table = getattr(self.tables, name)
        cols = tree[name]["cols"]
        return [(int(table.schema.weight(c, p)), cols[c][p]) for c, p in part_names(table.schema)]

    def verify_lookups(self, prepared=None, tables_names: Optional[Tuple[str, ...]] = None,
                       corrupt_table=None) -> Dict[str, bool]:
        """The logUp lookup argument of every family the block looks up
        (``parallel/logup_shard.py``), from the partition pass's log, with
        no second eager pass; with ``prepared``, the table sides come from
        the columns already on the device.  ``{table: ok}``."""
        from ..parallel.logup_shard import LOGUP_TABLES, verify_block_lookups_logup

        parts_of = None if prepared is None else (
            lambda name: self.table_parts_on_device(prepared, name))
        return verify_block_lookups_logup(
            self.witness, tables_names=tables_names or LOGUP_TABLES,
            corrupt_table=corrupt_table, device=self.device,
            log=(self.tables, self.lookup_log), parts_of=parts_of)

    def verify(self) -> None:
        failures = self.run_device(self.prepare())
        if failures:
            step_fails = sorted(k for k in failures if isinstance(k, int))
            row_fails = sorted((k for k in failures if isinstance(k, tuple)), key=str)
            raise AssertionError(f"block verification failed: steps {step_fails[:8]}, "
                                 f"circuit rows {row_fails[:8]}")

    def _run_eager_group(self, g) -> np.ndarray:
        """Host evaluation of a small subgroup (the same constraint body as
        the device replay; per-lane fail bits)."""
        ctx = Ctx("cpu", len(g["idxs"]), "eager")
        cs = ConstraintSystem(ctx)
        cs.decisions = list(g["signature"])
        curr = StepStateBatch(ctx, g["curr"], g["state"])
        nxt = StepStateBatch(ctx, g["next"])
        inst = Instruction(ctx, cs, self.tables.with_ctx(ctx), curr, nxt,
                           g["is_first"], g["is_last"])
        try:
            verify_step(inst)
        except LaneSplit:
            raise AssertionError("signature replay diverged for a host-scheduled subgroup")
        return cs.fail.numpy()

    @property
    def n_constraints(self) -> int:
        return sum(g["verifier"].n_constraints * len(g["idxs"])
                   for g in self.groups if g["verifier"] is not None)
