"""The cases of tests/test_torch_sharded.py that every rank runs, and the
witnesses both packages trace for them.

A spawned rank imports this module alone (the port and torch, never JAX):
``run_rank`` joins a gloo group, runs every case on the CPU over the mesh
of the whole group and pickles its results into the directory it is given,
one file a rank.  The witness builders take the tracer's modules as
arguments, so that the parent traces the same blocks with the JAX tracer.
"""
import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

CORRUPT_LANE = 13          # on the last rank's share at world size 2 to 4
GROUP_LANES = 16
STATE_ROWS = 16
LOGUP_FAMILIES = ("rw", "bytecode")
TIMEOUT_S = 300


def block_witness(T, Y, corrupt=False):
    """Two txs, as tests/test_sharded_block.py's ``_multi_tx_witness``
    (ADD, SSTORE, SLOAD; a call into a callee that SSTOREs and REVERTs),
    with a CALLDATACOPY and an EXP (so the copy and exp circuits have rows)
    and a withdrawal.  ``corrupt``: one ADD step's gas_left + 1, the first
    copy row's value + 1, the first exp row's d + 1 and the withdrawal's
    amount 0, each to be caught at its own keys."""
    callee = Y.Bytecode().push1(0x55).push1(0x09).sstore().push1(0).push1(0).revert()
    bc1 = (Y.Bytecode().push1(3).push1(5).add().pop().push1(0x11).push1(0x01).sstore()
           .push1(0x01).sload().pop())
    bc1.push1(8).push1(0).push1(0).calldatacopy()
    bc1.push1(3).push1(2).exp().pop()
    bc1.stop()
    bc2 = Y.Bytecode()
    bc2.push1(0).push1(0).push1(0).push1(0).push1(0).push2(0x5000).push2(0xFFFF).call().pop()
    bc2.push1(7).push1(0x02).sstore().stop()
    txs = [(Y.Transaction(id=1, gas=100000, gas_price=int(2e9), caller_address=0xFE,
                          callee_address=0xFF, call_data=bytes(range(8))), bc1),
           (Y.Transaction(id=2, gas=200000, gas_price=int(2e9), caller_address=0xFE,
                          callee_address=0xF2, nonce=1), bc2)]
    w = T.trace_block(Y.Block(base_fee=int(1e9)), txs,
                      accounts={0x5000: Y.Account(address=0x5000, code=callee)},
                      withdrawals=[Y.Withdrawal(id=7, validator_id=1, address=0xD00D,
                                                amount=int(2e9))])
    if corrupt:
        step = next(s for s in w.steps if s.execution_state.name == "ADD")
        step.gas_left += 1
        w.copy_circuit.rows[0]["value"] += 1
        w.exp_circuit.rows[0]["d"] += 1
        w.withdrawals[0].amount = 0
    return w


def state_rows(n, bad_adjacency=False):
    """tests/test_sharding.py's ``_state_rows`` on the port: a Start row,
    Memory writes, Stack writes; ``bad_adjacency`` swaps rows 7 and 8, the
    boundary of shares 7 | 8 at world size 2."""
    from zkevm_specs_tpu_torch import workloads

    rows, mpt = workloads.build_state_memory_stack(n)
    if bad_adjacency:
        rows[7], rows[8] = rows[8], rows[7]
    return rows, mpt


def group_cases():
    """{name: (verifier, steps, next steps)} of the group cases: a clean ADD
    group, one with a corrupted lane, and the MUL gadget's DIV (hinted)."""
    from zkevm_specs_tpu_torch import workloads
    from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState
    from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier

    out = {}
    for name, (state, build) in {
        "add_ok": (ExecutionState.ADD, lambda: workloads.build_add_workload(GROUP_LANES)),
        "add_remote_lane": (ExecutionState.ADD, lambda: workloads.build_add_workload(
            GROUP_LANES, corrupt_lane=CORRUPT_LANE)),
        "div_hinted": (ExecutionState.MUL, lambda: workloads.build_op_workload(
            ExecutionState.MUL, "DIV", lambda a, b: a // b if b else 0,
            workloads.random_word_pairs(GROUP_LANES))),
    }.items():
        tables, steps, nexts = build()
        out[name] = (CompiledGroupVerifier(tables, state, steps, nexts, device="cpu"), steps, nexts)
    return out


def logup_inputs(bv):
    """The rw family's host inputs from a block verifier's log: (query
    fingerprints, enables, table parts, multiplicity counts)."""
    from zkevm_specs_tpu_torch.parallel.logup_shard import (
        _concat_log, query_fingerprints_from_log, table_parts)

    table = bv.tables.rw
    q_fps, en = query_fingerprints_from_log(table, bv.lookup_log["rw"])
    idx, en_np = _concat_log(bv.lookup_log["rw"])
    return q_fps, en, table_parts(table), np.bincount(idx[en_np], minlength=table.n_rows)


def corrupt_last_share(world):
    """A ``corrupt_table`` that flips limb 0 of the rw table's last part at a
    row in the last rank's share (a rank other than 0 from world size 2)."""
    def corrupt(name, parts):
        if name != "rw":
            return
        _w, limbs = parts[-1]
        n = limbs.shape[0]
        limbs[n - 1 - (n // world) // 2, 0] ^= 1
    return corrupt


def rank_results(mesh, world):
    from zkevm_specs_tpu_torch.parallel.block_shard import ShardedBlockVerifier
    from zkevm_specs_tpu_torch.parallel.logup_shard import multiplicities, sharded_logup_check
    from zkevm_specs_tpu_torch.parallel.shard import shard_evm_group, sharded_state_circuit
    from zkevm_specs_tpu_torch.witness import tracer as PT
    from zkevm_specs_tpu_torch.witness import typing as PY

    out = {}
    for name, (v, steps, nexts) in group_cases().items():
        out[("group", name)] = shard_evm_group(v, steps, nexts, mesh).numpy()
        out[("group_hints", name)] = v.n_hints
    for bad in (False, True):
        rows, mpt = state_rows(STATE_ROWS, bad)
        out[("state", bad)] = sharded_state_circuit(rows, mpt, mesh).numpy()

    for corrupt in (False, True):
        # the lookup argument on the clean block (its edits touch no family
        # of LOGUP_FAMILIES)
        sbv = ShardedBlockVerifier(block_witness(PT, PY, corrupt), mesh,
                                   logup_tables=() if corrupt else LOGUP_FAMILIES)
        failures, lookups = sbv.check()
        out[("block", corrupt)] = failures
        out[("lookups", corrupt)] = lookups
        out[("message", corrupt)] = sbv.message(failures, lookups)
        out[("placement", corrupt)] = dict(sbv.producer_placement)
        if not corrupt:
            sbv.logup_tables = ("rw",)
            out["lookups_corrupt_part"] = sbv.verify_lookups(corrupt_table=corrupt_last_share(world))
            q_fps, en, parts, counts = logup_inputs(sbv.inner)
            counts[int(np.flatnonzero(counts)[0])] += 1
            out["logup_bad_multiplicity"] = sharded_logup_check(
                q_fps, en, parts, multiplicities(counts, "cpu"), 0xA1FA, mesh=mesh)
            mid = len(sbv.inner._state_rows) // 2
            sbv.inner._state_rows[mid]["value"] += 1
            out["state_row_edit"] = (mid, sbv.verify_state())
    if world == 4:
        from zkevm_specs_tpu_torch.parallel.shard import make_mesh_2d

        # the 2 x 2 grid: the step groups, the state rows and the rw family
        # (the producers run as on the 1-D mesh of the same ranks)
        grid = make_mesh_2d(2, 2, device="cpu")
        sbv = ShardedBlockVerifier(block_witness(PT, PY, True), grid, axes=("hosts", "chips"),
                                   logup_tables=("rw",))
        out["grid_steps"] = sbv.verify_evm_groups()
        out["grid_state"] = sbv.verify_state()
        out["grid_lookups"] = sbv.verify_lookups()
    return out


def run_rank(rank, world, port, out_dir):
    """One spawned rank: join the gloo group, run every case, pickle the
    results as ``<out_dir>/rank<rank>.pkl``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        from zkevm_specs_tpu_torch.parallel.shard import make_mesh

        results = rank_results(make_mesh(device="cpu"), world)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
