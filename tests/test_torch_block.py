"""The port's block verifier (zkevm_specs_tpu_torch.runtime.block) against
the JAX package's, on the CPU, tolerance 0.

The same unsigned 2 x 6 block (tests/test_block_jit.py:15-26, a caller
per tx) is traced by both packages and corrupted alike: clean, an ADD
step's ``gas_left``, a stack write's ``value`` (tests/test_block_jit.py:
47-61), an EndTx coinbase balance row, a prologue row's value; three more
blocks: other opcodes, one shared caller, three withdrawals; and the
arithmetic block at 4 txs x 1 cycle (``workloads.build_arith_block``),
clean, with one MULMOD step's pushed result + 1 and with one exp-circuit
row's ``d`` + 1.  On each, the port's ``CompiledBlockVerifier(w,
device="cpu")`` (the kernels' plain versions) is held against
``CompiledBlockVerifier(w, min_jit_lanes=1 << 30)`` of the JAX package,
which needs no XLA compile:

* the group partition (state, flags, lane indexes, signature);
* every group's per-lane fail bits, against JAX ``_run_eager_group``;
* the state, prologue, bytecode, keccak, exp, withdrawal and pi rows,
  against the JAX checks in spec mode (the JAX ``CircuitKernel``'s inputs,
  recorded as it is built, run eagerly);
* the failure dicts of ``run_device`` and ``run_device_combined``, against
  the JAX verdict, its ``("pi", row)`` keys included.

Two more blocks exercise the pi circuit: one whose txs carry calldata, and
one whose pi witness has a row's ``rpi_value_lc`` + 1 in both packages.

Signed blocks (``trace_block``'s default) add the tx and sig circuits
(their kinds run in tests/test_torch_block_signed.py, through this file's
checks):
the 2 x 6 block, one shared caller (each tx still gets its own key's
address, so it passes), calldata, and tx 0 re-signed with key 0xBAD
(tests/test_block_jit.py:test_block_jit_corrupt_signature_rejected; it
must fail).  The SSTORE-mix block (``workloads.sstore_block_txs`` at 2
txs) adds the copy circuit, the storage gadgets and the Storage,
TxAccessListAccountStorage and TxRefund rows of the state circuit; it is
held clean, with one SSTORE's written rw value + 1 and with one copy row's
``rlc_acc`` + 1 (both must fail).  The arithmetic block is traced signed,
as ``workloads.build_arith_block`` traces it.

Also K9's and K10's plain versions against the per-leaf upload and
``torch.cat``, the narrowing against the JAX ``_ship_leaves``, and what the
verifier refuses."""
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_specs_tpu.circuits import pi as jpi
from zkevm_specs_tpu.circuits import state as jst
from zkevm_specs_tpu.circuits import tx as jtx
from zkevm_specs_tpu.dsl.cs import ConstraintSystem as JCS
from zkevm_specs_tpu.dsl.value import Ctx as JCtx
from zkevm_specs_tpu.runtime import block as jblock
from zkevm_specs_tpu.runtime import kernels as jkernels
from zkevm_specs_tpu.tables import schemas as js
from zkevm_specs_tpu.tables.engine import Table as JTable
from zkevm_specs_tpu.witness import tracer as JT
from zkevm_specs_tpu.witness import typing as JY
from zkevm_specs_tpu_torch.circuits import pi as ppi
from zkevm_specs_tpu_torch.circuits import tx as ptx
from zkevm_specs_tpu_torch.ops.fr import P as FR_P
from zkevm_specs_tpu_torch.runtime import transfer
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier
from zkevm_specs_tpu_torch.runtime.convert import to_device
from zkevm_specs_tpu_torch.witness import tracer as PT
from zkevm_specs_tpu_torch.witness import typing as PY

from zkevm_specs_tpu_torch import workloads

from test_torch_tracer import _jax_txs, txs_of

torch.set_num_threads(1)

CIRCUITS = ("prologue", "bytecode", "keccak", "copy", "tx", "sig", "withdrawal", "pi")
COPY_CORRUPT_ROW = 5
PI_CORRUPT_ROW = 37


def _corrupt(w, kind):
    """The same corruption on either package's witness."""
    if kind == "gas_left":
        next(s for s in w.steps if s.execution_state.name == "ADD").gas_left += 1
    elif kind == "stack_value":
        row = next(r for r in w.rw.rws
                   if r["key0"] == int(js.Target.Stack) and r["rw"] == int(js.RW.Write))
        row["value"] = (row["value"] + 1) % (1 << 256)
    elif kind == "coinbase_balance":
        rows = [r for r in w.rw.rws if r["key0"] == int(js.Target.Account)
                and r["address"] == w.block.coinbase and r["rw"] == int(js.RW.Write)
                and r["field_tag"] == int(js.AccountFieldTag.Balance)]
        rows[-1]["value"] += 1             # the last tx's EndTx reward
    elif kind == "prologue_value":
        # tx 1's CallerAddress setup write (the sixth of its eleven, rw counter 6)
        row = next(r for r in w.rw.rws
                   if r["rw_counter"] == 6 and r["key0"] == int(js.Target.CallContext))
        assert row["address"] == int(js.CallContextFieldTag.CallerAddress)
        row["value"] += 1
    elif kind == "mulmod_push":
        # the pushed result of the second MULMOD step (its fourth rw row) + 1
        step = [s for s in w.steps if s.execution_state.name == "MULMOD"][1]
        row = next(r for r in w.rw.rws if r["rw_counter"] == step.rw_counter + 3)
        assert row["key0"] == int(js.Target.Stack) and row["rw"] == int(js.RW.Write)
        row["value"] = (row["value"] + 1) % (1 << 256)
    elif kind == "exp_row_d":
        row = w.exp_circuit.rows[4]
        row["d"] = (row["d"] + 1) % (1 << 256)
    elif kind == "wrong_key":
        # tx 0 re-signed with another valid key over the same payload
        sign_tx = ptx.sign_tx if isinstance(w, PT.BlockWitness) else jtx.sign_tx
        w.signed_txs[0] = sign_tx(0xBAD, w.signed_txs[0], w.chain_id)
    elif kind == "sstore_value":
        row = next(r for r in w.rw.rws if r["key0"] == int(js.Target.AccountStorage)
                   and r["rw"] == int(js.RW.Write))
        row["value"] += 1
    elif kind == "copy_rlc":
        row = w.copy_circuit.rows[COPY_CORRUPT_ROW]
        row["rlc_acc"] = (row["rlc_acc"] + 1) % FR_P


def _calldata_txs(Y):
    """Three calls whose txs carry calldata (zero and nonzero bytes, and an
    empty one), for the pi circuit's calldata region."""
    txs = txs_of(Y, n_txs=3, n_ops=2)
    for (tx, _), data in zip(txs, (bytes([0, 1, 2, 0]), b"", bytes(range(1, 40)))):
        tx.call_data = data
    return txs


def _pi_value_lc(pkg):
    """``pkg.public_data2witness`` with row PI_CORRUPT_ROW's rpi_value_lc
    + 1 in the witness it returns."""
    build = pkg.public_data2witness

    def corrupted(*args):
        w = build(*args)
        row = w.rows[PI_CORRUPT_ROW]
        row["rpi_value_lc"] = (row["rpi_value_lc"] + 1) % ppi.P
        return w

    return corrupted


def _arith_txs(Y, n_txs=4, cycles=1):
    """``workloads.arith_block_txs`` in the package ``Y``'s classes."""
    txs = workloads.arith_block_txs(n_txs, cycles)
    return txs if Y is PY else _jax_txs(txs)


def _sstore_txs(Y, n_txs=2):
    """``workloads.sstore_block_txs`` (bench.py's SSTORE-heavy pattern) in
    the package ``Y``'s classes."""
    txs = workloads.sstore_block_txs(n_txs)
    return txs if Y is PY else _jax_txs(txs)


BLOCKS = {   # kind: (txs_of arguments or a txs builder, corruption, withdrawals, signed)
    "clean": (dict(), None, 0, False),
    "gas_left": (dict(), "gas_left", 0, False),
    "stack_value": (dict(), "stack_value", 0, False),
    "coinbase_balance": (dict(), "coinbase_balance", 0, False),
    "prologue_value": (dict(), "prologue_value", 0, False),
    "sub_mul_div_mod": (dict(n_ops=8, ops=("add", "sub", "mul", "div", "mod")), None, 0, False),
    "shared_caller": (dict(shared_caller=True), None, 0, False),
    "withdrawals": (dict(), None, 3, False),
    "calldata": (_calldata_txs, None, 0, False),
    # the last eight ALU gadgets' opcodes through the block verifier
    "alu_gadgets": (dict(n_ops=14, ops=("gt", "sgt", "eq", "slt", "iszero", "not", "or", "xor",
                                        "byte", "signextend", "sar", "and_", "lt", "shr")),
                    None, 0, False),
    "pi_value_lc": (dict(), "pi_value_lc", 0, False),
    # the arithmetic block (4 txs x 1 cycle, one caller, signed), clean and
    # with chip_smoke.py's two corruptions
    "arith": (_arith_txs, None, 0, True),
    "arith_mulmod_push": (_arith_txs, "mulmod_push", 0, True),
    "arith_exp_row_d": (_arith_txs, "exp_row_d", 0, True),
    # signed blocks: the tx and sig circuits
    "signed": (dict(), None, 0, True),
    "signed_shared_caller": (dict(shared_caller=True), None, 0, True),
    "signed_calldata": (_calldata_txs, None, 0, True),
    "signed_wrong_key": (dict(), "wrong_key", 0, True),
    # the SSTORE-heavy mix: storage gadgets, SHA3 and the copy circuit
    "sstore": (_sstore_txs, None, 0, True),
    "sstore_value": (_sstore_txs, "sstore_value", 0, True),
    "sha3_copy_rlc": (_sstore_txs, "copy_rlc", 0, True),
}
# the signed and SSTORE-mix kinds, held by the same checks in
# test_torch_block_signed.py (a file of its own, so that a run spread by
# file keeps them off this file's worker)
SIGNED_KINDS = ("signed", "signed_shared_caller", "signed_calldata", "signed_wrong_key",
                "sstore", "sstore_value", "sha3_copy_rlc")
OWN_KINDS = [k for k in sorted(BLOCKS) if k not in SIGNED_KINDS]
# the blocks whose verdict must hold a failure
MUST_FAIL = {"gas_left", "stack_value", "coinbase_balance", "prologue_value", "shared_caller",
             "arith_mulmod_push", "arith_exp_row_d", "pi_value_lc", "signed_wrong_key",
             "sstore_value", "sha3_copy_rlc"}

_CACHE = {}


class JaxSide:
    """The JAX verifier of a witness, with every lane and row verdict in
    spec mode (no XLA compile)."""

    def __init__(self, w, monkeypatch):
        recorded = []
        orig = jkernels.CircuitKernel.__init__

        def record(self, name, check, cols, tables=None, static=None, extra=None):
            recorded.append((self, check, cols, tables or {}, static or {}, extra or {}))
            return orig(self, name, check, cols, tables, static, extra)

        monkeypatch.setattr(jkernels.CircuitKernel, "__init__", record)
        self.bv = jblock.CompiledBlockVerifier(w, min_jit_lanes=1 << 30)
        monkeypatch.undo()
        # each check under the verifier's name for it (the tx signatures'
        # "sig" and the ecRecover rows' "sig_trace" share a kernel name)
        names = {id(k): n for n, k in self.bv.circuit_kernels}
        recorded = [(names[id(k)], *rest) for k, *rest in recorded]
        self.lanes = [np.asarray(self.bv._run_eager_group(g)) for g in self.bv.groups]
        ctx = JCtx(np, len(self.bv._state_rows), "eager")
        cs = jst.check_state_rows(ctx, jst.StateRows(ctx, self.bv._state_rows),
                                  JTable.from_rows(ctx, js.MPT_SCHEMA, self.bv._state_mpt))
        self.rows = {"state": np.asarray(cs.fail)}
        for name, check, cols, tables, static, extra in recorded:
            v = next(iter(cols.values()))
            ctx = getattr(v, "lo", v).ctx
            cs = JCS(ctx)
            check(ctx, cs, cols, tables, static, {k: np.asarray(a) for k, a in extra.items()})
            self.rows[name] = np.asarray(cs.fail)

    def failures(self):
        out = {}
        for g, fail in zip(self.bv.groups, self.lanes):
            for lane, i in enumerate(g["idxs"]):
                if fail[lane]:
                    out[i] = True
        for name, fail in self.rows.items():
            for r in np.flatnonzero(fail):
                out[(name, int(r))] = True
        return out


def _sides(kind, monkeypatch):
    if kind not in _CACHE:
        kw, corruption, n_wd, signed = BLOCKS[kind]
        jw, pw = (T.trace_block(Y.Block(base_fee=int(1e9)),
                                kw(Y) if callable(kw) else txs_of(Y, **kw), sign=signed,
                                withdrawals=[Y.Withdrawal(id=i, validator_id=i, address=0xCAFE + i,
                                                          amount=10 + i) for i in range(n_wd)])
                  for T, Y in ((JT, JY), (PT, PY)))
        _corrupt(jw, corruption)
        _corrupt(pw, corruption)
        with pytest.MonkeyPatch.context() as mp:
            if corruption == "pi_value_lc":
                for pkg in (jpi, ppi):
                    mp.setattr(pkg, "public_data2witness", _pi_value_lc(pkg))
            pbv = CompiledBlockVerifier(pw, device="cpu")
            jax_side = JaxSide(jw, monkeypatch)
        prepared = pbv.prepare()
        _CACHE[kind] = (jax_side, pbv, prepared, pbv._device_pass(prepared))
    return _CACHE[kind]


@pytest.mark.parametrize("kind", OWN_KINDS)
def test_partition_matches_jax(kind, monkeypatch):
    jax_side, pbv, _, _ = _sides(kind, monkeypatch)

    def key(g):
        return (g["state"].name, g["is_first"], g["is_last"], list(g["idxs"]),
                [bool(d) if isinstance(d, (bool, np.bool_)) else int(d) for d in g["signature"]])

    assert [key(g) for g in pbv.groups] == [key(g) for g in jax_side.bv.groups]
    assert all(g["verifier"] is None for g in jax_side.bv.groups)


@pytest.mark.parametrize("kind", OWN_KINDS)
def test_group_lane_bits_match_jax(kind, monkeypatch):
    jax_side, pbv, _, outs = _sides(kind, monkeypatch)
    device_outs = iter(outs)
    for g, want in zip(pbv.groups, jax_side.lanes):
        n = len(g["idxs"])
        if g["verifier"] is None:
            got = pbv._run_eager_group(g)
        else:
            got = next(device_outs).numpy()
            assert got.shape == (len(g["curr"]),)
        np.testing.assert_array_equal(got[:n], want[:n])


@pytest.mark.parametrize("circuit", ("state",) + CIRCUITS)
@pytest.mark.parametrize("kind", OWN_KINDS)
def test_circuit_rows_match_jax(kind, circuit, monkeypatch):
    jax_side, pbv, _, outs = _sides(kind, monkeypatch)
    names = ["state"] + [name for name, _ in pbv.circuit_kernels]
    assert names == list(jax_side.rows)
    assert ("exp" in names) == kind.startswith("arith")
    assert ("copy" in names) == kind.startswith(("sstore", "sha3"))
    assert ("tx" in names) == ("sig" in names) == BLOCKS[kind][3]
    if circuit not in names:
        return
    got = outs[len(outs) - len(names) + names.index(circuit)]
    np.testing.assert_array_equal(got.numpy(), jax_side.rows[circuit])


@pytest.mark.parametrize("kind", [k for k in sorted(BLOCKS) if k.startswith("arith")])
def test_exp_circuit_rows_match_jax(kind, monkeypatch):
    """The exp circuit runs after the keccak circuit, as in the JAX
    verifier, and its rows' verdicts are the JAX check's."""
    jax_side, pbv, _, outs = _sides(kind, monkeypatch)
    names = ["state"] + [name for name, _ in pbv.circuit_kernels]
    assert names.index("exp") == names.index("keccak") + 1
    got = outs[len(outs) - len(names) + names.index("exp")].numpy()
    np.testing.assert_array_equal(got, jax_side.rows["exp"])
    assert got.shape == (len(pbv.witness.exp_circuit.rows),)
    assert got.any() == (kind == "arith_exp_row_d")


@pytest.mark.parametrize("kind", OWN_KINDS)
def test_failures_match_jax(kind, monkeypatch):
    jax_side, pbv, prepared, _ = _sides(kind, monkeypatch)
    want = jax_side.failures()
    assert pbv.run_device(prepared) == want
    assert pbv.run_device_combined(prepared) == want
    assert bool(want) == (kind in MUST_FAIL)
    if kind == "gas_left":
        bad = next(i for i, s in enumerate(pbv.witness.steps) if s.execution_state.name == "ADD")
        assert set(want) == {bad - 1, bad}
    if kind == "pi_value_lc":
        # the corrupted row and the row whose chain reads it, nothing else
        assert set(want) <= {("pi", PI_CORRUPT_ROW - 1), ("pi", PI_CORRUPT_ROW)} and want
    if kind == "signed_wrong_key":
        # the re-signed tx's lane of the tx circuit: its signer is not the
        # EVM-side sender
        assert set(want) == {("tx", 0)}
    if kind == "sha3_copy_rlc":
        assert ("copy", COPY_CORRUPT_ROW) in want
    if want:
        with pytest.raises(AssertionError, match="block verification failed"):
            pbv.verify()
    else:
        pbv.verify()


def test_padding_lanes_and_host_groups():
    w = PT.trace_block(PY.Block(base_fee=int(1e9)), txs_of(PY, n_txs=1, n_ops=3), sign=False)
    bv = CompiledBlockVerifier(w, device="cpu")
    assert any(len(g["curr"]) > len(g["idxs"]) for g in bv.groups if g["verifier"] is not None)
    assert any(g["verifier"] is None for g in bv.groups)
    assert bv.n_constraints > 0
    bv.verify()
    small = CompiledBlockVerifier(w, device="cpu", max_group_lanes=2, min_jit_lanes=1)
    assert max(len(g["idxs"]) for g in small.groups) == 2
    small.verify()


# -- K9 and K10: the plain versions ----------------------------------------------

def _leaves(kind, seed):
    rng = np.random.RandomState(seed)
    out = []
    for n in (0, 1, 7, 4097):
        if kind == "u8":
            out.append(torch.from_numpy(rng.randint(0, 256, size=(n, 1)).astype(np.int64)))
        elif kind == "u16":
            out.append(rng.randint(0, 1 << 16, size=n).astype(np.uint32))
        else:
            out += [torch.from_numpy(rng.randint(0, 1 << 16, size=(n, 2)).astype(np.int64)),
                    rng.randint(0, 200, size=n).astype(np.uint32),
                    rng.randint(1 << 16, 1 << 31, size=n).astype(np.uint32),
                    torch.from_numpy(rng.randint(-2**62, 2**62, size=n, dtype=np.int64)),
                    rng.randint(0, 2**63, size=n, dtype=np.uint64) * np.uint64(2),
                    rng.randint(-2**31, 2**31, size=n).astype(np.int32),
                    rng.rand(n) < 0.5,
                    torch.from_numpy(rng.randint(0, 256, size=n).astype(np.uint8))]
    return out


@pytest.mark.parametrize("kind", ["u8", "u16", "mixed"])
def test_leaf_unpack_plain_equals_per_leaf_upload(kind):
    leaves = _leaves(kind, seed=len(kind))
    got, plan = transfer.upload(leaves, "cpu")
    for g, leaf in zip(got, leaves):
        want = to_device(leaf, "cpu")
        assert g.dtype == want.dtype and g.shape == want.shape and torch.equal(g, want)
    assert plan.narrow_bytes <= plan.wide_bytes + plan.table.nbytes
    if kind == "u8":
        assert plan.host[transfer.U8].size == sum(int(np.prod(t.shape)) for t in leaves)


def test_narrowing_matches_jax_ship_leaves():
    """The staged kind of each uint32-class leaf follows ``_ship_leaves``
    (block.py:84-89): u8 below 2^8, u16 below 2^16, else kept wide; every
    other leaf that lands as int64 (here a small index order) follows the
    same rule; and the values come back equal."""
    leaves = _leaves("mixed", seed=3) + [np.arange(300, dtype=np.int64)[::-1].copy()]
    jax_leaves = [np.asarray(t.numpy().astype(np.uint32) if isinstance(t, torch.Tensor)
                             and t.dtype == torch.int64 and t.numel() and int(t.min()) >= 0
                             and int(t.max()) < 2**32 else t) for t in leaves]
    jax_out = jblock._ship_leaves(jax_leaves)
    got, plan = transfer.upload(leaves, "cpu")
    assert plan.segs[-1].tolist()[0] == transfer.U16
    for g, j, (kind, *_), leaf in zip(got, jax_out, plan.segs.tolist(), jax_leaves):
        j = np.asarray(j)
        if leaf.dtype in (np.uint32, np.int64) and leaf.size:
            m, lo = int(leaf.max()), int(leaf.min())
            assert kind == (transfer.U8 if 0 <= lo and m < 2**8 else
                            transfer.U16 if 0 <= lo and m < 2**16 else transfer.I64)
        np.testing.assert_array_equal(g.numpy().astype(np.int64)
                                      if j.dtype != np.uint64 else g.numpy().view(np.uint64),
                                      j.astype(np.int64) if j.dtype != np.uint64 else j)


@pytest.mark.parametrize("lengths", [[1], [0, 1, 5], [1000, 1, 70000, 3],
                                     [15, 16, 17, 0, 32, 4095, 4096, 4097]])
def test_verdict_pack_plain_equals_cat(lengths):
    """The packed buffer is the concatenation of the vectors, each padded
    with zeros to a multiple of 16 bytes: its unpacked vectors equal
    ``torch.cat``'s pieces (the JAX ``make_combined`` concatenation), and
    the table's lengths, offsets and first blocks follow the padding."""
    rng = np.random.RandomState(len(lengths))
    fails = [torch.from_numpy(rng.rand(n) < 0.3) for n in lengths]
    got = transfer.verdict_pack(fails)
    assert got.dtype == torch.uint8
    padded = [torch.cat([f.to(torch.uint8), torch.zeros(-n % 16, dtype=torch.uint8)])
              for f, n in zip(fails, lengths)]
    assert torch.equal(got, torch.cat(padded))
    cat = torch.cat([f.ravel().to(torch.uint8) for f in fails]).numpy()
    np.testing.assert_array_equal(np.concatenate(transfer.verdict_unpack(got.numpy(), lengths)),
                                  cat)
    table = transfer.verdict_table(fails)
    m = len(fails)
    offsets = np.cumsum([0] + [-(-n // 16) * 16 for n in lengths[:-1]]).tolist()
    firsts = np.cumsum([0] + [-(-n // 4096) for n in lengths[:-1]]).tolist()
    assert table[m:].tolist() == lengths + offsets + firsts
    assert all(o % 16 == 0 for o in offsets)


def test_verdict_block_bytes_match_the_kernel_source():
    """K10's grid (``verdict_blocks``) is cut at the kernel's block size:
    16 bytes a thread of a THREADS_PER_BLOCK block."""
    csrc = Path(transfer.__file__).parents[1] / "csrc"
    assert "constexpr int BLOCK_BYTES = THREADS_PER_BLOCK * 16;" in \
        (csrc / "verdict_pack.cu").read_text()
    assert f"#define THREADS_PER_BLOCK {transfer.VERDICT_BLOCK_BYTES // 16}" in \
        (csrc / "limb_common.cuh").read_text()


def test_verdict_pack_checks_its_inputs():
    with pytest.raises(ValueError):
        transfer.verdict_pack([torch.zeros(3, dtype=torch.int64)])
    with pytest.raises(ValueError):
        transfer.verdict_pack([])


# -- what the verifier refuses -----------------------------------------------------

def test_default_device_is_the_card_and_never_falls_back():
    w = PT.trace_block(PY.Block(), txs_of(PY, n_txs=1, n_ops=1), sign=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledBlockVerifier(w)


def test_not_ported_names_pi():
    """The pi circuit is ported: the verifier names no unported circuit of
    an unsigned block, and runs pi last, after the withdrawal circuit."""
    assert CompiledBlockVerifier.not_ported == ()
    w = PT.trace_block(PY.Block(), txs_of(PY, n_txs=1, n_ops=1), sign=False)
    names = [name for name, _ in CompiledBlockVerifier(w, device="cpu").circuit_kernels]
    assert names[-2:] == ["withdrawal", "pi"]
