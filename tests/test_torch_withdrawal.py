"""The port's withdrawal circuit (zkevm_specs_tpu_torch.circuits.withdrawal)
against the JAX package's, tolerance 0: on every vector of
tests/test_withdrawal_circuit.py and on ``workloads.build_withdrawals`` at
mainnet's 16 rows, the fail bits of the port's
``withdrawal_kernel(..., device="cpu")()`` equal those of the JAX
``withdrawal_kernel(...)()`` (jitted on the CPU), and ``verify_circuit``
raises where the JAX one does, with the same message.  Also the witness
builder, the RLP encoder and the DSL pieces the body adds (``F.broadcast``,
``Word.from_lo``)."""
import numpy as np
import pytest
import torch

from zkevm_specs_tpu.circuits import keccak as jk
from zkevm_specs_tpu.circuits import withdrawal as jw
from zkevm_specs_tpu.dsl.cs import ConstraintSystem as JConstraintSystem
from zkevm_specs_tpu.dsl.value import Ctx as JCtx
from zkevm_specs_tpu.dsl.value import F as JF
from zkevm_specs_tpu.dsl.value import Word as JWord
from zkevm_specs_tpu.ops import fr as jfr
from zkevm_specs_tpu.ops import limbs as JL
from zkevm_specs_tpu.witness.rlp import rlp_encode as jrlp
from zkevm_specs_tpu.witness.typing import Block as JBlock
from zkevm_specs_tpu.witness.typing import Withdrawal as JWithdrawal
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.circuits import withdrawal as pw
from zkevm_specs_tpu_torch.dsl.value import Ctx, F, Word
from zkevm_specs_tpu_torch.ops.fr import P
from zkevm_specs_tpu_torch.tables import engine
from zkevm_specs_tpu_torch.tables.schemas import MPT_SCHEMA
from zkevm_specs_tpu_torch.witness.rlp import rlp_encode
from zkevm_specs_tpu_torch.witness.typing import Block, Withdrawal

torch.set_num_threads(1)

MAX_WD = 5        # tests/test_withdrawal_circuit.py
R = 0x64


def _block_rows(n_wds):
    rows = [{"field_tag": r["field_tag"], "value": r["value"]}
            for r in JBlock(withdrawal_root=7 * n_wds).table_assignments()]
    assert rows == [{"field_tag": r["field_tag"], "value": r["value"]}
                    for r in Block(withdrawal_root=7 * n_wds).table_assignments()]
    return rows


def _witness(wds, n_wds_root):
    port = pw.withdrawals2witness([Withdrawal(*w) for w in wds], MAX_WD, R,
                                  _block_rows(n_wds_root))
    jax = jw.withdrawals2witness([JWithdrawal(*w) for w in wds], MAX_WD, R,
                                 _block_rows(n_wds_root))
    assert tuple(port) == tuple(jax)
    return port


def _vector(name):
    """(witness, expected to pass) of one vector of tests/test_withdrawal_circuit.py."""
    two = [(7, 99, 0xCAFE, int(2e9)), (8, 100, 0xBEEF, int(3e9))]
    if name == "ok":
        return _witness(two, 2), True
    if name == "only_padding":
        return _witness([], 0), True
    if name == "non_monotonic":
        return _witness([two[0], (9, 100, 0xBEEF, int(3e9))], 2), False
    w = _witness(two[:1], 1)
    rows = list(w.rows)
    if name == "bad_amount_hash":
        rows[0] = rows[0]._replace(amount=rows[0].amount + 1)
    else:                                   # bad_final_root
        rows[-1] = rows[-1]._replace(root=rows[-1].root + 1)
    return pw.Witness(rows, w.mpt_rows, w.keccak_rows, w.block_rows), False


def _raises(verify, *args):
    try:
        verify(*args)
    except AssertionError as e:
        return str(e)
    return None


def _both(witness, n, r):
    got = pw.withdrawal_kernel(witness, n, r, device="cpu")().numpy()
    want = np.asarray(jw.withdrawal_kernel(witness, n, r)())
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("name", ["ok", "only_padding", "non_monotonic", "bad_amount_hash",
                                  "bad_final_root"])
def test_vector_matches_jax(name):
    witness, ok = _vector(name)
    fail = _both(witness, MAX_WD, R)
    assert (not fail.any()) == ok
    port_msg = _raises(pw.verify_circuit, witness, MAX_WD, R)
    jax_msg = _raises(jw.verify_circuit, witness, MAX_WD, R)
    assert port_msg == jax_msg and (port_msg is None) == ok


@pytest.mark.parametrize("n_real,corrupt", [(16, None), (16, 5), (11, None), (11, 10)])
def test_builder_matches_jax(n_real, corrupt):
    witness, n, r = workloads.build_withdrawals(n_real=n_real, seed=3, corrupt_row=corrupt, r=R)
    assert n == workloads.MAX_WITHDRAWALS_PER_PAYLOAD == 16
    fail = _both(witness, n, r)
    assert np.flatnonzero(fail).tolist() == ([] if corrupt is None else [corrupt])
    port_msg = _raises(pw.verify_circuit, witness, n, r)
    assert port_msg == _raises(jw.verify_circuit, witness, n, r)
    assert (port_msg is None) == (corrupt is None)


def test_builder_at_its_drawn_randomness():
    """The builder's own r is 16 limbs: every row passes, a corrupted
    amount fails alone, and the padding rows continue the ids."""
    witness, n, r = workloads.build_withdrawals(n_real=12, seed=6)
    assert r == workloads.draw_randomness(np.random.RandomState(6))
    ids = [row.withdrawal_id for row in witness.rows]
    assert ids == list(range(ids[0], ids[0] + n))
    assert [row.amount == 0 for row in witness.rows] == [False] * 12 + [True] * 4
    assert not pw.withdrawal_kernel(witness, n, r, device="cpu")().any()
    pw.verify_circuit(witness, n, r)
    witness, n, r = workloads.build_withdrawals(n_real=12, seed=6, corrupt_row=0)
    assert pw.withdrawal_kernel(witness, n, r, device="cpu")().nonzero().flatten().tolist() == [0]


def _horner_by_field_ops(ctx, byte_cols, active_cols, r):
    """The JAX ``_horner_rlc`` scan with the field's own multiply and add
    (``ops/fr.py`` ``mul``/``add``), which take an r of any width."""
    acc = np.zeros((byte_cols.shape[1], 16), dtype=np.uint32)
    r_row = JL.int_to_limbs(r % P, 16)[None, :]
    for j in range(byte_cols.shape[0]):
        byte = JL.pad_limbs(np, byte_cols[j][:, None].astype(np.uint32), 16)
        acc = np.where(active_cols[j][:, None], jfr.add(np, jfr.mul(np, acc, r_row), byte), acc)
    return acc


@pytest.mark.parametrize("corrupt", [None, 0, 7])
def test_builder_at_its_drawn_randomness_matches_the_jax_circuit(monkeypatch, corrupt):
    """At the builder's own 254-bit r the circuit is held lane for lane
    against the JAX circuit in spec mode, whose Horner scan is done by
    ``fr.mul``/``fr.add`` there (its ``_horner_rlc`` stops at r < 2^224)."""
    witness, n, r = workloads.build_withdrawals(n_real=12, seed=6, corrupt_row=corrupt)
    assert r.bit_length() > 224
    monkeypatch.setattr(jk, "_horner_rlc", _horner_by_field_ops)
    jctx = JCtx(np, n, "eager")
    jcols, jextra = jw._withdrawal_inputs(witness, n, jctx)
    jcs = JConstraintSystem(jctx)
    jw.check_withdrawal(jctx, jcs, jcols, jw._withdrawal_tables(witness, jctx), {"r": r}, jextra)
    want = np.asarray(jcs.fail)
    got = pw.withdrawal_kernel(witness, n, r, device="cpu")().numpy()
    np.testing.assert_array_equal(got, want)
    assert np.flatnonzero(got).tolist() == ([] if corrupt is None else [corrupt])


def test_device_check_rebuilds_the_mpt_index(monkeypatch):
    """The MPT query comes in another column order than the prebuilt index,
    so the device check fingerprints the MPT table on every call (K6's
    fingerprint entry), as the JAX check rebuilds it under jit."""
    witness, n, r = workloads.build_withdrawals(n_real=16, seed=1, r=R)
    kernel = pw.withdrawal_kernel(witness, n, r, device="cpu")
    assert list(kernel.args[1]["mpt"]["idx"]) == ["/".join(MPT_SCHEMA.columns)]
    calls = []
    orig = engine.lookup_fingerprint

    def counted(parts, coefs):
        calls.append(parts[0].shape[0])
        return orig(parts, coefs)

    monkeypatch.setattr(engine, "lookup_fingerprint", counted)
    for _ in range(2):
        assert not kernel().any()
    assert calls == [len(witness.mpt_rows)] * 2


def test_device_context_reads_nothing_back(monkeypatch):
    witness, n, r = workloads.build_withdrawals(n_real=10, seed=2, corrupt_row=4, r=R)
    kernel = pw.withdrawal_kernel(witness, n, r, device="cpu")
    args = kernel.device_args()
    assert args[2]["byte_cols"].dtype == torch.uint8 and args[2]["active_cols"].dtype == torch.bool

    def host_read(*a, **k):
        raise AssertionError("a tensor value was read back during a device check")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    fail = kernel(args)
    monkeypatch.undo()
    assert np.flatnonzero(fail.numpy()).tolist() == [4]


def test_default_device_is_the_card_and_never_falls_back():
    witness, _ = _vector("ok")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pw.withdrawal_kernel(witness, MAX_WD, R)


@pytest.mark.parametrize("item", [0, 1, 0x7F, 0x80, 2**64 - 1, b"", b"x" * 55, b"y" * 56,
                                  [7, 99, 0xCAFE, int(2e9)], [[], [1, [2]], b"z" * 300]])
def test_rlp_matches_jax(item):
    assert rlp_encode(item) == jrlp(item)


def test_broadcast_and_from_lo_match_jax():
    jctx, ctx = JCtx(np, 6, "eager"), Ctx("cpu", 6, "eager")
    for value in (0, 12345, 2**64 - 1):
        jword = JWord.from_lo(JF.const(jctx, value).broadcast())
        word = Word.from_lo(F.const(ctx, value).broadcast())
        for part in ("lo", "hi"):
            j, p = getattr(jword, part), getattr(word, part)
            assert p.bits == j.bits
            np.testing.assert_array_equal(p.limbs.numpy(), np.asarray(j.limbs))
    full = F.from_ints(ctx, list(range(6)), 64)
    assert full.broadcast() is full
