"""The port's signed-tx path (zkevm_specs_tpu_torch.ops.ecc.secp256k1,
circuits/tx.py, circuits/sig.py and super_circuit.sig_witness_from_txs)
against the JAX package, on the CPU, tolerance 0.

* secp256k1: ``mul`` and ``u1 G + u2 Q`` on scalars at the edges of G's
  window table, ``sign``, ``recover``, ``verify`` and ``priv_to_pub`` on
  the same keys and hashes, and ``verify_batch`` on the edge cases (a key off
  the curve, no key, r or s at 0 and at N or above, a high s, the dummy
  signature), bit for bit against the JAX module, whichever of its paths
  (the native library or Python) it takes;
* ``txs2witness`` and ``sig_witness_from_txs`` row for row, the keccak
  tables compared as sets;
* on tests/test_tx_sig_circuits.py's vectors (ok, a create tx, a bad
  address, a bad signature, a wrong validity flag, a missing keccak
  entry): the inputs of ``tx_kernel`` / ``sig_kernel`` and their per-lane
  fail bits on ``device="cpu"`` (the kernels' plain versions) against the
  JAX checks run in spec mode, and the spec drivers' verdicts."""
import numpy as np
import pytest
import torch

from zkevm_specs_tpu.circuits import sig as jsig
from zkevm_specs_tpu.circuits import super_circuit as jsuper
from zkevm_specs_tpu.circuits import tx as jtx
from zkevm_specs_tpu.dsl.cs import ConstraintSystem as JCS
from zkevm_specs_tpu.dsl.value import Ctx as JCtx
from zkevm_specs_tpu.ops.ecc import secp256k1 as jec
from zkevm_specs_tpu.ops.keccak import keccak256
from zkevm_specs_tpu.tables.engine import Table as JTable
from zkevm_specs_tpu.tables.schemas import KECCAK_SCHEMA as J_KECCAK
from zkevm_specs_tpu_torch.circuits import sig as psig
from zkevm_specs_tpu_torch.circuits import super_circuit as psuper
from zkevm_specs_tpu_torch.circuits import tx as ptx
from zkevm_specs_tpu_torch.ops.ecc import secp256k1 as pec

torch.set_num_threads(1)

CHAIN_ID = 1337
MAX_TXS = 3
MAX_CALLDATA = 64
R = 12345678901234567890


# -- secp256k1 -------------------------------------------------------------------

@pytest.mark.parametrize("sk,msg", [(1, b""), (5, b"zkevm on tpu"), (pec.N - 1, b"x" * 100),
                                    (0xC0FFEE, bytes(32))])
def test_sign_recover_verify_match_jax(sk, msg):
    h = int.from_bytes(keccak256(msg), "big")
    k = (h ^ sk) % pec.N or 1
    assert pec.priv_to_pub(sk) == jec.priv_to_pub(sk)
    sig = pec.sign(h, sk, k)
    assert sig == jec.sign(h, sk, k)
    v, r, s = sig
    assert pec.recover(h, v, r, s) == jec.recover(h, v, r, s) == pec.priv_to_pub(sk)
    assert pec.verify(h, r, s, pec.priv_to_pub(sk)) is jec.verify(h, r, s, jec.priv_to_pub(sk))
    for bad in ((h + 1, v, r, s), (h, v ^ 1, r, s), (h, 4, r, s), (h, v, 0, s), (h, v, r, pec.N)):
        assert pec.recover(*bad) == jec.recover(*bad)


_SCALARS = [0, 1, 2, 15, 16, 17, 255, 256, 1 << 128, (1 << 252) + 15, pec.N - 1, pec.N - 2,
            pec.N, pec.N + 1, (1 << 256) - 1, 0xC0FFEE * 0x10001]


@pytest.mark.parametrize("k", _SCALARS)
def test_mul_and_double_mul_match_jax(k):
    """The port's table of G's windows and its Jacobian sum give the JAX
    module's points: k G, k Q and u1 G + u2 Q, on scalars at the windows'
    edges, at and past N, and sums that meet at a doubling or cancel."""
    q = jec.mul(jec.G, 0x1234567)
    assert pec.mul(pec.G, k) == jec.mul(jec.G, k)
    assert pec.mul(q, k) == jec.mul(q, k)
    for u1, u2, p in ((k, 77, q), (k, k, pec.G), (k, pec.N - k % pec.N, pec.G)):
        assert pec._double_mul(u1, u2, p) == jec.add(jec.mul(jec.G, u1), jec.mul(p, u2))


def _batch_rows():
    h = int.from_bytes(keccak256(b"batch"), "big")
    pub = pec.priv_to_pub(7)
    _, r, s = pec.sign(h, 7, 0x1234567)
    off_curve = (pub[0], (pub[1] + 1) % pec.P)
    return [
        (h, r, s, pub),                        # valid
        (h, r, pec.N - s, pub),                # the high s of the same signature
        (h + 1, r, s, pub),                    # another message
        (h, r, s, off_curve),                  # a key off the curve
        (h, r, s, None),                       # no key
        (h, 0, s, pub), (h, pec.N, s, pub), (h, pec.N + 5, s, pub),
        (h, r, 0, pub), (h, r, pec.N, pub), (h, r, 1 << 256, pub),
        (ptx.DUMMY_MSG_HASH, *ptx.DUMMY_SIGNATURE, ptx.DUMMY_PUBLIC_KEY),
        (h, r, s, pec.priv_to_pub(8)),         # another key
    ]


def test_verify_batch_matches_jax_on_edge_cases():
    rows = _batch_rows()
    got = pec.verify_batch(rows)
    assert got == jec.verify_batch(rows)
    assert got == [True, True, False, False, False, False, False, False, False, False, False,
                   True, False]
    # the batch is each row's verdict, and the JAX per-row verdict too
    assert got == [p is not None and jec.verify(h, r, s, p) for h, r, s, p in rows]


def test_dummy_signature_verifies():
    assert pec.verify(ptx.DUMMY_MSG_HASH, *ptx.DUMMY_SIGNATURE, ptx.DUMMY_PUBLIC_KEY)
    assert ptx.DUMMY_PUBLIC_KEY == pec.priv_to_pub(1)
    assert (ptx.DUMMY_SIGNATURE, ptx.DUMMY_PUBLIC_KEY, ptx.DUMMY_MSG_HASH) == (
        jtx.DUMMY_SIGNATURE, jtx.DUMMY_PUBLIC_KEY, jtx.DUMMY_MSG_HASH)


# -- the witnesses -------------------------------------------------------------------

def _make_tx(mod, sk, nonce=0, data=b"", to=0xDEADBEEF):
    tx = mod.Transaction(nonce=nonce, gas_price=int(2e9), gas=21000, to=to, value=int(1e16),
                         data=data, sig_v=0, sig_r=0, sig_s=0)
    return mod.sign_tx(sk, tx, CHAIN_ID)


TX_SETS = {
    "ok": [(3, 0, b"hello", 0xDEADBEEF), (7, 5, b"", 0xDEADBEEF)],
    "create": [(11, 1, b"\x60\x00", None)],
    "one": [(3, 0, b"", 0xDEADBEEF)],
}


def _txs(mod, name):
    return [_make_tx(mod, sk, nonce, data, to) for sk, nonce, data, to in TX_SETS[name]]


def _chip_fields(c):
    return (c.pub_key_hash, c.address, c.msg_hash, c.signature, c.pub_key, c.msg_hash_int)


@pytest.mark.parametrize("name", sorted(TX_SETS))
def test_txs2witness_matches_jax(name):
    jt, pt = _txs(jtx, name), _txs(ptx, name)
    assert [tuple(t) for t in pt] == [tuple(t) for t in jt]
    jw = jtx.txs2witness(jt, CHAIN_ID, MAX_TXS, MAX_CALLDATA, R)
    pw = ptx.txs2witness(pt, CHAIN_ID, MAX_TXS, MAX_CALLDATA, R)
    assert [tuple(r) for r in pw.rows] == [tuple(r) for r in jw.rows]
    assert pw.keccak_table.table == jw.keccak_table.table
    assert ([_chip_fields(c) for c in pw.sign_verifications]
            == [_chip_fields(c) for c in jw.sign_verifications])


@pytest.mark.parametrize("name", sorted(TX_SETS))
def test_sig_witness_from_txs_matches_jax(name):
    jw = jsuper.sig_witness_from_txs(_txs(jtx, name), CHAIN_ID, R)
    pw = psuper.sig_witness_from_txs(_txs(ptx, name), CHAIN_ID, R)
    fields = ("pub_key", "msg_hash", "sig_v", "sig_r", "sig_s", "pub_key_hash",
              "recovered_addr", "is_valid")
    assert ([[getattr(r, f) for f in fields] for r in pw.rows]
            == [[getattr(r, f) for f in fields] for r in jw.rows])
    assert [r.table_row() for r in pw.rows] == [r.table_row() for r in jw.rows]
    assert pw.keccak_table.table == jw.keccak_table.table
    assert {tuple(sorted(r.items())) for r in pw.keccak_table.rows()} == \
        {tuple(sorted(r.items())) for r in jw.keccak_table.rows()}


# -- the kernels' inputs and fail bits --------------------------------------------------

def _sig_row(mod, ec, sk=5, msg=b"zkevm on tpu", valid=True):
    h = keccak256(msg)
    v, r, s = ec.sign(int.from_bytes(h, "big"), sk, k=0x1234567)
    if not valid:
        s = (s + 1) % ec.N
    return mod.SigRow.assign((v, r, s), ec.priv_to_pub(sk), h, is_valid=valid)


def _tx_witness(mod, vector):
    """The tx witness of a vector of tests/test_tx_sig_circuits.py in
    ``mod``'s classes: (witness, must fail)."""
    w = mod.txs2witness(_txs(mod, "create" if vector == "create" else
                             "ok" if vector == "ok" else "one"),
                        CHAIN_ID, MAX_TXS, MAX_CALLDATA, R)
    if vector == "bad_address":
        rows = list(w.rows)
        i = int(mod.Tag.CallerAddress) - 1
        rows[i] = rows[i]._replace(value=rows[i].value ^ 1)
        return mod.Witness(rows, w.keccak_table, w.sign_verifications), True
    if vector == "bad_sig":
        sv = w.sign_verifications[0]
        bad = mod.SignVerifyChip(sv.pub_key_hash, sv.address, sv.msg_hash,
                                 (sv.signature[0], sv.signature[1] ^ 1), sv.pub_key,
                                 sv.msg_hash_int)
        return mod.Witness(w.rows, w.keccak_table, [bad] + w.sign_verifications[1:]), True
    return w, False


def _sig_witness(mod, ec, vector):
    kt = mod.KeccakTable()
    if vector == "ok":
        rows = [_sig_row(mod, ec, 5), _sig_row(mod, ec, 7), _sig_row(mod, ec, 9, valid=False)]
    else:
        rows = [_sig_row(mod, ec, 5)]
        if vector == "wrong_validity":
            rows[0].is_valid = False
    if vector != "missing_keccak":
        for row in rows:
            kt.add(ec.pubkey_bytes(row.pub_key), R)
    return mod.Witness(rows, kt), vector != "ok"


def _jax_fail(check, cols, keccak_rows, extra, n):
    ctx = next(iter(cols.values()))
    ctx = getattr(ctx, "lo", ctx).ctx
    cs = JCS(ctx)
    check(ctx, cs, cols, {"keccak": JTable.from_rows(ctx, J_KECCAK, keccak_rows)}, {"r": R},
          {k: np.asarray(a) for k, a in extra.items()})
    fail = np.asarray(cs.fail)
    assert fail.shape == (n,)
    return fail


def _same_inputs(kernel, jcols, jextra):
    """The port kernel's packed columns and extra arrays hold the JAX
    inputs' values."""
    from zkevm_specs_tpu_torch.dsl.value import Ctx
    from zkevm_specs_tpu_torch.runtime.kernels import unpack_values

    cols_tree, _, extra_tree = kernel.args
    pcols = unpack_values(Ctx("cpu", kernel.n, "eager"),
                          {k: {p: torch.from_numpy(np.asarray(a)) for p, a in v.items()}
                           for k, v in cols_tree.items()}, kernel.cols_meta)
    assert sorted(pcols) == sorted(jcols)
    for name in jcols:
        assert pcols[name].to_ints() == jcols[name].to_ints(), name
    assert sorted(extra_tree) == sorted(jextra)
    for name in jextra:
        np.testing.assert_array_equal(extra_tree[name], np.asarray(jextra[name]))


TX_VECTORS = ("ok", "create", "bad_address", "bad_sig")
SIG_VECTORS = ("ok", "wrong_validity", "missing_keccak")


@pytest.mark.parametrize("evm_callers", [False, True])
@pytest.mark.parametrize("vector", TX_VECTORS)
def test_tx_kernel_matches_jax(vector, evm_callers):
    jw, must_fail = _tx_witness(jtx, vector)
    pw, _ = _tx_witness(ptx, vector)
    callers = None
    if evm_callers:
        callers = [c.address for c in pw.sign_verifications if c.address]
        callers[0] ^= 0x10                  # an EVM-side sender that signed nothing
    jcols, jextra = jtx._tx_inputs(jw, MAX_TXS, JCtx(np, MAX_TXS, "eager"), callers)
    want = _jax_fail(jtx.check_tx, jcols, jw.keccak_table.rows(), jextra, MAX_TXS)
    k = ptx.tx_kernel(pw, MAX_TXS, R, evm_callers=callers, device="cpu")
    _same_inputs(k, jcols, jextra)
    got = k().numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() == (must_fail or evm_callers)
    for mod, w in ((jtx, jw), (ptx, pw)):
        if got.any():
            with pytest.raises(AssertionError):
                mod.verify_circuit(w, MAX_TXS, MAX_CALLDATA, R, evm_callers=callers)
        else:
            mod.verify_circuit(w, MAX_TXS, MAX_CALLDATA, R, evm_callers=callers)


@pytest.mark.parametrize("vector", SIG_VECTORS)
def test_sig_kernel_matches_jax(vector):
    jw, must_fail = _sig_witness(jsig, jec, vector)
    pw, _ = _sig_witness(psig, pec, vector)
    ctx = JCtx(np, len(jw.rows), "eager")
    jcols, jextra = jsig._sig_inputs(jw, ctx)
    want = _jax_fail(jsig.check_sig, jcols, jw.keccak_table.rows(), jextra, len(jw.rows))
    k = psig.sig_kernel(pw, R, device="cpu")
    _same_inputs(k, jcols, jextra)
    got = k().numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() == must_fail
    for mod, w in ((jsig, jw), (psig, pw)):
        if must_fail:
            with pytest.raises(AssertionError):
                mod.verify_circuit(w, R)
        else:
            mod.verify_circuit(w, R)


def test_kernels_search_the_prebuilt_keccak_index():
    """The keccak query comes in ``KECCAK_SCHEMA``'s order, so the device
    check searches the index built on the host and builds none."""
    from zkevm_specs_tpu_torch.tables import engine

    pw, _ = _sig_witness(psig, pec, "ok")
    tw, _ = _tx_witness(ptx, "ok")
    for k in (psig.sig_kernel(pw, R, device="cpu"),
              ptx.tx_kernel(tw, MAX_TXS, R, device="cpu")):
        assert list(k.args[1]["keccak"]["idx"]) == ["state_tag/input_rlc/input_len/output"]
        built = []
        orig = engine.lookup_fingerprint
        engine.lookup_fingerprint = lambda *a: built.append(a) or orig(*a)
        try:
            k()
        finally:
            engine.lookup_fingerprint = orig
        assert built == []


def test_sig_kernel_of_no_rows_is_none():
    assert psig.sig_kernel(psig.Witness([], psig.KeccakTable()), R, device="cpu") is None


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pw, _ = _sig_witness(psig, pec, "ok")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psig.sig_kernel(pw, R)
    tw, _ = _tx_witness(ptx, "ok")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptx.tx_kernel(tw, MAX_TXS, R)
