"""The port's pi circuit (zkevm_specs_tpu_torch.circuits.pi) against the
JAX package's, on the CPU, tolerance 0.

The public data of tests/test_public_inputs.py's shape (``rand_public_data``:
random block fields, 256 block hashes, txs with calldata, a full
withdrawal table), drawn from ``numpy.random.RandomState`` and built with
each package's classes, goes through both packages':

* ``public_data2witness``: the rows dict by dict, the keccak and calldata
  gas tables, the block, tx and withdrawal tables, the circuit length and
  the raw-byte segments;
* ``build_pi_inputs``: every column's limbs and bound, the lookup tables'
  columns, and ``copy_idx`` / ``copy_mask`` / ``copy_lhs``;
* ``check_pi``: each row's fail bit, clean and under each corruption
  tests/test_public_inputs.py applies (and a few more), in spec mode and
  through the port's ``pi_kernel`` on the CPU (the device mode, K6's plain
  version);
* the withdrawal padding deviation: a zero amount in the middle fails, as
  a suffix it passes.

Also ``public_data_from_witness`` on the blocks of tests/test_torch_block.py."""
import dataclasses

import numpy as np
import pytest
import torch

from zkevm_specs_tpu.circuits import pi as jpi
from zkevm_specs_tpu.circuits.super_circuit import public_data_from_witness as j_public_data
from zkevm_specs_tpu.dsl.cs import ConstraintSystem as JCS
from zkevm_specs_tpu.witness import tracer as JT
from zkevm_specs_tpu.witness import typing as JY
from zkevm_specs_tpu_torch.circuits import pi as ppi
from zkevm_specs_tpu_torch.circuits.super_circuit import public_data_from_witness as p_public_data
from zkevm_specs_tpu_torch.dsl.cs import ConstraintSystem as PCS
from zkevm_specs_tpu_torch.runtime.convert import to_device
from zkevm_specs_tpu_torch.witness import tracer as PT
from zkevm_specs_tpu_torch.witness import typing as PY

from test_torch_tracer import txs_of

torch.set_num_threads(1)

MAX_TXS, MAX_CALLDATA, MAX_WD = 2, 8, 3


def rand_public_data(pkg, seed, n_txs=2, calldata_lens=(3, 3), amounts=None):
    """tests/test_public_inputs.py:rand_public_data's fields in ``pkg``'s
    classes (``jpi`` or ``ppi``), drawn from a seeded RandomState; the
    withdrawals' amounts are random and nonzero unless given."""
    rng = np.random.RandomState(seed)

    def word(bits):
        return int.from_bytes(rng.bytes(32), "little") >> (256 - bits)

    block = pkg.Block(
        hash=word(256), parent_hash=word(256), uncle_hash=word(256), coinbase=word(160),
        state_root=word(256), tx_hash=word(256), receipt_hash=word(256), bloom=bytes(256),
        prev_randao=word(256), number=word(64), gas_limit=word(64), gas_used=word(64),
        time=word(64), extra=b"", mix_digest=word(256), nonce=word(64), base_fee=0,
        withdrawals_root=word(256))
    txs = [pkg.Transaction(nonce=word(64), gas_price=word(256), gas=word(64),
                           from_addr=word(160), to_addr=word(160), value=word(256),
                           data=bytes(rng.randint(0, 256, size=calldata_lens[i]).tolist()),
                           tx_sign_hash=word(256))
           for i in range(n_txs)]
    amounts = amounts or [word(64) or 1 for _ in range(MAX_WD)]
    wds = [pkg.Withdrawal(i, word(64), word(160), amounts[i]) for i in range(MAX_WD)]
    return pkg.PublicData(chain_id=word(64), block=block, state_root_prev=word(256),
                          block_hashes=[word(256) for _ in range(256)], txs=txs,
                          withdrawals=wds)


# the public data of each case: (n_txs, calldata lengths, seed)
CASES = {
    "two_txs": (2, (3, 3), 0),
    "single_tx": (1, (3,), 1),
    "zero_bytes": (2, (0, 8), 2),
    "no_calldata": (2, (0, 0), 3),
}


def _witnesses(case, **kw):
    n_txs, lens, seed = CASES[case]
    return tuple(pkg.public_data2witness(rand_public_data(pkg, seed, n_txs, lens, **kw),
                                         MAX_TXS, MAX_CALLDATA, MAX_WD) for pkg in (jpi, ppi))


@pytest.mark.parametrize("case", sorted(CASES))
def test_witness_matches_jax(case):
    jw, pw = _witnesses(case)
    assert pw.rows == jw.rows
    assert pw.keccak_table == jw.keccak_table and len(pw.keccak_table) == 2
    assert pw.calldata_gas_cost_table == jw.calldata_gas_cost_table
    assert pw.block_table == jw.block_table
    assert pw.tx_table == jw.tx_table
    assert pw.withdrawal_table == jw.withdrawal_table
    assert pw.circuit_len == jw.circuit_len == len(pw.rows)
    assert pw.copy_constrains == jw.copy_constrains
    assert dataclasses.asdict(pw.public_inputs) == dataclasses.asdict(jw.public_inputs)
    # row 0 holds the stream's first byte, the keccak lookup and the digest
    assert pw.rows[0]["q_rpi_keccak_lookup"] == 1 and pw.rows[0]["rpi_digest"] != 0
    assert pw.rows[-1]["q_bytes_last"] == 1


def _limbs(v):
    return np.asarray(v.limbs).astype(np.int64)


def _same_value(j, p):
    if hasattr(j, "lo"):
        _same_value(j.lo, p.lo)
        _same_value(j.hi, p.hi)
        return
    assert p.bits == j.bits
    np.testing.assert_array_equal(p.limbs.numpy(), _limbs(j))


@pytest.mark.parametrize("case", sorted(CASES))
def test_inputs_match_jax(case):
    jw, pw = _witnesses(case)
    _, jcols, jtables, jstatic, jextra = jpi.build_pi_inputs(jw, MAX_TXS, MAX_CALLDATA, MAX_WD)
    _, pcols, ptables, pstatic, pextra = ppi.build_pi_inputs(pw, MAX_TXS, MAX_CALLDATA, MAX_WD)
    assert list(pcols) == list(jcols) and pstatic == jstatic
    for k in jcols:
        _same_value(jcols[k], pcols[k])
    assert sorted(ptables) == sorted(jtables) == ["cd_gas", "keccak"]
    for name, jt in jtables.items():
        pt = ptables[name]
        assert pt.n_rows == jt.n_rows and pt.schema.name == jt.schema.name
        assert list(pt.schema.columns) == list(jt.schema.columns)
        for c in jt.data:
            _same_value(jt.data[c], pt.data[c])
    assert sorted(pextra) == sorted(jextra) == ["copy_idx", "copy_lhs", "copy_mask"]
    for k in jextra:
        np.testing.assert_array_equal(np.asarray(pextra[k]).astype(np.int64),
                                      np.asarray(jextra[k]).astype(np.int64))
    assert pextra["copy_idx"].dtype == np.int32 and pextra["copy_mask"].dtype == np.uint8


def _corrupt(w, kind):
    """The same edit of either package's witness."""
    rows = w.rows
    if kind == "bad_digest":                      # test_pi_bad_digest
        rows[0]["rpi_digest"] ^= 1
        w.public_inputs.pi_keccak ^= 1
    elif kind == "bad_byte":                      # test_pi_bad_byte
        rows[100]["rpi_bytes"] = (rows[100]["rpi_bytes"] + 1) % 256
    elif kind == "bad_calldata_gas_acc":          # test_pi_bad_calldata_gas_acc
        r = next(r for r in rows if r["q_tx_calldata"] and r["calldata_gas_cost"])
        r["calldata_gas_cost"] += 1
    elif kind == "value_lc":
        rows[37]["rpi_value_lc"] = (rows[37]["rpi_value_lc"] + 1) % ppi.P
    elif kind == "keccakrlc":
        rows[0]["rpi_bytes_keccakrlc"] = (rows[0]["rpi_bytes_keccakrlc"] + 1) % ppi.P
    elif kind == "tx_id_inv":
        r = next(r for r in rows if r["q_tx_calldata"] and r["tx_id"])
        r["tx_id_inv"] = (r["tx_id_inv"] + 1) % ppi.P
    elif kind == "tx_value_lo_inv":
        r = next(r for r in rows if r["q_tx_table"] and r["tx_value_lo"])
        r["tx_value_lo_inv"] = 0
    elif kind == "wd_id":
        r = next(r for r in rows if r["q_withdrawal_table"])
        r["wd_id"] += 1
    elif kind is not None:
        raise ValueError(kind)


def _jax_fail(w):
    ctx, cols, tables, static, extra = jpi.build_pi_inputs(w, MAX_TXS, MAX_CALLDATA, MAX_WD)
    cs = JCS(ctx)
    jpi.check_pi(ctx, cs, cols, tables, static, {k: np.asarray(a) for k, a in extra.items()})
    return np.asarray(cs.fail)


def _port_fails(w):
    """The port's fail bits in spec mode (eager, host lookups) and through
    ``pi_kernel`` on the CPU (device mode: K6's plain version)."""
    ctx, cols, tables, static, extra = ppi.build_pi_inputs(w, MAX_TXS, MAX_CALLDATA, MAX_WD)
    cs = PCS(ctx)
    ppi.check_pi(ctx, cs, cols, tables, static, to_device(extra, "cpu"))
    kernel = ppi.pi_kernel(w, MAX_TXS, MAX_CALLDATA, MAX_WD, device="cpu")
    return cs.fail.numpy(), kernel().numpy()


CORRUPTIONS = [None, "bad_digest", "bad_byte", "bad_calldata_gas_acc", "value_lc", "keccakrlc",
               "tx_id_inv", "tx_value_lo_inv", "wd_id"]


@pytest.mark.parametrize("case,kind", [("two_txs", k) for k in CORRUPTIONS]
                         + [("single_tx", None), ("single_tx", "bad_calldata_gas_acc"),
                            ("zero_bytes", None)], ids=str)
def test_fail_bits_match_jax(case, kind):
    jw, pw = _witnesses(case)
    _corrupt(jw, kind)
    _corrupt(pw, kind)
    want = _jax_fail(jw)
    spec, device = _port_fails(pw)
    np.testing.assert_array_equal(spec, want)
    np.testing.assert_array_equal(device, want)
    assert want.any() == (kind is not None)
    if kind == "bad_byte":
        assert want.all()              # the copy constraint is one verdict for every row
    if kind == "value_lc":
        assert 0 < want.sum() <= 2     # its row and the row before it


@pytest.mark.parametrize("kind", [None, "bad_digest"], ids=str)
def test_verify_circuit_verdict(kind):
    """Spec mode's verdict: passes on the clean witness, raises on a bad
    digest (as tests/test_public_inputs.py holds the JAX ``verify_circuit``)."""
    _, pw = _witnesses("single_tx")
    _corrupt(pw, kind)
    ppi.verify_circuit(pw, MAX_TXS, MAX_CALLDATA, MAX_WD, success=kind is None)
    with pytest.raises(AssertionError):
        ppi.verify_circuit(pw, MAX_TXS, MAX_CALLDATA, MAX_WD, success=kind is not None)


@pytest.mark.parametrize("amounts,ok", [([5, 7, 0], True), ([5, 0, 0], True),
                                        ([5, 0, 7], False), ([0, 5, 7], False)])
def test_withdrawal_padding_must_be_a_suffix(amounts, ok):
    """Zero-amount padding rows pass as a suffix of the withdrawal table
    and fail in the middle (the deviation from pi_circuit.py:321 that both
    packages make); the port's device mode on the CPU against the JAX
    check."""
    jw, pw = _witnesses("two_txs", amounts=amounts)
    want = _jax_fail(jw)
    got = ppi.pi_kernel(pw, MAX_TXS, MAX_CALLDATA, MAX_WD, device="cpu")().numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() != ok


# -- public_data_from_witness on the blocks of tests/test_torch_block.py -----------------

def _calldata_txs(Y):
    txs = txs_of(Y, n_txs=3, n_ops=2)
    for (tx, _), data in zip(txs, (bytes([0, 1, 2, 0]), b"", bytes(range(1, 40)))):
        tx.call_data = data
    return txs


BLOCKS = {
    "clean": (lambda Y: txs_of(Y), 0),
    "withdrawals": (lambda Y: txs_of(Y), 3),
    "shared_caller": (lambda Y: txs_of(Y, shared_caller=True), 0),
    "calldata": (_calldata_txs, 2),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_public_data_from_witness_matches_jax(kind):
    txs, n_wd = BLOCKS[kind]
    out = []
    for T, Y, build in ((JT, JY, j_public_data), (PT, PY, p_public_data)):
        w = T.trace_block(Y.Block(base_fee=int(1e9), number=3, history_hashes=[11, 22, 33]),
                          txs(Y), sign=False,
                          withdrawals=[Y.Withdrawal(id=i + 4, validator_id=i, address=0xCAFE + i,
                                                    amount=10 + i) for i in range(n_wd)])
        pd = build(w, max(1, n_wd) + 1)      # one padding slot past the block's withdrawals
        out.append((pd, w))
    (jpd, jw), (ppd, pw) = out
    assert dataclasses.asdict(ppd) == dataclasses.asdict(jpd)
    assert ppd.withdrawals[-1].amount == 0
    assert ppd.withdrawals[-1].id == (ppd.withdrawals[-2].id + 1 if n_wd else 1)
    assert ppd.block_hashes[-3:] == [11, 22, 33] and len(ppd.block_hashes) == 256
    # the pi witness of the block's public data
    max_calldata = max(1, sum(len(tx.call_data) for tx in pw.txs))
    n = max(1, n_wd) + 1
    jwit = jpi.public_data2witness(jpd, len(jw.txs), max_calldata, n)
    pwit = ppi.public_data2witness(ppd, len(pw.txs), max_calldata, n)
    assert pwit.rows == jwit.rows
    assert pwit.calldata_gas_cost_table == jwit.calldata_gas_cost_table


@pytest.mark.parametrize("module", ["tables.container", "circuits.super_circuit", "circuits.pi"])
def test_module_imports_first(module):
    """Each module imports as the first of the package in a fresh process
    (``tables/container.py`` imports the ``evm`` package, which imports it,
    only when the fixed tables are first built)."""
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run([sys.executable, "-c", f"import zkevm_specs_tpu_torch.{module}"],
                         cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
