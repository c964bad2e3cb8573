"""The port's bytecode circuit and CircuitKernel (zkevm_specs_tpu_torch.
circuits.bytecode, runtime.kernels) against the JAX package's, tolerance 0:
on the bytecode vectors of tests/test_bytecode_copy_exp.py, the fail bits of
the port's ``bytecode_kernel(..., device="cpu")()`` equal those of the JAX
``bytecode_kernel(...)()`` (jitted on the CPU), and ``verify_bytecode_circuit``
raises where the JAX one does."""
import numpy as np
import pytest
import torch

from zkevm_specs_tpu.circuits import bytecode as jbc
from zkevm_specs_tpu.dsl.value import Ctx as JCtx
from zkevm_specs_tpu.evm import Bytecode as JBytecode
from zkevm_specs_tpu.ops.fr import P
from zkevm_specs_tpu.runtime import kernels as jkernels
from zkevm_specs_tpu.tables.engine import Table as JTable
from zkevm_specs_tpu.tables.schemas import KECCAK_SCHEMA as JKECCAK
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.circuits import bytecode as pbc
from zkevm_specs_tpu_torch.dsl.value import Ctx
from zkevm_specs_tpu_torch.runtime import kernels as pkernels
from zkevm_specs_tpu_torch.runtime.convert import to_device
from zkevm_specs_tpu_torch.tables.engine import Table
from zkevm_specs_tpu_torch.tables.schemas import KECCAK_SCHEMA
from zkevm_specs_tpu_torch.witness.typing import Bytecode

torch.set_num_threads(1)

K = 9


def _rng(seed):
    return np.random.RandomState(seed)


def _fq(rng):
    return int.from_bytes(rng.bytes(32), "little") % P


def _small_code():
    code = bytes(Bytecode().push(1, 1).push(2, 1).add().stop().code)
    assert code == bytes(JBytecode().push(1, 1).push(2, 1).add().stop().code)
    return code


def _vector(name):
    """(rows, keccak rows, r, expected to pass) of one vector of
    tests/test_bytecode_copy_exp.py:33-93, with seeded randomness."""
    rng = _rng(sum(map(ord, name)))
    r = _fq(rng)
    keccak_codes = None
    if name == "unrolling_ok":
        codes = [_small_code(), rng.bytes(60), b"", bytes([0x60, 0x05])]
    elif name == "full_circuit":
        codes = [rng.bytes(2**K - 2)]
    elif name == "bad_hash":
        codes, keccak_codes = [rng.bytes(8)], [b"different"]
    elif name == "bad_length":
        codes = [rng.bytes(16)]
    elif name == "bad_is_code":
        codes = [bytes(Bytecode().push(5, 1).stop().code)]
    else:
        codes = [_small_code()]
    rows = jbc.assign_bytecode_circuit(K, [jbc.unroll(c) for c in codes], r)
    assert rows == pbc.assign_bytecode_circuit(K, [pbc.unroll(c) for c in codes], r)
    if name == "bad_byte":
        rows[2]["value"] = (rows[2]["value"] + 1) % 256
    elif name == "bad_length":
        rows[0]["value"] = rows[0]["length"] = 17
    elif name == "bad_is_code":
        rows[2]["is_code"] = 1 - rows[2]["is_code"]
    keccak_rows = jbc.assign_keccak_table(keccak_codes or codes, r)
    assert keccak_rows == pbc.assign_keccak_table(keccak_codes or codes, r)
    return rows, keccak_rows, r, name in ("unrolling_ok", "full_circuit")


VECTORS = ["unrolling_ok", "full_circuit", "bad_byte", "bad_length", "bad_is_code", "bad_hash"]


def _both(rows, keccak_rows, r):
    got = pbc.bytecode_kernel(rows, keccak_rows, r, device="cpu")().numpy()
    want = np.asarray(jbc.bytecode_kernel(rows, keccak_rows, r)())
    np.testing.assert_array_equal(got, want)
    return got


def _raises(verify, *args):
    try:
        verify(*args)
    except AssertionError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", VECTORS)
def test_vector_matches_jax(name):
    rows, keccak_rows, r, ok = _vector(name)
    fail = _both(rows, keccak_rows, r)
    assert (not fail.any()) == ok
    port_msg = _raises(pbc.verify_bytecode_circuit, rows, keccak_rows, r)
    jax_msg = _raises(jbc.verify_bytecode_circuit, rows, keccak_rows, r)
    assert port_msg == jax_msg
    assert (port_msg is None) == ok


@pytest.mark.parametrize("corrupt", [None, 45])
def test_alu_mix_matches_jax(corrupt):
    rows, keccak_rows, r = workloads.build_alu_bytecodes(2, 12, k=8, seed=5, corrupt_row=corrupt)
    fail = _both(rows, keccak_rows, r)
    assert fail.any() == (corrupt is not None)


def test_alu_bytecodes_are_the_bench_mix():
    codes = workloads.alu_bytecodes(3, 7)
    assert len(set(codes)) == 1 and len(codes[0]) == 6 * 7 + 1
    assert workloads.bytecode_k(workloads.alu_bytecodes(8, 11000)) == 20


def _keccak_table(ctx_cls, table_cls, schema, ctx_arg):
    rows = pbc.assign_keccak_table([b"", b"abc", bytes(range(40))], 12345)
    t = table_cls.from_rows(ctx_cls(ctx_arg, 1, "eager"), schema, rows)
    t.index_for(tuple(schema.columns))
    return t


def test_pack_table_round_trip():
    t = _keccak_table(Ctx, Table, KECCAK_SCHEMA, "cpu")
    tree, meta = pkernels.pack_table(t)
    # the JAX package packs the same table the same way
    jtree, jmeta = jkernels.pack_table(_keccak_table(JCtx, JTable, JKECCAK, np))
    assert meta["n_rows"] == jmeta["n_rows"] and meta["cols"] == jmeta["cols"]
    assert meta["spans"] == jmeta["spans"]
    for c, arrs in jtree["cols"].items():
        for part, arr in arrs.items():
            np.testing.assert_array_equal(tree["cols"][c][part], arr)
    for key, d in jtree["idx"].items():
        np.testing.assert_array_equal(tree["idx"][key]["fps"], d["fps"])
        np.testing.assert_array_equal(tree["idx"][key]["order"], d["order"])
    # unpacked from its upload, the table and its index are the same
    ctx = Ctx("cpu", 1, "device")
    back = pkernels.unpack_table(ctx, to_device(tree, "cpu"), meta)
    assert back.n_rows == t.n_rows and back.schema is t.schema
    for c, v in t.data.items():
        for part in (("lo", "hi") if hasattr(v, "lo") else (None,)):
            a = getattr(v, part) if part else v
            b = getattr(back.data[c], part) if part else back.data[c]
            assert a.bits == b.bits and torch.equal(a.limbs, b.limbs)
    (subset, (fps, order, span)), = t._indexes.items()
    bfps, border, bspan = back._indexes[subset]
    np.testing.assert_array_equal(bfps.numpy().view(np.uint64), fps)
    np.testing.assert_array_equal(border.numpy(), order)
    assert bspan == span == 1


def test_circuit_kernel_uploads_once_and_never_falls_back():
    rows, keccak_rows, r, _ = _vector("unrolling_ok")
    kernel = pbc.bytecode_kernel(rows, keccak_rows, r, device="cpu")
    assert kernel.device_args() is kernel.device_args()
    assert not kernel().any()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbc.bytecode_kernel(rows, keccak_rows, r)
