"""The port's state circuit (zkevm_specs_tpu_torch.circuits.state) against
the JAX package's, tolerance 0: per-row fail bits of the port's device-mode
check (run with device="cpu", so the kernels' plain versions run) equal
the JAX eager check and ``jax.jit(make_state_check_fn(meta))`` on the CPU,
on every vector of tests/test_state_circuit.py and on both bench mixes.
Also: K5's plain version against the JAX ordering key, K6's plain version
against the JAX non-hinted lookup, and the DSL bounds the check relies on."""
import jax
import numpy as np
import pytest
import torch

from zkevm_specs_tpu.circuits import state as jst
from zkevm_specs_tpu.dsl.cs import ConstraintSystem as JCS
from zkevm_specs_tpu.dsl.value import Ctx as JCtx
from zkevm_specs_tpu.dsl.value import F as JF
from zkevm_specs_tpu.dsl.value import Word as JWord
from zkevm_specs_tpu.ops import limbs as JL
from zkevm_specs_tpu.tables import schemas as jschemas
from zkevm_specs_tpu.tables.engine import Table as JTable
from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.circuits import state as pst
from zkevm_specs_tpu_torch.dsl.cs import ConstraintSystem
from zkevm_specs_tpu_torch.dsl.value import Ctx, F, Word
from zkevm_specs_tpu_torch.runtime.convert import to_device
from zkevm_specs_tpu_torch.tables import engine
from zkevm_specs_tpu_torch.tables import schemas as pschemas
from zkevm_specs_tpu_torch.tables.engine import Table

torch.set_num_threads(1)


# -- the vectors of tests/test_state_circuit.py, built by either package -------

def _full_trace_ops(m, s):
    RW, A, C, TL, TR = s.RW, s.AccountFieldTag, s.CallContextFieldTag, s.TxLogFieldTag, s.TxReceiptFieldTag
    ops = [
        m.StartOp(rw_counter=1, rw=RW.Read, lexicographic_ordering_selector=0),
        m.StartOp(rw_counter=2, rw=RW.Read),
        m.StartOp(rw_counter=3, rw=RW.Read),
        m.MemoryOp(rw_counter=1, rw=RW.Read, call_id=1, mem_addr=0, value=0),
        m.MemoryOp(rw_counter=2, rw=RW.Write, call_id=1, mem_addr=0, value=42),
        m.MemoryOp(rw_counter=3, rw=RW.Read, call_id=1, mem_addr=0, value=42),
        m.StackOp(rw_counter=4, rw=RW.Write, call_id=1, stack_ptr=1022, value=4321),
        m.StackOp(rw_counter=5, rw=RW.Write, call_id=1, stack_ptr=1023, value=533),
        m.StackOp(rw_counter=6, rw=RW.Read, call_id=1, stack_ptr=1023, value=533),
        m.StorageOp(rw_counter=7, rw=RW.Read, tx_id=1, addr=0x12345678, key=0x1516, value=789,
                    committed_value=789),
        m.StorageOp(rw_counter=8, rw=RW.Write, tx_id=1, addr=0x12345678, key=0x4959, value=38491,
                    committed_value=98765),
        m.CallContextOp(rw_counter=9, rw=RW.Read, call_id=1, field_tag=C.IsStatic, value=0),
        m.CallContextOp(rw_counter=10, rw=RW.Read, call_id=2, field_tag=C.IsStatic, value=0),
        m.AccountOp(rw_counter=12, rw=RW.Write, addr=0x12345678, field_tag=A.Nonce, value=1,
                    committed_value=0),
        m.AccountOp(rw_counter=13, rw=RW.Read, addr=0x12345678, field_tag=A.Nonce, value=1,
                    committed_value=0),
        m.TxRefundOp(rw_counter=14, rw=RW.Write, tx_id=1, value=1),
        m.TxRefundOp(rw_counter=15, rw=RW.Write, tx_id=1, value=1),
        m.TxAccessListAccountOp(rw_counter=16, rw=RW.Read, tx_id=1, addr=0x12345678, value=0),
        m.TxAccessListAccountOp(rw_counter=17, rw=RW.Write, tx_id=1, addr=0x12345678, value=1),
        m.TxAccessListAccountStorageOp(rw_counter=18, rw=RW.Read, tx_id=1, addr=0x12345678,
                                       key=0x1516, value=0),
        m.TxAccessListAccountStorageOp(rw_counter=19, rw=RW.Write, tx_id=1, addr=0x12345678,
                                       key=0x1516, value=1),
    ]
    logs = [(20, 1, 1, TL.Address, 0, 124), (21, 1, 1, TL.Topic, 0, 10), (22, 1, 1, TL.Topic, 1, 5),
            (23, 1, 1, TL.Topic, 2, 200), (24, 1, 1, TL.Topic, 3, 278), (25, 1, 1, TL.Data, 0, 10),
            (26, 1, 1, TL.Data, 1, 255), (27, 1, 2, TL.Address, 0, 255), (28, 1, 2, TL.Data, 0, 88),
            (29, 2, 1, TL.Address, 0, 210), (30, 2, 1, TL.Topic, 0, 255), (31, 2, 1, TL.Data, 0, 10)]
    for rwc, tx, log, ft, idx, val in logs:
        ops.append(m.TxLogOp(rw_counter=rwc, rw=RW.Write, tx_id=tx, log_id=log, field_tag=ft,
                             index=idx, value=val))
    for rwc, tx, ft, val in [(32, 1, TR.PostStateOrStatus, 1), (33, 1, TR.CumulativeGasUsed, 200),
                             (34, 2, TR.PostStateOrStatus, 1), (35, 2, TR.CumulativeGasUsed, 500)]:
        ops.append(m.TxReceiptOp(rw_counter=rwc, rw=RW.Read, tx_id=tx, field_tag=ft, value=val))
    return ops


def _start(m, s):
    return m.StartOp(rw_counter=1, rw=s.RW.Read, lexicographic_ordering_selector=0)


def _storage(m, s, rwc, key, value, committed, rw=None):
    return m.StorageOp(rw_counter=rwc, rw=rw if rw is not None else s.RW.Write, tx_id=1,
                       addr=0x12345678, key=key, value=value, committed_value=committed)


def _ops(name, m, s):
    """(ops, row edit) of one vector; the edit is applied to the assigned rows."""
    RW = s.RW
    if name == "state_ok":
        return _full_trace_ops(m, s), None
    if name == "mpt_updates_ok":
        A = s.AccountFieldTag
        return [_start(m, s),
                _storage(m, s, 7, 0x1516, 789, 789, RW.Read),
                _storage(m, s, 8, 0x4959, 38491, 98765),
                m.AccountOp(rw_counter=12, rw=RW.Write, addr=0x12345678, field_tag=A.Nonce, value=1,
                            committed_value=0),
                m.AccountOp(rw_counter=13, rw=RW.Read, addr=0x12345678, field_tag=A.Balance,
                            value=3, committed_value=0)], None
    if name == "bad_is_write":
        return [_start(m, s), _storage(m, s, 1, 0x15161718, 789, 789)], (1, "is_write", 2)
    if name.startswith("non_lexicographic"):
        key_a, key_b = {"non_lexicographic_small": (0x1112, 0x1111),
                        "non_lexicographic_wide": (2 << 250, 1 << 250),
                        "non_lexicographic_equal": (123, 123)}[name]
        return [_start(m, s), _storage(m, s, 1, key_a, 98765, 98765),
                _storage(m, s, 1, key_b, 789, 98765)], None
    if name == "bad_read_consistency":
        return [_start(m, s), m.MemoryOp(rw_counter=1, rw=RW.Write, call_id=1, mem_addr=0, value=42),
                m.MemoryOp(rw_counter=2, rw=RW.Read, call_id=1, mem_addr=0, value=43)], None
    if name == "memory_value_not_byte":
        return [_start(m, s),
                m.MemoryOp(rw_counter=1, rw=RW.Write, call_id=1, mem_addr=0, value=256)], None
    if name == "stack_first_access_read":
        return [_start(m, s),
                m.StackOp(rw_counter=1, rw=RW.Read, call_id=1, stack_ptr=1023, value=5)], None
    if name == "stack_pointer_jump":
        return [_start(m, s),
                m.StackOp(rw_counter=1, rw=RW.Write, call_id=1, stack_ptr=1000, value=5),
                m.StackOp(rw_counter=2, rw=RW.Write, call_id=1, stack_ptr=1002, value=5)], None
    if name == "bad_mpt_root_chain":
        return [_start(m, s), _storage(m, s, 7, 0x1516, 789, 789, RW.Read)], (1, "root", 999)
    if name == "tx_receipt_id_jump":
        TR = s.TxReceiptFieldTag
        return [_start(m, s),
                m.TxReceiptOp(rw_counter=1, rw=RW.Read, tx_id=1, field_tag=TR.PostStateOrStatus, value=1),
                m.TxReceiptOp(rw_counter=2, rw=RW.Read, tx_id=3, field_tag=TR.PostStateOrStatus,
                              value=1)], None
    raise KeyError(name)


# vector -> whether tests/test_state_circuit.py expects every row to pass
VECTORS = {
    "state_ok": True, "mpt_updates_ok": True, "bad_is_write": False,
    "non_lexicographic_small": False, "non_lexicographic_wide": False,
    "non_lexicographic_equal": False, "bad_read_consistency": False,
    "memory_value_not_byte": False, "stack_first_access_read": False,
    "stack_pointer_jump": False, "bad_mpt_root_chain": False, "tx_receipt_id_jump": False,
}


def _rows(name):
    """The vector's rows and MPT rows, built by both packages (which must
    agree) and returned as the JAX package's."""
    out = []
    for m, s in ((jst, jschemas), (pst, pschemas)):
        ops, edit = _ops(name, m, s)
        rows = m.assign_state_circuit(ops)
        if edit is not None:
            rows[edit[0]][edit[1]] = edit[2]
        out.append((rows, m.mpt_table_from_ops(ops)))
    assert out[0] == out[1]
    return out[0]


# -- the three ways of running the check ---------------------------------------

def _jax_eager(rows, mpt_rows):
    ctx = JCtx(np, len(rows), "eager")
    cs = jst.check_state_rows(ctx, jst.StateRows(ctx, rows),
                              JTable.from_rows(ctx, jschemas.MPT_SCHEMA, mpt_rows))
    return np.asarray(cs.fail)


_JITTED = {}


def _jax_jit(rows, mpt_rows):
    cols, tree, meta = jst.pack_state_inputs(rows, mpt_rows)
    key = repr(meta)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(jst.make_state_check_fn(meta))
    return np.asarray(_JITTED[key](cols, tree)), (cols, tree, meta)


def _port_device(rows, mpt_rows):
    cols, tree, meta = pst.pack_state_inputs(rows, mpt_rows)
    fn = pst.make_state_check_fn(meta, device="cpu")
    return fn(*to_device((cols, tree), "cpu")).numpy()


def _port_eager(rows, mpt_rows):
    ctx = Ctx("cpu", len(rows), "eager")
    cs = pst.check_state_rows(ctx, pst.StateRows(ctx, rows),
                              Table.from_rows(ctx, pschemas.MPT_SCHEMA, mpt_rows))
    return cs.fail.numpy()


def _all_agree(rows, mpt_rows):
    want = _jax_eager(rows, mpt_rows)
    jitted, (jcols, jtree, jmeta) = _jax_jit(rows, mpt_rows)
    np.testing.assert_array_equal(jitted, want)
    np.testing.assert_array_equal(_port_device(rows, mpt_rows), want)
    np.testing.assert_array_equal(_port_eager(rows, mpt_rows), want)
    # the JAX package's packed trees through the port's upload
    on_jax_inputs = pst.make_state_check_fn(jmeta, device="cpu")(*to_device((jcols, jtree), "cpu"))
    np.testing.assert_array_equal(on_jax_inputs.numpy(), want)
    return want


@pytest.mark.parametrize("name", sorted(VECTORS))
def test_vector_matches_jax(name):
    rows, mpt_rows = _rows(name)
    fail = _all_agree(rows, mpt_rows)
    assert (not fail.any()) == VECTORS[name]
    if VECTORS[name]:
        pst.verify_state_rows(rows, mpt_rows)
    else:
        with pytest.raises(AssertionError):
            pst.verify_state_rows(rows, mpt_rows)


@pytest.mark.parametrize("corrupt", [None, 37])
@pytest.mark.parametrize("mix", ["memory_stack", "storage_account"])
def test_mix_matches_jax(mix, corrupt):
    build = getattr(workloads, f"build_state_{mix}")
    rows, mpt_rows = build(256, seed=3, corrupt_row=corrupt)
    fail = _all_agree(rows, mpt_rows)
    assert np.flatnonzero(fail).tolist() == ([] if corrupt is None else [corrupt])


def test_pack_state_inputs_matches_jax():
    rows, mpt_rows = workloads.build_state_storage_account(64, seed=1)
    pcols, ptree, pmeta = pst.pack_state_inputs(rows, mpt_rows)
    jcols, jtree, jmeta = jst.pack_state_inputs(rows, mpt_rows)
    assert pmeta == jmeta
    for k in jcols:
        np.testing.assert_array_equal(pcols[k].numpy(), jcols[k])
    np.testing.assert_array_equal(ptree["fps"], jtree["fps"])
    np.testing.assert_array_equal(ptree["order"], jtree["order"])
    up = to_device(jtree, "cpu")
    assert up["fps"].dtype == torch.int64
    np.testing.assert_array_equal(up["fps"].numpy().view(np.uint64), jtree["fps"])


def test_default_device_is_the_card_and_never_falls_back():
    _, _, meta = pst.pack_state_inputs(*workloads.build_state_memory_stack(8))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pst.make_state_check_fn(meta)


# -- K5: the ordering key ------------------------------------------------------

def _key_rows(n, seed, address_override=None):
    rng = np.random.RandomState(seed)

    def big(bits):
        return int.from_bytes(rng.bytes(40), "little") % (1 << bits)

    rows = []
    for i in range(n):
        r = {"rw_counter": big(32), "is_write": 1, "tag": int(rng.randint(1, 12)),
             "id": big(28), "address": big(160), "field_tag": big(16), "storage_key": big(256),
             "value": 0, "initial_value": 0, "root": 0, "lexicographic_ordering_selector": 1}
        if rows and rng.rand() < 0.6:          # share a prefix with the previous row
            prev = rows[-1]
            cut = rng.randint(1, 6)
            for k in ("tag", "id", "address", "field_tag", "storage_key")[:cut]:
                r[k] = prev[k]
        rows.append(r)
    edges = {"id": jst.MAX_ID, "address": (1 << 160) - 1, "storage_key": (1 << 256) - 1,
             "rw_counter": (1 << 32) - 1, "tag": 255, "field_tag": (1 << 16) - 1}
    for i, (k, v) in enumerate(edges.items()):
        rows[3 + i][k] = v
        rows[10 + i].update(edges)
    rows[20]["tag"] = int(jst.Tag.Start)
    if address_override is not None:
        rows[address_override]["address"] = 1 << 160
    return rows


def _jax_order_ok(rows):
    ctx = JCtx(np, len(rows), "eager")
    st = jst.StateRows(ctx, rows)
    cur = jst._order_limbs(ctx, st)
    prev = jst._order_limbs(ctx, st.shifted(-1))
    return np.asarray(JL.lt(np, prev, cur) | st.tag.eq_mask(int(jst.Tag.Start))), cur


def _port_rows(rows):
    ctx = Ctx("cpu", len(rows), "eager")
    return ctx, pst.StateRows(ctx, rows)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_order_plain_matches_jax(seed):
    rows = _key_rows(64, seed)
    want, jkey = _jax_order_ok(rows)
    ctx, st = _port_rows(rows)
    cols = (st.tag.limbs, st.id.limbs, st.address.limbs, st.field_tag.limbs,
            st.storage_key.lo.limbs, st.storage_key.hi.limbs, st.rw_counter.limbs)
    key = pst.order_key_plain(*cols)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey)[:, :19])
    assert not np.asarray(jkey)[:, 19:].any()
    np.testing.assert_array_equal(pst.state_order_lt_plain(*cols).numpy(), want)
    np.testing.assert_array_equal(pst.state_order_lt(*cols).numpy(), want)
    np.testing.assert_array_equal(pst.order_ok(ctx, st).numpy(), want)
    # the F-operation key agrees at the declared bounds too
    fkey = pst._order_limbs(ctx, st)
    np.testing.assert_array_equal(fkey.numpy(), np.asarray(jkey))


def _tile_edge_rows(n, seed):
    """Rows of random keys (a prefix shared with the previous row at
    random) with, at each of K5's tile boundaries 128 and 256 that n
    reaches: keys equal across the boundary, keys that differ only in the
    key's top limbs (17-18: tag's high bits) and keys that differ only in
    rw_counter; a Start row at row 0."""
    rows = _key_rows(max(n, 26), seed)[:n] if n >= 26 else []
    if n < 26:
        rng = np.random.RandomState(seed)
        for _ in range(n):
            rows.append({"rw_counter": int(rng.randint(0, 1 << 31)), "is_write": 1,
                         "tag": int(rng.randint(1, 12)), "id": int(rng.randint(0, 1 << 28)),
                         "address": int.from_bytes(rng.bytes(20), "little"),
                         "field_tag": int(rng.randint(0, 1 << 16)),
                         "storage_key": int.from_bytes(rng.bytes(32), "little"), "value": 0,
                         "initial_value": 0, "root": 0, "lexicographic_ordering_selector": 1})
    for b in (128, 256):
        if b + 2 < n:
            rows[b] = dict(rows[b - 1])                                   # equal keys
            rows[b + 1] = dict(rows[b], tag=rows[b]["tag"] ^ 0x30)         # top limbs only
            rows[b + 2] = dict(rows[b + 1], rw_counter=rows[b + 1]["rw_counter"] + 1)
        elif b < n:
            rows[b] = dict(rows[b - 1], rw_counter=rows[b - 1]["rw_counter"] + 1)
    if n:
        rows[0] = dict(rows[0], tag=int(jst.Tag.Start))
    assert all(r["rw_counter"] < 1 << 32 for r in rows)
    return rows


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 255, 256, 257])
def test_order_plain_matches_jax_at_tile_edges(n):
    """K5's plain version against the JAX ``_order_limbs`` of the rows and
    of ``shifted(-1)`` with ``L.lt`` (state.py:253, :304-311), tolerance 0,
    at row counts about K5's tiles of 128, with the tile-boundary cases of
    ``_tile_edge_rows``."""
    rows = _tile_edge_rows(n, n)
    want, jkey = _jax_order_ok(rows)
    _, st = _port_rows(rows)
    cols = (st.tag.limbs, st.id.limbs, st.address.limbs, st.field_tag.limbs,
            st.storage_key.lo.limbs, st.storage_key.hi.limbs, st.rw_counter.limbs)
    np.testing.assert_array_equal(pst.order_key_plain(*cols).numpy(), np.asarray(jkey)[:, :19])
    np.testing.assert_array_equal(pst.state_order_lt_plain(*cols).numpy(), want)
    np.testing.assert_array_equal(pst.state_order_lt(*cols).numpy(), want)
    assert bool(want[0])
    for b in (128, 256):
        if b + 2 < n:
            assert not want[b] and want[b + 1] and want[b + 2]
            key = np.asarray(jkey)
            assert (key[b + 1, :17] == key[b, :17]).all() and (key[b + 1, 17:] != key[b, 17:]).any()
            assert (key[b + 2, 2:] == key[b + 1, 2:]).all()
        elif b < n:
            assert want[b]


def test_widened_row_takes_the_f_op_branch(monkeypatch):
    rows = _key_rows(48, 7, address_override=5)
    want, _ = _jax_order_ok(rows)
    ctx, st = _port_rows(rows)
    assert st.address.bits == 161

    def no_kernel(*a, **k):
        raise AssertionError("K5 reached on a widened witness")

    monkeypatch.setattr(pst, "state_order_lt", no_kernel)
    np.testing.assert_array_equal(pst.order_ok(ctx, st).numpy(), want)
    # and the declared bounds do reach K5
    ctx, st = _port_rows(_key_rows(48, 7))
    with pytest.raises(AssertionError, match="K5 reached"):
        pst.order_ok(ctx, st)


# -- K6: the fingerprint search ------------------------------------------------

MPT_COLS = ("address", "proof_type", "storage_key", "root", "root_prev", "value", "value_prev")


def _mpt_rows(rng, n, shared_address=None):
    def big(bits):
        return int.from_bytes(rng.bytes(40), "little") % (1 << bits)

    rows = []
    for i in range(n):
        rows.append({"address": big(160), "proof_type": int(rng.randint(1, 7)),
                     "storage_key": big(256), "root": big(256), "root_prev": big(250),
                     "value": big(int(rng.choice([8, 128, 256]))), "value_prev": big(64)})
    if shared_address is not None:
        for i in shared_address:
            rows[i]["address"] = 0xABCDEF
    return rows


def _queries(rng, rows, batch):
    picks = rng.randint(0, len(rows), size=batch)
    qs = [dict(rows[i]) for i in picks]
    for i in range(0, batch, 5):                   # absent keys
        qs[i]["value"] = (qs[i]["value"] + 1) % (1 << 256)
    return qs


def _jax_lookup(rows, qs, subset, index=None, enabled=None, mode="eager"):
    ctx = JCtx(np, len(qs), mode)
    t = JTable.from_rows(ctx, jschemas.MPT_SCHEMA, rows)
    if index is not None:
        t._indexes[subset] = index
    cs = JCS(ctx)
    cs.hint_record, cs.hint_bits = [], []
    query = {}
    for c in subset:
        vals = [q[c] for q in qs]
        query[c] = (JWord.from_ints(ctx, vals) if jschemas.MPT_SCHEMA.columns[c].kind == "word"
                    else JF.from_ints(ctx, vals, jschemas.MPT_SCHEMA.columns[c].bits))
    t.lookup(cs, query, enabled=enabled)
    return t, cs


def _port_query(ctx, qs, subset):
    query = {}
    for c in subset:
        vals = [q[c] for q in qs]
        spec = pschemas.MPT_SCHEMA.columns[c]
        query[c] = Word.from_ints(ctx, vals) if spec.kind == "word" else F.from_ints(ctx, vals, spec.bits)
    return query


def _port_search(rows, qs, subset, index):
    """K6's plain version on the port's table and query, with the given
    (fps uint64, order, span) index."""
    ctx = Ctx("cpu", len(qs), "device")
    t = Table.from_rows(ctx, pschemas.MPT_SCHEMA, rows)
    query = _port_query(ctx, qs, subset)
    pairs = []
    for c in subset:
        pairs += engine._parts(t.schema.columns[c], t.data[c], query[c])
    coefs = engine.fingerprint_coefs(t.schema, t._part_names(subset), "cpu")
    fps = torch.from_numpy(np.ascontiguousarray(index[0]).view(np.int64))
    order = torch.from_numpy(np.asarray(index[1], dtype=np.int64))
    return engine.lookup_search_eq([q.limbs for _, q in pairs], [tv.limbs for tv, _ in pairs],
                                   coefs, fps, order, index[2], len(qs))


def _check_search(rows, qs, subset, index=None):
    jt, jcs = _jax_lookup(rows, qs, subset, index)
    index = jt._indexes[subset]
    first_row, ok_unsat, ok_unique, ok_covered = _port_search(rows, qs, subset, index)
    np.testing.assert_array_equal(first_row.numpy(), jcs.hint_record[0]["idx"])
    for got, (bad, _) in zip((ok_covered, ok_unsat, ok_unique), jcs.records[:3]):
        np.testing.assert_array_equal(got.numpy(), ~np.asarray(bad))
    return ok_unsat.numpy(), ok_unique.numpy(), ok_covered.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_plain_matches_jax_lookup(seed):
    rng = np.random.RandomState(100 + seed)
    rows = _mpt_rows(rng, 40, shared_address=[3, 9])
    qs = _queries(rng, rows, 32)
    unsat, _, covered = _check_search(rows, qs, MPT_COLS)
    assert covered.all() and not unsat.all() and unsat.any()
    # a partial key: two rows share the address, so those queries are ambiguous
    qs[1]["address"] = 0xABCDEF
    _, unique, _ = _check_search(rows, qs, ("address",))
    assert not unique[1]


def test_search_span_three_and_uncovered():
    rng = np.random.RandomState(7)
    rows = _mpt_rows(rng, 24, shared_address=[2, 11, 17])
    qs = _queries(rng, rows, 16)
    qs[0]["address"] = qs[1]["address"] = 0xABCDEF
    subset = ("address",)
    jt, _ = _jax_lookup(rows, qs, subset)
    fps, order, span = jt._indexes[subset]
    assert span == 3                                 # one fingerprint repeated three times
    in_run = np.array([q["address"] == 0xABCDEF for q in qs])
    _, unique, covered = _check_search(rows, qs, subset)
    assert covered.all() and (unique == ~in_run).all()
    # an index that scans fewer candidates than the run: ok_covered fails
    # on exactly the queries in that run
    _, _, covered = _check_search(rows, qs, subset, index=(fps, order, 2))
    np.testing.assert_array_equal(covered, ~in_run)


@pytest.mark.parametrize("with_enabled", [False, True])
def test_device_lookup_fail_bits_match_jax_jit_mode(with_enabled, monkeypatch):
    rng = np.random.RandomState(12)
    rows = _mpt_rows(rng, 30, shared_address=[1, 2])
    qs = _queries(rng, rows, 20)
    qs[4]["address"] = 0xABCDEF
    enabled = rng.rand(20) < 0.7 if with_enabled else None
    for subset in (MPT_COLS, ("address", "storage_key"), ("address",)):
        _, jcs = _jax_lookup(rows, qs, subset, enabled=enabled, mode="jit")

        def no_host_search(*a, **k):
            raise AssertionError("the host search was reached from a device context")

        monkeypatch.setattr(Table, "_eager_lookup", no_host_search)
        ctx = Ctx("cpu", len(qs), "device")
        t = Table.from_rows(ctx, pschemas.MPT_SCHEMA, rows)
        cs = ConstraintSystem(ctx)
        row = t.lookup(cs, _port_query(ctx, qs, subset),
                       enabled=None if enabled is None else torch.from_numpy(enabled))
        np.testing.assert_array_equal(cs.fail.numpy(), np.asarray(jcs.fail))
        assert row._idx.dtype == torch.int32
        monkeypatch.undo()


def test_device_index_build_matches_the_host_index():
    rng = np.random.RandomState(4)
    rows = _mpt_rows(rng, 50, shared_address=[5, 6, 7])
    host = Table.from_rows(Ctx("cpu", 1, "eager"), pschemas.MPT_SCHEMA, rows)
    dev = Table.from_rows(Ctx("cpu", 1, "device"), pschemas.MPT_SCHEMA, rows)
    for subset in (MPT_COLS, ("address",)):
        h_fps, h_order, h_span = host.index_for(subset)
        d_fps, d_order, d_span = dev.index_for(subset)
        np.testing.assert_array_equal(d_fps.numpy().view(np.uint64), h_fps)
        row_fps = host._fingerprint(subset, host.data)
        np.testing.assert_array_equal(row_fps[d_order.numpy()], h_fps)
        assert d_span == engine.MAX_CANDIDATES and h_span == (3 if subset == ("address",) else 1)


def test_host_search_asserts_an_eager_context():
    rows = _mpt_rows(np.random.RandomState(0), 4)
    ctx = Ctx("cpu", 2, "device")
    t = Table.from_rows(ctx, pschemas.MPT_SCHEMA, rows)
    with pytest.raises(AssertionError, match="host lookup search"):
        t._eager_lookup(ConstraintSystem(ctx), _port_query(ctx, rows[:2], ("address",)),
                        ("address",), None)


# -- the DSL bounds the check relies on ----------------------------------------

@pytest.mark.parametrize("mode", ["eager", "device"])
def test_value_bounds_match_jax(mode):
    rng = np.random.RandomState(9)
    vals = [int(v) for v in rng.randint(0, 200, size=32)]
    vals[:3] = [0, 1, 255]
    flags = rng.rand(32) < 0.5
    jctx = JCtx(np, 32, "eager" if mode == "eager" else "jit")
    pctx = Ctx("cpu", 32, mode)
    jx, px = JF.from_ints(jctx, vals, 8), F.from_ints(pctx, vals, 8)
    for lo, hi in ((1, 12), (0, 25), (3, 200)):
        np.testing.assert_array_equal(px.lt_mask(lo).numpy(), np.asarray(jx.lt_mask(lo)))
        np.testing.assert_array_equal(F.const(pctx, hi).lt_mask(px).numpy(),
                                      np.asarray(JF.const(jctx, hi).lt_mask(jx)))
    jflag, pflag = JF.from_bool(jctx, flags), F.from_bool(pctx, torch.from_numpy(flags))
    for j, p in ((1 - jflag, 1 - pflag),
                 (jflag * 4 + (1 - jflag) * 2, pflag * 4 + (1 - pflag) * 2),
                 (jflag * 4 + (1 - jflag) * jx, pflag * 4 + (1 - pflag) * px)):
        assert p.bits == j.bits and p.width == j.width
        np.testing.assert_array_equal(p.limbs.numpy(), np.asarray(j.limbs))
