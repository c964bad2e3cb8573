"""The hinted replay lookup (K4, zkevm_specs_tpu_torch.tables.engine) against
the JAX package's replay branch of Table.lookup, both fed the same table
arrays and hint indexes (the port's through inputs_from_numpy), tolerance 0.
The JAX branch runs under numpy here, as its own CPU tests run it."""
import numpy as np
import pytest
import torch

from zkevm_specs_tpu.dsl.cs import ConstraintSystem as JCS
from zkevm_specs_tpu.dsl.value import Ctx as JCtx
from zkevm_specs_tpu.dsl.value import F as JF
from zkevm_specs_tpu.runtime import jit as jjit
from zkevm_specs_tpu.tables.container import Tables as JTables
from zkevm_specs_tpu.tables.schemas import RW, Target
from zkevm_specs_tpu_torch.dsl.cs import ConstraintSystem
from zkevm_specs_tpu_torch.dsl.value import Ctx, F
from zkevm_specs_tpu_torch.ops import limbs as L
from zkevm_specs_tpu_torch.runtime import jit as pjit
from zkevm_specs_tpu_torch.runtime.convert import inputs_from_numpy
from zkevm_specs_tpu_torch.tables import engine
from zkevm_specs_tpu_torch.tables.container import Tables
from zkevm_specs_tpu_torch.witness.typing import RWDictionary

torch.set_num_threads(1)

B = 24
WRONG_LANE = 7


def _rw_rows():
    rng = np.random.RandomState(11)
    rw = RWDictionary(1)
    for _ in range(B):
        a = int.from_bytes(rng.bytes(32), "little")
        b = int.from_bytes(rng.bytes(32), "little")
        rw.stack_read(1, 1022, a).stack_read(1, 1023, b).stack_write(1, 1023, (a + b) % 2**256)
    return rw.rws


def _query(F_, ctx, rw_counters):
    """The stack_pop query of a group: per-lane rw_counter, constant
    rw/tag/call id/stack pointer."""
    return dict(
        rw_counter=F_.from_ints(ctx, rw_counters, 32),
        rw=F_.const(ctx, int(RW.Read)),
        tag=F_.const(ctx, int(Target.Stack)),
        id=F_.const(ctx, 1),
        address=F_.const(ctx, 1022),
    )


@pytest.fixture(scope="module")
def replayed():
    rows = _rw_rows()
    jt = JTables(rw_table=rows)
    rw_counters = [1 + 3 * i for i in range(B)]

    # the JAX eager lookup resolves each lane's row: the hint stream
    ectx = JCtx(np, B, "eager")
    ecs = JCS(ectx)
    ecs.hint_record, ecs.hint_bits = [], []
    jt.with_ctx(ectx).rw_lookup(ecs, **_query(JF, ectx, rw_counters))
    assert not np.asarray(ecs.fail).any()
    idx = ecs.hint_record[0]["idx"].copy()
    idx[WRONG_LANE] = idx[WRONG_LANE] + 1      # points at the lane's next row
    hints = [{"idx": idx}]
    tree = jjit.tables_to_pytree(jt)

    # the JAX replay branch
    rctx = JCtx(np, B, "jit")
    rcs = JCS(rctx)
    rcs.hint_replay, rcs.hint_bits = hints, ["lookup_idx"]
    jtables = jjit.tables_from_pytree(rctx, tree, jjit.tables_meta(jt))
    jrow = jtables.rw_lookup(rcs, **_query(JF, rctx, rw_counters))

    # the port's replay on the same arrays
    _, _, ptree, phints = inputs_from_numpy({}, {}, tree, hints, "cpu")
    pctx = Ctx("cpu", B, "replay")
    pcs = ConstraintSystem(pctx)
    pcs.hint_replay, pcs.hint_bits = phints, ["lookup_idx"]
    ptables = pjit.tables_from_pytree(pctx, ptree, pjit.tables_meta(Tables(rw_table=rows)))
    launches = L.LAUNCHES["lookup_gather_eq"]
    prow = ptables.rw_lookup(pcs, **_query(F, pctx, rw_counters))
    return dict(jfail=np.asarray(rcs.fail), pfail=pcs.fail.numpy(), jrow=jrow, prow=prow,
                launches=launches)


def test_fail_bits_match_jax_and_only_the_wrong_hint_fails(replayed):
    np.testing.assert_array_equal(replayed["pfail"], replayed["jfail"])
    assert np.flatnonzero(replayed["pfail"]).tolist() == [WRONG_LANE]


@pytest.mark.parametrize("col", ["rw_counter", "address", "id", "value", "value_prev", "aux0"])
def test_gathered_columns_match_jax(replayed, col):
    jv, pv = getattr(replayed["jrow"], col), getattr(replayed["prow"], col)
    parts = [("lo", "lo"), ("hi", "hi")] if hasattr(jv, "lo") else [(None, None)]
    for part, _ in parts:
        j = jv if part is None else getattr(jv, part)
        p = pv if part is None else getattr(pv, part)
        assert p.bits == j.bits
        np.testing.assert_array_equal(
            p.limbs.numpy(), np.broadcast_to(np.asarray(j.limbs), p.limbs.shape).astype(np.int64))


def test_cpu_replay_launches_no_kernel(replayed):
    assert L.LAUNCHES["lookup_gather_eq"] == replayed["launches"]


def test_plain_lookup_enabled_mask_and_clamp():
    table = [torch.arange(20, dtype=torch.int64).reshape(10, 2)]
    query = [torch.tensor([[0, 1], [2, 3], [9, 9], [18, 19]], dtype=torch.int64)]
    idx = torch.tensor([0, 1, 2, 42], dtype=torch.int32)      # lane 3 is clamped to row 9
    ok, (g,) = engine.lookup_gather_eq(table, query, idx)
    assert ok.tolist() == [True, True, False, True]
    assert g[3].tolist() == [18, 19]
    enabled = torch.tensor([True, True, False, True])
    ok, _ = engine.lookup_gather_eq(table, query, idx, enabled)
    assert ok.tolist() == [True, True, True, True]
    ok, (g,) = engine.lookup_gather_eq(table, [None], idx, want_ok=False)
    assert ok is None and g[:, 0].tolist() == [0, 2, 4, 18]


# -- K4 at the edges of its tiles (tests/limb_tile_cases.py) -------------------------

import jax.numpy as jnp  # noqa: E402

from zkevm_specs_tpu.tables.engine import Col as JCol  # noqa: E402
from zkevm_specs_tpu.tables.engine import Schema as JSchema  # noqa: E402
from zkevm_specs_tpu.tables.engine import Table as JTable  # noqa: E402

from limb_tile_cases import GATHER_CASES, gather_case  # noqa: E402


def _jax_replay(table, query, idx, enabled):
    """The JAX package's hint-replay branch of Table.lookup on jax.numpy
    (its gather as XLA resolves an index), one "f" column a part: the
    per-lane ok and every part's gathered limbs."""
    batch = idx.shape[0]
    ctx = JCtx(jnp, batch, "jit")
    names = [f"c{p}" for p in range(len(table))]
    row_ctx = JCtx(jnp, table[0].shape[0], "jit")
    data = {c: JF(row_ctx, jnp.asarray(t.numpy().astype(np.uint32)), 254)
            for c, t in zip(names, table)}
    jt = JTable(ctx, JSchema("tiles", {c: JCol("f") for c in names}), data, table[0].shape[0])
    cs = JCS(ctx)
    cs.hint_replay, cs.hint_bits = [{"idx": jnp.asarray(idx.numpy())}], ["lookup_idx"]
    q = {c: None if v is None else JF(ctx, jnp.asarray(v.numpy().astype(np.uint32)), 254)
         for c, v in zip(names, query)}
    row = jt.lookup(cs, q, None if enabled is None else jnp.asarray(enabled.numpy()))
    gathered = [np.broadcast_to(np.asarray(getattr(row, c).limbs), (batch, t.shape[1]))
                for c, t in zip(names, table)]
    return ~np.asarray(cs.fail), gathered


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_tile_case_matches_jax(case):
    table, query, idx, enabled = gather_case(case)
    ok, gathered = engine.lookup_gather_eq(table, query, idx, enabled)
    want_ok, want_gathered = _jax_replay(table, query, idx, enabled)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    for g, w in zip(gathered, want_gathered):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    if all(q is None for q in query):
        assert bool(ok.all())


def test_hint_rows_count_negative_indexes_from_the_end_once():
    """XLA's gather (jnp indexing) wraps a negative index once, then clamps."""
    idx = torch.tensor([-7, -6, -5, -1, 0, 4, 5, 9], dtype=torch.int32)
    want = np.asarray(jnp.arange(5)[jnp.asarray(idx.numpy())])
    assert engine.hint_rows(idx, 5).tolist() == want.tolist() == [0, 0, 0, 4, 0, 4, 4, 4]
