"""The port's logUp lookup argument (zkevm_specs_tpu_torch.tables.logup,
zkevm_specs_tpu_torch.parallel.logup_shard, ops/fr.py's inverse) against
the JAX package's, on the CPU, tolerance 0.

The JAX side runs its numpy (spec-mode) path: ``fr.pow_const``/``fr.inv``,
``batch_inverse``/``logup_partial_sum(np, ...)`` and, for a block,
``block_lookup_log`` with a numpy mirror of ``sharded_logup_check`` built
only from JAX functions (its padding through ``_pad_to``, the table
fingerprint through ``fr.mul``/``fr.add``, both partial sums, and
``fr.reduce_wide(L.carry_propagate(..., 17))``).  Each JAX sum is kept to
about 1000 elements (the numpy path takes about 4 ms an element).  On the
CPU the port's kernels K12 and K13 (and K1, K3, K4) run their plain
versions.  One test, marked ``slow``, holds the port against the JAX
package's jitted ``sharded_logup_check`` on a one-device mesh (about 95 s
of XLA compile on a CPU).

Blocks: the unsigned 2 x 6 block of ``tests/test_torch_block.py`` and the
arithmetic block at 4 txs x 1 cycle, traced by both packages.  Last, the
import rule: no source of the port imports JAX or the JAX package."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_specs_tpu.dsl.value import Ctx as JCtx
from zkevm_specs_tpu.dsl.value import F as JF
from zkevm_specs_tpu.ops import fr as JFR
from zkevm_specs_tpu.ops import limbs as JL
from zkevm_specs_tpu.parallel import logup_shard as JLS
from zkevm_specs_tpu.tables import logup as JLU
from zkevm_specs_tpu.witness import tracer as JT
from zkevm_specs_tpu.witness import typing as JY
from zkevm_specs_tpu_torch.dsl.cs import LaneSplit
from zkevm_specs_tpu_torch.dsl.value import Ctx
from zkevm_specs_tpu_torch.ops import fr
from zkevm_specs_tpu_torch.ops import limbs as L
from zkevm_specs_tpu_torch.parallel import logup_shard as LS
from zkevm_specs_tpu_torch.runtime import block as block_runtime
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier
from zkevm_specs_tpu_torch.tables import logup
from zkevm_specs_tpu_torch.witness import tracer as PT
from zkevm_specs_tpu_torch.witness import typing as PY

from test_torch_block import _arith_txs
from test_torch_tracer import txs_of

torch.set_num_threads(1)

P = fr.P
ALPHA = 0xDEADBEEFCAFE1234567890    # tests/test_logup.py's
BLOCK_ALPHA = LS.ALPHA              # the JAX verify_block_lookups_logup default


def _rng_values(seed, n, zero_at=None):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P or 1 for _ in range(n)]
    if zero_at is not None:
        vals[{"first": 0, "middle": n // 2, "last": n - 1}[zero_at]] = 0
    return vals


def _jax_limbs(vals, n=16):
    return np.asarray(JL.ints_to_limbs([v % P for v in vals], n))


def _port(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int64))


def _same(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).astype(np.int64))


# -- K12: the field inverse, and pow_const ---------------------------------------

@pytest.mark.parametrize("value", [0, 1, P - 1, "random"])
def test_inv_one_lane_matches_jax_and_pow(value):
    v = _rng_values(1, 1)[0] if value == "random" else value
    a = _jax_limbs([v])
    got = fr.inv(_port(a))
    assert got.shape == (1, 16)
    _same(got, JFR.inv(np, a))
    assert fr.to_ints(got) == [pow(v, P - 2, P)]


@pytest.mark.parametrize("width", [16, 4, 1])
def test_inv_batch_matches_jax_and_pow(width):
    vals = [v % (1 << (16 * width)) for v in [0, 1, 2, P - 1, P - 2] + _rng_values(width, 11)]
    a = _jax_limbs(vals, width)
    got = fr.inv(_port(a))
    _same(got, JFR.inv(np, np.asarray(JL.pad_limbs(np, a, 16))))
    assert fr.to_ints(got) == [pow(v, P - 2, P) for v in vals]


@pytest.mark.parametrize("e", [0, 1, 2, 5, 0xFFFF, (1 << 64) + 3])
def test_pow_const_matches_jax(e):
    vals = [0, 1, P - 1] + _rng_values(e % 7, 5)
    a = _jax_limbs(vals)
    got = fr.pow_const(_port(a), e)
    _same(got, JFR.pow_const(np, a, e))
    assert fr.to_ints(got) == [pow(v, e, P) for v in vals]


def test_inv_checks_its_operand():
    with pytest.raises(ValueError):
        fr.inv(torch.zeros((2, 17), dtype=torch.int64))
    with pytest.raises(TypeError):
        fr.inv(torch.zeros((2, 16), dtype=torch.int32))


# -- K13: batch inverse and partial sum -------------------------------------------

def test_batch_inverse_on_jax_vectors():
    vals = [3, 7, 12345678901234567890, P - 2, 1]        # tests/test_logup.py:25
    arr = _jax_limbs(vals)
    got = logup.batch_inverse(_port(arr))
    _same(got, JLU.batch_inverse(np, arr))
    assert fr.to_ints(got) == [pow(v, P - 2, P) for v in vals]


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64])
def test_batch_inverse_matches_jax(n):
    vals = _rng_values(n, n)
    arr = _jax_limbs(vals)
    got = logup.batch_inverse(_port(arr))
    _same(got, JLU.batch_inverse(np, arr))
    assert fr.to_ints(got) == [pow(v, P - 2, P) for v in vals]


@pytest.mark.parametrize("zero_at", ["first", "middle", "last"])
def test_batch_inverse_zero_rule_matches_jax(zero_at):
    """One zero element zeroes the total and so every output, on both
    sides (logup.py:63-84)."""
    arr = _jax_limbs(_rng_values(17, 17, zero_at))
    got = logup.batch_inverse(_port(arr))
    _same(got, JLU.batch_inverse(np, arr))
    assert not got.any()


@pytest.mark.parametrize("with_m", [False, True])
@pytest.mark.parametrize("n", [1, 5, 33])
def test_logup_partial_sum_matches_jax(n, with_m):
    fps = _jax_limbs(_rng_values(n + 100, n))
    alpha = np.asarray(JL.int_to_limbs(ALPHA % P, 16))
    m = (np.asarray(JF.from_ints(JCtx(np, n), list(np.random.default_rng(n).integers(0, 9, n)),
                                 64).widen(16).limbs) if with_m else None)
    got = logup.logup_partial_sum(_port(fps), _port(alpha), None if m is None else _port(m))
    assert got.shape == (16,)
    _same(got, JLU.logup_partial_sum(np, fps, alpha, m))


def test_logup_partial_sum_is_zero_at_a_fingerprint():
    fps = _jax_limbs(_rng_values(9, 9))
    at = _port(fps[4])
    assert not logup.logup_partial_sum(_port(fps), at).any()
    _same(logup.logup_partial_sum(_port(fps), at),
          JLU.logup_partial_sum(np, fps, np.asarray(fps[4])))


def test_workspace_words_cover_the_levels():
    assert logup.logup_workspace_words(1) == 8
    # one tile: 17 elements in Montgomery form, 8 words each
    assert logup.logup_workspace_words(17) == 8 * 17
    # two levels: the elements, then their tiles' products
    tile = logup.LOGUP_THREADS * logup.LOGUP_RUN
    assert logup.logup_workspace_words(tile + 1) == 8 * (tile + 1 + 2)


# -- tests/test_logup.py's verdicts, through the port -----------------------------

def _fps(vals):
    return _port(_jax_limbs(vals))


def test_logup_accepts_valid_multiset():
    ctx = Ctx("cpu", 1)
    table, queries = _fps([10, 20, 30, 40]), _fps([20, 20, 40, 10, 10, 10])
    mult = logup.compute_multiplicities(queries, table, ctx)
    _same(mult, JLU.compute_multiplicities(queries.numpy(), table.numpy(), JCtx(np, 1)))
    assert logup.multiset_check(ctx, queries, table, mult, ALPHA)


def test_logup_rejects_missing_entry():
    ctx = Ctx("cpu", 1)
    table, queries = _fps([10, 20, 30, 40]), _fps([20, 99])
    mult = logup.compute_multiplicities(queries, table, ctx)
    assert not logup.multiset_check(ctx, queries, table, mult, ALPHA)


def test_logup_rejects_wrong_multiplicities():
    ctx = Ctx("cpu", 1)
    table, queries = _fps([10, 20, 30, 40]), _fps([20, 20])
    mult = L.ints_to_limbs([0, 1, 0, 0], 4)
    assert not logup.multiset_check(ctx, queries, table, mult, ALPHA)


def test_logup_shard_partials_compose():
    queries = _fps([11, 22, 33, 44, 55, 66])
    alpha = L.int_to_limbs(ALPHA % P, 16)
    full = logup.logup_partial_sum(queries, alpha)
    a, b = logup.logup_partial_sum(queries[:3], alpha), logup.logup_partial_sum(queries[3:], alpha)
    assert torch.equal(full, fr.add(a[None], b[None])[0])
    _same(full, JLU.logup_partial_sum(np, queries.numpy().astype(np.uint32),
                                      alpha.numpy().astype(np.uint32)))


# -- the blocks ----------------------------------------------------------------

BLOCKS = {"clean": lambda Y: txs_of(Y), "arith": _arith_txs}
_CACHE = {}


def _witnesses(kind):
    """(JAX witness, port witness) of a block, traced alike; the arithmetic
    block signed, as ``workloads.build_arith_block`` traces it (its txs
    share one caller)."""
    return tuple(T.trace_block(Y.Block(base_fee=int(1e9)), BLOCKS[kind](Y), sign=kind == "arith")
                 for T, Y in ((JT, JY), (PT, PY)))


def _block(kind):
    if kind not in _CACHE:
        jw, pw = _witnesses(kind)
        jtables, jper = JLS.block_lookup_log(jw)
        _CACHE[kind] = (jw, pw, jtables, jper, CompiledBlockVerifier(pw, device="cpu"))
    return _CACHE[kind]


def _multiset(entries):
    return sorted((int(i), bool(e)) for idx, en in entries for i, e in zip(idx, en))


def _jax_inputs(jtables, jper, name):
    """The JAX package's inputs of one family (verify_block_lookups_logup,
    logup_shard.py:223-240): query side from the logged rows, raw parts,
    bincount multiplicities."""
    table = getattr(jtables, name)
    q_fps, en = JLS.query_fingerprints_from_log(table.schema, jper[name])
    idx = np.concatenate([i for i, _, _ in jper[name]])
    counts = np.bincount(idx[en.astype(bool)], minlength=table.n_rows)
    return q_fps, en, JLS.table_parts(table), counts


def _jax_mirror(q_fps, en, parts, counts, alpha):
    """JAX ``sharded_logup_check`` on one device in numpy, from JAX
    functions only: (lhs, rhs, verdict)."""
    n_rows = parts[0][1].shape[0]
    mult = np.asarray(JF.from_ints(JCtx(np, n_rows, "eager"), [int(c) for c in counts], 64)
                      .widen(16).limbs)
    q = JLS._pad_to(q_fps, q_fps.shape[0]).copy()
    q[q.sum(axis=1) == 0, 0] = 1
    en_limbs = np.zeros((q.shape[0], 16), dtype=np.uint32)
    en_limbs[:, 0] = en
    alpha_l = np.asarray(JL.int_to_limbs(alpha % P, 16))
    t_fps = None
    for w, col in parts:
        col = JLS._pad_to(np.asarray(col), n_rows)
        term = JFR.mul(np, col, np.broadcast_to(JL.int_to_limbs(w % P, 16), col.shape))
        t_fps = term if t_fps is None else JFR.add(np, t_fps, term)
    lhs = JLU.logup_partial_sum(np, q, alpha_l, en_limbs)
    rhs = JLU.logup_partial_sum(np, t_fps, alpha_l, mult)
    lhs_c = JFR.reduce_wide(np, JL.carry_propagate(np, lhs[None, :], 17))
    rhs_c = JFR.reduce_wide(np, JL.carry_propagate(np, rhs[None, :], 17))
    return lhs_c, rhs_c, bool(np.all(lhs_c == rhs_c))


def _port_sums(inp, parts=None, counts=None, q_fps=None):
    mult = inp["multiplicities"] if counts is None else LS.multiplicities(counts, "cpu")
    lhs, rhs = LS.logup_sums(inp["query_fps"] if q_fps is None else q_fps, inp["query_en"],
                             parts or inp["parts"], mult, BLOCK_ALPHA, "cpu")
    return lhs, rhs, bool(L.eq(lhs, rhs).item())


def _assert_sums_equal(port, jax):
    _same(port[0], jax[0])
    _same(port[1], jax[1])
    assert port[2] == jax[2]


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_lookup_log_matches_jax(kind):
    """Per table, the same multiset of (row index, enabled) as the JAX
    ``block_lookup_log``: from the port's ``block_lookup_log`` and from the
    block verifier's partition pass (no second eager pass)."""
    _, pw, jtables, jper, bv = _block(kind)
    ptables, pper = LS.block_lookup_log(pw)
    assert sorted(pper) == sorted(jper) == sorted(bv.lookup_log)
    for name, entries in jper.items():
        want = _multiset((idx, en) for idx, en, _ in entries)
        assert _multiset(pper[name]) == want, name
        assert _multiset(bv.lookup_log[name]) == want, name
        assert getattr(ptables, name).n_rows == getattr(jtables, name).n_rows


def test_lane_split_passes_log_their_lookups(monkeypatch):
    """A pass that a LaneSplit cuts short keeps the lookups it logged, and
    its sub-passes log theirs again (the JAX log is one list shared by every
    ConstraintSystem, logup_shard.py:191-202): the arithmetic block's
    partition pass logs such entries, and the whole log holds as many
    entries as the JAX one."""
    _, pw, _, jper, _ = _block("arith")
    cut_short = []

    class Recording(block_runtime.ConstraintSystem):
        @property
        def lookup_log(self):
            return self.__dict__.get("_log")

        @lookup_log.setter
        def lookup_log(self, log):
            self.__dict__["_log"], self.__dict__["_start"] = log, len(log or ())

        def branch(self, cond_mask):
            try:
                return super().branch(cond_mask)
            except LaneSplit:
                cut_short.append(len(self.lookup_log) - self._start)
                raise

    monkeypatch.setattr(block_runtime, "ConstraintSystem", Recording)
    bv = CompiledBlockVerifier(pw, device="cpu")
    assert cut_short and sum(cut_short) > 0
    total = sum(len(i) for v in bv.lookup_log.values() for i, _ in v)
    assert total == sum(len(i) for v in jper.values() for i, _, _ in v)


@pytest.mark.parametrize("name", ["rw", "bytecode", "block", "tx"])
def test_query_fingerprints_match_jax(name):
    """The query side from the table's rows at the logged indexes equals the
    JAX one, fingerprinted from the logged rows; the table side's
    fingerprints and parts equal the JAX ones."""
    _, _, jtables, jper, bv = _block("clean")
    q_fps, en = LS.query_fingerprints_from_log(getattr(bv.tables, name), bv.lookup_log[name])
    j_fps, j_en = JLS.query_fingerprints_from_log(getattr(jtables, name).schema, jper[name])
    _same(q_fps, j_fps)
    np.testing.assert_array_equal(en.numpy(), j_en)
    _same(LS.table_fingerprints(getattr(bv.tables, name)),
          JLS.table_fingerprints(getattr(jtables, name)))
    parts, j_parts = LS.table_parts(getattr(bv.tables, name)), JLS.table_parts(getattr(jtables, name))
    assert [w for w, _ in parts] == [w for w, _ in j_parts]
    for (_, t), (_, j) in zip(parts, j_parts):
        _same(L.pad_limbs(t, 16), j)


# the families held against the JAX mirror on each block (the arithmetic
# block's bytecode family, 3116 queries, is past the numpy path's budget)
MIRRORED = {"clean": ("rw", "bytecode", "block", "tx"), "arith": ("rw", "exp", "block", "tx")}


@pytest.mark.parametrize("kind,name", [(k, n) for k in sorted(MIRRORED) for n in MIRRORED[k]])
def test_block_logup_matches_jax_mirror(kind, name):
    """Clean blocks: the port's lhs and rhs limb for limb and its verdict
    (true) equal the JAX numpy mirror's."""
    _, _, jtables, jper, bv = _block(kind)
    inp = LS.family_inputs(getattr(bv.tables, name), bv.lookup_log[name], "cpu")
    want = _jax_mirror(*_jax_inputs(jtables, jper, name), BLOCK_ALPHA)
    _assert_sums_equal(_port_sums(inp), want)
    assert want[2] is True


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_verify_block_lookups_logup(kind):
    """Every family the block looks up holds, through the witness entry
    point (a second eager pass) and through the block verifier's
    partition-pass log alike."""
    _, pw, _, jper, bv = _block(kind)
    names = tuple(n for n in LS.LOGUP_TABLES if n in jper)
    assert bv.verify_lookups() == {n: True for n in names}
    assert LS.verify_block_lookups_logup(pw, device="cpu") == {"rw": True}


def test_logup_sums_reduce_both_sides_in_one_entry_call(monkeypatch):
    """Each family's check normalises and reduces its two sides in one call
    of K2's normalise-and-reduce entry (``fr.normalize_reduce`` on ``[2,
    16]`` at keep 17): one call a family, no K2 product and no separate
    ``carry_propagate`` on the logUp path; the verdicts are unchanged."""
    _, _, _, jper, bv = _block("clean")
    calls = []
    entry = fr.normalize_reduce

    def spy(x, keep):
        calls.append((tuple(x.shape), keep))
        return entry(x, keep)

    def no_product(*a):
        raise AssertionError("a K2 product on the logUp path")

    monkeypatch.setattr(fr, "normalize_reduce", spy)
    monkeypatch.setattr(L, "limb_mul", no_product)
    monkeypatch.setattr(L, "carry_propagate", no_product)
    names = tuple(n for n in LS.LOGUP_TABLES if n in jper)
    assert bv.verify_lookups() == {n: True for n in names}
    assert calls == [((2, 16), 17)] * len(names)


def _rw_negative_inputs():
    _, _, jtables, jper, bv = _block("clean")
    inp = LS.family_inputs(bv.tables.rw, bv.lookup_log["rw"], "cpu")
    j = _jax_inputs(jtables, jper, "rw")
    busy = np.flatnonzero(inp["counts"])
    return bv, inp, j, int(busy[len(busy) // 2])


def test_block_logup_overcounted_multiplicity_matches_jax():
    bv, inp, (q, en, parts, counts), row = _rw_negative_inputs()
    np.testing.assert_array_equal(inp["counts"], counts)
    over = counts.copy()
    over[row] += 1
    want = _jax_mirror(q, en, parts, over, BLOCK_ALPHA)
    _assert_sums_equal(_port_sums(inp, counts=over), want)
    assert want[2] is False


def test_block_logup_corrupt_table_matches_jax():
    """A corrupted table value moves rhs and not lhs: the identity fails, on
    both sides, with the same limbs; the query side, fingerprinted before
    the tampering, is untouched."""
    bv, inp, (q, en, parts, counts), row = _rw_negative_inputs()
    k = LS.part_names(bv.tables.rw.schema).index(("value", "lo"))

    def corrupt(name, parts):
        parts[k][1][row, 0] ^= 1

    j_parts = [(w, np.asarray(JL.pad_limbs(np, c, 16)).copy()) for w, c in parts]
    corrupt("rw", j_parts)
    want = _jax_mirror(q, en, j_parts, counts, BLOCK_ALPHA)
    p_parts = [(w, t.clone()) for w, t in inp["parts"]]
    corrupt("rw", p_parts)
    got = _port_sums(inp, parts=p_parts)
    _assert_sums_equal(got, want)
    assert want[2] is False
    clean = _jax_mirror(q, en, parts, counts, BLOCK_ALPHA)
    _same(got[0], clean[0])
    assert not np.array_equal(want[1], clean[1])
    assert LS.verify_block_lookups_logup(bv.witness, device="cpu", corrupt_table=corrupt) == \
        {"rw": False}
    assert bv.verify_lookups(tables_names=("rw",)) == {"rw": True}


def test_block_logup_zero_fingerprint_query_matches_jax():
    """A query fingerprint of 0 becomes 1 on both sides (logup_shard.py:
    113-114), whichever the row: the verdicts and limbs agree."""
    bv, inp, (q, en, parts, counts), _ = _rw_negative_inputs()
    q = q.copy()
    q[3] = 0
    p_q = inp["query_fps"].clone()
    p_q[3] = 0
    want = _jax_mirror(q, en, parts, counts, BLOCK_ALPHA)
    _assert_sums_equal(_port_sums(inp, q_fps=p_q), want)
    assert want[2] is False


def test_zero_fingerprint_rule_is_asymmetric():
    """At world size 1 the rule rewrites the query side only: a table row
    whose fingerprint is 0, queried once, fails the identity in both
    packages, although the queries are a sub-multiset of the table."""
    table = _jax_limbs([0, 10, 20])
    q, en, counts = _jax_limbs([0, 20]), np.array([True, True]), np.array([1, 0, 1])
    want = _jax_mirror(q, en, [(1, table)], counts, BLOCK_ALPHA)
    got = LS.logup_sums(_port(q), torch.from_numpy(en), [(1, _port(table))],
                        LS.multiplicities(counts, "cpu"), BLOCK_ALPHA, "cpu")
    _same(got[0], want[0])
    _same(got[1], want[1])
    assert want[2] is False
    # without the zero row the same multiset holds
    assert LS.sharded_logup_check(_port(q[1:]), torch.from_numpy(en[1:]), [(1, _port(table))],
                                  LS.multiplicities(np.array([0, 0, 1]), "cpu"), BLOCK_ALPHA,
                                  "cpu") is True


def test_no_fallback_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pw, _, _, bv = _block("clean")
    inp = LS.family_inputs(bv.tables.rw, bv.lookup_log["rw"], "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LS.sharded_logup_check(inp["query_fps"], inp["query_en"], inp["parts"],
                               inp["multiplicities"], BLOCK_ALPHA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LS.verify_block_lookups_logup(pw)


@pytest.mark.slow
def test_block_logup_matches_jax_jit_one_device_mesh():
    """The JAX package's jitted sharded_logup_check on a one-device mesh
    (about 95 s of XLA compile on a CPU) against the port, on the 2 x 6
    block's rw family, clean and with an over-counted multiplicity."""
    from zkevm_specs_tpu.parallel.shard import make_mesh

    bv, inp, (q, en, parts, counts), row = _rw_negative_inputs()
    mesh = make_mesh(1)
    over = counts.copy()
    over[row] += 1
    for c in (counts, over):
        mult = np.asarray(JF.from_ints(JCtx(np, len(c), "eager"), [int(x) for x in c], 64)
                          .widen(16).limbs)
        want = JLS.sharded_logup_check(q, en, parts, mult, mesh, BLOCK_ALPHA)
        assert want is (c is counts)
        assert _port_sums(inp, counts=c)[2] is want


# -- the import rule --------------------------------------------------------------

_ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted(str(p.relative_to(_ROOT))
                      for p in (_ROOT / "zkevm_specs_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py", "profile_replay.py"]


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    """No module of the port, nor its chip scripts, imports ``jax`` or
    anything of ``zkevm_specs_tpu`` (relative imports stay in the port)."""
    tree = ast.parse((_ROOT / path).read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module]
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "zkevm_specs_tpu")]
    assert not bad, f"{path} imports {bad}"
