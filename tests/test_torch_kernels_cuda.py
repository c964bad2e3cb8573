"""The CUDA kernels against their plain PyTorch versions on the card,
over every mode and operand width class they take, bit-exact (they are
integer functions).  Marked ``cuda``: each test skips where no CUDA device
is present, and runs on the card with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda --noconftest

(``--noconftest``: ``tests/conftest.py`` imports JAX, which a CUDA machine
need not have.)
"""
import contextlib
import re

import numpy as np
import pytest
import torch

from zkevm_specs_tpu_torch.ops import fr
from zkevm_specs_tpu_torch.ops import limbs as L
from zkevm_specs_tpu_torch.ops import word_mul
from zkevm_specs_tpu_torch.runtime import cuda_build
from zkevm_specs_tpu_torch.tables import engine
from zkevm_specs_tpu_torch.tables import logup

from limb_tile_cases import (ADDSUB_CASES, ADDSUB_TILE, GATHER_CASES, GATHER_TILE, addsub_case,
                             addsub_operands, addsub_staged, chain_width, gather_case,
                             gather_operands)
from word_mul_cases import CASES as WORD_MUL_CASES
from word_mul_cases import make_case

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

ROWS = 1000     # not a multiple of the 256-thread block


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _limbs(rng, rows, n, bits, dev):
    vals = [int.from_bytes(rng.bytes(40), "little") % (1 << bits) for _ in range(rows)]
    edges = [0, 1, (1 << bits) - 1, fr.P - 1 if bits >= 254 else 1, (1 << bits) >> 1]
    vals[:len(edges)] = [e % (1 << bits) for e in edges][:rows]
    if bits >= 254:
        vals = [v % fr.P for v in vals]
    return L.ints_to_limbs(vals, n).to(dev)


def _operands(seed, na, nb, broadcast, dev, bits_a=None, bits_b=None):
    rng = np.random.RandomState(seed)
    a = _limbs(rng, ROWS, na, bits_a or 16 * na, dev)
    b = _limbs(rng, ROWS, nb, bits_b or 16 * nb, dev)
    if broadcast == "b":
        b = b[3:4]
    elif broadcast == "a":
        a = a[4:5]
    return a, b


def _equal(got, want):
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("broadcast", [None, "a", "b"])
@pytest.mark.parametrize("na,nb,out_n", [(1, 1, 1), (2, 2, 4), (3, 5, 8), (4, 4, 8), (8, 8, 16),
                                         (16, 8, 16), (16, 16, 32), (17, 16, 17), (17, 17, 34),
                                         (9, 16, 20), (4, 4, 2), (16, 4, 34)])
def test_limb_mul(dev, na, nb, out_n, broadcast):
    a, b = _operands(na * 37 + nb, na, nb, broadcast, dev)
    _equal(L.limb_mul(a, b, out_n), L.mul_plain(a, b, out_n))


@pytest.mark.parametrize("broadcast", [None, "a", "b"])
@pytest.mark.parametrize("mode,na,nb,out_n", [
    (L.ADD, 1, 1, 1), (L.ADD, 1, 2, 2), (L.ADD, 2, 2, 4), (L.ADD, 8, 16, 16), (L.ADD, 16, 16, 17),
    (L.ADD, 17, 17, 17), (L.ADD, 16, 16, 8),
    (L.SUB, 1, 1, 0), (L.SUB, 2, 4, 0), (L.SUB, 16, 16, 0), (L.SUB, 17, 17, 0), (L.SUB, 16, 8, 0),
    (L.FR_ADD, 16, 16, 0), (L.FR_ADD, 4, 16, 0), (L.FR_ADD, 17, 1, 0),
    (L.FR_SUB, 16, 16, 0), (L.FR_SUB, 1, 16, 0), (L.FR_SUB, 16, 4, 0),
])
def test_limb_addsub(dev, mode, na, nb, out_n, broadcast):
    fr_bits = 254 if mode in (L.FR_ADD, L.FR_SUB) else None
    a, b = _operands(mode * 100 + na * 7 + nb, na, nb, broadcast, dev,
                     bits_a=None if na > 16 or not fr_bits else min(fr_bits, 16 * na),
                     bits_b=None if nb > 16 or not fr_bits else min(fr_bits, 16 * nb))
    _equal(L.limb_addsub(a, b, mode, out_n), L.addsub_plain(a, b, mode, out_n))


@pytest.mark.parametrize("broadcast", [None, "a", "b"])
@pytest.mark.parametrize("na,nb", [(16, 16), (4, 16), (16, 1), (8, 8), (1, 1)])
def test_fr_mul(dev, na, nb, broadcast):
    a, b = _operands(na * 11 + nb, na, nb, broadcast, dev,
                     bits_a=min(254, 16 * na), bits_b=min(254, 16 * nb))
    _equal(fr.fr_mul(a, b), fr.fr_mul_plain(a, b))
    p1 = fr.from_ints([fr.P - 1] * 7, dev)
    _equal(fr.fr_mul(p1, p1), fr.fr_mul_plain(p1, p1))


@pytest.mark.parametrize("with_enabled", [None, "lanes", "row"])
def test_lookup_gather_eq(dev, with_enabled):
    rng = np.random.RandomState(5)
    n_rows = 3000
    widths = [2, 1, 16, 8, 8]
    table = [torch.from_numpy(rng.randint(0, 1 << 16, size=(n_rows, w))).to(dev) for w in widths]
    table[2][:, 2:] = 0                                 # a wide column holding narrow values
    idx = torch.from_numpy(rng.randint(-3, n_rows + 3, size=ROWS).astype(np.int32)).to(dev)
    rows = idx.long().clamp(0, n_rows - 1)
    query = [table[0][rows].clone(), table[1][rows[:1]].clone(), table[2][rows][:, :2].clone(),
             table[3][rows].clone(), None]
    query[0][::7, 0] += 1                               # some lanes mismatch
    enabled = None
    if with_enabled == "lanes":
        enabled = torch.from_numpy(rng.rand(ROWS) < 0.5).to(dev)
    elif with_enabled == "row":
        enabled = torch.tensor([False], device=dev)
    got = engine.lookup_gather_eq(table, query, idx, enabled)
    want = engine.lookup_gather_eq_plain(table, query, idx, enabled)
    _equal([got[0], *got[1]], [want[0], *want[1]])
    ok, gathered = engine.lookup_gather_eq(table, [None] * 5, idx, want_ok=False)
    assert ok is None
    _equal(gathered, engine.lookup_gather_eq_plain(table, [None] * 5, idx)[1])


# -- K3 and K4 at the edges of their tiles (tests/limb_tile_cases.py) ----------------

@pytest.mark.parametrize("case", sorted(ADDSUB_CASES))
def test_limb_addsub_tile_case(dev, case):
    a, b, mode, out_n = addsub_case(case, dev)
    _equal(L.limb_addsub(a, b, mode, out_n), L.addsub_plain(a, b, mode, out_n))


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_lookup_gather_eq_tile_case(dev, case):
    table, query, idx, enabled = gather_case(case, dev)
    got = engine.lookup_gather_eq(table, query, idx, enabled)
    want = engine.lookup_gather_eq_plain(table, query, idx, enabled)
    _equal([got[0], *got[1]], [want[0], *want[1]])
    ok, gathered = engine.lookup_gather_eq(table, [None] * len(table), idx, want_ok=False)
    assert ok is None
    _equal(gathered, engine.lookup_gather_eq_plain(table, [None] * len(table), idx)[1])


@pytest.mark.parametrize("mode,na,nb,out_n", [(L.ADD, 16, 16, 16), (L.SUB, 1, 16, 0),
                                              (L.FR_ADD, 16, 16, 0), (L.FR_SUB, 16, 16, 0),
                                              (L.ADD, 32, 32, 32), (L.SUB, 64, 64, 0),
                                              (L.ADD, 2, 1, 2), (L.SUB, 3, 3, 0)])
def test_limb_addsub_instance_at_its_threshold(dev, mode, na, nb, out_n):
    """A batch of one lane or one tile less runs the direct path, a batch
    of one tile or one more the staged one (a chain of ADDSUB_DIRECT_WIDTH
    limbs or fewer, or wider than ADDSUB_MAX_UNROLLED, the direct one at
    every batch), each counted once by the launcher."""
    width = chain_width(mode, na, nb, out_n)
    for batch in (1, ADDSUB_TILE - 1, ADDSUB_TILE, ADDSUB_TILE + 1):
        a, b, _, _ = addsub_operands(mode, na, nb, out_n, batch, seed=batch, device=dev)
        path = ("staged" if addsub_staged(batch, width, L.row_stride(a), L.row_stride(b))
                else "direct")
        before = cuda_build.path_launches("limb_addsub")
        got = L.limb_addsub(a, b, mode, out_n)
        after = cuda_build.path_launches("limb_addsub")
        assert after[path] == before[path] + 1 and sum(after.values()) == sum(before.values()) + 1
        _equal(got, L.addsub_plain(a, b, mode, out_n))


@pytest.mark.parametrize("gather_only", [False, True])
def test_lookup_gather_eq_instance_at_its_threshold(dev, gather_only):
    """One partial tile, one tile and one more: one launch each."""
    parts = [(8, None if gather_only else 8), (4, None if gather_only else 16)]
    for batch in (1, GATHER_TILE - 1, GATHER_TILE, GATHER_TILE + 1):
        table, query, idx, _ = gather_operands(parts, batch, seed=batch, device=dev)
        before = L.LAUNCHES["lookup_gather_eq"]
        got = engine.lookup_gather_eq(table, query, idx, want_ok=not gather_only)
        assert L.LAUNCHES["lookup_gather_eq"] == before + 1
        want = engine.lookup_gather_eq_plain(table, query, idx)
        _equal(list(got[1]) + ([] if gather_only else [got[0]]),
               list(want[1]) + ([] if gather_only else [want[0]]))


@pytest.mark.parametrize("batch", [GATHER_TILE - 1, 3 * GATHER_TILE + 7])
def test_lookup_gather_eq_misaligned_views(dev, batch):
    """Table and query parts one limb into wider rows."""
    table, query, idx, enabled = gather_operands([(8, 8), (4, 4)], batch, seed=3, device=dev,
                                                 enabled="lanes")
    table = [torch.cat([t[:, :1], t], dim=1)[:, 1:] for t in table]
    query = [torch.cat([q[:, :1], q], dim=1)[:, 1:] for q in query]
    got = engine.lookup_gather_eq(table, query, idx, enabled)
    want = engine.lookup_gather_eq_plain(table, query, idx, enabled)
    _equal([got[0], *got[1]], [want[0], *want[1]])


def test_limb_addsub_and_lookup_gather_eq_replay_in_a_graph(dev):
    """K3 (both instances, every mode) and K4 (a partial tile and many
    tiles, with and without a query) captured in one CUDA graph give the
    eager results on every replay."""
    tile = ADDSUB_TILE
    k3 = [addsub_case(c, dev) for c in (f"FR_ADD_16_16_0_batch{tile + 1}",
                                        f"SUB_1_16_0_batch{tile - 1}", "ADD_16_8_view_view",
                                        "FR_SUB_neg", f"ADD_32_32_32_batch{tile + 1}",
                                        "SUB_64_3_offset_offset_view")]
    k4 = [gather_case(c, dev) for c in ("rw_ascending_batch5000",
                                        f"rw_random_batch{GATHER_TILE - 1}",
                                        f"gather_random_batch{GATHER_TILE + 1}")]

    def run():
        outs = []
        for a, b, mode, out_n in k3:
            r = L.limb_addsub(a, b, mode, out_n)
            outs += list(r) if mode == L.SUB else [r]
        for table, query, idx, enabled in k4:
            ok, gathered = engine.lookup_gather_eq(table, query, idx, enabled)
            outs += [ok, *gathered]
        return outs

    want = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        _equal(outs, want)


def test_counts_rise_only_where_a_kernel_launches(dev):
    a = torch.ones((4, 4), dtype=torch.int64, device=dev)
    before = L.LAUNCHES["limb_mul"]
    L.limb_mul(a, a, 8)
    L.limb_mul(a.cpu(), a.cpu(), 8)
    assert L.LAUNCHES["limb_mul"] == before + 1
    with pytest.raises(ValueError):
        L.limb_mul(a, a.cpu(), 8)


# -- K1 at the bytecode circuit's shape: a one-limb constant multiplier ----------

@pytest.mark.parametrize("value", [1, 2, 0xFFFF])
def test_fr_mul_one_limb_constant(dev, value):
    a, _ = _operands(value % 97, 16, 1, None, dev, bits_a=254)
    b = L.int_to_limbs(value, 1)[None, :].to(dev)
    _equal(fr.fr_mul(a, b), fr.fr_mul_plain(a, b))


# -- K5: the state circuit's ordering check ---------------------------------------

def _order_cols(seed, dev):
    """The key columns of ROWS rows at their declared widths, neighbours
    sharing prefixes, with the edge values id = MAX_ID, address = 2^160-1,
    storage_key = 2^256-1 and rw_counter = 2^32-1."""
    rng = np.random.RandomState(seed)

    def col(bits, n, edge):
        vals = [int.from_bytes(rng.bytes(40), "little") % (1 << bits) for _ in range(ROWS)]
        vals[5:9] = [edge] * 4
        vals[300:400] = [vals[299]] * 100
        return L.ints_to_limbs(vals, n)

    tag = L.ints_to_limbs([int(t) for t in rng.randint(1, 12, size=ROWS)], 1)
    tag[::50] = 1                                       # Start rows
    sk = col(256, 16, (1 << 256) - 1)
    cols = [tag, col(28, 2, (1 << 28) - 1), col(160, 16, (1 << 160) - 1), col(16, 1, 0xFFFF),
            sk[:, :8].contiguous(), sk[:, 8:].contiguous(), col(32, 2, (1 << 32) - 1)]
    return [c.to(dev) for c in cols]


@pytest.mark.parametrize("seed", [0, 1])
def test_state_order_lt(dev, seed):
    from zkevm_specs_tpu_torch.circuits import state

    cols = _order_cols(seed, dev)
    before = L.LAUNCHES["state_order_lt"]
    got = state.state_order_lt(*cols)
    assert L.LAUNCHES["state_order_lt"] == before + 1
    _equal(got, state.state_order_lt_plain(*cols))
    assert got.any() and not got.all()


# -- K6: the fingerprint search ---------------------------------------------------

def _search_case(dev, n_rows=3000, span_run=3):
    """A table of three parts (2, 16 and 8 limbs), its host index, and
    ROWS queries: most copy a row, every 7th differs, and a run of
    ``span_run`` rows shares the first two parts."""
    rng = np.random.RandomState(17)
    table = [rng.randint(0, 1 << 16, size=(n_rows, w)).astype(np.int64) for w in (2, 16, 8)]
    table[1][:, 10:] = 0
    run = [10, 500, 2000][:span_run]
    for p in (0, 1):
        table[p][run] = table[p][run[0]]
    coefs = torch.from_numpy(rng.randint(-(1 << 62), 1 << 62, size=(3, 16)).astype(np.int64))
    table_t = [torch.from_numpy(t) for t in table]
    fps = engine.fingerprint_plain(table_t, coefs)
    order = torch.sort(fps ^ engine._SIGN, stable=True).indices
    sorted_fps = fps[order].contiguous()
    picks = rng.randint(0, n_rows, size=ROWS)
    picks[:4] = run[0]
    query = [t[picks].clone() for t in table_t]
    query[2][::7, 0] += 1
    query[1] = query[1][:, :10].contiguous()           # a narrower query than its column
    to = lambda ts: [t.to(dev) for t in ts]            # noqa: E731
    return to(query), to(table_t), coefs.to(dev), sorted_fps.to(dev), order.to(dev)


@pytest.mark.parametrize("subset", ["all", "first_two"])
@pytest.mark.parametrize("max_span", [1, 2, 3, 8])
def test_lookup_search_eq(dev, subset, max_span):
    query, table, coefs, fps, order = _search_case(dev)
    if subset == "first_two":                          # the span-3 run is ambiguous here
        table_c = [t.cpu() for t in table[:2]]
        coefs = coefs[:2].contiguous()
        fps_rows = engine.fingerprint_plain(table_c, coefs.cpu())
        order = torch.sort(fps_rows ^ engine._SIGN, stable=True).indices
        fps = fps_rows[order].contiguous().to(dev)
        order = order.to(dev)
        query, table = query[:2], table[:2]
    args = (query, table, coefs, fps, order, max_span, ROWS)
    before = L.LAUNCHES["lookup_search_eq"]
    got = engine.lookup_search_eq(*args)
    assert L.LAUNCHES["lookup_search_eq"] == before + 1
    want = engine.lookup_search_eq_plain(*args)
    _equal(list(got), list(want))
    if subset == "first_two":
        assert bool(got[2][:4].all()) == (max_span < 2)    # ambiguous once 2 are scanned
        assert bool(got[3][:4].all()) == (max_span >= 3)   # covered only with span >= 3
    # a broadcast [1, w] query row
    row_query = [q[:1].contiguous() for q in query]
    args = (row_query, table, coefs, fps, order, max_span, ROWS)
    _equal(list(engine.lookup_search_eq(*args)), list(engine.lookup_search_eq_plain(*args)))


def test_lookup_fingerprint(dev):
    _, table, coefs, _, _ = _search_case(dev)
    before = L.LAUNCHES["lookup_fingerprint"]
    got = engine.lookup_fingerprint(table, coefs)
    assert L.LAUNCHES["lookup_fingerprint"] == before + 1
    _equal(got, engine.fingerprint_plain(table, coefs))


# -- K1 after its arithmetic moved to csrc/fr_arith.cuh ----------------------------

def test_fr_mul_equals_python_ints(dev):
    rng = np.random.RandomState(31)
    a_vals = [int.from_bytes(rng.bytes(32), "little") % fr.P for _ in range(ROWS)]
    b_vals = [int.from_bytes(rng.bytes(32), "little") % fr.P for _ in range(ROWS)]
    a_vals[:4] = [0, 1, fr.P - 1, fr.P - 1]
    b_vals[:4] = [fr.P - 1, fr.P - 1, fr.P - 1, 1]
    got = fr.fr_mul(fr.from_ints(a_vals, dev), fr.from_ints(b_vals, dev))
    torch.cuda.synchronize()
    assert fr.to_ints(got) == [a * b % fr.P for a, b in zip(a_vals, b_vals)]


# -- K7: the keccak sponge ----------------------------------------------------------

def _sponge_case(kind):
    from zkevm_specs_tpu_torch.ops import keccak

    rng = np.random.RandomState(41)
    if kind == "edges":
        lengths = [0, 1, 135, 136, 137, 271, 272, 300]
    else:                               # ROWS rows of 1 to 4 blocks in one batch
        lengths = rng.randint(0, 4 * 136, size=ROWS).tolist()
    datas = [rng.bytes(n) for n in lengths]
    _, _, padded, n_blocks = keccak.pad_blocks(datas)
    blocks = torch.from_numpy(padded.view("<u4").astype(np.int64).reshape(len(datas), -1, 34))
    return datas, blocks, torch.from_numpy(n_blocks.astype(np.int32))


@pytest.mark.parametrize("kind", ["edges", "mixed"])
def test_keccak_sponge(dev, kind):
    from zkevm_specs_tpu_torch.ops import keccak

    datas, blocks, n_blocks = _sponge_case(kind)
    blocks, n_blocks = blocks.to(dev), n_blocks.to(dev)
    before = L.LAUNCHES["keccak_sponge"]
    got = keccak.keccak_sponge(blocks, n_blocks)
    assert L.LAUNCHES["keccak_sponge"] == before + 1
    _equal(got, keccak.keccak_sponge_plain(blocks, n_blocks))
    words = got.cpu().numpy().astype("<u4")
    assert [w.tobytes() for w in words] == [keccak.keccak256(d) for d in datas]


def test_keccak_sponge_clamps_the_block_count(dev):
    from zkevm_specs_tpu_torch.ops import keccak

    _, blocks, n_blocks = _sponge_case("edges")
    n_blocks = torch.tensor([0, -3, 1, 2, 9, 3, 100, 1], dtype=torch.int32)
    blocks, n_blocks = blocks.to(dev), n_blocks.to(dev)
    _equal(keccak.keccak_sponge(blocks, n_blocks), keccak.keccak_sponge_plain(blocks, n_blocks))


def _source_define(name, define):
    m = re.search(r"#define " + define + r" (\d+)", (cuda_build.CSRC / name).read_text())
    assert m, define
    return int(m.group(1))


# -- K7's two paths: one warp a row under KECCAK_COOP_ROWS rows, one thread a row
# at and above it

K7_COOP_ROWS = _source_define("keccak_sponge.cu", "KECCAK_COOP_ROWS")
K7_POOL = [0, 1, 135, 136, 137, 300, 66000]   # 66000 bytes: 486 blocks


def _pool_rows(rows, lengths, seed=43):
    """``rows`` rows cycling over one preimage of each length: (the
    preimages, blocks, n_blocks) on the card."""
    from zkevm_specs_tpu_torch.ops import keccak

    rng = np.random.RandomState(seed)
    pool = [rng.bytes(n) for n in lengths]
    _, _, padded, n_blocks = keccak.pad_blocks(pool)
    blocks = torch.from_numpy(padded.view("<u4").astype(np.int64).reshape(len(pool), -1, 34))
    pick = torch.arange(rows) % len(pool)
    return ([pool[i] for i in pick.tolist()], blocks.cuda()[pick.cuda()].contiguous(),
            torch.from_numpy(n_blocks.astype(np.int32)).cuda()[pick.cuda()].contiguous())


def _sponge_path(rows):
    return "warp" if rows < K7_COOP_ROWS else "row"


@pytest.mark.parametrize("rows", [1, 8, 40, K7_COOP_ROWS - 1, K7_COOP_ROWS, K7_COOP_ROWS + 1])
def test_keccak_sponge_paths_equal_keccak256(dev, rows):
    """Each path against keccak256 on rows of 0, 1, 135, 136, 137, 300 and
    66000 bytes (486 blocks), and against the plain version on the short
    rows; the launch is counted once, under the path the row count picks."""
    from zkevm_specs_tpu_torch.ops import keccak

    datas, blocks, n_blocks = _pool_rows(rows, K7_POOL)
    before, paths = L.LAUNCHES["keccak_sponge"], cuda_build.path_launches("keccak_sponge")
    got = keccak.keccak_sponge(blocks, n_blocks)
    torch.cuda.synchronize()
    after = cuda_build.path_launches("keccak_sponge")
    assert L.LAUNCHES["keccak_sponge"] == before + 1
    assert {k: after[k] - paths[k] for k in after} == {
        p: int(p == _sponge_path(rows)) for p in after}
    words = got.cpu().numpy().astype("<u4")
    assert [w.tobytes() for w in words] == [keccak.keccak256(d) for d in datas]
    datas, blocks, n_blocks = _pool_rows(rows, K7_POOL[:-1])
    _equal(keccak.keccak_sponge(blocks, n_blocks), keccak.keccak_sponge_plain(blocks, n_blocks))


@pytest.mark.parametrize("rows", [8, K7_COOP_ROWS - 1, K7_COOP_ROWS])
def test_keccak_sponge_paths_clamp_the_block_count(dev, rows):
    from zkevm_specs_tpu_torch.ops import keccak

    _, blocks, _ = _pool_rows(rows, K7_POOL[:-1])
    rng = np.random.RandomState(rows)
    n_blocks = torch.from_numpy(rng.choice([-7, -1, 0, 1, 2, 3, 4, 1000], size=rows)
                                .astype(np.int32)).to(dev)
    _equal(keccak.keccak_sponge(blocks, n_blocks), keccak.keccak_sponge_plain(blocks, n_blocks))


# -- K1 on its Montgomery path: operands at and above p, every layout ---------------

FRMUL_TILE = _source_define("fr_mul.cu", "FRMUL_TILE")


def _fr_mul_operand(rng, lanes, n, layout, dev):
    """[lanes, n] limbs of values below 2^(16 n), the edges p, 2p - 1 and
    2^256 - 1 (cut to n limbs) first; laid out dense, at an 8-byte offset
    (no 16-byte loads), as a view of wider rows of even or odd stride."""
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(lanes)]
    edges = [fr.P, 2 * fr.P - 1, (1 << 256) - 1, 0, 1, fr.P - 1]
    vals[:len(edges)] = edges[:lanes]
    vals = [v % (1 << 16 * n) for v in vals]
    t = L.ints_to_limbs(vals, n)
    if layout == "dense":
        return vals, t.to(dev)
    if layout == "misaligned":
        flat = torch.zeros(lanes * n + 1, dtype=torch.int64, device=dev)
        view = flat[1:].view(lanes, n)
    else:
        wide = torch.zeros((lanes, n + (4 if layout == "strided" else 3)), dtype=torch.int64,
                           device=dev)
        view = wide[:, 2:2 + n] if layout == "strided" else wide[:, 1:1 + n]
    view.copy_(t.to(dev))
    return vals, view


@pytest.mark.parametrize("layout", ["dense", "misaligned", "strided", "strided_odd"])
@pytest.mark.parametrize("b_kind", ["broadcast_b", "broadcast_a", "varying"])
@pytest.mark.parametrize("lanes", [1, FRMUL_TILE - 1, FRMUL_TILE, FRMUL_TILE + 1, 131072])
def test_fr_mul_equals_python_ints_at_and_above_p(dev, lanes, b_kind, layout):
    rng = np.random.RandomState(lanes + len(layout) + len(b_kind))
    for na, nb in ((16, 16), (3, 16), (16, 1)):
        a_vals, a = _fr_mul_operand(rng, lanes, na, layout, dev)
        b_vals, b = _fr_mul_operand(rng, 1 if b_kind != "varying" else lanes, nb, layout, dev)
        if b_kind == "broadcast_a":
            a_vals, a, b_vals, b = b_vals, b, a_vals, a
        got = fr.fr_mul(a, b)
        if lanes <= 4 * FRMUL_TILE:
            _equal(got, fr.fr_mul_plain(a, b))
        if len(a_vals) == 1:
            a_vals = a_vals * len(b_vals)
        if len(b_vals) == 1:
            b_vals = b_vals * len(a_vals)
        assert fr.to_ints(got.cpu()) == [x * y % fr.P for x, y in zip(a_vals, b_vals)]


@pytest.mark.parametrize("b_kind", ["row", "expanded"])
@pytest.mark.parametrize("lanes", [1, FRMUL_TILE + 1, 131072])
def test_fr_mul_two_broadcast_rows(dev, lanes, b_kind):
    """An expanded ``[1, 16]`` a (row stride 0) times a ``[1, 16]`` row or
    another expanded one: every lane of the batch holds the one product."""
    rng = np.random.RandomState(lanes + len(b_kind))
    x, y = (int.from_bytes(rng.bytes(32), "little") | 1 << 255 for _ in "xy")   # above p
    a, b = (L.ints_to_limbs([v], 16).to(dev) for v in (x, y))
    a = a.expand(lanes, 16)
    if b_kind == "expanded":
        b = b.expand(lanes, 16)
    assert L.row_stride(a) == 0
    got = fr.fr_mul(a, b)
    assert got.shape == (lanes, 16)
    _equal(got, fr.fr_mul_plain(a, b))
    assert fr.to_ints(got.cpu()) == [x * y % fr.P] * lanes


def test_fr_mul_and_keccak_sponge_replay_in_a_graph(dev):
    """K1 (broadcast and varying b, a ragged tile) and K7 (both paths)
    captured in one CUDA graph give the eager results on every replay."""
    from zkevm_specs_tpu_torch.ops import keccak

    rng = np.random.RandomState(47)
    _, a = _fr_mul_operand(rng, 3 * FRMUL_TILE + 5, 16, "dense", dev)
    _, b = _fr_mul_operand(rng, 3 * FRMUL_TILE + 5, 16, "strided", dev)
    _, c = _fr_mul_operand(rng, 1, 16, "dense", dev)
    sponges = [_pool_rows(rows, K7_POOL[:-1])[1:] for rows in (8, K7_COOP_ROWS)]

    def run():
        return [fr.fr_mul(a, b), fr.fr_mul(a, c)] + [keccak.keccak_sponge(*x) for x in sponges]

    want = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        _equal(outs, want)


# -- K8: the byte-RLC Horner scan ---------------------------------------------------

@pytest.mark.parametrize("mask", ["prefix", "random"])
@pytest.mark.parametrize("r_limbs", [1, 16])
def test_horner_rlc(dev, r_limbs, mask):
    from zkevm_specs_tpu_torch.circuits import keccak

    rng = np.random.RandomState(r_limbs + len(mask))
    T = 70
    byte_cols = torch.from_numpy(rng.randint(0, 256, size=(T, ROWS)).astype(np.uint8))
    if mask == "prefix":
        lens = rng.randint(0, T + 1, size=ROWS)
        lens[:2] = [0, T]
        active = torch.from_numpy(np.arange(T)[:, None] < lens[None, :])
    else:
        active = torch.from_numpy(rng.rand(T, ROWS) < 0.7)
    r = fr.P - 1 - int(rng.randint(1 << 30)) if r_limbs == 16 else 0x64
    byte_cols, active = byte_cols.to(dev), active.to(dev)
    before = L.LAUNCHES["horner_rlc"]
    got = keccak.horner_rlc(byte_cols, active, r)
    assert L.LAUNCHES["horner_rlc"] == before + keccak.horner_schedule(T, ROWS).launches
    _equal(got, keccak.horner_rlc_plain(byte_cols, active, r))


def _horner_ints(byte_cols, active, r):
    """The Python-int Horner of every row (exact, independent of the limb
    code)."""
    b, a = byte_cols.cpu().numpy(), active.cpu().numpy()
    out = []
    for i in range(b.shape[1]):
        acc = 0
        for v in b[a[:, i], i].tolist():
            acc = (acc * r + v) % fr.P
        out.append(acc)
    return out


# (T, n): ragged T against the schedule's chunk at one to eight rows (two
# launches, several chunk groups), the arithmetic table's row count, the
# withdrawal shape (one launch, a tree in the block), and n past the card's
# fill (one thread a row, several stages, a ragged last stage)
HORNER_SHAPES = [(2049, 1), (66001, 8), (3001, 3), (24162, 40), (42, 16), (300, 70000),
                 (70, 33792), (1, 5), (0, 7)]


@pytest.mark.parametrize("mask", ["prefix", "random"])
@pytest.mark.parametrize("T,n", HORNER_SHAPES)
def test_horner_rlc_chunked_schedules(dev, T, n, mask):
    """K8 at the shapes that exercise each branch of its schedule, with a
    non-prefix mask or a prefix one, a row with no active step and an
    all-active row, against the Python-int Horner (and its schedule's launch
    count)."""
    from zkevm_specs_tpu_torch.circuits import keccak

    rng = np.random.RandomState(T + n)
    byte_cols = rng.randint(0, 256, size=(T, n)).astype(np.uint8)
    if mask == "prefix":
        lens = rng.randint(0, T + 1, size=n)
        lens[:2] = [0, T][:n]
        active = np.arange(T)[:, None] < lens[None, :]
    else:
        active = rng.rand(T, n) < 0.6
        active[:, 0] = False
        if n > 1:
            active[:, 1] = True
    byte_cols = torch.from_numpy(byte_cols).to(dev)
    active = torch.from_numpy(active).to(dev)
    r = fr.P - 1 - int(rng.randint(1 << 30))
    s = keccak.horner_schedule(T, n)
    before = L.LAUNCHES["horner_rlc"]
    got = keccak.horner_rlc(byte_cols, active, r)
    torch.cuda.synchronize()
    assert L.LAUNCHES["horner_rlc"] == before + s.launches
    want = _horner_ints(byte_cols, active, r)
    assert L.limbs_to_ints(got.cpu()) == want, s


@pytest.mark.parametrize("n", [1, 2, 7, 8, 1428])
def test_horner_rlc_at_the_sig_shapes(dev, n):
    """K8 at the tx and sig checks' ``[64, n]`` public-key bytes, every step
    active (the signed blocks' txs and the 1428-transfer block), against
    its plain version and the Python-int Horner."""
    from zkevm_specs_tpu_torch.circuits import keccak

    rng = np.random.RandomState(n)
    byte_cols = torch.from_numpy(rng.randint(0, 256, size=(64, n)).astype(np.uint8)).to(dev)
    active = torch.ones((64, n), dtype=torch.bool, device=dev)
    before = L.LAUNCHES["horner_rlc"]
    got = keccak.horner_rlc(byte_cols, active, 0x64)
    assert L.LAUNCHES["horner_rlc"] == before + keccak.horner_schedule(64, n).launches
    _equal(got, keccak.horner_rlc_plain(byte_cols, active, 0x64))
    assert L.limbs_to_ints(got.cpu()) == _horner_ints(byte_cols, active, 0x64)


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("n", [4, 64])
def test_tx_and_sig_checks_on_the_card(dev, n, corrupt):
    """``tx_kernel`` and ``sig_kernel`` on signed transfers: the card's fail
    bits equal the CPU's (K8 at ``[64, n]``, K6 at the keccak lookup,
    searching the index built on the host), with one lane's ECDSA verdict
    flipped in the uploaded inputs or none."""
    from zkevm_specs_tpu_torch import workloads
    from zkevm_specs_tpu_torch.circuits import sig, super_circuit, tx
    from zkevm_specs_tpu_torch.circuits.keccak import horner_schedule

    txs = workloads.signed_transfers(n)
    chain = workloads.TX_SIG_CHAIN_ID
    tw = tx.txs2witness(txs, chain, n, 64, 0x64)
    sw = super_circuit.sig_witness_from_txs(txs, chain, 0x64)
    for name, make in (("tx", lambda d: tx.tx_kernel(tw, n, 0x64, device=d)),
                       ("sig", lambda d: sig.sig_kernel(sw, 0x64, device=d))):
        k_dev, k_cpu = make("cuda"), make("cpu")
        args_dev, args_cpu = k_dev.device_args(), k_cpu.device_args()
        if corrupt:
            for extra in (args_dev[2], args_cpu[2]):
                extra["ecdsa_ok"][n // 2] ^= 1
        before = {k: L.LAUNCHES[k] for k in ("horner_rlc", "lookup_search_eq",
                                             "lookup_fingerprint")}
        got = k_dev(args_dev)
        torch.cuda.synchronize()
        assert L.LAUNCHES["horner_rlc"] == before["horner_rlc"] + horner_schedule(64, n).launches
        assert L.LAUNCHES["lookup_search_eq"] == before["lookup_search_eq"] + 1, name
        assert L.LAUNCHES["lookup_fingerprint"] == before["lookup_fingerprint"], name
        want = k_cpu(args_cpu)
        assert torch.equal(got.cpu(), want)
        assert torch.nonzero(want).flatten().tolist() == ([n // 2] if corrupt else [])


def test_horner_rlc_replays_in_a_graph(dev):
    """K8's two launches captured in a CUDA graph give the same limbs on
    every replay (the power table is uploaded by the warm-up call)."""
    from zkevm_specs_tpu_torch.circuits import keccak

    rng = np.random.RandomState(9)
    byte_cols = torch.from_numpy(rng.randint(0, 256, size=(5000, 4)).astype(np.uint8)).to(dev)
    active = torch.from_numpy(rng.rand(5000, 4) < 0.8).to(dev)
    want = keccak.horner_rlc(byte_cols, active, 0x64)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = keccak.horner_rlc(byte_cols, active, 0x64)
    for _ in range(3):
        out.zero_()
        graph.replay()
        _equal(out, want)


# -- K9 and K10: the block verifier's upload and verdict gather -----------------------

def _leaves(kind, seed=0):
    """Host leaves of the block verifier's kinds: 16-bit limb tensors and
    numpy uint32 columns (narrowed to u8/u16 by their maximum, or kept at
    int64 past 2^16), u64 fingerprints, int32 and int64 columns, bool and
    uint8 columns; with empty and one-element leaves."""
    rng = np.random.RandomState(seed)
    sizes = [0, 1, 7, 4096, 4097, 10_000]
    out = []
    for i, n in enumerate(sizes):
        if kind == "u8":
            out.append(torch.from_numpy(rng.randint(0, 256, size=(n, 1)).astype(np.int64)))
        elif kind == "u16":
            out.append(rng.randint(0, 1 << 16, size=n).astype(np.uint32))
        else:
            out += [torch.from_numpy(rng.randint(0, 1 << 16, size=(n, 2)).astype(np.int64)),
                    rng.randint(0, 200, size=n).astype(np.uint32),
                    torch.from_numpy(rng.randint(-2**62, 2**62, size=n, dtype=np.int64)),
                    rng.randint(0, 2**63, size=n, dtype=np.uint64) * np.uint64(2) + np.uint64(i % 2),
                    rng.randint(-2**31, 2**31, size=n).astype(np.int32),
                    rng.rand(n) < 0.5,
                    torch.from_numpy(rng.randint(0, 256, size=n).astype(np.uint8))]
    return out


@pytest.mark.parametrize("kind", ["u8", "u16", "mixed"])
def test_leaf_unpack(dev, kind):
    from zkevm_specs_tpu_torch.runtime import transfer
    from zkevm_specs_tpu_torch.runtime.convert import to_device

    leaves = _leaves(kind, seed=len(kind))
    before = L.LAUNCHES["leaf_unpack"]
    got, plan = transfer.upload(leaves, dev)
    assert L.LAUNCHES["leaf_unpack"] == before + 1
    torch.cuda.synchronize()
    for g, leaf in zip(got, leaves):
        want = to_device(leaf, dev)
        assert g.dtype == want.dtype and g.shape == want.shape and torch.equal(g, want)
    # every leaf of the arena against K9's plain version on the same staged buffers
    staged = transfer.stage(plan, dev)
    args = (staged[:4], staged[4], len(plan.segs), plan.arena_bytes)
    _equal(transfer.leaf_views(transfer.leaf_unpack(*args), plan),
           transfer.leaf_views(transfer.leaf_unpack_plain(*args), plan))


@pytest.mark.parametrize("lengths", [[1], [0, 1, 5], [1000, 1, 1 << 20, 3, 4097],
                                     list(range(18)), [0, 0, 4095, 4096, 4097, 0]])
def test_verdict_pack(dev, lengths):
    from zkevm_specs_tpu_torch.runtime import transfer

    rng = np.random.RandomState(len(lengths))
    fails = [torch.from_numpy(rng.rand(n) < 0.3).to(dev) for n in lengths]
    before = L.LAUNCHES["verdict_pack"]
    got = transfer.verdict_pack(fails)
    assert L.LAUNCHES["verdict_pack"] == before + 1
    _equal(got, transfer.verdict_pack_plain(fails))


@pytest.mark.parametrize("shift", [1, 3, 8, 15])
def test_verdict_pack_misaligned_sources(dev, shift):
    """Vectors that are slices of a larger bool buffer at every distance
    from a 16-byte edge (lengths 0 to 17 and longer), with bytes that are
    not 0/1 in their bool storage: the kernel reads them byte by byte,
    normalises them and equals its plain version; padding bytes are 0."""
    from zkevm_specs_tpu_torch.runtime import transfer

    rng = np.random.RandomState(shift)
    raw = torch.from_numpy(rng.randint(0, 4, size=200_000).astype(np.uint8)).to(dev)
    buf = raw.view(torch.bool)
    lengths = list(range(18)) + [4096 + 5, 70_000]
    fails, at = [], shift
    for n in lengths:
        fails.append(buf[at:at + n])
        at += n + shift
    got = transfer.verdict_pack(fails)
    want = transfer.verdict_pack_plain([f.to(torch.uint8) != 0 for f in fails])
    _equal(got, want)
    assert int(got.max()) <= 1


@pytest.mark.parametrize("wide", [False, True], ids=["256", "512"])
@pytest.mark.parametrize("case", WORD_MUL_CASES)
def test_mul_add_words(dev, case, wide):
    rows, _, _ = make_case(case, wide, n=ROWS)
    rows = [r.to(dev) for r in rows]
    before = L.LAUNCHES["mul_add_words"]
    ok, overflow = word_mul.mul_add_words(rows, wide)
    assert L.LAUNCHES["mul_add_words"] == before + 1
    want_ok, want_over = word_mul.mul_add_words_plain(rows, wide)
    _equal(ok, want_ok.expand(ok.shape))
    if wide:
        assert overflow is None
    else:
        _equal(overflow, want_over.expand(overflow.shape))


@pytest.mark.parametrize("wide", [False, True], ids=["256", "512"])
@pytest.mark.parametrize("case", ["random_valid", "random_fields", "constants"])
def test_mul_add_words_at_group_lanes(dev, case, wide):
    """At the MUL group's 131072 lanes."""
    rows, _, _ = make_case(case, wide, n=131072, seed=1)
    rows = [r.to(dev) for r in rows]
    ok, overflow = word_mul.mul_add_words(rows, wide)
    want_ok, want_over = word_mul.mul_add_words_plain(rows, wide)
    _equal(ok, want_ok.expand(ok.shape))
    if not wide:
        _equal(overflow, want_over.expand(overflow.shape))


def _small_block(kind="alu"):
    from zkevm_specs_tpu_torch import workloads

    if kind == "sstore":
        return workloads.build_sstore_block(2)
    if kind == "flow":
        return workloads.build_flow_block(2, 8)
    if kind == "conformance":
        return workloads.build_conformance_block()
    if kind == "calls":
        return workloads.build_call_block(4, 3)
    if kind == "mega":
        return workloads.build_conformance_mega_block()
    if kind == "create":
        return workloads.build_create_block(2, 1)
    if kind == "create_chain":
        return workloads.build_create_chain_block()
    if kind == "precompile":
        return workloads.build_precompile_block(1, 1, 2)
    return workloads.build_alu_block(2, 6) if kind == "alu" else workloads.build_arith_block(2, 2)


@pytest.mark.parametrize("kind", ["alu", "arith", "sstore", "flow", "conformance", "calls",
                                  "mega", "create", "create_chain", "precompile"])
@pytest.mark.parametrize("corrupt", [False, True])
def test_block_graph_replay_equals_per_kernel_pass(dev, corrupt, kind):
    from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier

    w = _small_block(kind)
    if corrupt:
        name = {"alu": "ADD", "arith": "MULMOD", "sstore": "SSTORE", "flow": "CALLDATALOAD",
                "conformance": "EXTCODECOPY", "calls": "CALL_OP", "mega": "CALL_OP",
                "create": "CREATE2", "create_chain": "CREATE", "precompile": "BN254_ADD"}[kind]
        next(s for s in w.steps if s.execution_state.name == name).gas_left += 1
    bv = CompiledBlockVerifier(w)                       # device "cuda"
    prepared = bv.prepare()
    per_kernel = bv.run_device(prepared)
    assert bv.run_device_combined(prepared) == per_kernel       # captures, then replays
    captured = prepared["graph"]["launches"]
    assert captured["verdict_pack"] == 1 and "leaf_unpack" not in captured
    before = L.LAUNCHES.copy()
    assert bv.run_device_combined(prepared) == per_kernel       # a replay alone
    assert L.LAUNCHES == before, "a graph replay goes through no kernel wrapper"
    on_cpu = CompiledBlockVerifier(w, device="cpu")
    assert on_cpu.run_device(on_cpu.prepare()) == per_kernel
    assert bool(per_kernel) == corrupt


def _flow_kernel_plain():
    """(module, wrapper, plain version) of every kernel the block verifier's
    device pass launches."""
    from zkevm_specs_tpu_torch.circuits import keccak as keccak_circuit
    from zkevm_specs_tpu_torch.circuits import state
    from zkevm_specs_tpu_torch.ops import keccak as keccak_ops

    return (
        (fr, "fr_mul", fr.fr_mul_plain),
        (L, "limb_mul", L.mul_plain),
        (L, "limb_addsub", lambda a, b, mode, out_n=0: L.addsub_plain(a, b, mode, out_n)),
        (engine, "lookup_gather_eq",
         lambda *a, want_ok=True, **kw: engine.lookup_gather_eq_plain(*a, **kw)),
        (engine, "lookup_search_eq", engine.lookup_search_eq_plain),
        (engine, "lookup_fingerprint", engine.fingerprint_plain),
        (state, "state_order_lt", state.state_order_lt_plain),
        (keccak_circuit, "keccak_sponge", keccak_ops.keccak_sponge_plain),
        (keccak_circuit, "horner_rlc", keccak_circuit.horner_rlc_plain),
    )


def _flatten(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flatten(o)]
    return [out]


@pytest.mark.parametrize("kind", ["flow", "conformance", "calls", "mega"])
def test_flow_block_kernel_shapes_equal_plain(dev, kind, monkeypatch):
    """Every kernel call of the loop block's, the conformance block's, the
    call block's and the mega conformance block's per-kernel pass (the
    flow, context, account, copy, log, call and halt gadgets' groups among
    them), each held against its plain version on the same arguments,
    bit-exact."""
    from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier

    bv = CompiledBlockVerifier(_small_block(kind))
    prepared = bv.prepare()
    calls = []
    for module, name, plain in _flow_kernel_plain():
        orig = getattr(module, name)

        def record(*a, _orig=orig, _plain=plain, _name=name, **kw):
            out = _orig(*a, **kw)
            calls.append((_name, out, _plain, a, kw))
            return out

        monkeypatch.setattr(module, name, record)
    assert not bv.run_device(prepared)
    monkeypatch.undo()
    names = {name for name, *_ in calls}
    assert {"limb_addsub", "lookup_gather_eq", "fr_mul", "limb_mul", "lookup_search_eq"} <= names, \
        names
    for name, out, plain, a, kw in calls:
        for got, want in zip(_flatten(out), _flatten(plain(*a, **kw))):
            if isinstance(got, torch.Tensor):
                _equal(got, want.expand(got.shape) if want.dim() else want)


# -- K12 (field inverse) and K13 (batch inverse, logUp partial sum) ------------------

def _fr_values(rng, n, zero_at=None):
    vals = [int.from_bytes(rng.bytes(32), "little") % fr.P for _ in range(n)]
    edges = [1, 2, fr.P - 1, fr.P - 2, 1 << 128]
    vals[:min(n, len(edges))] = edges[:n]
    vals = [v or 1 for v in vals]
    if zero_at is not None:
        vals[{"first": 0, "middle": n // 2, "last": n - 1}[zero_at]] = 0
    return vals


@pytest.mark.parametrize("rows,width", [(1, 16), (1000, 16), (1000, 4), (300, 1)])
def test_fr_inv(dev, rows, width):
    rng = np.random.RandomState(rows + width)
    vals = [v % (1 << (16 * width)) for v in _fr_values(rng, rows)]
    vals[rows // 2] = 0
    a = L.ints_to_limbs(vals, width).to(dev)
    before = L.LAUNCHES["fr_inv"]
    got = fr.inv(a)
    assert L.LAUNCHES["fr_inv"] == before + 1
    _equal(got, fr.inv_plain(a))
    assert fr.to_ints(got.cpu()) == [pow(v, fr.P - 2, fr.P) for v in vals]


# n = 1, a chunk (16), past it, and sizes that are no multiple of a chunk or
# of a 128-thread block
@pytest.mark.parametrize("zero_at", [None, "first", "middle", "last"])
@pytest.mark.parametrize("n", [1, 16, 17, 1000, 4097])
def test_batch_inverse(dev, n, zero_at):
    vals = _fr_values(np.random.RandomState(n), n, zero_at)
    x = L.ints_to_limbs(vals, 16).to(dev)
    before = L.LAUNCHES["logup_sum"], L.LAUNCHES["fr_inv"]
    got = logup.batch_inverse(x)
    assert (L.LAUNCHES["logup_sum"], L.LAUNCHES["fr_inv"]) == (before[0] + 2, before[1] + 1)
    _equal(got, logup.batch_inverse_plain(x))
    want = ([0] * n if zero_at else [pow(v, fr.P - 2, fr.P) for v in vals])
    assert fr.to_ints(got.cpu()) == want


@pytest.mark.parametrize("mult", [None, "en", "counts"])
@pytest.mark.parametrize("n", [1, 17, 1000, 4097])
def test_logup_partial_sum(dev, n, mult):
    rng = np.random.RandomState(n + 7)
    fps = L.ints_to_limbs(_fr_values(rng, n), 16).to(dev)
    alpha = L.int_to_limbs(0xA1FA, 16).to(dev)
    m = {None: None, "en": torch.from_numpy(rng.randint(0, 2, size=(n, 1))),
         "counts": torch.from_numpy(rng.randint(0, 1 << 16, size=(n, 4)))}[mult]
    m = None if m is None else m.to(dev)
    got = logup.logup_partial_sum(fps, alpha, m)
    _equal(got, logup.logup_partial_sum_plain(fps, alpha, m))
    # alpha equal to one fingerprint: a zero denominator zeroes the sum
    at = fps[n // 2].clone()
    zero = logup.logup_partial_sum(fps, at, m)
    _equal(zero, logup.logup_partial_sum_plain(fps, at, m))
    assert not bool(zero.any())


# -- K12 and K13 on the 32-bit-limb Montgomery product: Python ints, and every
#    level and tile boundary of K13's plan ------------------------------------------

P = fr.P
LOGUP_TILE = logup.LOGUP_THREADS * logup.LOGUP_RUN


@pytest.mark.parametrize("rows", [1, 31, 32, 33, 131072])
def test_fr_inv_equals_python_ints(dev, rows):
    rng = np.random.RandomState(rows)
    cases = ([[0], [1], [P - 1], _fr_values(rng, 1)] if rows == 1
             else [[0, 1, P - 1] + _fr_values(rng, rows - 3)])
    for vals in cases:
        a = L.ints_to_limbs(vals, 16).to(dev)
        before = L.LAUNCHES["fr_inv"]
        got = fr.inv(a)
        assert L.LAUNCHES["fr_inv"] == before + 1
        assert fr.to_ints(got.cpu()) == [pow(v, P - 2, P) for v in vals]
        if rows <= 33:
            _equal(got, fr.inv_plain(a))


def _fr_rows(rng, n, zero_at=None):
    """n canonical elements as [n, 16] limbs (the top limb below p's, so
    each is below p; 1, 2 and p - 1 first) and as Python ints."""
    limbs = rng.randint(0, 1 << 16, size=(n, 16)).astype(np.int64)
    limbs[:, 15] %= P >> 240
    t = torch.from_numpy(limbs)
    t[:3] = L.ints_to_limbs([1, 2, P - 1], 16)[:n]
    if zero_at is not None:
        t[{"first": 0, "middle": n // 2, "last": n - 1}[zero_at]] = 0
    return t, fr.to_ints(t)


def _logup_call(call, n, sum_mode):
    """One K13 call: two wrapper launches, one of K12, and the device
    launches counted in the source equal to the plan's, at most 8 with
    K12's."""
    before = L.LAUNCHES["logup_sum"], L.LAUNCHES["fr_inv"], logup.device_launches()
    got = call()
    assert (L.LAUNCHES["logup_sum"], L.LAUNCHES["fr_inv"]) == (before[0] + 2, before[1] + 1)
    up, down = logup.device_launches()
    assert (up - before[2][0], down - before[2][1]) == logup.logup_plan(n).launches(sum_mode)
    assert up - before[2][0] + 1 + down - before[2][1] <= 8
    return got


# every level and tile boundary of the plan, up to the ALU block's bytecode
# queries
LOGUP_NS = [1, 2, LOGUP_TILE - 1, LOGUP_TILE, LOGUP_TILE + 1, 2 * LOGUP_TILE + 3,
            LOGUP_TILE ** 2, LOGUP_TILE ** 2 + 1, 6160016]


@pytest.mark.parametrize("n", LOGUP_NS)
def test_batch_inverse_across_the_plan(dev, n):
    x, vals = _fr_rows(np.random.RandomState(n % 9973), n)
    x = x.to(dev)
    got = _logup_call(lambda: logup.batch_inverse(x), n, False)
    if n <= 2 * LOGUP_TILE + 3:
        assert fr.to_ints(got.cpu()) == logup.batch_inverse_ints(vals)
        _equal(got, logup.batch_inverse_plain(x))
    else:   # every x * inv is 1 (K1), and both ends against Python ints
        one = torch.zeros((n, 16), dtype=torch.int64, device=dev)
        one[:, 0] = 1
        _equal(fr.fr_mul(x, got), one)
        ends = list(range(LOGUP_TILE)) + list(range(n - LOGUP_TILE, n))
        assert fr.to_ints(got[ends].cpu()) == [pow(vals[i], P - 2, P) for i in ends]


@pytest.mark.parametrize("zero_at", ["first", "middle", "last"])
@pytest.mark.parametrize("n", [LOGUP_TILE, LOGUP_TILE + 1, LOGUP_TILE ** 2 + 1])
def test_batch_inverse_zero_across_the_plan(dev, n, zero_at):
    x, _ = _fr_rows(np.random.RandomState(n % 9973), n, zero_at)
    got = logup.batch_inverse(x.to(dev))
    torch.cuda.synchronize()
    assert not bool(got.any())


# m widths 1 (en), 4 (counts) and 16 (any element); the largest shape with
# the query side's m only, as the ALU block gives it
LOGUP_SUM_CASES = [(n, w) for n in LOGUP_NS for w in (None, 1, 4, 16)
                   if n < 6160016 or w == 1]


@pytest.mark.parametrize("n,m_width", LOGUP_SUM_CASES)
def test_logup_partial_sum_across_the_plan(dev, n, m_width):
    rng = np.random.RandomState(n % 9973 + 7)
    fps, vals = _fr_rows(rng, n)
    fps = fps.to(dev)
    alpha_int = 0xA1FA
    alpha = L.int_to_limbs(alpha_int, 16).to(dev)
    if m_width is None:
        m, m_ints = None, [1] * n
    elif m_width == 16:
        m, m_ints = _fr_rows(rng, n)
    else:   # en (0/1) or a 64-bit count
        m = torch.from_numpy(rng.randint(0, 2 if m_width == 1 else 1 << 16, size=(n, m_width)))
        m_ints = fr.to_ints(m)
    m = None if m is None else m.to(dev)
    got = _logup_call(lambda: logup.logup_partial_sum(fps, alpha, m), n, True)
    assert fr.to_ints(got.cpu()[None])[0] == logup.logup_partial_sum_ints(vals, alpha_int, m_ints)
    if n <= 2 * LOGUP_TILE + 3:
        _equal(got, logup.logup_partial_sum_plain(fps, alpha, m))
    # alpha equal to one fingerprint (first, middle, last): the sum is 0
    for i in sorted({0, n // 2, n - 1}):
        zero = logup.logup_partial_sum(fps, fps[i].clone(), m)
        torch.cuda.synchronize()
        assert not bool(zero.any())


# -- K6's three paths: one warp a lane under SEARCH_WARP_BATCH lanes, a staged tile
# of lanes from SEARCH_TILE_BATCH lanes of wide queries, one thread a lane between;
# each case also on a build of each path alone

SEARCH_WARP_BATCH = _source_define("lookup_search_eq.cu", "SEARCH_WARP_BATCH")
SEARCH_TILE_BATCH = _source_define("lookup_search_eq.cu", "SEARCH_TILE_BATCH")
SEARCH_TILE_LIMBS = _source_define("lookup_search_eq.cu", "SEARCH_TILE_LIMBS")
K6_BATCHES = [1, 31, 127, 128, 129, SEARCH_WARP_BATCH - 1, SEARCH_WARP_BATCH + 1, 1 << 19]
assert (1 << 19) >= SEARCH_TILE_BATCH
K6_ROWS = 5000
K6_WIDTHS = [(1, 1), (8, 8), (16, 16), (10, 9), (16, 16), (16, 16)]  # (table, query) limbs
assert sum(q for _, q in K6_WIDTHS) >= SEARCH_TILE_LIMBS   # 2^19 lanes take the tile path


@pytest.fixture(scope="module")
def search_libs():
    """{path: library}: the source's own build (None) and one build a path
    (every batch a tile, one warp a lane, or one thread a lane)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    top = 2**31 - 1
    return {"own": None, **cuda_build.build_variants(
        "lookup_search_eq",
        {"tile": ["SEARCH_WARP_BATCH=0", "SEARCH_TILE_BATCH=0", "SEARCH_TILE_LIMBS=0"],
         "warp": [f"SEARCH_WARP_BATCH={top}"],
         "row": ["SEARCH_WARP_BATCH=0", f"SEARCH_TILE_BATCH={top}"]})}


def _search_path(batch, query):
    """The path the source's own launcher takes."""
    if batch < SEARCH_WARP_BATCH:
        return "warp"
    wide = sum(q.shape[1] for q in query) >= SEARCH_TILE_LIMBS
    return "tile" if batch >= SEARCH_TILE_BATCH and wide else "row"


_K6_TABLE = {}


def _k6_table():
    """A table of six parts and its host index: rows 10-17 equal (8
    matches), rows 20-25 equal but in part 3's limb 5, whose coefficient
    is 0 (6 candidates, one match), row 30 with limbs at 2^40 + 7 and -5,
    part 3's limb 9 nonzero in every 97th row (past the query's width)."""
    if not _K6_TABLE:
        rng = np.random.RandomState(5)
        table = [rng.randint(0, 1 << 16, size=(K6_ROWS, tw)).astype(np.int64)
                 for tw, _ in K6_WIDTHS]
        table[3][:, 9] = 0
        table[3][::97, 9] = 3
        for t in table:
            t[10:18] = t[10]
            t[20:26] = t[20]
        table[3][20:26, 5] = np.arange(6)
        table[1][30, 2], table[1][30, 3] = (1 << 40) + 7, -5
        coefs = rng.randint(-(1 << 62), 1 << 62, size=(len(K6_WIDTHS), 16)).astype(np.int64)
        coefs[3, 5] = 0
        table_t, coefs_t = [torch.from_numpy(t) for t in table], torch.from_numpy(coefs)
        fps = engine.fingerprint_plain(table_t, coefs_t)
        order = torch.sort(fps ^ engine._SIGN, stable=True).indices
        _K6_TABLE.update(table=table_t, coefs=coefs_t, fps=fps[order].contiguous(), order=order)
    return _K6_TABLE


def _k6_args(batch, layout, max_span, dev):
    """The lookup's arguments on the card: ``batch`` lanes picking rows
    (the runs and row 30 first, every 5th lane matching no row); "wide"
    moves limbs outside [0, 2^32) into the query (part 3's limb 5 by 2^32,
    which leaves the low word and the fingerprint alone; part 1's limb 2
    to -2^33); "broadcast" gives one [1, w] row a part; "strided" lays
    every query and table part out at a row stride above its width."""
    k6 = _k6_table()
    rng = np.random.RandomState(batch)
    picks = rng.randint(0, K6_ROWS, size=batch)
    picks[:4] = [10, 20, 23, 30][:min(batch, 4)]
    query = [t[torch.from_numpy(picks)][:, :qw].clone()
             for t, (_, qw) in zip(k6["table"], K6_WIDTHS)]
    query[2][4::5, 0] ^= 1
    if layout == "wide":
        query[3][1::3, 5] += 1 << 32
        query[1][5::7, 2] = -(1 << 33)
    if layout == "broadcast":
        query = [q[:1].clone() for q in query]
    table = list(k6["table"])

    def strided(t):
        out = torch.zeros((t.shape[0], t.shape[1] + 3), dtype=t.dtype, device=dev)
        out[:, :t.shape[1]] = t.to(dev)
        return out[:, :t.shape[1]]

    place = strided if layout == "strided" else (lambda t: t.to(dev))
    return ([place(q) for q in query], [place(t) for t in table], k6["coefs"].to(dev),
            k6["fps"].to(dev), k6["order"].to(dev), max_span, batch)


def _k6_check(args, libs):
    """Each build against the plain version, one launch a call, counted
    under the path its launcher picks."""
    batch = args[-1]
    want = engine.lookup_search_eq_plain(*args)
    for path, lib in libs.items():
        with cuda_build.launching("lookup_search_eq", lib) if lib else contextlib.nullcontext():
            before, paths = L.LAUNCHES["lookup_search_eq"], cuda_build.path_launches(
                "lookup_search_eq")
            got = engine.lookup_search_eq(*args)
            torch.cuda.synchronize()
            after = cuda_build.path_launches("lookup_search_eq")
        assert L.LAUNCHES["lookup_search_eq"] == before + 1
        took = path if lib else _search_path(batch, args[0])
        assert {k: after[k] - paths[k] for k in after} == {p: int(p == took) for p in after}
        _equal(list(got), list(want))
    return want


@pytest.mark.parametrize("max_span", range(1, 9))
@pytest.mark.parametrize("batch", K6_BATCHES)
def test_lookup_search_eq_paths_at_batches(dev, search_libs, batch, max_span):
    first_row, unsat, unique, covered = _k6_check(_k6_args(batch, "dense", max_span, dev),
                                                  search_libs)
    if batch >= 4:   # rows 10-17: 8 matches; rows 20-25: 6 candidates, one match
        assert bool(unsat[0]) and bool(unique[0]) == (max_span == 1)
        assert bool(covered[0]) == (max_span == 8) and int(first_row[1]) == 20
        assert bool(unique[1]) and bool(unsat[2]) == (max_span >= 4)


@pytest.mark.parametrize("max_span", [1, 3, 8])
@pytest.mark.parametrize("layout", ["broadcast", "strided", "wide"])
@pytest.mark.parametrize("batch", K6_BATCHES)
def test_lookup_search_eq_paths_at_layouts(dev, search_libs, batch, layout, max_span):
    """A broadcast [1, w] query, rows at a stride above their width, and
    query limbs at and above 2^32 (a lane the tile path marks wide): the
    kernel on both paths equal to the plain version."""
    _, unsat, _, _ = _k6_check(_k6_args(batch, layout, max_span, dev), search_libs)
    if layout == "wide" and batch > 3:
        assert not bool(unsat[1]) and bool(unsat[3])   # 2^32 apart: no match; row 30 matches


@pytest.mark.parametrize("rows", [1, 127, 128, 129, K6_ROWS])
def test_lookup_fingerprint_at_tiles(dev, rows):
    """The fingerprint entry at the tile's edges, dense and at a row
    stride above the width, limbs outside [0, 2^32) included."""
    k6 = _k6_table()
    for layout in ("dense", "strided"):
        args = _k6_args(1, layout, 1, dev)
        parts = [t[:rows] for t in args[1]]
        before = L.LAUNCHES["lookup_fingerprint"]
        got = engine.lookup_fingerprint(parts, args[2])
        assert L.LAUNCHES["lookup_fingerprint"] == before + 1
        _equal(got, engine.fingerprint_plain(parts, args[2]))
    assert torch.equal(engine.fingerprint_plain(k6["table"], k6["coefs"])[k6["order"]], k6["fps"])


FP_TILED_ROWS = _source_define("lookup_search_eq.cu", "FP_TILED_ROWS")


@pytest.mark.parametrize("layout", ["dense", "strided"])
@pytest.mark.parametrize("rows", [FP_TILED_ROWS - 1, FP_TILED_ROWS, FP_TILED_ROWS + 129])
def test_lookup_fingerprint_both_paths(dev, rows, layout):
    """The fingerprint entry on both sides of its switch to staged tiles
    (FP_TILED_ROWS rows of the 67-limb table, which passes FP_TILED_LIMBS):
    the table's rows cycled, row 30's limbs at 2^40 + 7 and -5 included."""
    k6 = _k6_table()
    pick = torch.arange(rows) % K6_ROWS
    parts = [t[pick] for t in k6["table"]]
    if layout == "strided":   # a row stride above the width, made on the card
        parts = [torch.cat([t, torch.zeros((rows, 3), dtype=t.dtype)], 1).to(dev)[:, :t.shape[1]]
                 for t in parts]
    else:
        parts = [t.to(dev) for t in parts]
    coefs = k6["coefs"].to(dev)
    before = L.LAUNCHES["lookup_fingerprint"]
    got = engine.lookup_fingerprint(parts, coefs)
    assert L.LAUNCHES["lookup_fingerprint"] == before + 1
    _equal(got, engine.fingerprint_plain(parts, coefs))


# -- K11 at a batch of one, at the arithmetic block's 2048 lanes (small tile) and at
# the MUL group's 131072 (large tile), both variants

WORDMUL_SMALL_BATCH = _source_define("mul_add_words.cu", "WORDMUL_SMALL_BATCH")


def _word_rows(case, wide, lanes, layout, dev):
    """``word_mul_cases`` rows cycled to ``lanes`` lanes ([1, w] rows kept),
    dense or at a row stride above the width."""
    rows, _, _ = make_case(case, wide, n=min(lanes, 4096), seed=lanes)
    out = []
    for r in rows:
        if r.shape[0] > 1 or lanes == 1:
            r = r[torch.arange(lanes) % r.shape[0]]
        if layout == "strided":
            wide_r = torch.zeros((r.shape[0], r.shape[1] + 3), dtype=r.dtype, device=dev)
            wide_r[:, :r.shape[1]] = r.to(dev)
            out.append(wide_r[:, :r.shape[1]])
        else:
            out.append(r.to(dev))
    return out


@pytest.mark.parametrize("layout", ["dense", "strided"])
@pytest.mark.parametrize("case", ["random_valid", "random_fields", "constants", "widths",
                                  "carry_past_72_bits"])
@pytest.mark.parametrize("wide", [False, True], ids=["256", "512"])
@pytest.mark.parametrize("lanes", [1, 2048, 131072])
def test_mul_add_words_at_lanes(dev, lanes, wide, case, layout):
    rows = _word_rows(case, wide, lanes, layout, dev)
    assert (lanes < WORDMUL_SMALL_BATCH) == (lanes != 131072)   # both tiles run
    before = L.LAUNCHES["mul_add_words"]
    ok, overflow = word_mul.mul_add_words(rows, wide)
    assert L.LAUNCHES["mul_add_words"] == before + 1
    want_ok, want_over = word_mul.mul_add_words_plain(rows, wide)
    _equal(ok, want_ok.expand(ok.shape))
    if not wide:
        _equal(overflow, want_over.expand(overflow.shape))
    if case == "carry_past_72_bits" and lanes > 1:   # carry_lo 2^72 fails, 2^72 - 1 passes
        assert not bool(ok[0, 0]) and bool(ok[0, 1])


# -- K2's product, tile-staged: tile edges, either operand broadcast, any row
# stride; and K2's normalise-and-reduce entry

MUL_TILE = _source_define("limb_mul.cu", "MUL_TILE")
MUL_BATCHES = [1, MUL_TILE - 1, MUL_TILE, MUL_TILE + 1, 2048, 65535, 65536, 65537, 131072]
MUL_SHAPES = [(1, 16, 16), (16, 1, 17), (17, 17, 34), (5, 9, 3), (8, 16, 24), (16, 16, 32),
              (4, 4, 8), (17, 3, 20), (2, 2, 1)]


def _mul_operand(rng, lanes, n, layout, dev):
    """[lanes, n] limbs of values below 2^(16 n) (2^(16 n) - 1 and 0 first),
    dense, at an 8-byte offset, or a view of wider rows of even or odd
    stride."""
    vals = [int.from_bytes(rng.bytes(40), "little") % (1 << 16 * n) for _ in range(lanes)]
    vals[:2] = [(1 << 16 * n) - 1, 0][:lanes]
    t = L.ints_to_limbs(vals, n)
    if layout == "dense":
        return vals, t.to(dev)
    if layout == "misaligned":
        view = torch.zeros(lanes * n + 1, dtype=torch.int64, device=dev)[1:].view(lanes, n)
    else:
        wide = torch.zeros((lanes, n + (4 if layout == "strided" else 3)), dtype=torch.int64,
                           device=dev)
        view = wide[:, 2:2 + n] if layout == "strided" else wide[:, 1:1 + n]
    view.copy_(t.to(dev))
    return vals, view


@pytest.mark.parametrize("layout", ["dense", "misaligned", "strided", "strided_odd"])
@pytest.mark.parametrize("side", ["varying", "broadcast_a", "broadcast_b"])
@pytest.mark.parametrize("batch", MUL_BATCHES)
def test_limb_mul_tiles(dev, batch, side, layout):
    """K2's product at the tile's edges and up to 131072 lanes, one launch
    a call, equal to its plain version and (to 2048 lanes) to (a * b) mod
    2^(16 out_n) on Python ints."""
    rng = np.random.RandomState(batch + len(side) + len(layout))
    for na, nb, out_n in MUL_SHAPES:
        a_vals, a = _mul_operand(rng, 1 if side == "broadcast_a" else batch, na, layout, dev)
        b_vals, b = _mul_operand(rng, 1 if side == "broadcast_b" else batch, nb, layout, dev)
        before = L.LAUNCHES["limb_mul"]
        got = L.limb_mul(a, b, out_n)
        assert L.LAUNCHES["limb_mul"] == before + 1
        _equal(got, L.mul_plain(a, b, out_n))
        if batch <= 2048:
            a_vals = a_vals * batch if len(a_vals) == 1 else a_vals
            b_vals = b_vals * batch if len(b_vals) == 1 else b_vals
            want = [x * y % (1 << 16 * out_n) for x, y in zip(a_vals, b_vals)]
            assert L.limbs_to_ints(got.cpu()) == want, (na, nb, out_n)


def test_limb_mul_every_width_pair(dev):
    """Every (na, nb) of 1..17 at 33 lanes (a partial second tile), out_n
    the full product and the widest 34, against Python ints."""
    rng = np.random.RandomState(17)
    for na in range(1, 18):
        for nb in range(1, 18):
            a_vals, a = _mul_operand(rng, 33, na, "dense", dev)
            b_vals, b = _mul_operand(rng, 33, nb, "strided_odd", dev)
            for out_n in sorted({na + nb, 34}):
                got = L.limb_mul(a, b, out_n)
                _equal(got, L.mul_plain(a, b, out_n))
                want = [x * y % (1 << 16 * out_n) for x, y in zip(a_vals, b_vals)]
                assert L.limbs_to_ints(got.cpu()) == want, (na, nb, out_n)


def _reduce_columns(rng, rows, m, layout, dev):
    """[rows, m] columns below 2^32 (a row of 2^32 - 1, of 2^16 - 1 and of
    p's limbs first), dense or a view of wider rows."""
    cols = rng.randint(0, 1 << 32, size=(rows, m), dtype=np.uint64).astype(np.int64)
    edges = [[(1 << 32) - 1] * m, [(1 << 16) - 1] * m, [(fr.P >> 16 * k) & 0xFFFF for k in range(m)]]
    cols[:min(rows, 3)] = np.asarray(edges[:rows], dtype=np.int64)
    t = torch.from_numpy(cols)
    if layout == "dense":
        return cols, t.to(dev)
    wide = torch.zeros((rows, m + 3), dtype=torch.int64, device=dev)
    wide[:, 1:1 + m] = t.to(dev)
    return cols, wide[:, 1:1 + m]


@pytest.mark.parametrize("layout", ["dense", "strided"])
@pytest.mark.parametrize("reduce", [False, True], ids=["ripple", "reduce"])
@pytest.mark.parametrize("keep", [17, 32])
@pytest.mark.parametrize("rows", [1, 2, 3, 257])
def test_limb_reduce(dev, rows, keep, reduce, layout):
    """K2's normalise-and-reduce entry at m = 1..32 columns, one launch a
    call, equal to its plain version (``carry_propagate_plain``, or
    ``normalize_reduce_plain``) and to x' mod 2^(16 keep) (mod p, reduced)
    on Python ints."""
    rng = np.random.RandomState(rows * keep + reduce)
    for m in range(1, 33):
        cols, x = _reduce_columns(rng, rows, m, layout, dev)
        before = L.LAUNCHES["limb_reduce"]
        got = L.limb_reduce(x, keep, reduce)
        assert L.LAUNCHES["limb_reduce"] == before + 1
        want = fr.normalize_reduce_plain(x, keep) if reduce else L.carry_propagate_plain(x, keep)
        _equal(got, want)
        wide = [sum(int(c) << (16 * k) for k, c in enumerate(row[:keep])) % (1 << (16 * keep))
                for row in cols]
        assert L.limbs_to_ints(got.cpu()) == [v % fr.P if reduce else v for v in wide], m


def test_carry_propagate_and_reduce_wide_launch_the_entry(dev):
    """On the card ``L.carry_propagate`` (keep as asked, up to 34),
    ``fr.reduce_wide`` (keep 32) and ``fr.normalize_reduce`` are one launch
    of the entry each and launch no product."""
    rng = np.random.RandomState(5)
    _, x = _reduce_columns(rng, 5, 20, "dense", dev)
    product = L.ints_to_limbs([(fr.P - 1) ** 2, fr.P * 3, 7], 32).to(dev)
    for call, want in ((lambda: L.carry_propagate(x, 34), L.carry_propagate_plain(x, 34)),
                       (lambda: fr.reduce_wide(product), fr.reduce_wide_plain(product)),
                       (lambda: fr.normalize_reduce(x, 17), fr.normalize_reduce_plain(x, 17))):
        before = dict(L.LAUNCHES)
        got = call()
        launched = {k: L.LAUNCHES[k] - before.get(k, 0) for k in L.LAUNCHES}
        assert {k: v for k, v in launched.items() if v} == {"limb_reduce": 1}
        _equal(got, want)


# -- K5: warp and block edges, both sizes of the main path, strided views



def _order_cols_on_card(n, data, layout, dev):
    """The key columns of n rows at their declared widths, made on the card:
    random keys with runs of equal prefixes ("random"), keys ascending in
    rw_counter ("sorted"), or one key on every row ("equal", no Start row);
    else a Start row every 1000 rows from row 0; dense or views of wider
    rows."""
    gen = torch.Generator(device=dev).manual_seed(n + len(data))

    def limbs(w, used=None):
        t = torch.randint(0, 1 << 16, (n, w), device=dev, generator=gen)
        if used is not None:
            t[:, used:] = 0
        return t

    tag = torch.randint(2, 12, (n, 1), device=dev, generator=gen)
    cols = [tag, limbs(2), limbs(16, 10), limbs(1), limbs(8), limbs(8), limbs(2)]
    if data == "random":
        runs = torch.arange(n, device=dev) // 3 * 3       # rows of a run of 3 share a prefix
        for c in cols[:6]:
            c.copy_(c[runs])
    elif data in ("sorted", "equal"):
        for c in cols:
            c.copy_(c[:1].expand_as(c))
        if data == "sorted":
            i = torch.arange(n, device=dev)
            cols[6][:, 0], cols[6][:, 1] = i & 0xFFFF, i >> 16
    if data != "equal":
        cols[0][::1000] = 1
    if layout == "strided":
        out = []
        for c in cols:
            wide = torch.zeros((n, c.shape[1] + 3), dtype=torch.int64, device=dev)
            wide[:, 1:1 + c.shape[1]] = c
            out.append(wide[:, 1:1 + c.shape[1]])
        cols = out
    return cols


def _order_ints(cols):
    from zkevm_specs_tpu_torch.circuits import state

    keys = L.limbs_to_ints(state.order_key_plain(*[c.cpu() for c in cols]))
    tags = cols[0][:, 0].cpu().tolist()
    return [keys[i - 1] < keys[i] or tags[i] == 1 for i in range(len(keys))]


@pytest.mark.parametrize("layout", ["dense", "strided"])
@pytest.mark.parametrize("data", ["random", "sorted", "equal"])
@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 127, 128, 129, 255, 256, 257, 2 ** 19, 528369])
def test_state_order_lt_tiles(dev, n, data, layout):
    """K5 at row counts about a warp and a block and at the state (2^19)
    and block (528369) checks' sizes, one launch a call, equal to its plain
    version and (to 257 rows) to the keys compared as Python ints."""
    from zkevm_specs_tpu_torch.circuits import state

    cols = _order_cols_on_card(n, data, layout, dev)
    before = L.LAUNCHES["state_order_lt"]
    got = state.state_order_lt(*cols)
    assert L.LAUNCHES["state_order_lt"] == before + 1
    _equal(got, state.state_order_lt_plain(*cols))
    if n <= 257:
        assert got.cpu().tolist() == _order_ints(cols)
    if data == "sorted" and n > 1:
        assert bool(got[1:].all())
    if data == "equal":
        assert not bool(got.any())
