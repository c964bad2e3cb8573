"""The tile mappings of kernels K3 (``csrc/limb_addsub.cu``), K4
(``csrc/lookup_gather_eq.cu``), K1 (``csrc/fr_mul.cu``, K3's staging at
16 limbs), K6 (``csrc/lookup_search_eq.cu``: its query tile, its sweep of
the candidates and both paths' searches), K11
(``csrc/mul_add_words.cu``: K3's staging into 16-bit halves), K2's product
(``csrc/limb_mul.cu``: K3's staging at the operands' limb caps, a
flattened store) and K5 (``csrc/state_order_lt.cu``: a row's loads and the
previous row's key across a warp) on the CPU:
a Python model of each kernel's
index arithmetic, with the tile sizes, the pitch, the division by a
reciprocal and the choice of instance read from the sources, walked over
every thread of a tile at each width and tile edge.  It checks that every
(lane, limb) is loaded and stored exactly once, that 16-byte accesses sit
on 16-byte boundaries and never straddle two rows they should not, and
that a warp reading limb k of its lanes' staged rows hits 32 distinct
shared-memory banks (4-byte words, so one phase of 32 threads)."""
from bisect import bisect_left
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from limb_tile_cases import (ADDSUB_DIRECT_WIDTH, ADDSUB_MAX_LIMBS, ADDSUB_MAX_UNROLLED,
                             ADDSUB_SOURCE, ADDSUB_TILE, GATHER_SOURCE, GATHER_THREADS,
                             GATHER_TILE, GATHER_UNROLL, addsub_pitch, addsub_staged, define)

torch.set_num_threads(1)

WARP, BANKS = 32, 32
CSRC = Path(__file__).resolve().parents[1] / "zkevm_specs_tpu_torch" / "csrc"
# div_by, host_magic and the row staging (stage_rows) K1 and K11 share
COMMON_SOURCE = (CSRC / "limb_common.cuh").read_text()


def test_sources_state_the_modelled_rules():
    """The lines the model below mirrors, as the sources write them."""
    assert "return n == 1 ? e : (int)__umulhi((unsigned)e, magic);" in COMMON_SOURCE
    assert "return n <= 1 ? 0u : 0xFFFFFFFFu / (unsigned)n + 1u;" in COMMON_SOURCE
    for name in ("limb_addsub.cu", "lookup_gather_eq.cu", "fr_mul.cu", "lookup_search_eq.cu",
                 "mul_add_words.cu"):
        source = (CSRC / name).read_text()
        assert "int div_by(" not in source and "unsigned host_magic(" not in source, name
    for source in (ADDSUB_SOURCE, GATHER_SOURCE):
        assert '#include "limb_common.cuh"' in source
    assert "constexpr int addsub_pitch(int w) { return w | 1; }" in ADDSUB_SOURCE
    assert "template <int MODE, int W = ADDSUB_DIRECT_WIDTH + 1>" in ADDSUB_SOURCE
    assert ("if (g.a.stride == 0 && g.b.stride == 0) return launch_direct<MODE>(g, stream);"
            in ADDSUB_SOURCE)
    assert "if (g.batch < ADDSUB_TILE) return launch_direct<MODE, W>(g, stream);" in ADDSUB_SOURCE
    assert "if (W == 0 || g.batch < ADDSUB_TILE) {" in ADDSUB_SOURCE
    assert ("if constexpr (W > ADDSUB_MAX_UNROLLED) {\n    return launch_direct<MODE>(g, stream);"
            in ADDSUB_SOURCE)
    assert "return g.width == W ? launch_staged<MODE, W>(g, stream)" in ADDSUB_SOURCE
    assert "case MODE_FR_ADD: return (int)launch_staged<MODE_FR_ADD, 17>(g, s);" in ADDSUB_SOURCE
    assert "x.span = stride == n ? n : x.copy;" in ADDSUB_SOURCE
    assert ("x.vec = aligned && (stride == n || (stride % 2 == 0 && x.span % 2 == 0));"
            in ADDSUB_SOURCE)
    assert "for (int e = 2 * tid; e < total; e += 2 * nt) {" in ADDSUB_SOURCE
    assert "for (int f = 2 * t; f < total; f += 2 * tile) {" in ADDSUB_SOURCE
    assert ("const unsigned blocks = (unsigned)((batch + GATHER_TILE - 1) / GATHER_TILE);"
            in GATHER_SOURCE)
    assert GATHER_SOURCE.count("<<<") == 1
    assert ("for (int e0 = t; e0 < total; e0 += GATHER_UNROLL * GATHER_THREADS) {"
            in GATHER_SOURCE)
    assert "const int e = e0 + u * GATHER_THREADS;" in GATHER_SOURCE
    assert "for (int l = t; l < lanes; l += GATHER_THREADS) {" in GATHER_SOURCE
    assert "parts.span[p] = parts.query[p] == nullptr || tw > qw ? tw : qw;" in GATHER_SOURCE
    assert "long long row = i < 0 ? i + n_rows : i;" in GATHER_SOURCE


def magic(n):
    return 0 if n <= 1 else 0xFFFFFFFF // n + 1


def div_by(e, n):
    return e if n == 1 else (e * magic(n)) >> 32


@pytest.mark.parametrize("tile,spans", [(ADDSUB_TILE, range(1, ADDSUB_MAX_LIMBS + 1)),
                                        (GATHER_TILE, list(range(1, 65)) + [127, 997, 1024])])
def test_reciprocal_division_is_exact(tile, spans):
    """div_by at every element index a tile of ``tile`` lanes sweeps."""
    for n in spans:
        e = np.arange(tile * n, dtype=np.uint64)
        got = e if n == 1 else (e * np.uint64(magic(n))) >> np.uint64(32)
        assert np.array_equal(got, e // np.uint64(n)), n


# -- K3 --------------------------------------------------------------------------------

def operand(stride, n, width, aligned):
    copy = min(n, width)
    span = n if stride == n else copy
    vec = aligned and (stride == n or (stride % 2 == 0 and span % 2 == 0))
    return copy, span, vec


def stage(stride, n, width, aligned, lanes, tile):
    """K3's stage() for one operand over every thread of a tile: the
    device elements it loads (by lane and limb) and the staged words it
    writes, checked as it goes."""
    copy, span, vec = operand(stride, n, width, aligned)
    pitch = addsub_pitch(width)
    loads, writes = Counter(), Counter()
    if stride == 0:
        for tid in range(tile):
            for k in range(tid, width, tile):
                writes[0, k] += 1
                if k < copy:
                    loads[0, k] += 1
        return loads, writes
    total = lanes * span
    for tid in range(tile):
        for e in range(2 * tid, total, 2 * tile):
            lane = div_by(e, span)
            k = e - lane * span
            lane1, k1 = (lane, k + 1) if k + 1 < span else (lane + 1, 0)
            addr = lane * stride + k
            if vec and e + 1 < total:
                # one 16-byte load: an even element offset from the aligned
                # base (a tile starts at an even lane), the pair adjacent
                if stride == n:
                    assert e % 2 == 0
                else:
                    assert stride % 2 == 0 and addr % 2 == 0
                assert lane1 * stride + k1 == addr + 1
            loads[lane, k] += 1
            if e + 1 < total:
                loads[lane1, k1] += 1
            if k < copy:
                writes[lane, k] += 1
            if e + 1 < total and k1 < copy:
                writes[lane1, k1] += 1
    for tid in range(tile):
        for lane in range(tid, lanes, tile):
            for k in range(copy, width):
                writes[lane, k] += 1
    assert all(pitch * lane + k < lanes * pitch for lane, k in writes)
    return loads, writes


def store(out_n, width, lanes, tile, pitch=None):
    """K3's flattened store over every thread: the output elements it
    writes and the staged words it reads (K2's product stores the same
    way from rows of ``pitch`` words)."""
    pitch = addsub_pitch(width) if pitch is None else pitch
    stores, reads = Counter(), Counter()
    total = lanes * out_n
    for t in range(tile):
        for f in range(2 * t, total, 2 * tile):
            lane = div_by(f, out_n)
            k = f - lane * out_n
            lane1, k1 = (lane, k + 1) if k + 1 < out_n else (lane + 1, 0)
            assert f % 2 == 0                       # a 16-byte store on an even element
            stores[lane, k] += 1
            reads[lane * pitch + k] += 1
            if f + 1 < total:
                stores[lane1, k1] += 1
                reads[lane1 * pitch + k1] += 1
    return stores, reads


def chain_banks_conflict_free(width, tile):
    """A warp's threads read (and write) word t * pitch + k of the tile for
    each limb k: 32 distinct banks."""
    pitch = addsub_pitch(width)
    for w0 in range(0, tile, WARP):
        for k in range(width):
            banks = {((w0 + t) * pitch + k) % BANKS for t in range(WARP)}
            if len(banks) != WARP:
                return False
    return True


# the widths the staged instance runs
K3_WIDTHS = list(range(ADDSUB_DIRECT_WIDTH + 1, ADDSUB_MAX_UNROLLED + 1))


@pytest.mark.parametrize("width", K3_WIDTHS)
def test_addsub_pitch_is_free_of_bank_conflicts(width):
    assert addsub_pitch(width) % 2 == 1 and addsub_pitch(width) >= width
    assert chain_banks_conflict_free(width, ADDSUB_TILE)


@pytest.mark.parametrize("layout", ["dense", "strided_even", "strided_odd", "broadcast",
                                    "misaligned"])
@pytest.mark.parametrize("width", K3_WIDTHS)
def test_addsub_tile_loads_and_stores_every_limb_once(width, layout):
    tile = ADDSUB_TILE
    for n in sorted({1, max(1, width - 1), width, min(width + 3, ADDSUB_MAX_LIMBS)}):
        stride = {"dense": n, "misaligned": n, "broadcast": 0, "strided_even": n + 2 - n % 2,
                  "strided_odd": n + 1 + n % 2}[layout]
        copy = min(n, width)
        for lanes in sorted({1, tile - 1, tile}):
            loads, writes = stage(stride, n, width, layout != "misaligned", lanes, tile)
            rows = 1 if stride == 0 else lanes
            assert set(writes) == {(lane, k) for lane in range(rows) for k in range(width)}
            assert set(writes.values()) == {1}
            assert set(loads.values()) == {1}
            assert {(lane, k) for lane, k in loads if k < copy} == {
                (lane, k) for lane in range(rows) for k in range(copy)}
            for out_n in sorted({1, width}):
                stores, reads = store(out_n, width, lanes, tile)
                assert set(stores) == {(lane, k) for lane in range(lanes) for k in range(out_n)}
                assert set(stores.values()) == {1}
                assert set(reads.values()) == {1}


def test_addsub_staged_tile_fits_shared_memory():
    for width in K3_WIDTHS:
        words = 2 * ADDSUB_TILE * addsub_pitch(width)
        assert words * 4 <= 48 * 1024, width


@pytest.mark.parametrize("width", [1, 2, 3, 16, 17, 18, 64])
def test_addsub_instance_threshold(width):
    """A batch under one tile runs direct, as do a chain of
    ADDSUB_DIRECT_WIDTH limbs or fewer, one wider than ADDSUB_MAX_UNROLLED
    and two broadcast rows."""
    tile = ADDSUB_TILE
    staged = width in K3_WIDTHS
    assert addsub_staged(1, width, width, width) is False
    assert addsub_staged(tile - 1, width, width, 0) is False
    assert addsub_staged(tile, width, width, width) is staged
    assert addsub_staged(tile + 1, width, 0, width) is staged
    assert addsub_staged(tile + 1, width, 0, 0) is False


# -- K4 --------------------------------------------------------------------------------

def gather_tile(parts, lanes):
    """K4's staged loop over every thread of a block, for parts (tw, qw)
    (qw None: gather only): table reads, gathered stores, query reads and
    compares by (part, lane, limb)."""
    reads, stores, qreads, compares = Counter(), Counter(), Counter(), Counter()
    for p, (tw, qw) in enumerate(parts):
        span = tw if qw is None or tw > qw else qw
        total = lanes * span
        for t in range(GATHER_THREADS):
            for e0 in range(t, total, GATHER_UNROLL * GATHER_THREADS):
                for u in range(GATHER_UNROLL):
                    e = e0 + u * GATHER_THREADS
                    if e >= total:
                        break
                    lane = div_by(e, span)
                    k = e - lane * span
                    if k < tw:
                        reads[p, lane, k] += 1
                        stores[p, lane, k] += 1
                    if qw is not None:
                        compares[p, lane, k] += 1
                        if k < qw:
                            qreads[p, lane, k] += 1
    return reads, stores, qreads, compares


@pytest.mark.parametrize("parts", [[(1, 1)], [(8, 8), (8, 8), (1, 1), (4, 16), (1, 1)],
                                   [(16, 2), (2, 16), (8, None)], [(8, None)] * 14,
                                   [(w, w) for w in (1, 2, 4, 8, 16)] * 3 + [(3, None)]])
def test_gather_tile_visits_every_limb_once(parts):
    for lanes in (1, GATHER_TILE - 1, GATHER_TILE):
        reads, stores, qreads, compares = gather_tile(parts, lanes)
        want_t = {(p, lane, k) for p, (tw, _) in enumerate(parts)
                  for lane in range(lanes) for k in range(tw)}
        want_q = {(p, lane, k) for p, (_, qw) in enumerate(parts) if qw is not None
                  for lane in range(lanes) for k in range(qw)}
        want_c = {(p, lane, k) for p, (tw, qw) in enumerate(parts) if qw is not None
                  for lane in range(lanes) for k in range(max(tw, qw))}
        for got, want in ((reads, want_t), (stores, want_t), (qreads, want_q),
                          (compares, want_c)):
            assert set(got) == want and set(got.values()) <= {1}


def test_gather_flat_store_is_coalesced():
    """A warp's 32 consecutive elements of a part store to 32 consecutive
    gathered limbs: lane * tw + k is the element index itself."""
    for tw in (1, 2, 4, 8, 16):
        for e in range(GATHER_TILE * tw):
            lane = div_by(e, tw)
            assert lane * tw + (e - lane * tw) == e


def assert_staged_rows_rules():
    """limb_common.cuh's staged_row and stage_rows (K1, K11) state the
    rules ``stage`` above models: span and copy, the 16-byte rule, pairs of
    elements a thread, halves or words written only below copy, zero from
    copy up to the limbs a row keeps."""
    c = COMMON_SOURCE
    for line in ("x.copy = n < limbs ? n : limbs;",
                 "x.span = stride == n ? n : x.copy;",
                 "x.magic = host_magic(x.span);",
                 "x.vec = aligned && (stride == n || (stride % 2 == 0 && x.span % 2 == 0));",
                 "for (int e = 2 * tid; e < total; e += 2 * nt) {",
                 "const int lane = div_by(e, x.span, x.magic);",
                 "if (k < x.copy) s[lane * pitch + k] = (T)v0;",
                 "if (e + 1 < total && k1 < x.copy) s[lane1 * pitch + k1] = (T)v1;",
                 "for (int k = x.copy; k < limbs; ++k) s[lane * pitch + k] = (T)0;",
                 "for (int k = tid; k < limbs; k += nt) s[k] = k < x.copy ? (T)x.p[k] : (T)0;"):
        assert line in c, line


# -- K1 (csrc/fr_mul.cu): K3's staging at a width of 16 limbs ------------------------

FRMUL_SOURCE = (Path(__file__).resolve().parents[1] / "zkevm_specs_tpu_torch" / "csrc"
                / "fr_mul.cu").read_text()
FRMUL_TILE = define(FRMUL_SOURCE, "FRMUL_TILE")
FRMUL_PITCH = define(FRMUL_SOURCE, "FRMUL_PITCH")


def test_fr_mul_source_states_the_modelled_rules():
    """K1 stages its rows as K3's stage() does at a width of 16 (copy and
    span are n <= 16), through limb_common.cuh's stage_rows in 32-bit
    words, and stores rows of 16 limbs two at a time."""
    assert '#include "fr_mont.cuh"' in FRMUL_SOURCE
    assert "g.a = staged_row(a, sa, na, FR_LIMBS);" in FRMUL_SOURCE
    assert "g.b = staged_row(b, sb, nb, FR_LIMBS);" in FRMUL_SOURCE
    assert "stage_rows(g.a, sa, base, lanes, FRMUL_PITCH, FR_LIMBS);" in FRMUL_SOURCE
    assert "stage_rows(g.b, sb, base, lanes, FRMUL_PITCH, FR_LIMBS);" in FRMUL_SOURCE
    assert "__shared__ uint32_t sa[FRMUL_TILE * FRMUL_PITCH];" in FRMUL_SOURCE
    assert_staged_rows_rules()
    assert "for (int f = 2 * t; f < total; f += 2 * FRMUL_TILE) {" in FRMUL_SOURCE
    assert "const int lane = one ? 0 : f / FR_LIMBS, k = f % FR_LIMBS;" in FRMUL_SOURCE
    # two broadcast rows: thread 0 alone forms the product, in row 0
    assert "const bool one = g.a.stride == 0;" in FRMUL_SOURCE
    assert "if (one ? t == 0 : t < lanes) {" in FRMUL_SOURCE
    assert FRMUL_PITCH == addsub_pitch(16)
    assert 2 * FRMUL_TILE * FRMUL_PITCH * 4 <= 48 * 1024
    assert chain_banks_conflict_free(16, FRMUL_TILE)


@pytest.mark.parametrize("layout", ["dense", "strided_even", "strided_odd", "broadcast",
                                    "misaligned"])
@pytest.mark.parametrize("n", [1, 2, 3, 15, 16])
def test_fr_mul_tile_loads_and_stores_every_limb_once(n, layout):
    stride = {"dense": n, "misaligned": n, "broadcast": 0, "strided_even": n + 2 - n % 2,
              "strided_odd": n + 1 + n % 2}[layout]
    for lanes in sorted({1, FRMUL_TILE - 1, FRMUL_TILE}):
        loads, writes = stage(stride, n, 16, layout != "misaligned", lanes, FRMUL_TILE)
        rows = 1 if stride == 0 else lanes
        assert set(writes) == {(lane, k) for lane in range(rows) for k in range(16)}
        assert set(writes.values()) == {1} and set(loads.values()) == {1}
        assert set(loads) == {(lane, k) for lane in range(rows) for k in range(n)}
        stores, reads = store(16, 16, lanes, FRMUL_TILE)
        assert set(stores) == {(lane, k) for lane in range(lanes) for k in range(16)}
        assert set(stores.values()) == {1} and set(reads.values()) == {1}


# -- K6 (csrc/lookup_search_eq.cu): the staged parts, the sweep, the searches -----

SEARCH_SOURCE = (Path(__file__).resolve().parents[1] / "zkevm_specs_tpu_torch" / "csrc"
                 / "lookup_search_eq.cu").read_text()
SEARCH_TILE = define(SEARCH_SOURCE, "SEARCH_TILE")
SEARCH_THREADS = define(SEARCH_SOURCE, "SEARCH_THREADS")
SEARCH_UNROLL = define(SEARCH_SOURCE, "SEARCH_UNROLL")
SEARCH_CANDIDATES = define(SEARCH_SOURCE, "SEARCH_CANDIDATES")
SEARCH_STAGE_UNROLL = define(SEARCH_SOURCE, "STAGE_UNROLL")
FP_TILE = define(SEARCH_SOURCE, "FP_TILE")
FP_PITCH = define(SEARCH_SOURCE, "FP_PITCH")
FP_PAIRS = define(SEARCH_SOURCE, "FP_PAIRS")


def test_search_source_states_the_modelled_rules():
    """The lines the K6 model below mirrors, as the source writes them: the
    parts staged as one range of pairs (every limb, rows of w at pitch
    w | 1), the candidates listed and swept as one range, the two
    searches and the paths' switch."""
    s = SEARCH_SOURCE
    assert '#include "limb_common.cuh"' in s
    for line in (
            "parts.svec[p] = ((uintptr_t)parts.staged[p] & 15) == 0 &&\n"
            "                    (stride == n || (stride % 2 == 0 && n % 2 == 0));",
            "parts.pitch[p] = 2 * (((n + 1) >> 1) | 1);",
            "const int e = 2 * (threadIdx.x + j * FP_TILE);",
            "s[lane * FP_PITCH + k] = v[j].x;",
            "if (rows >= FP_TILED_ROWS && parts.elems[MAX_PARTS] >= FP_TILED_LIMBS) {",
            "f0[u] = stride == 0 ? fp_bcast : fp + lane;",
            "f1[u] = stride == 0 ? fp_bcast : fp + lane1;",
            "const uint64_t fp = sl.fp[t] + sl.fp_bcast;",
            "if (live) offset += (stride == 0 ? 1 : tile) * parts.pitch[p];",
            "? ((parts.staged_stride[q] == 0 ? 1 : lanes) * parts.staged_w[q] + 1) >> 1",
            "for (int i0 = threadIdx.x;; i0 += STAGE_UNROLL * nt) {",
            "const int i = i0 + u * nt;",
            "const int e = 2 * (i - first);",
            "if (sl.start[m] <= c0 + c) a = m; else b = m;",
            "sl.cand_row[c] = (int)order[sl.lo[a] + (c0 + c - sl.start[a])];",
            "for (int e0 = t; e0 < total; e0 += SEARCH_UNROLL * SEARCH_THREADS) {",
            "const int e = e0 + u * SEARCH_THREADS;",
            "cand[u] = e < total ? div_by(e, row_elems, parts.elems_magic) : -1;",
            "if (fps[mid] < fp) lo = mid + 1; else hi = mid;",
            "while (hi - lo > 32) {",
            "const bool below = fps[lo + (t + 1) * n / 33] < fp;",
            "const long long new_lo = c == 0 ? lo : lo + c * n / 33 + 1;",
            "hi = c == 32 ? hi : lo + (c + 1) * n / 33;",
            "lo += __popc(__ballot_sync(FULL, lo + t < hi && fps[lo + t] < fp));",
            "if (batch < SEARCH_WARP_BATCH) {",
            "if (batch < SEARCH_TILE_BATCH || limbs < SEARCH_TILE_LIMBS) {"):
        assert line in s, line


def stage_flat(parts, lanes, threads, unroll):
    """The flattened staging of K6 (``stage_parts``) over every thread:
    parts (stride, n, span, copy, aligned), part p's element e (lane e //
    span, limb e % span) for e <
    rows_p * span, rows_p 1 where the stride is 0; the pairs of all parts
    one range walked by each thread's cursor, ``unroll`` pairs a step.
    Returns the loads and the staged writes (k < copy) by (part, lane,
    limb); asserts each 16-byte load aligned and within its row."""
    loads, writes = Counter(), Counter()

    def pairs_of(q):
        if q >= len(parts):
            return 0
        stride, _, span, _, _ = parts[q]
        return ((1 if stride == 0 else lanes) * span + 1) >> 1

    for tid in range(threads):
        p, first, pairs = 0, 0, pairs_of(0)
        i0 = tid
        while True:
            step = []
            for u in range(unroll):
                i = i0 + u * threads
                while p < len(parts) and i >= first + pairs:
                    first += pairs
                    p += 1
                    pairs = pairs_of(p)
                step.append((p, i - first))
            if step[0][0] >= len(parts):
                break
            for q, pair in step:
                if q >= len(parts):
                    break
                stride, n, span, copy, aligned = parts[q]
                total = (1 if stride == 0 else lanes) * span
                e = 2 * pair
                lane = div_by(e, span)
                k = e - lane * span
                lane1, k1 = (lane, k + 1) if k + 1 < span else (lane + 1, 0)
                vec = aligned and (stride == n or (stride % 2 == 0 and span % 2 == 0))
                if vec and e + 1 < total:
                    addr = lane * stride + k
                    assert addr % 2 == 0 and lane1 * stride + k1 == addr + 1
                for ln, kk, live in ((lane, k, True), (lane1, k1, e + 1 < total)):
                    if live:
                        loads[q, ln, kk] += 1
                        if kk < copy:
                            writes[q, ln, kk] += 1
            i0 += unroll * threads
    return loads, writes


LAYOUTS = ["dense", "strided_even", "strided_odd", "broadcast", "misaligned"]


def _stride(layout, n):
    return {"dense": n, "misaligned": n, "broadcast": 0, "strided_even": n + 2 - n % 2,
            "strided_odd": n + 1 + n % 2}[layout]


def search_pitch(w):
    """Halves a staged query row of w limbs takes: an odd count of words."""
    return 2 * (((w + 1) >> 1) | 1)


@pytest.mark.parametrize("widths", [[1], [2, 16, 8], [16] * 12, [3, 1, 16, 2, 9], [16] * 16])
def test_search_parts_stage_every_limb_once(widths):
    """K6's stage_parts at SEARCH_THREADS threads: every (part, lane, limb)
    of the query loaded and staged once, each part in every layout; a
    lane's staged row of w limbs read bank-free (limb k of 32 lanes in 32
    distinct 4-byte words a bank each)."""
    for shift in range(len(LAYOUTS)):
        layouts = [LAYOUTS[(p + shift) % len(LAYOUTS)] for p in range(len(widths))]
        parts = [(_stride(lay, n), n, n, n, lay != "misaligned") for lay, n in zip(layouts, widths)]
        for lanes in sorted({1, 31, SEARCH_TILE - 1, SEARCH_TILE}):
            loads, writes = stage_flat(parts, lanes, SEARCH_THREADS, SEARCH_STAGE_UNROLL)
            want = {(p, lane, k) for p, (stride, n, _, _, _) in enumerate(parts)
                    for lane in range(1 if stride == 0 else lanes) for k in range(n)}
            assert set(loads) == set(writes) == want
            assert set(loads.values()) == set(writes.values()) == {1}
    for w in set(widths):
        pitch = search_pitch(w)
        assert pitch % 4 == 2 and pitch >= w
        for w0 in range(0, SEARCH_TILE, WARP):
            for k in range(w):
                words = {((w0 + t) * pitch + k) // 2 for t in range(WARP)}
                assert len({word % BANKS for word in words}) == WARP


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", [1, 2, 3, 8, 15, 16])
def test_fingerprint_part_loads_every_limb_once(n, layout):
    """The fingerprint entry's fp_load/fp_store of one part: thread t's
    pairs j (element 2 * (t + j * FP_TILE), FP_PAIRS of them) cover every
    (row, limb) of the tile once, 16-byte loads aligned within a row, the
    staged rows at FP_PITCH 64-bit words read bank-free (a half-warp a
    phase)."""
    stride = _stride(layout, n)
    aligned = layout != "misaligned"
    vec = aligned and (stride == n or (stride % 2 == 0 and n % 2 == 0))
    for lanes in sorted({1, FP_TILE - 1, FP_TILE}):
        total = (1 if stride == 0 else lanes) * n
        seen = Counter()
        for t in range(FP_TILE):
            for j in range(FP_PAIRS):
                e = 2 * (t + j * FP_TILE)
                if e >= total:
                    break
                lane = div_by(e, n)
                k = e - lane * n
                lane1, k1 = (lane, k + 1) if k + 1 < n else (lane + 1, 0)
                if vec and e + 1 < total:
                    addr = lane * stride + k
                    assert addr % 2 == 0 and lane1 * stride + k1 == addr + 1
                seen[lane, k] += 1
                if e + 1 < total:
                    seen[lane1, k1] += 1
        rows = 1 if stride == 0 else lanes
        assert set(seen) == {(lane, k) for lane in range(rows) for k in range(n)}
        assert set(seen.values()) == {1}
    assert FP_PITCH % 2 == 1 and FP_PITCH >= 16 and 2 * FP_TILE * FP_PAIRS >= FP_TILE * 16
    for w0 in range(0, FP_TILE, WARP // 2):
        for k in range(16):
            pairs = {(2 * ((w0 + t) * FP_PITCH + k)) % BANKS for t in range(WARP // 2)}
            assert len(pairs) == WARP // 2


def test_search_staged_rows_fit_shared_memory():
    """Sixteen parts of 16 limbs, the widest query, fit one block's shared
    memory (227 KB) as 16-bit halves beside the lanes' state; the
    fingerprint's tile of one part fits 48 KB."""
    assert 16 * SEARCH_TILE * search_pitch(16) * 2 + 16 * 1024 <= 227 * 1024
    assert FP_TILE * FP_PITCH * 8 <= 48 * 1024


def search_sweep(spans, ncand):
    """The tile path's candidate list and sweep over every thread: the
    lanes' candidates listed after a prefix sum, SEARCH_CANDIDATES at a
    time, each listed candidate's lane found by the fill's binary search,
    then the list's candidates x padded row elements swept as one range.
    Returns the (lane, rank, part, limb) elements compared."""
    lanes = len(ncand)
    start = [sum(ncand[:lane]) for lane in range(lanes)]
    listed = sum(ncand)
    elems = [(p, k) for p, span in enumerate(spans) for k in range(span)]
    row = len(elems)
    seen = Counter()
    for c0 in range(0, listed, SEARCH_CANDIDATES):
        in_list = min(SEARCH_CANDIDATES, listed - c0)
        lane_of = []
        for c in range(in_list):
            a, b = 0, lanes
            while b - a > 1:
                m = (a + b) >> 1
                a, b = (m, b) if start[m] <= c0 + c else (a, m)
            assert start[a] <= c0 + c < start[a] + ncand[a]
            lane_of.append((a, c0 + c - start[a]))
        total = in_list * row
        for t in range(SEARCH_THREADS):
            for e0 in range(t, total, SEARCH_UNROLL * SEARCH_THREADS):
                for u in range(SEARCH_UNROLL):
                    e = e0 + u * SEARCH_THREADS
                    if e >= total:
                        break
                    c = div_by(e, row)
                    seen[(*lane_of[c], *elems[e - c * row])] += 1
    return seen


@pytest.mark.parametrize("spans", [[1], [2, 16, 8], [16] * 12, [3, 1, 16, 2, 9], [16] * 16])
def test_search_sweep_compares_every_candidate_limb_once(spans):
    rng = np.random.RandomState(len(spans))
    for lanes, most in ((1, 8), (SEARCH_TILE - 1, 3), (SEARCH_TILE, 8), (SEARCH_TILE, 1)):
        ncand = list(rng.randint(0, most + 1, size=lanes))
        seen = search_sweep(spans, ncand)
        want = {(lane, s, p, k) for lane in range(lanes) for s in range(ncand[lane])
                for p, span in enumerate(spans) for k in range(span)}
        assert set(seen) == want and set(seen.values()) <= {1}


def binary_search(keys, fp):
    """The tile path's search: one thread a lane, the range halved."""
    lo, hi, loads = 0, len(keys), 0
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        loads += 1
        if keys[mid] < fp:
            lo = mid + 1
        else:
            hi = mid
    return lo, loads


def warp_search(keys, fp):
    """The warp path's search: 32 probes at lo + (t + 1) * n // 33 narrow
    [lo, hi] 33-fold a step (the probes' answers a prefix, counted by the
    ballot), then one probe a slot of the last 32; the invariant that the
    lower bound lies in [lo, hi] is checked at every step."""
    want = bisect_left(keys, fp)
    lo, hi, steps = 0, len(keys), 0
    while hi - lo > 32:
        n = hi - lo
        probes = [lo + (t + 1) * n // 33 for t in range(32)]
        assert all(lo <= q < hi for q in probes) and probes == sorted(set(probes))
        below = [keys[q] < fp for q in probes]
        c = sum(below)
        assert below == [True] * c + [False] * (32 - c)
        lo, hi = ((lo if c == 0 else lo + c * n // 33 + 1),
                  (hi if c == 32 else lo + (c + 1) * n // 33))
        assert lo <= want <= hi and hi - lo <= n // 33 + 1
        steps += 1
    lo += sum(lo + t < hi and keys[lo + t] < fp for t in range(32))
    return lo, steps + 1


def _keys(T, seed):
    """T sorted keys with runs (few distinct values where T is large)."""
    rng = np.random.RandomState(seed)
    return sorted(int(v) for v in rng.randint(0, max(2, T // 3), size=T))


def _targets(keys):
    picks = [keys[0], keys[len(keys) // 2], keys[-1]]
    return sorted({-1, keys[-1] + 1, *picks, *(v + 1 for v in picks)})


def test_searches_find_the_candidate_run_at_every_small_table():
    """Both paths' searches give the lower bound, the first slot of the
    candidate run (or past every smaller key), at every T in 1..4096; the
    binary search in ceil(log2(T + 1)) loads, the warp's in at most
    ceil(log33(T)) + 1 rounds."""
    for T in range(1, 4097):
        keys = _keys(T, T)
        for fp in _targets(keys):
            want = bisect_left(keys, fp)
            lo, loads = binary_search(keys, fp)
            assert lo == want and loads <= T.bit_length(), (T, fp)
            lo, steps = warp_search(keys, fp)
            assert lo == want, (T, fp)
            assert steps <= 1 + next(k for k in range(8) if 33 ** k * 32 >= T), (T, steps)


def test_searches_at_the_storage_index():
    """At the Storage/Account mix's 524287-row index: 19 loads against 5
    rounds."""
    keys = _keys(524287, 7)
    for fp in _targets(keys):
        want = bisect_left(keys, fp)
        lo, loads = binary_search(keys, fp)
        assert lo == want and loads <= 19
        lo, steps = warp_search(keys, fp)
        assert lo == want and steps <= 5


# -- K11 (csrc/mul_add_words.cu): K1's staging into 16-bit halves -----------------

WORDMUL_SOURCE = (Path(__file__).resolve().parents[1] / "zkevm_specs_tpu_torch" / "csrc"
                  / "mul_add_words.cu").read_text()
WORDMUL_THREADS = define(WORDMUL_SOURCE, "WORDMUL_THREADS")
WORDMUL_TILE = define(WORDMUL_SOURCE, "WORDMUL_TILE")
WORDMUL_SMALL_TILE = define(WORDMUL_SOURCE, "WORDMUL_SMALL_TILE")
QUARTER_PITCH = define(WORDMUL_SOURCE, "QUARTER_PITCH")
FIELD_PITCH = define(WORDMUL_SOURCE, "FIELD_PITCH")


def test_word_mul_source_states_the_modelled_rules():
    """K11's rows are staged as K3 stages an operand at a width of 8
    limbs (a, b) or 16 (c, d, e), each limb a 16-bit half of a word."""
    s = WORDMUL_SOURCE
    assert ("g.row[k] = staged_row((const void*)desc[k], desc[N_OPERANDS + k], n,\n"
            "                          k < N_QUARTER_ROWS ? QUARTER_LIMBS : 16);") in s
    assert ("stage_rows(g.row[r], reinterpret_cast<uint16_t*>(sq + r * TILE * QUARTER_PITCH), "
            "base, lanes,\n               2 * QUARTER_PITCH, QUARTER_LIMBS);") in s
    assert ("stage_rows(g.row[N_QUARTER_ROWS + r], reinterpret_cast<uint16_t*>(sf + r * TILE * "
            "FIELD_PITCH),\n               base, lanes, 2 * FIELD_PITCH, 16);") in s
    assert_staged_rows_rules()
    assert "for (int f = 2 * t; f < total; f += 2 * WORDMUL_THREADS) {" in s
    assert "const uint32_t w = so[(f >> 4) * FIELD_PITCH + ((f & 15) >> 1)];" in s
    assert QUARTER_PITCH % 2 == 1 and QUARTER_PITCH >= 4
    assert FIELD_PITCH % 2 == 1 and FIELD_PITCH >= 8
    words = (4 * QUARTER_PITCH + 7 * FIELD_PITCH) * WORDMUL_TILE
    assert words * 4 <= 48 * 1024


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("limbs", [8, 16])
def test_word_mul_tile_loads_every_limb_once(limbs, layout):
    """K11's stage() is K3's at a width of 8 limbs (a, b) or 16 (c, d, e),
    at WORDMUL_THREADS threads and both tiles: every (lane, limb) a lane
    needs loaded once and each of its halves written once (zero past the
    row), 16-byte loads aligned and within a row; word j of a lane's row
    read bank-free."""
    for n in sorted({1, 2, 3, 7, 8, 15, 16}):
        stride, copy = _stride(layout, n), min(n, limbs)
        for lanes in sorted({1, WORDMUL_SMALL_TILE - 1, WORDMUL_SMALL_TILE, WORDMUL_TILE}):
            loads, writes = stage(stride, n, limbs, layout != "misaligned", lanes,
                                  WORDMUL_THREADS)
            rows = 1 if stride == 0 else lanes
            assert set(writes) == {(lane, k) for lane in range(rows) for k in range(limbs)}
            assert set(writes.values()) == {1} and set(loads.values()) == {1}
            assert {(lane, k) for lane, k in loads if k < copy} == {
                (lane, k) for lane in range(rows) for k in range(copy)}
    pitch = QUARTER_PITCH if limbs == 8 else FIELD_PITCH
    for w0 in range(0, WORDMUL_TILE, WARP):
        for j in range(limbs // 2):
            assert len({((w0 + t) * pitch + j) % BANKS for t in range(WARP)}) == WARP


def test_word_mul_overflow_store_writes_every_limb_once():
    """The 256 variant's flattened store: element f is limb f % 16 of lane
    f / 16, the pair (f, f + 1) the halves of one staged word; every limb
    written once, 16-byte stores on even elements."""
    for lanes in (1, WORDMUL_SMALL_TILE, WORDMUL_TILE):
        stores, words = Counter(), Counter()
        total = lanes * 16
        for t in range(WORDMUL_THREADS):
            for f in range(2 * t, total, 2 * WORDMUL_THREADS):
                assert f % 2 == 0
                word = (f >> 4) * FIELD_PITCH + ((f & 15) >> 1)
                words[word] += 1
                stores[f // 16, f % 16] += 1
                stores[(f + 1) // 16, (f + 1) % 16] += 1
        assert set(stores) == {(lane, k) for lane in range(lanes) for k in range(16)}
        assert set(stores.values()) == {1} and set(words.values()) == {1}


# -- K2 (csrc/limb_mul.cu): the product's staged operands and flattened store -------

LIMB_MUL_SOURCE = (CSRC / "limb_mul.cu").read_text()
MUL_THREADS = define(LIMB_MUL_SOURCE, "MUL_THREADS")
MUL_TILE = define(LIMB_MUL_SOURCE, "MUL_TILE")
MUL_OUT_PITCH = define(LIMB_MUL_SOURCE, "MUL_OUT_PITCH")
MUL_CAPS = (4, 8, 16, 17)


def mul_cap(n):
    return 4 if n <= 4 else 8 if n <= 8 else 16 if n <= 16 else 17


def test_limb_mul_source_states_the_modelled_rules():
    """K2's product stages both operands as K3's stage() does at the
    operand's limb cap (limb_common.cuh's stage_rows, 32-bit words at an odd
    pitch), one thread a lane, and stores its output flattened as K3 does,
    from rows of MUL_OUT_PITCH words; a tile of MUL_TILE lanes at every
    batch, no build-time override."""
    s = LIMB_MUL_SOURCE
    assert '#include "fr_mont.cuh"' in s
    assert "__host__ __device__ constexpr int mul_pitch(int cap) { return cap | 1; }" in s
    assert "int cap_of(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 17; }" in s
    assert "g.a = staged_row(a, sa, na, ca);" in s
    assert "g.b = staged_row(b, sb, nb, cb);" in s
    assert "stage_rows(g.a, sa, base, lanes, mul_pitch(CA), CA);" in s
    assert "stage_rows(g.b, sb, base, lanes, mul_pitch(CB), CB);" in s
    assert_staged_rows_rules()
    assert "const uint32_t* ar = sa + (g.a.stride == 0 ? 0 : t * mul_pitch(CA));" in s
    assert "uint32_t* o = so + t * MUL_OUT_PITCH;" in s
    assert "for (int f = 2 * t; f < total; f += 2 * MUL_THREADS) {" in s
    assert "const int lane = div_by(f, g.out_n, g.out_magic);" in s
    assert ("const int lane1 = k + 1 == g.out_n ? lane + 1 : lane, k1 = k + 1 == g.out_n ? 0 "
            ": k + 1;") in s
    assert "const unsigned blocks = (unsigned)((g.batch + MUL_TILE - 1) / MUL_TILE);" in s
    assert "limb_mul_kernel<CA, CB><<<blocks, MUL_THREADS, 0, stream>>>(g);" in s
    assert "#ifndef" not in s
    assert MUL_OUT_PITCH % 2 == 1 and MUL_OUT_PITCH >= 34
    assert MUL_TILE % 2 == 0 and MUL_TILE <= MUL_THREADS
    assert (2 * addsub_pitch(17) + MUL_OUT_PITCH) * MUL_TILE * 4 <= 48 * 1024


def test_limb_mul_tile_threshold():
    """One tile at every batch, no threshold: a 2048-lane call of the
    arithmetic pass runs 64 blocks of 32 lanes, the last block of any batch
    holds the remainder."""
    def blocks(batch):
        return -(-batch // MUL_TILE)

    assert (blocks(2048), MUL_TILE) == (64, 32)
    assert blocks(1) == 1 and blocks(MUL_TILE + 1) == 2
    for batch in (1, MUL_TILE - 1, MUL_TILE, MUL_TILE + 1, 2048, 65536, 131072):
        assert 0 < batch - (blocks(batch) - 1) * MUL_TILE <= MUL_TILE


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 9, 15, 16, 17])
def test_limb_mul_tile_loads_and_stores_every_limb_once(n, layout):
    """K2's operand staging at MUL_THREADS threads and MUL_TILE lanes: every
    (lane, limb) of an operand loaded once and its word written once (zero
    from the row's width up to its cap), 16-byte loads aligned and within a
    row, a broadcast row once; a lane's staged row and output row read and
    written bank-free; every (lane, limb) of the output stored once from
    one staged word, 16-byte stores on even elements, for every out_n."""
    stride, cap = _stride(layout, n), mul_cap(n)
    pitch = addsub_pitch(cap)
    assert pitch % 2 == 1 and pitch >= cap
    for lanes in sorted({1, MUL_TILE - 1, MUL_TILE}):
        loads, writes = stage(stride, n, cap, layout != "misaligned", lanes, MUL_THREADS)
        rows = 1 if stride == 0 else lanes
        assert set(writes) == {(lane, k) for lane in range(rows) for k in range(cap)}
        assert set(writes.values()) == {1} and set(loads.values()) == {1}
        assert set(loads) == {(lane, k) for lane in range(rows) for k in range(n)}
    assert chain_banks_conflict_free(cap, MUL_TILE)
    for w0 in range(0, MUL_TILE, WARP):
        for k in range(34):
            assert len({((w0 + t) * MUL_OUT_PITCH + k) % BANKS for t in range(WARP)}) == WARP
    for out_n in sorted({1, 2, n, 2 * n, 16, 17, 33, 34}):
        for lanes in sorted({1, MUL_TILE - 1, MUL_TILE}):
            stores, reads = store(out_n, 0, lanes, MUL_THREADS, pitch=MUL_OUT_PITCH)
            assert set(stores) == {(lane, k) for lane in range(lanes) for k in range(out_n)}
            assert set(stores.values()) == {1} and set(reads.values()) == {1}
            # the tile's first element is even: a tile starts at an even lane
            assert (MUL_TILE * out_n) % 2 == 0


# -- K5 (csrc/state_order_lt.cu): one thread a row, the previous key by a shuffle --

ORDER_SOURCE = (CSRC / "state_order_lt.cu").read_text()
ORDER_THREADS = define(ORDER_SOURCE, "ORDER_THREADS")
# (limbs a row the key uses, the column's width in the state circuit), in the
# source's column order
ORDER_COLS = [(1, 1), (2, 2), (10, 16), (1, 1), (8, 8), (8, 8), (2, 2)]


def test_state_order_source_states_the_modelled_rules():
    """K5 loads a row's 32 key limbs in 16-byte pairs where every column of
    two limbs or more is 16-byte aligned at an even row stride (one load a
    limb otherwise), takes the previous row's key from the lane before by
    a warp shuffle, lane 0 building its own (row r - 1, or n - 1 for row
    0), and a lane past the end loads row n - 1 and writes nothing."""
    s = ORDER_SOURCE
    for line in ("return c == TAG || c == FIELD_TAG ? 1 : c == ID || c == RW_COUNTER ? 2 : c == "
                 "ADDRESS ? 10 : 8;",
                 "enum Col { TAG, ID, ADDRESS, FIELD_TAG, SK_LO, SK_HI, RW_COUNTER, N_COLS };",
                 "if (VEC && col_limbs(c) % 2 == 0) {",
                 "for (int k = 0; k < col_limbs(c); k += 2) {",
                 "const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(row + k));",
                 "const long long r = live ? i : g.n - 1;",
                 "for (int k = 0; k < KEY_LIMBS; ++k) prev[k] = __shfl_up_sync(0xffffffffu, "
                 "cur[k], 1);",
                 "if ((threadIdx.x & 31) == 0) {",
                 "load_row<VEC>(g, r == 0 ? g.n - 1 : r - 1, v);",
                 "if (live) g.out[i] = lt || tag == START_TAG;",
                 "vec = vec && (col_limbs(c) % 2 == 1 ||",
                 "(((uintptr_t)ptrs[c] & 15) == 0 && strides[c] % 2 == 0));",
                 "const unsigned blocks = (unsigned)((n + ORDER_THREADS - 1) / ORDER_THREADS);"):
        assert line in s, line
    assert "int limb_offset(int c) {\n  return (c > TAG" in s    # closed form: it folds
    assert ORDER_THREADS % WARP == 0
    assert "#ifndef" not in s
    assert sum(used for used, _ in ORDER_COLS) == 32


@pytest.mark.parametrize("layout", ["dense", "strided", "misaligned"])
@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 127, 128, 129, 255, 256, 257])
def test_state_order_loads_every_row_once_and_its_previous_key(n, layout):
    """Over every lane of an n-row check: each row's limbs the key uses
    loaded once by its own lane (no limb beyond them: address 10 of 16),
    16-byte loads aligned and within a row; each live row's previous key is
    row (i - 1) mod n's, by the shuffle from the lane before or built by
    lane 0 of its warp; a lane past the end writes nothing."""
    strides = [{"dense": width, "misaligned": width, "strided": width + 2 + width % 2}[layout]
               for _, width in ORDER_COLS]
    vec = layout != "misaligned" and all(used % 2 == 1 or stride % 2 == 0
                                         for (used, _), stride in zip(ORDER_COLS, strides))
    loads = Counter()
    blocks = -(-n // ORDER_THREADS)
    prev_of, written = {}, Counter()
    for b in range(blocks):
        rows = {}
        for t in range(ORDER_THREADS):
            i = b * ORDER_THREADS + t
            live = i < n
            r = i if live else n - 1
            rows[t] = r
            for c, ((used, _), stride) in enumerate(zip(ORDER_COLS, strides)):
                step = 2 if vec and used % 2 == 0 else 1
                for k in range(0, used, step):
                    if step == 2:
                        assert (r * stride + k) % 2 == 0    # a 16-byte aligned pair in the row
                    if live:
                        for kk in range(k, k + step):
                            loads[c, r, kk] += 1
        for t in range(ORDER_THREADS):
            i = b * ORDER_THREADS + t
            if i >= n:
                continue
            prev_of[i] = (rows[t] - 1) % n if t % WARP == 0 else rows[t - 1]
            written[i] += 1
    assert set(loads) == {(c, row, k) for c, (used, _) in enumerate(ORDER_COLS)
                          for row in range(n) for k in range(used)}
    assert set(loads.values()) == {1}
    assert prev_of == {i: (i - 1) % n for i in range(n)}
    assert set(written) == set(range(n)) and set(written.values()) == {1}
