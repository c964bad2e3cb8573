"""The tile mappings of kernels K3 (``csrc/limb_addsub.cu``), K4
(``csrc/lookup_gather_eq.cu``) and K1 (``csrc/fr_mul.cu``, K3's staging at
16 limbs) on the CPU: a Python model of each kernel's
index arithmetic, with the tile sizes, the pitch, the division by a
reciprocal and the choice of instance read from the sources, walked over
every thread of a tile at each width and tile edge.  It checks that every
(lane, limb) is loaded and stored exactly once, that 16-byte accesses sit
on 16-byte boundaries and never straddle two rows they should not, and
that a warp reading limb k of its lanes' staged rows hits 32 distinct
shared-memory banks (4-byte words, so one phase of 32 threads)."""
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


def test_sources_state_the_modelled_rules():
    """The lines the model below mirrors, as the sources write them."""
    for source in (ADDSUB_SOURCE, GATHER_SOURCE):
        assert "return n == 1 ? e : (int)__umulhi((unsigned)e, magic);" in source
        assert "return n <= 1 ? 0u : 0xFFFFFFFFu / (unsigned)n + 1u;" in source
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


def store(out_n, width, lanes, tile):
    """K3's flattened store over every thread: the output elements it
    writes and the staged words it reads."""
    pitch = addsub_pitch(width)
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


# -- K1 (csrc/fr_mul.cu): K3's staging at a width of 16 limbs ------------------------

FRMUL_SOURCE = (Path(__file__).resolve().parents[1] / "zkevm_specs_tpu_torch" / "csrc"
                / "fr_mul.cu").read_text()
FRMUL_TILE = define(FRMUL_SOURCE, "FRMUL_TILE")
FRMUL_PITCH = define(FRMUL_SOURCE, "FRMUL_PITCH")


def test_fr_mul_source_states_the_modelled_rules():
    """K1 stages its rows as K3's stage() does at a width of 16 (copy and
    span are n <= 16), and stores rows of 16 limbs two at a time."""
    assert "return n == 1 ? e : (int)__umulhi((unsigned)e, magic);" in FRMUL_SOURCE
    assert "return n <= 1 ? 0u : 0xFFFFFFFFu / (unsigned)n + 1u;" in FRMUL_SOURCE
    assert "x.vec = aligned && (stride == n || (stride % 2 == 0 && n % 2 == 0));" in FRMUL_SOURCE
    assert "for (int e = 2 * tid; e < total; e += 2 * nt) {" in FRMUL_SOURCE
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
