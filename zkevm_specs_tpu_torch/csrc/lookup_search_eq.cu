// K6 lookup_search_eq: the fingerprint lookup of a batched query against a
// sorted table index, for a check that has no witness hints.  For each lane:
//   1. fp = sum over the queried parts and their limbs of limb_k * coef_k,
//      wrapping mod 2^64 (the JAX package's u64 fingerprint);
//   2. lo = the lower bound of fp in the table's fingerprints, sorted in
//      u64 order;
//   3. for the slots lo .. lo + max_span - 1 that still carry fp, take the
//      slot's table row and compare every queried part limb for limb with
//      the query (both zero-padded to the wider, as limbs.eq pads);
//   4. write the first matching row, ok_unsat = (matches >= 1),
//      ok_unique = (matches <= 1), and ok_covered = (no slot past the
//      scanned span still carries fp).
// A second entry point writes the fingerprint of every row of a set of
// parts, which builds a table's index on the device.
//
// Replaces the non-hinted branch of zkevm_specs_tpu/tables/engine.py:
// Table.lookup (engine.py:227-280), and the fingerprint of its index
// build under jit (_fingerprint :109-139 inside index_for :141-164).
// Scanning stops at the first slot past the fingerprint's run: the slots
// are sorted, so every later slot of the JAX loop is out of the run too.
//
// What bounds it on the card: bytes (the query read once, the search's
// keys, the candidates' table rows) at large batches, and the chain of
// dependent loads (query, search, candidates) at small ones.  A thread
// that reads its own lane's limbs makes every warp load touch 32 rows up
// to 128 bytes apart, a binary search is log2(T) dependent loads, and a
// loop over parts or candidates that waits for each one's loads makes a
// chain of them, so the launcher picks one of three paths by batch and
// query width, and counts each:
//
// Tile path (SEARCH_TILE_BATCH lanes and more, of queries of
// SEARCH_TILE_LIMBS limbs or more: rows 512 bytes or wider, which a
// warp's loads of one limb of 32 lanes cannot keep in cache, and batches
// that fill enough tiles to hide a tile's phases): a block of
// SEARCH_THREADS threads takes SEARCH_TILE lanes.
//   1. It stages every queried part's rows (stage_parts): part p's element
//      e is (lane e / w, limb e % w); pairs of elements run over all the
//      parts as one range, consecutive threads on consecutive pairs, 16
//      bytes a load where the base address and the row stride allow, a
//      [1, w] row once, STAGE_UNROLL pairs a thread in flight.  Each limb
//      sits in shared memory as a 16-bit half, a row at an odd pitch of
//      32-bit words, so a warp reading limb k of 32 lanes hits 32 banks, and
//      the tile takes half the bytes of 32-bit words (more tiles resident,
//      more searches in flight).  A half holds a limb below 2^16, which
//      every canonical limb is; a staged limb outside [0, 2^16) marks the
//      tile, each of its lanes then reads its own query again, and a lane
//      with such a limb takes its compare from device memory, exact for
//      every int64 (its fingerprint is summed on the loaded values).
//      Each limb's product with its coefficient is added into its lane's
//      fingerprint in shared memory as it is staged (a 64-bit atomic).
//   2. One thread a lane runs the binary search on the sorted keys (most
//      lanes' first steps hit the same keys, which stay in cache) and reads
//      the next eight slots' keys at once to count its candidates.
//   3. The tile's candidates are listed (a prefix sum of the counts), up
//      to SEARCH_CANDIDATES at a time, their rows read at once; the block's
//      threads then sweep the list's candidates x padded row elements (the
//      sum over parts of max(tw, qw)) as one range, the table read
//      contiguous within a part of a candidate's row, the query from shared
//      memory, SEARCH_UNROLL loads in flight a thread (K4's sweep), the
//      parts' pointers and widths read from shared memory (a warp's
//      threads take several parts at once); a mismatch clears the
//      candidate's flag in shared memory.
//   4. One thread a lane tallies its candidates in rank order and writes
//      first_row and the three ok bytes: a warp's 32 lanes, coalesced.
//
// Row path (between the two, and narrower queries): one thread a lane, its
// query's limbs read directly and its candidates compared limb by limb;
// measured as fast as the tile path, or faster, on the blocks' lookups of
// about 96561 lanes and on the 5-part keccak lookups of 2^20 lanes, whose
// queries are narrow and whose candidates are few.
//
// Warp path (under SEARCH_WARP_BATCH lanes, the block verifier's small
// lookups): one warp a lane, SEARCH_WARP_LANES warps a block.
//   1. The warp's threads take the lane's padded elements (at most 256) 32
//      at a time, load the query limbs together and keep them in
//      registers; the fingerprint is a warp sum.
//   2. The search probes 32 keys of the range at once (positions lo + (t +
//      1) * n / 33), and a ballot narrows the range 33-fold: about
//      log33(T) dependent loads, not log2(T).
//   3. The next 32 slots' keys, table rows and the covered slot's key are
//      read at once; each candidate's row is compared by the warp's
//      threads, a ballot per candidate.
//
// The fingerprint entry, for FP_TILED_ROWS rows or more of FP_TILED_LIMBS
// limbs or more (a row 256 bytes or wider, whose loads one thread a row
// would spread over a warp's 32 rows), stages a tile of FP_TILE rows one
// part at a time (flattened 16-byte loads, 64-bit words at an odd pitch,
// every int64 exact), the next part's loads in flight while one thread a
// row adds the current part's products, and writes each row's fingerprint
// coalesced; narrower or fewer rows take one thread a row, its limbs read
// directly (measured faster there: no staging round per part).
#include "limb_common.cuh"

#define SEARCH_TILE 128        // lanes of a tile on the tile path
#define SEARCH_THREADS 256     // threads of a tile-path block
#define SEARCH_UNROLL 4        // table limbs a thread loads before it compares
#define SEARCH_CANDIDATES 128  // candidates a tile-path block lists at a time
#define STAGE_UNROLL 4         // pairs of limbs a thread loads before it stages them
#define SEARCH_WARP_LANES 4    // lanes (warps) of a warp-path block
#ifndef SEARCH_WARP_BATCH
#define SEARCH_WARP_BATCH 8192    // batches under this many lanes take the warp path
#endif
#ifndef SEARCH_TILE_BATCH
#define SEARCH_TILE_BATCH 262144  // the tile path from this many lanes ...
#endif
#ifndef SEARCH_TILE_LIMBS
#define SEARCH_TILE_LIMBS 64      // ... of queries of this many limbs or more
#endif
#define FP_TILE 128            // rows (and threads) of a fingerprint tile
#define FP_PITCH 17            // 64-bit words a staged fingerprint row takes: odd
#define FP_PAIRS 8             // pairs of limbs a fingerprint thread loads a part: 16 / 2
#define FP_TILED_ROWS 8192     // the fingerprint entry stages tiles from this many rows
#define FP_TILED_LIMBS 32      // of at least this many limbs

namespace {

constexpr int MAX_PARTS = 16;
constexpr int FP_LIMBS = 16;
constexpr int MAX_ELEMS = MAX_PARTS * FP_LIMBS;   // a lane's widest padded row
constexpr int WARP_ELEMS = MAX_ELEMS / 32;        // elements a warp-path thread holds
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Parts {
  const int64_t* query[MAX_PARTS];
  const int64_t* table[MAX_PARTS];
  long long query_stride[MAX_PARTS];  // 0: a broadcast [1, w] row
  long long table_stride[MAX_PARTS];
  int query_w[MAX_PARTS];
  int table_w[MAX_PARTS];
  // the staged rows: the query's (search) or the table's (fingerprint)
  const int64_t* staged[MAX_PARTS];
  long long staged_stride[MAX_PARTS];
  int staged_w[MAX_PARTS];
  unsigned smagic[MAX_PARTS];  // div_by's reciprocal of staged_w
  int svec[MAX_PARTS];         // 16-byte loads: base aligned, pairs never straddle rows
  int pitch[MAX_PARTS];        // halves a staged query row takes: an odd count of words
  int offset[MAX_PARTS];       // first half of the part's staged rows
  int elems[MAX_PARTS + 1];    // the first padded element of each part (sum of max(tw, qw))
  unsigned elems_magic;        // div_by's reciprocal of a row's padded elements
};

__device__ __forceinline__ long long ld(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

// Stages the query rows of every part of a tile of `lanes` lanes from lane
// `base` as 16-bit halves: part p's element e, 0 <= e < rows_p * w_p
// (rows_p = 1 for a broadcast row), is (lane e / w_p, limb e % w_p),
// staged at half offset_p + lane * pitch_p + limb.  The pairs of elements
// of all parts run as one range, pair i to thread i % blockDim.x; a thread
// loads STAGE_UNROLL pairs before it stores any.  Each limb's product with
// its coefficient, on the full int64 value, is added into its lane's
// fingerprint (fp[lane]; a broadcast row's into *fp_bcast) by a shared
// 64-bit atomic.  A limb outside [0, 2^16) sets *wide.
__device__ __forceinline__ void stage_parts(const Parts& parts, int n_parts, long long base,
                                            int lanes, const uint64_t* __restrict__ coefs,
                                            uint16_t* staged, unsigned long long* fp,
                                            unsigned long long* fp_bcast, int* wide) {
  const int nt = blockDim.x;
  int p = 0, first = 0;  // the cursor: part p's pairs start at pair `first`
  auto pairs_of = [&](int q) {
    return q < n_parts
               ? ((parts.staged_stride[q] == 0 ? 1 : lanes) * parts.staged_w[q] + 1) >> 1
               : 0;
  };
  int pairs = pairs_of(0);
  for (int i0 = threadIdx.x;; i0 += STAGE_UNROLL * nt) {
    int d0[STAGE_UNROLL], d1[STAGE_UNROLL];  // the pair's staged halves (-1: none)
    long long v0[STAGE_UNROLL], v1[STAGE_UNROLL];
    unsigned long long *f0[STAGE_UNROLL], *f1[STAGE_UNROLL];  // their lanes' fingerprints
    const uint64_t *c0[STAGE_UNROLL], *c1[STAGE_UNROLL];      // and coefficients
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int i = i0 + u * nt;
      while (p < n_parts && i >= first + pairs) {
        first += pairs;
        pairs = pairs_of(++p);
      }
      d0[u] = d1[u] = -1;
      if (p >= n_parts) continue;
      const int n = parts.staged_w[p];
      const long long stride = parts.staged_stride[p];
      const int e = 2 * (i - first);
      const int lane = div_by(e, n, parts.smagic[p]);
      const int k = e - lane * n;
      const int lane1 = k + 1 == n ? lane + 1 : lane, k1 = k + 1 == n ? 0 : k + 1;
      const bool two = e + 1 < (stride == 0 ? 1 : lanes) * n;
      d0[u] = parts.offset[p] + lane * parts.pitch[p] + k;
      d1[u] = two ? parts.offset[p] + lane1 * parts.pitch[p] + k1 : -1;
      f0[u] = stride == 0 ? fp_bcast : fp + lane;
      f1[u] = stride == 0 ? fp_bcast : fp + lane1;
      c0[u] = coefs + p * FP_LIMBS + k;
      c1[u] = coefs + p * FP_LIMBS + k1;
      const int64_t* src = parts.staged[p] + base * stride;
      if (parts.svec[p] && two) {
        const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(src + lane * stride + k));
        v0[u] = v.x;
        v1[u] = v.y;
      } else {
        v0[u] = ld(src + lane * stride + k);
        v1[u] = two ? ld(src + lane1 * stride + k1) : 0;
      }
    }
    if (d0[0] < 0) return;
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      if (d0[u] < 0) break;
      staged[d0[u]] = (uint16_t)v0[u];
      const unsigned long long p0 = (unsigned long long)v0[u] * __ldg(c0[u]);
      if (d1[u] >= 0) {
        staged[d1[u]] = (uint16_t)v1[u];
        const unsigned long long p1 = (unsigned long long)v1[u] * __ldg(c1[u]);
        if (f1[u] == f0[u]) {
          atomicAdd(f0[u], p0 + p1);
        } else {
          atomicAdd(f0[u], p0);
          atomicAdd(f1[u], p1);
        }
      } else {
        atomicAdd(f0[u], p0);
      }
      if ((unsigned long long)v0[u] >> 16 || (unsigned long long)v1[u] >> 16) *wide = 1;
    }
  }
}

// -- tile path ----------------------------------------------------------------

// a part as the sweep reads it, from shared memory (a warp's threads take
// several parts at once)
struct PartRef {
  const int64_t* table;
  const int64_t* query;
  long long table_stride, query_stride;
  int table_w, query_w, offset, pitch;  // pitch 0: a broadcast query row
};

// shared memory of a tile-path block past the staged query rows
struct TileLanes {
  PartRef part[MAX_PARTS];
  unsigned long long fp[SEARCH_TILE];  // each lane's fingerprint, summed while staging
  unsigned long long fp_bcast;         // the broadcast rows' share of every lane's
  long long lo[SEARCH_TILE];         // lower bound of each lane's fingerprint
  int start[SEARCH_TILE];            // the lane's first candidate in the tile's list
  int any_wide;                      // a staged limb lies outside [0, 2^16)
  int wide[SEARCH_TILE];             // lane l's query has such a limb
  int warp_total[SEARCH_TILE / 32];  // candidates of each warp's lanes
  int cand_lane[SEARCH_CANDIDATES];  // the listed candidates: lane, table row, still equal
  int cand_row[SEARCH_CANDIDATES];
  int match[SEARCH_CANDIDATES];
  unsigned char elem_part[MAX_ELEMS];  // padded element j of a row: its part and limb
  unsigned char elem_limb[MAX_ELEMS];
};

__global__ void __launch_bounds__(SEARCH_THREADS)
lookup_search_eq_tile_kernel(Parts parts, int n_parts, const uint64_t* __restrict__ coefs,
                             const uint64_t* __restrict__ fps, const int64_t* __restrict__ order,
                             long long n_rows, int max_span, int* __restrict__ first_row,
                             bool* __restrict__ ok_unsat, bool* __restrict__ ok_unique,
                             bool* __restrict__ ok_covered, long long batch) {
  extern __shared__ uint16_t staged[];
  __shared__ TileLanes sl;
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * SEARCH_TILE;
  const int lanes = (int)min((long long)SEARCH_TILE, batch - base);
  const int row_elems = parts.elems[n_parts];
  if (t == 0) sl.any_wide = 0, sl.fp_bcast = 0;
  if (t < SEARCH_TILE) sl.fp[t] = 0;
  if (t < n_parts) {
    const long long qs = parts.query_stride[t];
    sl.part[t] = {parts.table[t], parts.query[t], parts.table_stride[t], qs, parts.table_w[t],
                  parts.query_w[t], parts.offset[t], qs == 0 ? 0 : parts.pitch[t]};
  }
  for (int j = t; j < row_elems; j += SEARCH_THREADS) {
    int p = 0;
    while (j >= parts.elems[p + 1]) ++p;
    sl.elem_part[j] = (unsigned char)p;
    sl.elem_limb[j] = (unsigned char)(j - parts.elems[p]);
  }
  __syncthreads();
  stage_parts(parts, n_parts, base, lanes, coefs, staged, sl.fp, &sl.fp_bcast, &sl.any_wide);
  __syncthreads();

  // one thread a lane: the fingerprint, the search, the candidates
  int n = 0;
  long long lo = 0;
  bool covered = true;
  if (t < lanes) {
    bool wide = false;  // the lane's own limbs, read again where a staged limb was wide
    for (int p = 0; sl.any_wide && p < n_parts; ++p)
      for (int k = 0; k < parts.query_w[p]; ++k)
        wide = wide || (unsigned long long)ld(parts.query[p] + (base + t) * parts.query_stride[p] +
                                              k) >> 16;
    sl.wide[t] = wide;
    const uint64_t fp = sl.fp[t] + sl.fp_bcast;
    long long hi = n_rows;
    while (lo < hi) {
      const long long mid = lo + ((hi - lo) >> 1);
      if (fps[mid] < fp) lo = mid + 1; else hi = mid;
    }
    const long long end = lo + max_span;
    covered = end >= n_rows || fps[end < n_rows - 1 ? end : n_rows - 1] != fp;
    for (int s0 = 0; s0 < max_span; s0 += 8) {  // eight slots' keys at once
      bool carries[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const long long slot = lo + s0 + u;
        carries[u] = s0 + u < max_span && slot < n_rows && fps[slot] == fp;
      }
      int run = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) run += run == u && carries[u];
      n += run;
      if (run < 8) break;
    }
    sl.lo[t] = lo;
  }
  // the list: each lane's candidates after those of the lanes before it
  int x = t < SEARCH_TILE ? n : 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if ((t & 31) >= off) x += y;
  }
  if (t < SEARCH_TILE && (t & 31) == 31) sl.warp_total[t >> 5] = x;
  __syncthreads();
  int listed = 0, before = 0;
#pragma unroll
  for (int w = 0; w < SEARCH_TILE / 32; ++w) {
    before += w < (t >> 5) ? sl.warp_total[w] : 0;
    listed += sl.warp_total[w];
  }
  if (t < lanes) sl.start[t] = before + x - n;
  __syncthreads();

  int n_match = 0, first = 0;
  for (int c0 = 0; c0 < listed; c0 += SEARCH_CANDIDATES) {
    const int in_list = min(SEARCH_CANDIDATES, listed - c0);
    for (int c = t; c < in_list; c += SEARCH_THREADS) {
      int a = 0, b = lanes;  // the last lane whose list starts at or before c0 + c
      while (b - a > 1) {
        const int m = (a + b) >> 1;
        if (sl.start[m] <= c0 + c) a = m; else b = m;
      }
      sl.cand_lane[c] = a;
      sl.cand_row[c] = (int)order[sl.lo[a] + (c0 + c - sl.start[a])];
      sl.match[c] = 1;
    }
    __syncthreads();
    const int total = in_list * row_elems;
    for (int e0 = t; e0 < total; e0 += SEARCH_UNROLL * SEARCH_THREADS) {
      int cand[SEARCH_UNROLL], part[SEARCH_UNROLL], limb[SEARCH_UNROLL];
      long long tv[SEARCH_UNROLL];
#pragma unroll
      for (int u = 0; u < SEARCH_UNROLL; ++u) {
        const int e = e0 + u * SEARCH_THREADS;
        cand[u] = e < total ? div_by(e, row_elems, parts.elems_magic) : -1;
        if (cand[u] < 0) continue;
        const int j = e - cand[u] * row_elems;
        part[u] = sl.elem_part[j];
        limb[u] = sl.elem_limb[j];
        const PartRef& r = sl.part[part[u]];
        tv[u] = limb[u] < r.table_w
                    ? ld(r.table + sl.cand_row[cand[u]] * r.table_stride + limb[u])
                    : 0;
      }
#pragma unroll
      for (int u = 0; u < SEARCH_UNROLL; ++u) {
        if (cand[u] < 0) break;
        const PartRef& r = sl.part[part[u]];
        const int k = limb[u], lane = sl.cand_lane[cand[u]];
        long long qv = 0;
        if (k < r.query_w)
          qv = sl.wide[lane] ? ld(r.query + (base + lane) * r.query_stride + k)
                             : (long long)staged[r.offset + lane * r.pitch + k];
        if (tv[u] != qv) sl.match[cand[u]] = 0;
      }
    }
    __syncthreads();
    if (t < lanes) {  // this lane's listed candidates, in rank order
      const int lo_c = max(sl.start[t] - c0, 0), hi_c = min(sl.start[t] + n - c0, in_list);
      for (int c = lo_c; c < hi_c; ++c) {
        if (!sl.match[c]) continue;
        if (n_match == 0) first = sl.cand_row[c];
        ++n_match;
      }
    }
    __syncthreads();
  }
  if (t < lanes) {
    const long long lane = base + t;
    first_row[lane] = first;
    ok_unsat[lane] = n_match >= 1;
    ok_unique[lane] = n_match <= 1;
    ok_covered[lane] = covered;
  }
}

// -- row path -------------------------------------------------------------------

// the fingerprint of one row of the parts, its limbs read directly
__device__ __forceinline__ uint64_t fingerprint(const int64_t* const* ptrs,
                                                const long long* strides, const int* widths,
                                                int n_parts, const uint64_t* __restrict__ coefs,
                                                long long row) {
  uint64_t fp = 0;
  for (int p = 0; p < n_parts; ++p) {
    const int64_t* v = ptrs[p] + row * strides[p];
    const int w = widths[p];
    for (int k = 0; k < w; ++k) fp += (uint64_t)v[k] * __ldg(coefs + p * FP_LIMBS + k);
  }
  return fp;
}

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
lookup_search_eq_row_kernel(Parts parts, int n_parts, const uint64_t* __restrict__ coefs,
                            const uint64_t* __restrict__ fps, const int64_t* __restrict__ order,
                            long long n_rows, int max_span, int* __restrict__ first_row,
                            bool* __restrict__ ok_unsat, bool* __restrict__ ok_unique,
                            bool* __restrict__ ok_covered, long long batch) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const uint64_t fp = fingerprint(parts.query, parts.query_stride, parts.query_w, n_parts,
                                  coefs, lane);
  long long lo = 0, hi = n_rows;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (fps[mid] < fp) lo = mid + 1; else hi = mid;
  }
  int n_match = 0, first = 0;
  for (int s = 0; s < max_span; ++s) {
    const long long slot = lo + s;
    if (slot >= n_rows || fps[slot] != fp) break;
    const int row = (int)order[slot];
    bool exact = true;
    for (int p = 0; p < n_parts && exact; ++p) {
      const int64_t* t = parts.table[p] + (long long)row * parts.table_stride[p];
      const int64_t* q = parts.query[p] + lane * parts.query_stride[p];
      const int tw = parts.table_w[p], qw = parts.query_w[p];
      const int n = tw > qw ? tw : qw;
      for (int k = 0; k < n && exact; ++k) exact = (k < tw ? t[k] : 0) == (k < qw ? q[k] : 0);
    }
    if (exact) {
      if (n_match == 0) first = row;
      ++n_match;
    }
  }
  const long long end = lo + max_span;
  first_row[lane] = first;
  ok_unsat[lane] = n_match >= 1;
  ok_unique[lane] = n_match <= 1;
  ok_covered[lane] = end >= n_rows || fps[end < n_rows - 1 ? end : n_rows - 1] != fp;
}

// -- warp path ------------------------------------------------------------------

__global__ void __launch_bounds__(32 * SEARCH_WARP_LANES)
lookup_search_eq_warp_kernel(Parts parts, int n_parts, const uint64_t* __restrict__ coefs,
                             const uint64_t* __restrict__ fps, const int64_t* __restrict__ order,
                             long long n_rows, int max_span, int* __restrict__ first_row,
                             bool* __restrict__ ok_unsat, bool* __restrict__ ok_unique,
                             bool* __restrict__ ok_covered, long long batch) {
  const int t = threadIdx.x & 31;
  const long long lane = (long long)blockIdx.x * SEARCH_WARP_LANES + (threadIdx.x >> 5);
  if (lane >= batch) return;  // the warp's threads leave together
  const int total = parts.elems[n_parts];

  // element e = t + 32 j of the lane's padded row: (part, limb), the query
  // limb (0 past the part's query width) in registers; the fingerprint
  long long qv[WARP_ELEMS];
  int part[WARP_ELEMS], limb[WARP_ELEMS];
  uint64_t fp = 0;
  int p = 0;
#pragma unroll
  for (int j = 0; j < WARP_ELEMS; ++j) {
    const int e = t + 32 * j;
    qv[j] = 0;
    part[j] = -1;
    limb[j] = 0;
    if (e < total) {
      while (e >= parts.elems[p + 1]) ++p;
      part[j] = p;
      limb[j] = e - parts.elems[p];
      if (limb[j] < parts.query_w[p]) {
        qv[j] = ld(parts.query[p] + lane * parts.query_stride[p] + limb[j]);
        fp += (uint64_t)qv[j] * __ldg(coefs + p * FP_LIMBS + limb[j]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) fp += __shfl_xor_sync(FULL, fp, off);

  // the lower bound lies in [lo, hi]: 32 probes narrow it 33-fold a step
  long long lo = 0, hi = n_rows;
  while (hi - lo > 32) {
    const long long n = hi - lo;
    const bool below = fps[lo + (t + 1) * n / 33] < fp;
    const int c = __popc(__ballot_sync(FULL, below));
    const long long new_lo = c == 0 ? lo : lo + c * n / 33 + 1;
    hi = c == 32 ? hi : lo + (c + 1) * n / 33;
    lo = new_lo;
  }
  lo += __popc(__ballot_sync(FULL, lo + t < hi && fps[lo + t] < fp));

  // the candidates: the slots from lo that carry fp, at most max_span; a
  // slot's key, its row and the covered slot's key read together
  const long long end = lo + max_span;
  const bool covered = end >= n_rows || fps[end < n_rows - 1 ? end : n_rows - 1] != fp;
  int n_match = 0, first = 0;
  for (int s0 = 0; s0 < max_span; s0 += 32) {
    const long long slot = lo + s0 + t;
    const bool in_span = s0 + t < max_span && slot < n_rows;
    const int cand_row = in_span ? (int)order[slot] : 0;
    const unsigned run = __ballot_sync(FULL, in_span && fps[slot] == fp);  // a prefix: sorted
    const int n = __popc(run);
    for (int s = 0; s < n; ++s) {
      const int row = __shfl_sync(FULL, cand_row, s);
      bool differs = false;
#pragma unroll
      for (int j = 0; j < WARP_ELEMS; ++j) {
        if (part[j] < 0) continue;
        const int q = part[j];
        const long long tv = limb[j] < parts.table_w[q]
                                 ? ld(parts.table[q] + row * parts.table_stride[q] + limb[j])
                                 : 0;
        differs = differs || tv != qv[j];
      }
      if (!__any_sync(FULL, differs)) {
        if (n_match == 0) first = row;
        ++n_match;
      }
    }
    if (n < 32) break;
  }
  if (t == 0) {
    first_row[lane] = first;
    ok_unsat[lane] = n_match >= 1;
    ok_unique[lane] = n_match <= 1;
    ok_covered[lane] = covered;
  }
}

// -- fingerprint entry ------------------------------------------------------------

// The pairs of part p's rows a fingerprint thread loads: element e = 2 * (t
// + j * FP_TILE) is (row e / w, limb e % w), and the next element with it.
__device__ __forceinline__ void fp_load(const Parts& parts, int p, long long base, int lanes,
                                       longlong2 v[FP_PAIRS]) {
  const int n = parts.staged_w[p];
  const long long stride = parts.staged_stride[p];
  const int total = (stride == 0 ? 1 : lanes) * n;
  const int64_t* src = parts.staged[p] + base * stride;
#pragma unroll
  for (int j = 0; j < FP_PAIRS; ++j) {
    const int e = 2 * (threadIdx.x + j * FP_TILE);
    if (e >= total) break;
    const int lane = div_by(e, n, parts.smagic[p]), k = e - lane * n;
    const int lane1 = k + 1 == n ? lane + 1 : lane, k1 = k + 1 == n ? 0 : k + 1;
    if (parts.svec[p] && e + 1 < total) {
      v[j] = __ldg(reinterpret_cast<const longlong2*>(src + lane * stride + k));
    } else {
      v[j].x = ld(src + lane * stride + k);
      v[j].y = e + 1 < total ? ld(src + lane1 * stride + k1) : 0;
    }
  }
}

__device__ __forceinline__ void fp_store(const Parts& parts, int p, int lanes,
                                         const longlong2 v[FP_PAIRS], long long* s) {
  const int n = parts.staged_w[p];
  const int total = (parts.staged_stride[p] == 0 ? 1 : lanes) * n;
#pragma unroll
  for (int j = 0; j < FP_PAIRS; ++j) {
    const int e = 2 * (threadIdx.x + j * FP_TILE);
    if (e >= total) break;
    const int lane = div_by(e, n, parts.smagic[p]), k = e - lane * n;
    const int lane1 = k + 1 == n ? lane + 1 : lane, k1 = k + 1 == n ? 0 : k + 1;
    s[lane * FP_PITCH + k] = v[j].x;
    if (e + 1 < total) s[lane1 * FP_PITCH + k1] = v[j].y;
  }
}

// One part at a time through a staged tile, the next part's loads in flight
// while the threads add the current part's products.
__global__ void __launch_bounds__(FP_TILE)
lookup_fingerprint_kernel(Parts parts, int n_parts, const uint64_t* __restrict__ coefs,
                          uint64_t* __restrict__ out, long long rows) {
  __shared__ long long s[FP_TILE * FP_PITCH];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * FP_TILE;
  const int lanes = (int)min((long long)FP_TILE, rows - base);
  longlong2 v[FP_PAIRS];
  fp_load(parts, 0, base, lanes, v);
  uint64_t fp = 0;
  for (int p = 0; p < n_parts; ++p) {
    if (p) __syncthreads();  // the previous part's rows are read
    fp_store(parts, p, lanes, v, s);
    __syncthreads();
    if (p + 1 < n_parts) fp_load(parts, p + 1, base, lanes, v);
    if (t < lanes) {
      const long long* row = s + (parts.staged_stride[p] == 0 ? 0 : t * FP_PITCH);
      const uint64_t* c = coefs + p * FP_LIMBS;
#pragma unroll
      for (int k = 0; k < FP_LIMBS; ++k)
        if (k < parts.table_w[p]) fp += (uint64_t)row[k] * __ldg(c + k);
    }
  }
  if (t < lanes) out[base + t] = fp;
}

// one thread a row, its limbs read directly
__global__ void __launch_bounds__(THREADS_PER_BLOCK)
lookup_fingerprint_row_kernel(Parts parts, int n_parts, const uint64_t* __restrict__ coefs,
                              uint64_t* __restrict__ out, long long rows) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  out[row] = fingerprint(parts.table, parts.table_stride, parts.table_w, n_parts, coefs, row);
}

// -- launchers ------------------------------------------------------------------

// launches per path of the search entry since the library loaded: [tile, warp, row]
long long g_path_launches[3] = {0, 0, 0};

// the parts' pointers, strides and widths, and the staged rows' layout for
// a tile of `tile` lanes; the staged words of a block in *words
Parts load_parts(int n_parts, const void* q_ptrs, const void* q_strides, const void* q_ws,
                 const void* t_ptrs, const void* t_strides, const void* t_ws, int tile,
                 int* words) {
  Parts parts;
  int offset = 0;
  parts.elems[0] = 0;
  for (int p = 0; p < MAX_PARTS; ++p) {
    const bool live = p < n_parts;
    const bool query = live && q_ptrs;
    parts.query[p] = query ? (const int64_t*)((const uint64_t*)q_ptrs)[p] : nullptr;
    parts.query_stride[p] = query ? ((const long long*)q_strides)[p] : 0;
    parts.query_w[p] = query ? ((const int*)q_ws)[p] : 0;
    parts.table[p] = live ? (const int64_t*)((const uint64_t*)t_ptrs)[p] : nullptr;
    parts.table_stride[p] = live ? ((const long long*)t_strides)[p] : 0;
    parts.table_w[p] = live ? ((const int*)t_ws)[p] : 0;
    const int tw = parts.table_w[p], qw = parts.query_w[p];
    parts.staged[p] = query ? parts.query[p] : parts.table[p];
    parts.staged_stride[p] = query ? parts.query_stride[p] : parts.table_stride[p];
    const int n = parts.staged_w[p] = query ? qw : tw;
    const long long stride = parts.staged_stride[p];
    parts.smagic[p] = host_magic(n);
    parts.svec[p] = ((uintptr_t)parts.staged[p] & 15) == 0 &&
                    (stride == n || (stride % 2 == 0 && n % 2 == 0));
    parts.pitch[p] = 2 * (((n + 1) >> 1) | 1);
    parts.offset[p] = offset;
    if (live) offset += (stride == 0 ? 1 : tile) * parts.pitch[p];
    parts.elems[p + 1] = parts.elems[p] + (live ? (tw > qw ? tw : qw) : 0);
  }
  parts.elems_magic = host_magic(parts.elems[MAX_PARTS]);
  *words = offset;
  return parts;
}

bool bad_widths(const Parts& parts, int n_parts) {
  for (int p = 0; p < n_parts; ++p) {
    const int tw = parts.table_w[p], qw = parts.query_w[p];
    if (tw < 0 || tw > FP_LIMBS || qw < 0 || qw > FP_LIMBS) return true;
    if (parts.table_stride[p] < 0 || parts.query_stride[p] < 0) return true;
  }
  return false;
}

// raises a kernel's dynamic shared memory past 48 KB where a launch needs it
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes, size_t* raised) {
  if (bytes <= *raised) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *raised = bytes;
  return err;
}

}  // namespace

extern "C" int lookup_search_eq_launch(int n_parts, const void* q_ptrs, const void* q_strides,
                                       const void* q_ws, const void* t_ptrs,
                                       const void* t_strides, const void* t_ws,
                                       const void* coefs, const void* fps, const void* order,
                                       long long n_rows, int max_span, void* first_row,
                                       void* oks, long long batch, void* stream) {
  if (batch <= 0) return 0;
  if (n_parts < 1 || n_parts > MAX_PARTS || n_rows < 1 || max_span < 1)
    return (int)cudaErrorInvalidValue;
  int words;
  const Parts parts = load_parts(n_parts, q_ptrs, q_strides, q_ws, t_ptrs, t_strides, t_ws,
                                 SEARCH_TILE, &words);
  if (bad_widths(parts, n_parts)) return (int)cudaErrorInvalidValue;
  bool* ok = (bool*)oks;  // [3, batch]: unsat, unique, covered
  const cudaStream_t s = (cudaStream_t)stream;
  if (batch < SEARCH_WARP_BATCH) {
    const unsigned blocks = (unsigned)((batch + SEARCH_WARP_LANES - 1) / SEARCH_WARP_LANES);
    lookup_search_eq_warp_kernel<<<blocks, 32 * SEARCH_WARP_LANES, 0, s>>>(
        parts, n_parts, (const uint64_t*)coefs, (const uint64_t*)fps, (const int64_t*)order,
        n_rows, max_span, (int*)first_row, ok, ok + batch, ok + 2 * batch, batch);
    ++g_path_launches[1];
    return (int)cudaGetLastError();
  }
  int limbs = 0;
  for (int p = 0; p < n_parts; ++p) limbs += parts.query_w[p];
  if (batch < SEARCH_TILE_BATCH || limbs < SEARCH_TILE_LIMBS) {
    lookup_search_eq_row_kernel<<<grid_for(batch), THREADS_PER_BLOCK, 0, s>>>(
        parts, n_parts, (const uint64_t*)coefs, (const uint64_t*)fps, (const int64_t*)order,
        n_rows, max_span, (int*)first_row, ok, ok + batch, ok + 2 * batch, batch);
    ++g_path_launches[2];
    return (int)cudaGetLastError();
  }
  const size_t bytes = (size_t)words * sizeof(uint16_t);
  static size_t raised = 48 * 1024 - sizeof(TileLanes);
  const cudaError_t err = allow_shared(lookup_search_eq_tile_kernel, bytes, &raised);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((batch + SEARCH_TILE - 1) / SEARCH_TILE);
  lookup_search_eq_tile_kernel<<<blocks, SEARCH_THREADS, bytes, s>>>(
      parts, n_parts, (const uint64_t*)coefs, (const uint64_t*)fps, (const int64_t*)order,
      n_rows, max_span, (int*)first_row, ok, ok + batch, ok + 2 * batch, batch);
  ++g_path_launches[0];
  return (int)cudaGetLastError();
}

extern "C" int lookup_fingerprint_launch(int n_parts, const void* t_ptrs, const void* t_strides,
                                         const void* t_ws, const void* coefs, void* out,
                                         long long rows, void* stream) {
  if (rows <= 0) return 0;
  if (n_parts < 1 || n_parts > MAX_PARTS) return (int)cudaErrorInvalidValue;
  int words;
  const Parts parts = load_parts(n_parts, nullptr, nullptr, nullptr, t_ptrs, t_strides, t_ws,
                                 FP_TILE, &words);
  if (bad_widths(parts, n_parts)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows >= FP_TILED_ROWS && parts.elems[MAX_PARTS] >= FP_TILED_LIMBS) {
    const unsigned blocks = (unsigned)((rows + FP_TILE - 1) / FP_TILE);
    lookup_fingerprint_kernel<<<blocks, FP_TILE, 0, s>>>(parts, n_parts, (const uint64_t*)coefs,
                                                        (uint64_t*)out, rows);
  } else {
    lookup_fingerprint_row_kernel<<<grid_for(rows), THREADS_PER_BLOCK, 0, s>>>(
        parts, n_parts, (const uint64_t*)coefs, (uint64_t*)out, rows);
  }
  return (int)cudaGetLastError();
}

// the launches of each path of the search entry since the library loaded
extern "C" int lookup_search_eq_path_launches(void* tile, void* warp, void* row) {
  *(long long*)tile = g_path_launches[0];
  *(long long*)warp = g_path_launches[1];
  *(long long*)row = g_path_launches[2];
  return 0;
}
