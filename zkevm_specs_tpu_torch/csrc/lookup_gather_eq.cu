// K4 lookup_gather_eq: the hinted replay of a table lookup.  For each lane,
// take the table row at the lane's hint index, compare every queried column
// limb for limb with the lane's query (both zero-padded to the wider of the
// two, as limbs.eq pads), write the gathered columns out, and set
//   ok[lane] = exact || !enabled[lane].
// A part with no query only gathers (the lazy column gather of Row).
//
// Replaces zkevm_specs_tpu/tables/engine.py:Table.lookup's hint-replay
// branch (engine.py:199-225) with _gather_rows (313-317) and F.gather
// (dsl/value.py:262-267).  Hint indexes are resolved as that gather
// resolves them under XLA: a negative index counts from the end once
// (idx + n_rows), then the index is clamped into the table.
//
// What bounds it on the card: bytes.  A lane reads its index, its query
// limbs and one table row of the queried columns, and writes the gathered
// limbs and one flag; there is a compare per limb and nothing else.  A
// thread that walks its own lane's limbs makes every warp access of limb k
// touch 32 rows and every store a scatter of 8-byte partial sectors, so
// the design tiles the lanes:
//   1. a block of GATHER_THREADS threads takes GATHER_TILE lanes and
//      resolves their hint indexes once, into shared memory;
//   2. for each part the block's threads sweep the tile's lanes x
//      max(tw, qw) elements lane-major, limb-minor: the table read is
//      contiguous within a row (and across rows where the hints ascend),
//      the query read and the gathered store are coalesced.  Each thread
//      starts the read-only loads of GATHER_UNROLL elements before it
//      stores any, so a thread has that many row reads in flight, and a
//      block has more threads than lanes, so a mid-size batch still
//      fills the card;
//   3. a mismatch clears the lane's flag in shared memory (every writer
//      writes the same value), and ok is written once a tile, coalesced.
// A batch under one tile is one partial tile: its block's threads still
// sweep its lanes' limbs together (over the block passes' batches under
// one tile, as fast in sum as one thread a lane; PERF.md section 6).
#include "limb_common.cuh"

#ifndef GATHER_TILE
#define GATHER_TILE 128     // lanes of a tile
#endif
#define GATHER_THREADS 256  // threads of a tiled block
#define GATHER_UNROLL 4     // elements a thread loads before it stores

namespace {

constexpr int MAX_PARTS = 16;
constexpr int MAX_SPAN = 1024;  // limbs of a part's widest row

struct Parts {
  const int64_t* table[MAX_PARTS];
  const int64_t* query[MAX_PARTS];  // nullptr: gather only
  int64_t* gathered[MAX_PARTS];
  long long table_stride[MAX_PARTS];
  long long query_stride[MAX_PARTS];
  int table_w[MAX_PARTS];
  int query_w[MAX_PARTS];
  int span[MAX_PARTS];        // elements a lane of the part sweeps: max(tw, qw), or tw
  unsigned magic[MAX_PARTS];  // div_by's reciprocal of span
};

// the row of a hint index: negative counts from the end once, then clamped
__device__ __forceinline__ long long hint_row(int i, long long n_rows) {
  long long row = i < 0 ? i + n_rows : i;
  return row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
}

__global__ void __launch_bounds__(GATHER_THREADS)
lookup_gather_eq_kernel(Parts parts, int n_parts, const int* __restrict__ idx,
                        long long n_rows, const bool* __restrict__ enabled,
                        long long enabled_stride, bool* __restrict__ ok, long long batch) {
  __shared__ long long rows[GATHER_TILE];
  __shared__ int flag[GATHER_TILE];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * GATHER_TILE;
  const int lanes = (int)min((long long)GATHER_TILE, batch - base);
  for (int l = t; l < lanes; l += GATHER_THREADS) {
    rows[l] = hint_row(idx[base + l], n_rows);
    flag[l] = 1;
  }
  __syncthreads();
  for (int p = 0; p < n_parts; ++p) {
    const int tw = parts.table_w[p], span = parts.span[p];
    const unsigned magic = parts.magic[p];
    const int64_t* table = parts.table[p];
    const long long ts = parts.table_stride[p];
    int64_t* g = parts.gathered[p] + base * tw;
    const int64_t* q = parts.query[p];
    const int qw = parts.query_w[p];
    const long long qs = parts.query_stride[p];
    if (q != nullptr) q += base * qs;
    const int total = lanes * span;
    for (int e0 = t; e0 < total; e0 += GATHER_UNROLL * GATHER_THREADS) {
      int lane[GATHER_UNROLL], k[GATHER_UNROLL];
      long long tv[GATHER_UNROLL], qv[GATHER_UNROLL];
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u) {
        const int e = e0 + u * GATHER_THREADS;
        lane[u] = div_by(e, span, magic);
        k[u] = e - lane[u] * span;
        const bool in = e < total;
        tv[u] = in && k[u] < tw ? __ldg((const long long*)table + rows[lane[u]] * ts + k[u]) : 0;
        qv[u] = in && q != nullptr && k[u] < qw
                    ? __ldg((const long long*)q + lane[u] * qs + k[u]) : 0;
      }
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u) {
        if (e0 + u * GATHER_THREADS >= total) break;
        if (k[u] < tw) g[lane[u] * tw + k[u]] = tv[u];
        if (q != nullptr && tv[u] != qv[u]) flag[lane[u]] = 0;
      }
    }
  }
  if (ok == nullptr) return;
  __syncthreads();
  for (int l = t; l < lanes; l += GATHER_THREADS) {
    const bool en = enabled == nullptr ? true : enabled[(base + l) * enabled_stride];
    ok[base + l] = flag[l] || !en;
  }
}

}  // namespace

extern "C" int lookup_gather_eq_launch(int n_parts, const void* table_ptrs,
                                       const void* table_strides, const void* table_ws,
                                       const void* query_ptrs, const void* query_strides,
                                       const void* query_ws, const void* gathered_ptrs,
                                       const void* idx, long long n_rows,
                                       const void* enabled, long long enabled_stride,
                                       void* ok, long long batch, void* stream) {
  if (batch <= 0) return 0;
  if (n_parts < 1 || n_parts > MAX_PARTS || n_rows < 1) return (int)cudaErrorInvalidValue;
  Parts parts;
  for (int p = 0; p < MAX_PARTS; ++p) {
    const bool used = p < n_parts;
    parts.table[p] = used ? (const int64_t*)((const uint64_t*)table_ptrs)[p] : nullptr;
    parts.query[p] = used ? (const int64_t*)((const uint64_t*)query_ptrs)[p] : nullptr;
    parts.gathered[p] = used ? (int64_t*)((const uint64_t*)gathered_ptrs)[p] : nullptr;
    parts.table_stride[p] = used ? ((const long long*)table_strides)[p] : 0;
    parts.query_stride[p] = used ? ((const long long*)query_strides)[p] : 0;
    parts.table_w[p] = used ? ((const int*)table_ws)[p] : 0;
    parts.query_w[p] = used ? ((const int*)query_ws)[p] : 0;
    const int tw = parts.table_w[p], qw = parts.query_w[p];
    parts.span[p] = parts.query[p] == nullptr || tw > qw ? tw : qw;
    parts.magic[p] = host_magic(parts.span[p]);
    // div_by is exact for e * span < 2^32, e < GATHER_TILE * span
    if (used && (tw < 1 || (parts.query[p] != nullptr && qw < 1) || parts.span[p] > MAX_SPAN))
      return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((batch + GATHER_TILE - 1) / GATHER_TILE);
  lookup_gather_eq_kernel<<<blocks, GATHER_THREADS, 0, (cudaStream_t)stream>>>(
      parts, n_parts, (const int*)idx, n_rows, (const bool*)enabled, enabled_stride,
      (bool*)ok, batch);
  return (int)cudaGetLastError();
}
