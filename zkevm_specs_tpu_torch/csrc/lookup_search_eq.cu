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
// What bounds it on the card: bytes, and the latency of the dependent
// loads of the binary search (about log2(T) of them per lane).  The design
// is one thread per lane: the fingerprint is taken in registers from the
// query limbs, the search touches one 8-byte key per step (the first steps
// of all lanes hit the same few keys, which stay in L1/L2), and only the
// candidate rows' queried limbs are read, once each.
#include "limb_common.cuh"

namespace {

constexpr int MAX_PARTS = 16;
constexpr int FP_LIMBS = 16;

struct Parts {
  const int64_t* query[MAX_PARTS];
  const int64_t* table[MAX_PARTS];
  long long query_stride[MAX_PARTS];
  long long table_stride[MAX_PARTS];
  int query_w[MAX_PARTS];
  int table_w[MAX_PARTS];
};

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
lookup_search_eq_kernel(Parts parts, int n_parts, const uint64_t* __restrict__ coefs,
                        const uint64_t* __restrict__ fps, const int64_t* __restrict__ order,
                        long long n_rows, int max_span, int* __restrict__ first_row,
                        bool* __restrict__ ok_unsat, bool* __restrict__ ok_unique,
                        bool* __restrict__ ok_covered, long long batch) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const uint64_t fp = fingerprint(parts.query, parts.query_stride, parts.query_w, n_parts,
                                  coefs, lane);

  long long lo = 0, hi = n_rows;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (fps[mid] < fp) lo = mid + 1; else hi = mid;
  }

  int n_match = 0;
  int first = 0;
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
      for (int k = 0; k < n; ++k) {
        const int64_t tv = k < tw ? t[k] : 0;
        const int64_t qv = k < qw ? q[k] : 0;
        if (tv != qv) { exact = false; break; }
      }
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

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
lookup_fingerprint_kernel(Parts parts, int n_parts, const uint64_t* __restrict__ coefs,
                          uint64_t* __restrict__ out, long long rows) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  out[row] = fingerprint(parts.table, parts.table_stride, parts.table_w, n_parts, coefs, row);
}

Parts load_parts(int n_parts, const void* q_ptrs, const void* q_strides, const void* q_ws,
                 const void* t_ptrs, const void* t_strides, const void* t_ws) {
  Parts parts;
  for (int p = 0; p < MAX_PARTS; ++p) {
    const bool live = p < n_parts;
    parts.query[p] = live && q_ptrs ? (const int64_t*)((const uint64_t*)q_ptrs)[p] : nullptr;
    parts.query_stride[p] = live && q_strides ? ((const long long*)q_strides)[p] : 0;
    parts.query_w[p] = live && q_ws ? ((const int*)q_ws)[p] : 0;
    parts.table[p] = live ? (const int64_t*)((const uint64_t*)t_ptrs)[p] : nullptr;
    parts.table_stride[p] = live ? ((const long long*)t_strides)[p] : 0;
    parts.table_w[p] = live ? ((const int*)t_ws)[p] : 0;
  }
  return parts;
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
  Parts parts = load_parts(n_parts, q_ptrs, q_strides, q_ws, t_ptrs, t_strides, t_ws);
  bool* ok = (bool*)oks;  // [3, batch]: unsat, unique, covered
  lookup_search_eq_kernel<<<grid_for(batch), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      parts, n_parts, (const uint64_t*)coefs, (const uint64_t*)fps, (const int64_t*)order,
      n_rows, max_span, (int*)first_row, ok, ok + batch, ok + 2 * batch, batch);
  return (int)cudaGetLastError();
}

extern "C" int lookup_fingerprint_launch(int n_parts, const void* t_ptrs, const void* t_strides,
                                         const void* t_ws, const void* coefs, void* out,
                                         long long rows, void* stream) {
  if (rows <= 0) return 0;
  if (n_parts < 1 || n_parts > MAX_PARTS) return (int)cudaErrorInvalidValue;
  Parts parts = load_parts(n_parts, nullptr, nullptr, nullptr, t_ptrs, t_strides, t_ws);
  lookup_fingerprint_kernel<<<grid_for(rows), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      parts, n_parts, (const uint64_t*)coefs, (uint64_t*)out, rows);
  return (int)cudaGetLastError();
}
