// K4 lookup_gather_eq: the hinted replay of a table lookup.  For each lane,
// take the table row at the lane's hint index, compare every queried column
// limb for limb with the lane's query (both zero-padded to the wider of the
// two, as limbs.eq pads), write the gathered columns out, and set
//   ok[lane] = exact || !enabled[lane].
// A part with no query only gathers (the lazy column gather of Row).
//
// Replaces zkevm_specs_tpu/tables/engine.py:Table.lookup's hint-replay
// branch (engine.py:199-225) with _gather_rows (313-317) and F.gather
// (dsl/value.py:262-267).  Hint indexes are clamped into the table, as
// XLA's gather clamps them.
//
// What bounds it on the card: bytes.  A lane reads its index, its query
// limbs and one table row of the queried columns, and writes the gathered
// limbs and one flag; there is a compare per limb and nothing else.  The
// design runs one thread per lane over all queried columns in one launch,
// so the table row is read once, compared and written back in the same
// pass, and the verdict is one flag instead of one mask per column.
#include "limb_common.cuh"

namespace {

constexpr int MAX_PARTS = 16;

struct Parts {
  const int64_t* table[MAX_PARTS];
  const int64_t* query[MAX_PARTS];  // nullptr: gather only
  int64_t* gathered[MAX_PARTS];
  long long table_stride[MAX_PARTS];
  long long query_stride[MAX_PARTS];
  int table_w[MAX_PARTS];
  int query_w[MAX_PARTS];
};

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
lookup_gather_eq_kernel(Parts parts, int n_parts, const int* __restrict__ idx,
                        long long n_rows, const bool* __restrict__ enabled,
                        long long enabled_stride, bool* __restrict__ ok,
                        long long batch) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  long long row = idx[lane];
  row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
  bool exact = true;
  for (int p = 0; p < n_parts; ++p) {
    const int tw = parts.table_w[p];
    const int64_t* t = parts.table[p] + row * parts.table_stride[p];
    int64_t* g = parts.gathered[p] + lane * (long long)tw;
    const int64_t* q = parts.query[p];
    if (q == nullptr) {
      for (int k = 0; k < tw; ++k) g[k] = t[k];
      continue;
    }
    q += lane * parts.query_stride[p];
    const int qw = parts.query_w[p];
    const int n = tw > qw ? tw : qw;
    for (int k = 0; k < n; ++k) {
      const int64_t tv = k < tw ? t[k] : 0;
      const int64_t qv = k < qw ? q[k] : 0;
      exact = exact && (tv == qv);
      if (k < tw) g[k] = tv;
    }
  }
  if (ok != nullptr) {
    const bool en = enabled == nullptr ? true : enabled[lane * enabled_stride];
    ok[lane] = exact || !en;
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
  for (int p = 0; p < n_parts; ++p) {
    parts.table[p] = (const int64_t*)((const uint64_t*)table_ptrs)[p];
    parts.query[p] = (const int64_t*)((const uint64_t*)query_ptrs)[p];
    parts.gathered[p] = (int64_t*)((const uint64_t*)gathered_ptrs)[p];
    parts.table_stride[p] = ((const long long*)table_strides)[p];
    parts.query_stride[p] = ((const long long*)query_strides)[p];
    parts.table_w[p] = ((const int*)table_ws)[p];
    parts.query_w[p] = ((const int*)query_ws)[p];
  }
  for (int p = n_parts; p < MAX_PARTS; ++p) {
    parts.table[p] = nullptr;
    parts.query[p] = nullptr;
    parts.gathered[p] = nullptr;
    parts.table_stride[p] = 0;
    parts.query_stride[p] = 0;
    parts.table_w[p] = 0;
    parts.query_w[p] = 0;
  }
  lookup_gather_eq_kernel<<<grid_for(batch), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      parts, n_parts, (const int*)idx, n_rows, (const bool*)enabled, enabled_stride,
      (bool*)ok, batch);
  return (int)cudaGetLastError();
}
