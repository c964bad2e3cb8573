// K13 logup_sum: the Montgomery batch inverse of n BN254-Fr elements, and
// the logUp partial sum sum_i m_i / (alpha - fp_i), in two entries that
// bracket one inversion of the elements' total product (K12, fr_inv):
//
//   logup_up_launch    the product tree: its levels and the total product;
//   logup_down_launch  the inverses from the inverted total, written out
//                      ([n, 16], the batch inverse) or multiplied by m_i and
//                      summed ([16], the partial sum).
//
// Replaces zkevm_specs_tpu/tables/logup.py:batch_inverse (:49-84) and
// logup_partial_sum (:87-106): there prefix and suffix products by
// lax.associative_scan with an Fr-multiply combine, one fr.inv of the
// total, inv[i] = prefix[i-1] * suffix[i+1] * total_inv, then a pairwise
// tree of Fr adds.  Only canonical values leave either version, and the
// inverse of a nonzero element (and a sum in the field) has one canonical
// value, so the limbs equal the JAX ones.  One zero element zeroes the
// total, its inverse is 0, and every level below it then yields 0: every
// inverse and the partial sum are 0, as in JAX (logup.py:63-84).
//
// Design: a recursive Montgomery inversion.  Level 0 holds the n elements
// (alpha - fp_i in the partial sum), level l + 1 the products of level l's
// chunks, down to one element, the total.  Chunk j of a level of n_l
// elements is {j, j + c, j + 2c, ...} for c = ceil(n_l / CHUNK), so a warp's
// threads touch neighbouring elements.  The up pass keeps each chunk's
// running (inclusive) products; the down pass starts a chunk from its
// product's inverse and walks it backwards: inv(x_k) = running * prefix
// before k, then running *= x_k.  Workspace arrays are limb-major uint32
// ([16][n_l]); the caller allocates the workspace (logup_workspace_words in
// the wrapper mirrors the layout below, which the entries check).
//
// What bounds it on the card: integer multiply-adds, about four field
// products an element (one up, two down, one by m_i) against 256 bytes or
// less read an element; at small n the latency of the levels' chains and
// of the one inversion between the entries.
#include "fr_arith.cuh"

#define LOGUP_CHUNK 16
#define LOGUP_THREADS 128
#define LOGUP_MAX_LEVELS 24

namespace {

// the elements of one level: level 0 reads int64 rows (row stride sx, nx
// limbs), as alpha - row when alpha is given; a higher level reads its
// limb-major workspace array
struct Src {
  const int64_t* x;
  long long sx;
  int nx;
  const int64_t* alpha;
  const uint32_t* w;
  long long n;
};

__device__ __forceinline__ void load(const Src& s, long long i, uint32_t v[16]) {
  if (s.w != nullptr) {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = s.w[k * s.n + i];
    return;
  }
  const int64_t* row = s.x + i * s.sx;
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = limb_at(row, k, s.nx);
  if (s.alpha != nullptr) {
    uint32_t a[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) a[k] = (uint32_t)s.alpha[k];
    fr_sub16(a, v, v);
  }
}

__device__ __forceinline__ void store_w(uint32_t* w, long long n, long long i, const uint32_t v[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k * n + i] = v[k];
}

__device__ __forceinline__ void store_rows(int64_t* o, const uint32_t v[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = (int64_t)v[k];
}

__device__ __forceinline__ long long chunk_len(long long n, long long n_chunks, long long j) {
  return (n - j + n_chunks - 1) / n_chunks;
}

// up pass of one level: chunk j's running products into pre, its product
// into prod (limb-major, n_chunks elements), or into top (int64 [16]) when
// the level has one chunk
__global__ void __launch_bounds__(LOGUP_THREADS)
up_kernel(Src s, long long n_chunks, uint32_t* __restrict__ pre, uint32_t* __restrict__ prod,
          int64_t* __restrict__ top) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_chunks) return;
  const long long len = chunk_len(s.n, n_chunks, j);
  uint32_t acc[16];
  load(s, j, acc);
  store_w(pre, s.n, j, acc);
#pragma unroll 1
  for (long long k = 1; k < len; ++k) {
    const long long i = j + k * n_chunks;
    uint32_t v[16];
    load(s, i, v);
    fr_mul16(acc, v, acc);
    store_w(pre, s.n, i, acc);
  }
  if (n_chunks == 1) {
    store_rows(top, acc);
  } else {
    store_w(prod, n_chunks, j, acc);
  }
}

// down pass of one level: chunk j from its product's inverse (inv_next, a
// limb-major array of n_chunks elements, or top_inv when there is one
// chunk) to each element's inverse: into inv_w (a higher level), into
// rows ([n, 16], level 0 of the batch inverse), or multiplied by m_i and
// summed into sum_w[j] (level 0 of the partial sum; m null means 1)
__global__ void __launch_bounds__(LOGUP_THREADS)
down_kernel(Src s, long long n_chunks, const uint32_t* __restrict__ pre,
            const uint32_t* __restrict__ inv_next, const int64_t* __restrict__ top_inv,
            uint32_t* __restrict__ inv_w, int64_t* __restrict__ rows,
            const int64_t* __restrict__ m, long long sm, int nm, uint32_t* __restrict__ sum_w) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_chunks) return;
  const long long len = chunk_len(s.n, n_chunks, j);
  uint32_t running[16], sum[16];
  if (top_inv != nullptr) {
#pragma unroll
    for (int k = 0; k < 16; ++k) running[k] = (uint32_t)top_inv[k];
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) running[k] = inv_next[k * n_chunks + j];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) sum[k] = 0;
#pragma unroll 1
  for (long long k = len - 1; k >= 0; --k) {
    const long long i = j + k * n_chunks;
    uint32_t out[16];
    if (k > 0) {
      uint32_t p[16], v[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) p[t] = pre[t * s.n + i - n_chunks];
      fr_mul16(running, p, out);
      load(s, i, v);
      fr_mul16(running, v, running);
    } else {
#pragma unroll
      for (int t = 0; t < 16; ++t) out[t] = running[t];
    }
    if (sum_w != nullptr) {
      if (m != nullptr) {
        const int64_t* mr = m + i * sm;
        uint32_t mv[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) mv[t] = limb_at(mr, t, nm);
        fr_mul16(out, mv, out);
      }
      fr_add16(sum, out, sum);
    } else if (rows != nullptr) {
      store_rows(rows + i * 16, out);
    } else {
      store_w(inv_w, s.n, i, out);
    }
  }
  if (sum_w != nullptr) store_w(sum_w, n_chunks, j, sum);
}

// one level of the sum's reduction: chunk j of in (n elements) into
// out[j], or into final (int64 [16]) when the level has one chunk
__global__ void __launch_bounds__(LOGUP_THREADS)
sum_kernel(const uint32_t* __restrict__ in, long long n, long long n_chunks,
           uint32_t* __restrict__ out, int64_t* __restrict__ final_sum) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_chunks) return;
  const long long len = chunk_len(n, n_chunks, j);
  uint32_t acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = in[k * n + j];
#pragma unroll 1
  for (long long k = 1; k < len; ++k) {
    uint32_t v[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) v[t] = in[t * n + j + k * n_chunks];
    fr_add16(acc, v, acc);
  }
  if (n_chunks == 1) {
    store_rows(final_sum, acc);
  } else {
    store_w(out, n_chunks, j, acc);
  }
}

// the levels and the workspace layout: n_0 = n, n_{l+1} = ceil(n_l / CHUNK)
// until one element (at least one level up); per level l < L the running
// products PRE_l (n_l elements), per level 1 <= l <= L the chunk products
// X_l, per level 1 <= l < L the inverses INV_l; 16 words an element
struct Plan {
  int L;
  long long n[LOGUP_MAX_LEVELS + 1];
  long long pre[LOGUP_MAX_LEVELS], x[LOGUP_MAX_LEVELS + 1], inv[LOGUP_MAX_LEVELS + 1];
  long long words;
};

int make_plan(long long n, Plan* p) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  p->n[0] = n;
  int L = 0;
  do {
    if (L == LOGUP_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    p->n[L + 1] = (p->n[L] + LOGUP_CHUNK - 1) / LOGUP_CHUNK;
    ++L;
  } while (p->n[L] > 1);
  p->L = L;
  long long at = 0;
  for (int l = 0; l < L; ++l) { p->pre[l] = at; at += 16 * p->n[l]; }
  for (int l = 1; l <= L; ++l) { p->x[l] = at; at += 16 * p->n[l]; }
  for (int l = 1; l < L; ++l) { p->inv[l] = at; at += 16 * p->n[l]; }
  p->words = at;
  return 0;
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + LOGUP_THREADS - 1) / LOGUP_THREADS);
}

Src level0(const void* x, long long sx, int nx, const void* alpha, long long n) {
  return Src{(const int64_t*)x, sx, nx, (const int64_t*)alpha, nullptr, n};
}

Src level_w(const uint32_t* w, long long n) { return Src{nullptr, 0, 0, nullptr, w, n}; }

}  // namespace

// the product tree of x ([n, nx] int64 rows, row stride sx; alpha - x when
// alpha, an int64 [16] row, is given) into work (words uint32 words); the
// total product into top (int64 [16])
extern "C" int logup_up_launch(const void* x, long long sx, int nx, const void* alpha, long long n,
                               void* work, long long words, void* top, void* stream) {
  Plan p;
  int err = make_plan(n, &p);
  if (err) return err;
  if (words < p.words || nx < 1 || nx > 16) return (int)cudaErrorInvalidValue;
  uint32_t* w = (uint32_t*)work;
  cudaStream_t st = (cudaStream_t)stream;
  for (int l = 0; l < p.L; ++l) {
    Src s = l == 0 ? level0(x, sx, nx, alpha, n) : level_w(w + p.x[l], p.n[l]);
    up_kernel<<<blocks_for(p.n[l + 1]), LOGUP_THREADS, 0, st>>>(
        s, p.n[l + 1], w + p.pre[l], l + 1 < p.L ? w + p.x[l + 1] : nullptr,
        l + 1 == p.L ? (int64_t*)top : nullptr);
  }
  return (int)cudaGetLastError();
}

// the down pass from top_inv (int64 [16], the inverse of logup_up_launch's
// total) over the same x, alpha and work: with sum 0 the inverses into out
// ([n, 16] int64); with sum 1 sum_i m_i * inv_i (m [n, nm] int64 rows, row
// stride sm, or null for 1) into out (int64 [16])
extern "C" int logup_down_launch(const void* x, long long sx, int nx, const void* alpha,
                                 long long n, const void* m, long long sm, int nm, void* work,
                                 long long words, const void* top_inv, void* out, int sum,
                                 void* stream) {
  Plan p;
  int err = make_plan(n, &p);
  if (err) return err;
  if (words < p.words || nx < 1 || nx > 16 || (m != nullptr && (nm < 1 || nm > 16)))
    return (int)cudaErrorInvalidValue;
  uint32_t* w = (uint32_t*)work;
  cudaStream_t st = (cudaStream_t)stream;
  for (int l = p.L - 1; l >= 0; --l) {
    Src s = l == 0 ? level0(x, sx, nx, alpha, n) : level_w(w + p.x[l], p.n[l]);
    const bool last = l + 1 == p.L;
    down_kernel<<<blocks_for(p.n[l + 1]), LOGUP_THREADS, 0, st>>>(
        s, p.n[l + 1], w + p.pre[l], last ? nullptr : w + p.inv[l + 1],
        last ? (const int64_t*)top_inv : nullptr, l > 0 ? w + p.inv[l] : nullptr,
        l == 0 && !sum ? (int64_t*)out : nullptr, (const int64_t*)m, sm, nm,
        l == 0 && sum ? w + p.x[1] : nullptr);
  }
  if (sum) {
    // the chunk sums sit in X_1 (no longer read); level l's sums reduce
    // into X_{l+1}, down to one
    for (int l = 1; l <= p.L; ++l) {
      const long long n_chunks = (p.n[l] + LOGUP_CHUNK - 1) / LOGUP_CHUNK;
      sum_kernel<<<blocks_for(n_chunks), LOGUP_THREADS, 0, st>>>(
          w + p.x[l], p.n[l], n_chunks, n_chunks > 1 ? w + p.x[l + 1] : nullptr,
          n_chunks == 1 ? (int64_t*)out : nullptr);
      if (n_chunks == 1) break;
    }
  }
  return (int)cudaGetLastError();
}
