// Shared definitions of the limb kernels: 16-bit limbs held in int64
// tensors, one thread per lane, lane rows addressed by an element stride
// (0 for a broadcast [1, w] constant row).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LIMB_MASK 0xFFFFu
#define LIMB_BITS 16
#define THREADS_PER_BLOCK 256

// BN254 scalar-field modulus p as 17 little-endian 16-bit limbs (top limb 0)
__constant__ uint32_t c_p17[17] = {
    0x0001, 0xf000, 0xf593, 0x43e1, 0x7091, 0x79b9, 0xe848, 0x2833, 0x585d,
    0x8181, 0x45b6, 0xb850, 0xa029, 0xe131, 0x4e72, 0x3064, 0x0000};

// Barrett constant mu = floor(2^512 / p), 259 bits, 17 limbs
__constant__ uint32_t c_mu17[17] = {
    0x9259, 0xe1de, 0x3a6b, 0x2070, 0x0ae6, 0x9e88, 0x5200, 0x1448, 0x0147,
    0x8073, 0xa586, 0xb074, 0x4a7a, 0x23a0, 0x4626, 0x4a47, 0x0005};

// limb k of a lane row of width n, zero beyond the row (the JAX package's
// pad_limbs)
__device__ __forceinline__ uint32_t limb_at(const int64_t* row, int k, int n) {
  return k < n ? (uint32_t)row[k] : 0u;
}

static inline unsigned int grid_for(long long batch) {
  return (unsigned int)((batch + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK);
}

// e / n for e * n < 2^32: a multiply by ceil(2^32 / n) (host_magic)
__device__ __forceinline__ int div_by(int e, int n, unsigned magic) {
  return n == 1 ? e : (int)__umulhi((unsigned)e, magic);
}

static inline unsigned host_magic(int n) { return n <= 1 ? 0u : 0xFFFFFFFFu / (unsigned)n + 1u; }

// A tile of lane rows staged flattened into shared memory (K1 fr_mul.cu,
// K11 mul_add_words.cu): an operand of n limbs a row every `stride`
// elements (0: one broadcast row).  The loop walks `span`-limb rows (n
// where the rows are dense, so the tile is one range of elements; `copy`
// otherwise) and keeps the first `copy` = min(n, limbs) limbs.
struct StagedRow {
  const int64_t* p;
  long long stride;
  int n, copy, span;
  unsigned magic;  // div_by's reciprocal of span
  int vec;         // 16-byte loads: base 16-byte aligned, and pairs never straddle rows
};

static inline StagedRow staged_row(const void* p, long long stride, int n, int limbs) {
  StagedRow x;
  x.p = (const int64_t*)p;
  x.stride = stride;
  x.n = n;
  x.copy = n < limbs ? n : limbs;
  x.span = stride == n ? n : x.copy;
  x.magic = host_magic(x.span);
  const bool aligned = ((uintptr_t)p & 15) == 0;
  x.vec = aligned && (stride == n || (stride % 2 == 0 && x.span % 2 == 0));
  return x;
}

// Loads the first `copy` limbs of the tile's rows of x (`lanes` lanes from
// lane `base`) into shared-memory rows of `pitch` elements of T, zero up to
// `limbs`; a broadcast row once.  Element e is lane e / span, limb e %
// span; consecutive threads take consecutive pairs, one 16-byte load a
// pair where x.vec allows.  T is uint32_t (a limb a word) or uint16_t (a
// canonical limb, below 2^16, a half).
template <typename T>
__device__ __forceinline__ void stage_rows(const StagedRow& x, T* s, long long base, int lanes,
                                           int pitch, int limbs) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (x.stride == 0) {
    for (int k = tid; k < limbs; k += nt) s[k] = k < x.copy ? (T)x.p[k] : (T)0;
    return;
  }
  const int64_t* src = x.p + base * x.stride;
  const int total = lanes * x.span;
#pragma unroll 4
  for (int e = 2 * tid; e < total; e += 2 * nt) {
    const int lane = div_by(e, x.span, x.magic);
    const int k = e - lane * x.span;
    const int lane1 = k + 1 == x.span ? lane + 1 : lane, k1 = k + 1 == x.span ? 0 : k + 1;
    int64_t v0, v1 = 0;
    if (x.vec && e + 1 < total) {
      const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(src + lane * x.stride + k));
      v0 = v.x;
      v1 = v.y;
    } else {
      v0 = __ldg(reinterpret_cast<const long long*>(src + lane * x.stride + k));
      if (e + 1 < total)
        v1 = __ldg(reinterpret_cast<const long long*>(src + lane1 * x.stride + k1));
    }
    if (k < x.copy) s[lane * pitch + k] = (T)v0;
    if (e + 1 < total && k1 < x.copy) s[lane1 * pitch + k1] = (T)v1;
  }
  if (x.copy < limbs)
    for (int lane = tid; lane < lanes; lane += nt)
      for (int k = x.copy; k < limbs; ++k) s[lane * pitch + k] = (T)0;
}
