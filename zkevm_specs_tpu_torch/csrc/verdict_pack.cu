// K10 verdict_pack: gathers the block's fail vectors (one bool vector per
// EVM group, the state check and each circuit check) into one flat uint8
// buffer, so that one device-to-host copy fetches every verdict.  Vector v
// of m lands at a 16-byte aligned offset; the bytes between its end and
// the next vector's offset are 0.  A device table of int64 holds, for
// vector v, its address (table[v]), its length (table[m + v]), its output
// offset (table[2m + v]) and its first block (table[3m + v], the prefix sum
// of ceil(length / BLOCK_BYTES)).
//
// Replaces the verdict concatenation of
// zkevm_specs_tpu/runtime/block.py:make_combined (:514-519,
// jnp.concatenate of o.ravel().astype(uint8)), read back in
// run_device_combined's order (:536-553).
//
// What bounds it on the card: bytes, one read and one write of each
// verdict byte, and at the block's sizes (about 10^6 verdicts) the launch
// itself.  The design is one 1-D grid of exactly the blocks the vectors
// need: a block stages the first-block column in shared memory (one load
// each, in parallel) and finds its vector by a binary search there, so
// the chain of dependent global loads is the table row, the source and
// the store; each thread turns 16 source bytes into one aligned 16-byte
// store, normalised to 0/1 a 4-byte word at a time (__vcmpne4).  A
// vector's body is read 16 bytes at a time where its address is 16-byte
// aligned (every fresh allocation), byte by byte otherwise; its ragged end
// reads only its own bytes and writes the padding as 0.  The table is read
// from device memory, so a CUDA graph that captured the launch can hold
// the addresses of the vectors the graph itself allocates, written into
// the table after the capture; the grid depends on the lengths alone.
#include "limb_common.cuh"

namespace {

constexpr int BLOCK_BYTES = THREADS_PER_BLOCK * 16;
constexpr int MAX_VECTORS = 1024;  // the first-block column, staged in shared memory

__device__ __forceinline__ uint32_t normalise(uint32_t w) { return __vcmpne4(w, 0u) & 0x01010101u; }

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
verdict_pack_kernel(const long long* __restrict__ table, int m, uint8_t* __restrict__ out) {
  __shared__ long long first[MAX_VECTORS];
  for (int k = threadIdx.x; k < m; k += THREADS_PER_BLOCK) first[k] = table[3 * m + k];
  __syncthreads();
  const long long b = blockIdx.x;
  int lo = 0, hi = m - 1;  // the last vector whose first block is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (first[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const int v = lo;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(table[v]);
  const long long n = table[m + v];
  const long long i = (b - first[v]) * BLOCK_BYTES + 16LL * threadIdx.x;
  if (i >= n) return;
  uint32_t w[4];
  if (i + 16 <= n && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4 q = *reinterpret_cast<const uint4*>(src + i);
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else {
    const long long left = n - i;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int at = 4 * k + c;
        if (at < left) word |= (uint32_t)src[i + at] << (8 * c);
      }
      w[k] = word;
    }
  }
  *reinterpret_cast<uint4*>(out + table[2 * m + v] + i) =
      make_uint4(normalise(w[0]), normalise(w[1]), normalise(w[2]), normalise(w[3]));
}

}  // namespace

// blocks: the grid, the sum over vectors of ceil(length / BLOCK_BYTES)
// (runtime/transfer.py:verdict_blocks, at VERDICT_BLOCK_BYTES = BLOCK_BYTES)
extern "C" int verdict_pack_launch(const void* table, int m, long long blocks, void* out,
                                   void* stream) {
  if (m <= 0 || blocks <= 0) return 0;
  if (m > MAX_VECTORS || table == nullptr || out == nullptr ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 || blocks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  verdict_pack_kernel<<<(unsigned int)blocks, THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)table, m, (uint8_t*)out);
  return (int)cudaGetLastError();
}
