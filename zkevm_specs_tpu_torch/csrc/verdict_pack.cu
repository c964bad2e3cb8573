// K10 verdict_pack: gathers the block's fail vectors (one bool vector per
// EVM group, the state check and each circuit check) into one flat uint8
// buffer, so that one device-to-host copy fetches every verdict.  A
// device table of int64 holds, for vector v of m, its address (table[v]),
// its length (table[m + v]) and its offset in the output (table[2m + v]).
//
// Replaces the verdict concatenation of
// zkevm_specs_tpu/runtime/block.py:make_combined (:514-519,
// jnp.concatenate of o.ravel().astype(uint8)), read back in
// run_device_combined's order (:536-553).
//
// What bounds it on the card: bytes, one read and one write of each
// verdict byte, and at the block's sizes the launch itself.  The design is
// a 2-D grid: blockIdx.y picks the vector, blockIdx.x a chunk of
// THREADS_PER_BLOCK * ITEMS bytes of it; blocks past a short vector's end
// return at once.  The table is read from device memory, so a CUDA graph
// that captured the launch can hold the addresses of the vectors the
// graph itself allocates, written into the table after the capture.
#include "limb_common.cuh"

namespace {

constexpr int ITEMS = 4;

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
verdict_pack_kernel(const long long* __restrict__ table, int m, uint8_t* __restrict__ out) {
  const int v = blockIdx.y;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(table[v]);
  const long long n = table[m + v];
  uint8_t* dst = out + table[2 * m + v];
  const long long base = (long long)blockIdx.x * THREADS_PER_BLOCK * ITEMS;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + (long long)k * THREADS_PER_BLOCK + threadIdx.x;
    if (i < n) dst[i] = src[i] != 0;
  }
}

}  // namespace

extern "C" int verdict_pack_launch(const void* table, int m, long long max_n, void* out,
                                   void* stream) {
  if (m <= 0 || max_n <= 0) return 0;
  if (m > 65535 || table == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)THREADS_PER_BLOCK * ITEMS;
  const long long gx = (max_n + per_block - 1) / per_block;
  if (gx > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)gx, (unsigned int)m);
  verdict_pack_kernel<<<grid, THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)table, m, (uint8_t*)out);
  return (int)cudaGetLastError();
}
