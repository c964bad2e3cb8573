// K9 leaf_unpack: scatters the block verifier's uploaded input leaves from
// a few narrow staging buffers into one device arena, each leaf widened to
// its type in the port.  Sources (by kind): 0 u8, 1 u16, 2 int32, 3 int64.
// Each segment (one leaf) is five int64: source kind, source element
// offset, element count, destination kind (0 int64, 1 int32, 2 one byte)
// and destination byte offset in the arena.  The pairs that occur are
// u8 -> int64 and u16 -> int64 (16-bit limbs, words and indexes shipped at
// their data maximum), int32 -> int32, int64 -> int64 (u64 fingerprints as
// their int64 bits) and u8 -> one byte (bool and uint8 leaves kept as they
// are).
//
// Replaces zkevm_specs_tpu/runtime/block.py:_ship_leaves (:61-115): there
// the uint32 leaves are narrowed on the host, one device_put per dtype
// buffer, and a jitted unpacker of dynamic_slice + astype + reshape per
// leaf rebuilds the device arrays.
//
// What bounds it on the card: bytes.  Each element is read once (1, 2, 4
// or 8 bytes) and written once (8 bytes for the widened limbs), with no
// arithmetic.  The design is a chunk table built on the host: every leaf
// is cut into chunks of CHUNK elements and block b copies chunk b (its
// segment's five fields read once into shared memory), consecutive
// threads on consecutive elements, so both sides are coalesced and no
// thread searches for its leaf.
#include "limb_common.cuh"

namespace {

constexpr long long CHUNK = 4096;

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
leaf_unpack_kernel(const uint8_t* __restrict__ u8, const uint16_t* __restrict__ u16,
                   const int32_t* __restrict__ i32, const int64_t* __restrict__ i64,
                   const long long* __restrict__ segs, const long long* __restrict__ chunks,
                   uint8_t* __restrict__ arena) {
  __shared__ long long seg[5];
  __shared__ long long start;
  if (threadIdx.x < 5) seg[threadIdx.x] = segs[chunks[2 * blockIdx.x] * 5 + threadIdx.x];
  if (threadIdx.x == 0) start = chunks[2 * blockIdx.x + 1];
  __syncthreads();
  const int src_kind = (int)seg[0], dst_kind = (int)seg[3];
  const long long src_off = seg[1], n = seg[2];
  const long long end = start + CHUNK < n ? start + CHUNK : n;
  uint8_t* dst = arena + seg[4];
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    long long v;
    switch (src_kind) {
      case 0: v = u8[src_off + i]; break;
      case 1: v = u16[src_off + i]; break;
      case 2: v = i32[src_off + i]; break;
      default: v = i64[src_off + i]; break;
    }
    switch (dst_kind) {
      case 0: reinterpret_cast<int64_t*>(dst)[i] = (int64_t)v; break;
      case 1: reinterpret_cast<int32_t*>(dst)[i] = (int32_t)v; break;
      default: dst[i] = (uint8_t)v; break;
    }
  }
}

}  // namespace

extern "C" int leaf_unpack_launch(const void* u8, const void* u16, const void* i32,
                                  const void* i64, const void* segs, const void* chunks,
                                  long long n_chunks, void* arena, void* stream) {
  if (n_chunks <= 0) return 0;
  if (n_chunks > 0x7FFFFFFFLL || segs == nullptr || chunks == nullptr || arena == nullptr)
    return (int)cudaErrorInvalidValue;
  leaf_unpack_kernel<<<(unsigned int)n_chunks, THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)u8, (const uint16_t*)u16, (const int32_t*)i32, (const int64_t*)i64,
      (const long long*)segs, (const long long*)chunks, (uint8_t*)arena);
  return (int)cudaGetLastError();
}
