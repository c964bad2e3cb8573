// K5 state_order_lt: the lexicographic ordering check of the state circuit.
// For each row i of n, build the ordering key of row i and of row
// (i - 1) mod n straight from the columns,
//   v   = (((tag * 2^28 + id) * 2^160 + address) * 2^16 + field_tag) * 2^32
//         + storage_key
//   key = v * 2^32 + rw_counter,
// and write out[i] = key(i - 1) < key(i) || tag[i] == Start (1).
//
// Replaces zkevm_specs_tpu/circuits/state.py:_order_limbs (state.py:253-281)
// applied to the rows and to StateRows.shifted(-1), and the L.lt compare of
// check_state_rows (state.py:304-311).  It takes the columns at their
// declared bounds (tag < 2^8, id < 2^32, address < 2^160, field_tag < 2^16,
// storage_key < 2^256 as lo/hi 128-bit halves, rw_counter < 2^32), where
// that F arithmetic is exact: the key is then the integer above, 19 limbs
// wide (the JAX key's limbs 19..30 are zero).  Wider witnesses take the F
// operations on the host's side of that static branch.
//
// What bounds it on the card: bytes.  A row needs 32 limbs (tag 1, id 2,
// address 10, field_tag 1, storage_key 16, rw_counter 2) and writes one
// flag; the arithmetic is one 17-limb add with carry and a 19-limb compare.
// The design is one thread per row that builds both keys in registers; the
// previous row's limbs are the neighbouring thread's, so they come from
// L1/L2 and not a second pass over device memory, and no 31-limb key is
// ever written out (the JAX version materialises two [n, 31] keys).
#include "limb_common.cuh"

namespace {

constexpr int KEY_LIMBS = 19;
constexpr unsigned START_TAG = 1;

struct Cols {
  const int64_t* tag;
  const int64_t* id;
  const int64_t* address;
  const int64_t* field_tag;
  const int64_t* sk_lo;
  const int64_t* sk_hi;
  const int64_t* rw_counter;
  long long s_tag, s_id, s_address, s_field_tag, s_sk_lo, s_sk_hi, s_rw_counter;
};

__device__ __forceinline__ void order_key(const Cols& c, long long i, uint32_t key[KEY_LIMBS]) {
  const int64_t* rwc = c.rw_counter + i * c.s_rw_counter;
  key[0] = (uint32_t)rwc[0];
  key[1] = (uint32_t)rwc[1];
  const int64_t* id = c.id + i * c.s_id;
  // a = tag * 2^28 + id < 2^37
  const uint64_t a = ((uint64_t)c.tag[i * c.s_tag] << 28) + (uint64_t)id[0] +
                     ((uint64_t)id[1] << 16);
  // w = a * 2^176 + address * 2^16 + field_tag, 14 limbs, no overlaps
  uint32_t w[14];
  w[0] = (uint32_t)c.field_tag[i * c.s_field_tag];
  const int64_t* addr = c.address + i * c.s_address;
#pragma unroll
  for (int k = 0; k < 10; ++k) w[1 + k] = (uint32_t)addr[k];
  w[11] = (uint32_t)(a & LIMB_MASK);
  w[12] = (uint32_t)((a >> 16) & LIMB_MASK);
  w[13] = (uint32_t)(a >> 32);
  // v = w * 2^32 + storage_key, 17 limbs, at key limbs 2..18
  const int64_t* lo = c.sk_lo + i * c.s_sk_lo;
  const int64_t* hi = c.sk_hi + i * c.s_sk_hi;
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < 17; ++j) {
    uint32_t s = carry;
    if (j < 8) s += (uint32_t)lo[j];
    else if (j < 16) s += (uint32_t)hi[j - 8];
    if (j >= 2 && j < 16) s += w[j - 2];
    key[2 + j] = s & LIMB_MASK;
    carry = s >> LIMB_BITS;
  }
}

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
state_order_lt_kernel(Cols c, bool* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t cur[KEY_LIMBS], prev[KEY_LIMBS];
  order_key(c, i, cur);
  order_key(c, i == 0 ? n - 1 : i - 1, prev);
  bool lt = false;
  bool decided = false;
#pragma unroll
  for (int k = KEY_LIMBS - 1; k >= 0; --k) {
    if (!decided && prev[k] != cur[k]) {
      lt = prev[k] < cur[k];
      decided = true;
    }
  }
  out[i] = lt || (uint64_t)c.tag[i * c.s_tag] == START_TAG;
}

}  // namespace

extern "C" int state_order_lt_launch(const void* tag, long long s_tag, const void* id,
                                     long long s_id, const void* address, long long s_address,
                                     const void* field_tag, long long s_field_tag,
                                     const void* sk_lo, long long s_sk_lo, const void* sk_hi,
                                     long long s_sk_hi, const void* rw_counter,
                                     long long s_rw_counter, void* out, long long n,
                                     void* stream) {
  if (n <= 0) return 0;
  Cols c{(const int64_t*)tag, (const int64_t*)id, (const int64_t*)address,
         (const int64_t*)field_tag, (const int64_t*)sk_lo, (const int64_t*)sk_hi,
         (const int64_t*)rw_counter, s_tag, s_id, s_address, s_field_tag, s_sk_lo, s_sk_hi,
         s_rw_counter};
  state_order_lt_kernel<<<grid_for(n), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      c, (bool*)out, n);
  return (int)cudaGetLastError();
}
