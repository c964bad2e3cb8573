// K5 state_order_lt: the lexicographic ordering check of the state circuit.
// For each row i of n, the ordering key of row i and of row (i - 1) mod n,
//   v   = (((tag * 2^28 + id) * 2^160 + address) * 2^16 + field_tag) * 2^32
//         + storage_key
//   key = v * 2^32 + rw_counter,
// and out[i] = key(i - 1) < key(i) || tag[i] == Start (1).
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
// address 10 of its 16, field_tag 1, storage_key 8 + 8, rw_counter 2) and
// writes one flag; the arithmetic is one 17-limb add with carry and a
// 19-limb compare.  The design is one thread a row, whose 32 limbs are
// loaded in 16-byte pairs (one load a limb where a column is not 16-byte
// aligned at an even row stride), all issued before any is used; its key is
// built once in registers, and the previous row's key comes from the lane
// before by a warp shuffle (lane 0 of each warp builds its own: row i - 1,
// or n - 1 for row 0, since the check is cyclic).  No shared memory and no
// barrier.  A warp's loads touch 32 rows a row apart, but each row's pairs
// come from the same lines, so the bytes from memory are the rows' limbs.
// Measured and replaced (profile_replay.py --narrow): a tile of 128 rows
// staged through shared memory, each column coalesced (first one
// stage_rows loop a column, then all seven as one range of pairs), keys
// built once into shared memory, the halo row by the warp after the tile:
// at 2^19 rows 0.085 ms at best, against 0.061 for this design and 0.090
// for the one-thread-a-row kernel that built both keys from scalar loads.
#include "limb_common.cuh"

#define ORDER_THREADS 128   // threads (rows) of a block: whole warps

namespace {

constexpr int KEY_LIMBS = 19;
constexpr int ROW_LIMBS = 32;  // limbs of a row the key uses
constexpr unsigned START_TAG = 1;

// the key's columns
enum Col { TAG, ID, ADDRESS, FIELD_TAG, SK_LO, SK_HI, RW_COUNTER, N_COLS };

// limbs of a column the key uses, and the column's first limb in a row's
// ROW_LIMBS (a sum written out, not recursive, so that a call with a
// constant column folds to a constant: a recursive device function is not
// inlined, and the row would leave registers)
__host__ __device__ constexpr int col_limbs(int c) {
  return c == TAG || c == FIELD_TAG ? 1 : c == ID || c == RW_COUNTER ? 2 : c == ADDRESS ? 10 : 8;
}
__host__ __device__ constexpr int limb_offset(int c) {
  return (c > TAG ? col_limbs(TAG) : 0) + (c > ID ? col_limbs(ID) : 0) +
         (c > ADDRESS ? col_limbs(ADDRESS) : 0) + (c > FIELD_TAG ? col_limbs(FIELD_TAG) : 0) +
         (c > SK_LO ? col_limbs(SK_LO) : 0) + (c > SK_HI ? col_limbs(SK_HI) : 0) +
         (c > RW_COUNTER ? col_limbs(RW_COUNTER) : 0);
}

static_assert(limb_offset(N_COLS) == ROW_LIMBS, "a row holds every limb the key uses");
static_assert(ORDER_THREADS % 32 == 0, "a block is whole warps: the shuffle takes every lane");

struct Args {
  const int64_t* p[N_COLS];
  long long stride[N_COLS];
  bool* out;
  long long n;
};

// the limbs of row r the key uses, column c's limb k at limb_offset(c) + k:
// one 16-byte load a pair where VEC (every column of two limbs or more
// 16-byte aligned at an even row stride), else one a limb
template <bool VEC>
__device__ __forceinline__ void load_row(const Args& g, long long r, uint32_t v[ROW_LIMBS]) {
#pragma unroll
  for (int c = 0; c < N_COLS; ++c) {
    const int64_t* row = g.p[c] + r * g.stride[c];
    if (VEC && col_limbs(c) % 2 == 0) {
#pragma unroll
      for (int k = 0; k < col_limbs(c); k += 2) {
        const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(row + k));
        v[limb_offset(c) + k] = (uint32_t)x.x;
        v[limb_offset(c) + k + 1] = (uint32_t)x.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < col_limbs(c); ++k)
        v[limb_offset(c) + k] = (uint32_t)__ldg(reinterpret_cast<const long long*>(row + k));
    }
  }
}

// the key of a row from its limbs v, into key[0..18]
__device__ __forceinline__ void build_key(const uint32_t v[ROW_LIMBS], uint32_t key[KEY_LIMBS]) {
  auto limb = [&](int c, int k) { return v[limb_offset(c) + k]; };
  key[0] = limb(RW_COUNTER, 0);
  key[1] = limb(RW_COUNTER, 1);
  // a = tag * 2^28 + id < 2^37
  const uint64_t a = ((uint64_t)limb(TAG, 0) << 28) + (uint64_t)limb(ID, 0) +
                     ((uint64_t)limb(ID, 1) << 16);
  // w = a * 2^176 + address * 2^16 + field_tag, 14 limbs, no overlaps
  uint32_t w[14];
  w[0] = limb(FIELD_TAG, 0);
#pragma unroll
  for (int k = 0; k < 10; ++k) w[1 + k] = limb(ADDRESS, k);
  w[11] = (uint32_t)(a & LIMB_MASK);
  w[12] = (uint32_t)((a >> 16) & LIMB_MASK);
  w[13] = (uint32_t)(a >> 32);
  // v = w * 2^32 + storage_key, 17 limbs, at key limbs 2..18
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < 17; ++j) {
    uint32_t s = carry;
    if (j < 8) s += limb(SK_LO, j);
    else if (j < 16) s += limb(SK_HI, j - 8);
    if (j >= 2 && j < 16) s += w[j - 2];
    key[2 + j] = s & LIMB_MASK;
    carry = s >> LIMB_BITS;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(ORDER_THREADS) state_order_lt_kernel(Args g) {
  const long long i = (long long)blockIdx.x * ORDER_THREADS + threadIdx.x;
  const bool live = i < g.n;
  const long long r = live ? i : g.n - 1;  // a lane past the end takes part in the shuffle
  uint32_t v[ROW_LIMBS], cur[KEY_LIMBS], prev[KEY_LIMBS];
  load_row<VEC>(g, r, v);
  const uint32_t tag = v[limb_offset(TAG)];
  build_key(v, cur);
#pragma unroll
  for (int k = 0; k < KEY_LIMBS; ++k) prev[k] = __shfl_up_sync(0xffffffffu, cur[k], 1);
  if ((threadIdx.x & 31) == 0) {
    load_row<VEC>(g, r == 0 ? g.n - 1 : r - 1, v);
    build_key(v, prev);
  }
  bool lt = false;
  bool decided = false;
#pragma unroll
  for (int k = KEY_LIMBS - 1; k >= 0; --k) {
    if (!decided && prev[k] != cur[k]) {
      lt = prev[k] < cur[k];
      decided = true;
    }
  }
  if (live) g.out[i] = lt || tag == START_TAG;
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
  const void* ptrs[N_COLS] = {tag, id, address, field_tag, sk_lo, sk_hi, rw_counter};
  const long long strides[N_COLS] = {s_tag, s_id, s_address, s_field_tag, s_sk_lo, s_sk_hi,
                                     s_rw_counter};
  Args g;
  bool vec = true;
  for (int c = 0; c < N_COLS; ++c) {
    if (strides[c] < 0) return (int)cudaErrorInvalidValue;
    g.p[c] = (const int64_t*)ptrs[c];
    g.stride[c] = strides[c];
    vec = vec && (col_limbs(c) % 2 == 1 ||
                  (((uintptr_t)ptrs[c] & 15) == 0 && strides[c] % 2 == 0));
  }
  g.out = (bool*)out;
  g.n = n;
  const unsigned blocks = (unsigned)((n + ORDER_THREADS - 1) / ORDER_THREADS);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec) state_order_lt_kernel<true><<<blocks, ORDER_THREADS, 0, s>>>(g);
  else state_order_lt_kernel<false><<<blocks, ORDER_THREADS, 0, s>>>(g);
  return (int)cudaGetLastError();
}
