// K8 horner_rlc: the byte random linear combination of each row of a
// batch, acc <- (acc * r + byte) mod p over the active steps, for byte
// columns bytes [T, n] (uint8), an activity mask active [T, n] (bool) and a
// static canonical r (16 limbs, passed by value); out [n, 16] canonical
// limbs of the BN254 scalar field.
//
// Replaces zkevm_specs_tpu/circuits/keccak.py:_horner_rlc (:44-74): there a
// lax.scan whose step is L.mul by r's limbs, L.add of the byte, then
// fr.reduce_wide, masked by active.  Every value below is a canonical
// residue (the Barrett step of fr_arith.cuh, shared with K1 and K12,
// reduces anything below 2^512 exactly), so any order of combining gives
// the JAX limbs.
//
// What bounds it on the card: the least work is a row's sum over active j
// of byte_j * r^e_j (e_j its active steps after j) from a table of powers
// of r: a byte times eight 32-bit limbs a step (about 18 instructions),
// and bytes, the two input columns and the table read once.  At the ALU
// block's table [66001, 8] that is bytes, under 0.001 ms (chip_smoke.py's
// horner_cost).  This kernel does far more: a 16-bit-limb field product
// and its Barrett reduction a step (about 1800 instructions, one 64-bit
// column sum carrying the chain), so its own arithmetic, not the card,
// sets its time.  One thread per row, the old design, left that table to
// 8 threads, each a chain of 66001 dependent steps with its mask load
// inside every step (233 ms).
//
// The design is a chunked Horner.  For a general mask, a row's value is
// the sum over active j of byte_j * r^(active steps after j), so a chunk
// of C steps is summarised by (h, r^c): h its own Horner value from 0 and
// c its count of active steps; (h_a, P_a) then (h_b, P_b) combine to
// (h_a * P_b + h_b, P_a * P_b), and a chunk with no active step is the
// identity (0, 1).
//  * The schedule (circuits/keccak.py:horner_schedule, shared with the
//    tests) picks C so that n * ceil(T / C) work items fill the card
//    (132 SMs x 2 blocks x 256 threads), C <= 1024; a block holds
//    chunks_per_block consecutive chunks of rows_per_block rows (<= 256
//    threads).  When n alone fills the card C = T: one thread per row, as
//    before.
//  * Chunk phase (horner_chunk_kernel): the block stages its tile of
//    bytes and masks through shared memory, at most 32 steps of each of
//    its chunks at a time, loaded in address order; a step then reads one
//    packed 16-bit value (mask bit | byte) from shared memory, so no
//    global load sits inside the dependent chain.  r^c comes from a table
//    of r^0 .. r^C (built on the host from Python ints, cached on the
//    device per (r, C)).
//  * Combine phase: a tree over the block's chunks in shared memory (two
//    field products a level, independent of each other), each level
//    halving the sequence so that its busy threads fill the lowest warps;
//    with more than one block per row, each block writes its (h, P) pair
//    and a second launch (horner_combine_kernel, one block per row) folds
//    and combines them the same way.  The chain is C steps plus one
//    product pair per level: about log2(256) + log2(groups) levels.
//  * Both kernels are held to two resident blocks an SM (MIN_BLOCKS);
//    horner_blocks_per_sm reads the occupancy back from the built kernels.
#include <string.h>

#include "fr_arith.cuh"

namespace {

constexpr int MAX_THREADS = 256;  // threads of a block, both kernels
// resident blocks an SM asked of ptxas (at most 128 registers a thread):
// left to itself it gives the halving tree 181-201 registers, one block an
// SM, and the SHA3 mix's 256 blocks of one thread a row then run in two
// waves
constexpr int MIN_BLOCKS = 2;
constexpr int MAX_STAGE = 32;     // steps of each chunk staged at a time
constexpr uint32_t ACTIVE_BIT = 0x100;

struct Limbs16 {
  uint32_t v[16];
};

// x += a over x's 32 limbs (x < p^2 and a < p, so no carry leaves x)
__device__ __forceinline__ void add_low16(uint32_t x[32], const uint32_t a[16]) {
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t v = x[k] + a[k] + carry;
    x[k] = v & LIMB_MASK;
    carry = v >> LIMB_BITS;
  }
#pragma unroll
  for (int k = 16; k < 32; ++k) {
    const uint32_t v = x[k] + carry;
    x[k] = v & LIMB_MASK;
    carry = v >> LIMB_BITS;
  }
}

// (h, pw) <- (h * pwb + hb, pw * pwb): chunk range a, then range b after it.
// Out of line: cicc 12.9 crashes on these kernels with it inlined into the
// trees; a call costs a 256-byte stack frame, off the chunk scans' path
__device__ __noinline__ void combine(uint32_t h[16], uint32_t pw[16], const uint32_t hb[16],
                                        const uint32_t pwb[16]) {
  uint32_t x[32];
  fr_product(h, pwb, 0u, x);
  add_low16(x, hb);
  fr_barrett(x, h);
  fr_mul16(pw, pwb, pw);
}

// the pair of thread slot t in a [32][threads] shared buffer (limb-major, so
// neighbouring threads hit neighbouring banks)
__device__ __forceinline__ void store_pair(uint32_t* buf, int threads, int t, const uint32_t h[16],
                                           const uint32_t pw[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    buf[k * threads + t] = h[k];
    buf[(16 + k) * threads + t] = pw[k];
  }
}

__device__ __forceinline__ void load_pair(const uint32_t* buf, int threads, int t, uint32_t h[16],
                                          uint32_t pw[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    h[k] = buf[k * threads + t];
    pw[k] = buf[(16 + k) * threads + t];
  }
}

// In-order tree over `count` pairs: the thread at position pos (0 ..) of
// the sequence sits in slot t = pos * unit + lane.  Each level halves the
// sequence: position i takes the pairs at 2i and 2i + 1 (or the lone last
// one), so the busy threads are the lowest slots and whole warps fall idle
// as the count halves.  At the end position 0's thread holds the combined
// pair.  Every thread of the block calls it (it synchronises).
__device__ __forceinline__ void tree_combine(uint32_t* buf, int threads, int t, int pos, int count,
                                             int unit, uint32_t h[16], uint32_t pw[16]) {
  store_pair(buf, threads, t, h, pw);
  const int lane = t - pos * unit;
  for (int c = count; c > 1; c = (c + 1) >> 1) {
    __syncthreads();
    const bool busy = pos < (c + 1) >> 1;
    if (busy) {
      load_pair(buf, threads, 2 * pos * unit + lane, h, pw);
      if (2 * pos + 1 < c) {
        uint32_t hb[16], pwb[16];
        load_pair(buf, threads, (2 * pos + 1) * unit + lane, hb, pwb);
        combine(h, pw, hb, pwb);
      }
    }
    __syncthreads();
    if (busy) store_pair(buf, threads, t, h, pw);
  }
}

__device__ __forceinline__ void write_limbs(int64_t* o, const uint32_t v[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = (int64_t)v[k];
}

// block b = row group * groups + chunk group; thread t = chunk in block *
// rows_per_block + row in block
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
horner_chunk_kernel(const uint8_t* __restrict__ bytes, const bool* __restrict__ active, long long T,
                    long long n, int C, long long K, int R, int Kb, int S, long long groups,
                    Limbs16 r, const uint32_t* __restrict__ powers, int64_t* __restrict__ out,
                    uint32_t* __restrict__ partial) {
  __shared__ uint32_t smem[32 * MAX_THREADS];  // the staged steps, then the tree
  uint16_t* stage = reinterpret_cast<uint16_t*>(smem);
  const int threads = R * Kb;
  const int t = threadIdx.x;
  const int kb = t / R, rr = t % R;
  const long long rg = blockIdx.x / groups, cg = blockIdx.x % groups;
  const long long row = rg * R + rr;
  const long long first = cg * Kb;  // the block's first chunk

  uint32_t acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0;
  int c = 0;
  const int stages = (C + S - 1) / S;
  for (int s = 0; s < stages; ++s) {
    __syncthreads();  // the previous stage is consumed
    // element e = (chunk in block, line, row in block): consecutive e,
    // consecutive addresses within a line of R rows
    for (int e = t; e < S * threads; e += threads) {
      const int er = e % R, q = e / R;
      const int line = q % S, ekb = q / S;
      const int step = s * S + line;
      const long long ch = first + ekb;
      const long long j = ch * C + step;
      const long long erow = rg * R + er;
      uint16_t v = 0;
      if (step < C && ch < K && j < T && erow < n) {
        const long long at = j * n + erow;
        if (active[at]) v = (uint16_t)(ACTIVE_BIT | bytes[at]);
      }
      stage[line * threads + ekb * R + er] = v;
    }
    __syncthreads();
    const int lines = min(S, C - s * S);
#pragma unroll 1
    for (int line = 0; line < lines; ++line) {
      const uint32_t v = stage[line * threads + t];
      if (v & ACTIVE_BIT) {
        uint32_t x[32];
        fr_product(acc, r.v, v & 0xFFu, x);
        fr_barrett(x, acc);
      }
      c += v >> 8;  // counted outside the branch (cicc 12.9 crashes on ++c inside it)
    }
  }
  if (K == 1) {  // one chunk a row: the scan is the row's value
    if (row < n) write_limbs(out + row * 16, acc);
    return;
  }

  uint32_t pw[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) pw[k] = __ldg(powers + c * 16 + k);
  __syncthreads();  // the stage buffer becomes the tree's
  const int count = (int)(K - first < Kb ? K - first : Kb);
  tree_combine(smem, threads, t, kb, count, R, acc, pw);
  if (kb != 0 || row >= n) return;
  if (groups == 1) {
    write_limbs(out + row * 16, acc);
  } else {
    uint32_t* o = partial + (row * groups + cg) * 32;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      o[k] = acc[k];
      o[16 + k] = pw[k];
    }
  }
}

// one block per row: thread t folds its run of the row's chunk groups in
// order, then the tree combines the runs
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
horner_combine_kernel(const uint32_t* __restrict__ partial, long long groups,
                      int64_t* __restrict__ out) {
  __shared__ uint32_t smem[32 * MAX_THREADS];
  const long long row = blockIdx.x;
  const int t = threadIdx.x, threads = blockDim.x;
  const long long per = (groups + threads - 1) / threads;
  const long long g0 = t * per, g1 = g0 + per < groups ? g0 + per : groups;
  const uint32_t* src = partial + row * groups * 32;
  uint32_t h[16], pw[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    h[k] = 0;
    pw[k] = k == 0;
  }
  if (g0 < g1) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      h[k] = src[g0 * 32 + k];
      pw[k] = src[g0 * 32 + 16 + k];
    }
  }
#pragma unroll 1
  for (long long g = g0 + 1; g < g1; ++g) {
    uint32_t hb[16], pwb[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      hb[k] = src[g * 32 + k];
      pwb[k] = src[g * 32 + 16 + k];
    }
    combine(h, pw, hb, pwb);
  }
  const int count = (int)((groups + per - 1) / per);
  tree_combine(smem, threads, t, t, count, 1, h, pw);
  if (t == 0) write_limbs(out + row * 16, h);
}

}  // namespace

// The chunk phase of schedule (chunk, rows_per_block, chunks_per_block)
// (circuits/keccak.py:horner_schedule); the chunks a row, the stage and
// the groups follow from it.  With groups > 1 it leaves [n, groups, 32]
// uint32 pairs in partial for horner_combine_launch, else the [n, 16]
// result in out.
extern "C" int horner_chunk_launch(const void* bytes, const void* active, long long T, long long n,
                                   int chunk, int rows_per_block, int chunks_per_block,
                                   const void* r_limbs, const void* powers, void* out,
                                   void* partial, void* stream) {
  if (n <= 0) return 0;
  if (T < 0 || chunk < 1) return (int)cudaErrorInvalidValue;
  const long long chunks = T > chunk ? (T + chunk - 1) / chunk : 1;
  const long long groups = (chunks + chunks_per_block - 1) / chunks_per_block;
  const long long threads = (long long)rows_per_block * chunks_per_block;
  if (r_limbs == nullptr || rows_per_block < 1 || chunks_per_block < 1 || threads > MAX_THREADS ||
      (chunks > 1 && powers == nullptr) || (groups > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block * groups;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  Limbs16 r;
  memcpy(r.v, r_limbs, sizeof(r.v));  // host array of 16 uint32 limbs
  horner_chunk_kernel<<<(unsigned int)blocks, (unsigned int)threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const bool*)active, T, n, chunk, chunks, rows_per_block,
      chunks_per_block, chunk < MAX_STAGE ? chunk : MAX_STAGE, groups, r,
      (const uint32_t*)powers, (int64_t*)out, (uint32_t*)partial);
  return (int)cudaGetLastError();
}

// The combine phase over the chunk phase's pairs: one block per row, of
// the power of two at or above min(groups, MAX_THREADS) threads.
extern "C" int horner_combine_launch(const void* partial, long long n, long long groups, void* out,
                                     void* stream) {
  if (n <= 0) return 0;
  if (partial == nullptr || groups < 1 || n > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  int threads = 1;
  while (threads < groups && threads < MAX_THREADS) threads <<= 1;
  horner_combine_kernel<<<(unsigned int)n, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)partial, groups, (int64_t*)out);
  return (int)cudaGetLastError();
}

// Resident blocks of MAX_THREADS threads an SM, of the chunk and the
// combine kernel (the schedule's HORNER_TARGET_ITEMS is sized by it)
extern "C" int horner_blocks_per_sm(int* chunk_blocks, int* combine_blocks) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      chunk_blocks, horner_chunk_kernel, MAX_THREADS, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(combine_blocks, horner_combine_kernel,
                                                        MAX_THREADS, 0);
  return (int)err;
}
