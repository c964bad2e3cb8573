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
// total, its inverse is 0, and every product below it then yields 0: every
// inverse and the partial sum are 0, as in JAX (logup.py:63-84).
//
// Design: a tree of block tiles on fr_mont.cuh's 32-bit-limb Montgomery
// product.  Level 0 holds the n elements (alpha - fp_i in the partial sum),
// converted to Montgomery form as they are loaded; level l + 1 holds the
// products of level l's tiles, down to one element, the total.  A tile is
// threads * run consecutive elements; thread j of tile t holds the run
// t * tile + j + k * threads, k < run (neighbouring threads on neighbouring
// elements), multiplies it serially, and the block multiplies its threads'
// run products by a binary tree in shared memory (log2(threads) steps).
// So a level shrinks tile-fold (1024 at 256 threads x 4): two levels at
// 528401 elements, three at 6160016.  The up entry stores each level's
// elements in Montgomery form, eight words each; the down entry rebuilds a
// tile's run prefixes and tree from them, walks the tree down from the
// tile product's inverse (a node's inverse times its sibling is its
// sibling's inverse), then each run backwards (inv(x_k) = inv(P_k) *
// P_(k-1), inv(P_(k-1)) = inv(P_k) * x_k), and writes the inverses over
// the level's elements, or at level 0 the canonical rows, or m_i times
// each inverse (a Montgomery product with a plain m_i is plain) summed by a
// tree of field adds into one sum a tile.  A last one-block launch adds the
// tile sums when there is more than one tile.  Device launches a call:
// levels up, K12, levels down, and that sum: 6 at 528401 elements, 8 at
// 6160016 (tables/logup.py:logup_plan mirrors make_plan, and the entries
// refuse a plan that differs).  Workspace arrays are word-major uint32
// ([8][n_l]); the caller allocates it.  The entries count the kernels they
// launch (logup_device_launches).
//
// The tile is fixed when the source is compiled: LOGUP_THREADS threads a
// block (a power of two) times LOGUP_RUN elements a thread, 256 x 4 as
// sized on the card (profile_replay.py --logup builds other tiles with
// -D for its sweep).
//
// What bounds it on the card: integer multiply-adds, about 4.5 field
// products an element (one conversion and one product up; the prefix
// again, two down, one by m_i) against 128 bytes or less read an element
// at level 0; at small n the latency of the levels' trees and of the one
// inversion between the entries.
#include "fr_mont.cuh"

#ifndef LOGUP_THREADS
#define LOGUP_THREADS 256
#endif
#ifndef LOGUP_RUN
#define LOGUP_RUN 4
#endif
#define LOGUP_MIN_BLOCKS 2
#define LOGUP_MAX_LEVELS 8

namespace {

static_assert(LOGUP_THREADS >= 32 && (LOGUP_THREADS & (LOGUP_THREADS - 1)) == 0,
              "LOGUP_THREADS: a power of two of at least a warp");
static_assert(LOGUP_RUN >= 1, "LOGUP_RUN: at least one element a thread");

constexpr int kThreads = LOGUP_THREADS;
constexpr long long kTile = (long long)LOGUP_THREADS * LOGUP_RUN;

// kernels launched by each entry since the library was loaded
int g_up_launches = 0, g_down_launches = 0;

// a binary tree over the block's threads: node 1 the root, node h + j
// (j < h) the parent of 2(h + j) and 2(h + j) + 1, thread j's leaf at
// kThreads + j; word-major so neighbouring threads touch neighbouring banks
struct Tree {
  uint32_t w[8][2 * kThreads];
};

__device__ __forceinline__ void node_get(const Tree& s, int i, uint32_t v[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = s.w[k][i];
}

__device__ __forceinline__ void node_put(Tree& s, int i, const uint32_t v[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) s.w[k][i] = v[k];
}

__device__ __forceinline__ void load_w(const uint32_t* w, long long n, long long i, uint32_t v[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = w[k * n + i];
}

__device__ __forceinline__ void store_w(uint32_t* w, long long n, long long i, const uint32_t v[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k * n + i] = v[k];
}

__device__ __forceinline__ void copy8(const uint32_t a[8], uint32_t out[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = a[k];
}

// the 16 canonical int64 limbs of a Montgomery-form value
__device__ __forceinline__ void store_canonical(const uint32_t v[8], int64_t* row) {
  uint32_t c[8];
  mont_from(v, c);
  mont_unpack16(c, row);
}

// every node of the tree from the threads' leaves: the root is their
// product (or sum, with add)
template <bool ADD>
__device__ __forceinline__ void tree_up(Tree& s, int j, const uint32_t leaf[8]) {
  node_put(s, kThreads + j, leaf);
  __syncthreads();
#pragma unroll 1
  for (int h = kThreads >> 1; h >= 1; h >>= 1) {
    if (j < h) {
      uint32_t a[8], b[8];
      node_get(s, 2 * (h + j), a);
      node_get(s, 2 * (h + j) + 1, b);
      if (ADD) {
        mont_add(a, b, a);
      } else {
        mont_mul(a, b, a);
      }
      node_put(s, h + j, a);
    }
    __syncthreads();
  }
}

// from the root's inverse in node 1, every node's inverse over its product:
// a node's inverse is its parent's inverse times its sibling's product
__device__ __forceinline__ void tree_down(Tree& s, int j) {
#pragma unroll 1
  for (int h = 2; h <= kThreads; h <<= 1) {
    uint32_t v[8];
    if (j < h) {
      uint32_t parent[8], sibling[8];
      node_get(s, (h + j) >> 1, parent);
      node_get(s, (h + j) ^ 1, sibling);
      mont_mul(parent, sibling, v);
    }
    __syncthreads();
    if (j < h) node_put(s, h + j, v);
    __syncthreads();
  }
}

// level 0's source: int64 rows (row stride sx, nx limbs), as alpha - row
// when alpha is given
struct Rows {
  const int64_t* x;
  long long sx;
  int nx;
  const int64_t* alpha;
};

// up pass of one level: tile blockIdx.x of its n elements (level 0: read
// from rows and stored into xw in Montgomery form; else read from xw) into
// its product, stored into next (n_next elements) or, for the last level,
// into top (int64 [16], canonical)
__global__ void __launch_bounds__(LOGUP_THREADS, LOGUP_MIN_BLOCKS)
up_kernel(Rows rows, long long n, uint32_t* __restrict__ xw, uint32_t* __restrict__ next,
          long long n_next, int64_t* __restrict__ top) {
  __shared__ Tree tree;
  const int j = threadIdx.x;
  const long long base = blockIdx.x * kTile + j;
  uint32_t alpha[8];
  if (rows.x != nullptr && rows.alpha != nullptr) mont_pack16(rows.alpha, 16, alpha);
  uint32_t acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = c_mont_one[k];
#pragma unroll
  for (int r = 0; r < LOGUP_RUN; ++r) {
    const long long i = base + (long long)r * kThreads;
    if (i < n) {
      uint32_t v[8];
      if (rows.x != nullptr) {
        uint32_t w[8];
        mont_pack16(rows.x + i * rows.sx, rows.nx, w);
        if (rows.alpha != nullptr) mont_sub(alpha, w, w);
        mont_to(w, v);
        store_w(xw, n, i, v);
      } else {
        load_w(xw, n, i, v);
      }
      if (r == 0) {
        copy8(v, acc);
      } else {
        mont_mul(acc, v, acc);
      }
    }
  }
  tree_up<false>(tree, j, acc);
  if (j == 0) {
    node_get(tree, 1, acc);
    if (n_next == 1) {
      store_canonical(acc, top);
    } else {
      store_w(next, n_next, blockIdx.x, acc);
    }
  }
}

// down pass of one level: tile blockIdx.x of the n elements in xw, from
// its product's inverse (inv_next[blockIdx.x], or top_inv, int64 [16]
// canonical, at the last level) to each element's inverse: over xw (a
// higher level), into rows_out ([n, 16], level 0 of the batch inverse), or
// multiplied by m_i (m null: 1) and summed (level 0 of the partial sum)
// into sums[blockIdx.x] (n_next elements, in place of inv_next), or into
// sum_out (int64 [16]) when the level is one tile
__global__ void __launch_bounds__(LOGUP_THREADS, LOGUP_MIN_BLOCKS)
down_kernel(long long n, uint32_t* __restrict__ xw, uint32_t* inv_next, long long n_next,
            const int64_t* __restrict__ top_inv, int level0, int64_t* __restrict__ rows_out,
            const int64_t* __restrict__ m, long long sm, int nm, int sum_mode,
            int64_t* __restrict__ sum_out) {
  __shared__ Tree tree;
  const int j = threadIdx.x;
  const long long base = blockIdx.x * kTile + j;
  // the run's prefix products again
  uint32_t pre[LOGUP_RUN][8], acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = c_mont_one[k];
#pragma unroll
  for (int r = 0; r < LOGUP_RUN; ++r) {
    const long long i = base + (long long)r * kThreads;
    if (i < n) {
      uint32_t v[8];
      load_w(xw, n, i, v);
      if (r == 0) {
        copy8(v, acc);
      } else {
        mont_mul(acc, v, acc);
      }
    }
    copy8(acc, pre[r]);
  }
  tree_up<false>(tree, j, acc);
  if (j == 0) {
    uint32_t v[8];
    if (n_next == 1) {
      uint32_t w[8];
      mont_pack16(top_inv, 16, w);
      mont_to(w, v);
    } else {
      load_w(inv_next, n_next, blockIdx.x, v);
    }
    node_put(tree, 1, v);
  }
  __syncthreads();
  tree_down(tree, j);
  uint32_t inv[8], sum[8];
  node_get(tree, kThreads + j, inv);
#pragma unroll
  for (int k = 0; k < 8; ++k) sum[k] = 0;
#pragma unroll
  for (int r = LOGUP_RUN - 1; r >= 0; --r) {
    const long long i = base + (long long)r * kThreads;
    if (i < n) {
      uint32_t out[8];
      if (r > 0) {
        uint32_t v[8];
        mont_mul(inv, pre[r - 1], out);
        load_w(xw, n, i, v);
        mont_mul(inv, v, inv);
      } else {
        copy8(inv, out);
      }
      if (!level0) {
        store_w(xw, n, i, out);
      } else if (!sum_mode) {
        store_canonical(out, rows_out + i * 16);
      } else {
        uint32_t c[8];
        if (m != nullptr) {
          uint32_t mv[8];
          mont_pack16(m + i * sm, nm, mv);
          mont_mul(out, mv, c);
        } else {
          mont_from(out, c);
        }
        mont_add(sum, c, sum);
      }
    }
  }
  if (!(level0 && sum_mode)) return;
  __syncthreads();  // every thread is past its reads of the tree
  tree_up<true>(tree, j, sum);
  if (j == 0) {
    node_get(tree, 1, sum);
    if (n_next == 1) {
      mont_unpack16(sum, sum_out);
    } else {
      store_w(inv_next, n_next, blockIdx.x, sum);
    }
  }
}

// the sum of n plain values (word-major) into out (int64 [16]): one block
__global__ void __launch_bounds__(LOGUP_THREADS, LOGUP_MIN_BLOCKS)
sum_kernel(const uint32_t* __restrict__ in, long long n, int64_t* __restrict__ out) {
  __shared__ Tree tree;
  const int j = threadIdx.x;
  uint32_t sum[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sum[k] = 0;
#pragma unroll 1
  for (long long i = j; i < n; i += kThreads) {
    uint32_t v[8];
    load_w(in, n, i, v);
    mont_add(sum, v, sum);
  }
  tree_up<true>(tree, j, sum);
  if (j == 0) {
    node_get(tree, 1, sum);
    mont_unpack16(sum, out);
  }
}

// the levels and the workspace layout: n_0 = n, n_{l+1} = ceil(n_l / tile)
// until one element (at least one level up); level l < L's elements at
// off[l], 8 words each
struct Plan {
  int L;
  long long n[LOGUP_MAX_LEVELS + 1];
  long long off[LOGUP_MAX_LEVELS];
  long long words;
};

int make_plan(long long n, int levels, long long words, Plan* p) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  p->n[0] = n;
  int L = 0;
  do {
    if (L == LOGUP_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    p->n[L + 1] = (p->n[L] + kTile - 1) / kTile;
    ++L;
  } while (p->n[L] > 1);
  p->L = L;
  long long at = 0;
  for (int l = 0; l < L; ++l) {
    p->off[l] = at;
    at += 8 * p->n[l];
  }
  p->words = at;
  // the caller's plan (tables/logup.py:logup_plan) must be this one
  if (levels != L || words != at) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// the product tree of x ([n, nx] int64 rows, row stride sx; alpha - x when
// alpha, an int64 [16] row, is given) into work (words uint32 words) under
// the plan of levels levels; the total product into top (int64 [16])
extern "C" int logup_up_launch(const void* x, long long sx, int nx, const void* alpha, long long n,
                               int levels, void* work, long long words, void* top, void* stream) {
  Plan p;
  int err = make_plan(n, levels, words, &p);
  if (err) return err;
  if (nx < 1 || nx > 16) return (int)cudaErrorInvalidValue;
  uint32_t* w = (uint32_t*)work;
  cudaStream_t st = (cudaStream_t)stream;
  for (int l = 0; l < p.L; ++l) {
    Rows src = l == 0 ? Rows{(const int64_t*)x, sx, nx, (const int64_t*)alpha}
                      : Rows{nullptr, 0, 0, nullptr};
    up_kernel<<<(unsigned int)p.n[l + 1], kThreads, 0, st>>>(
        src, p.n[l], w + p.off[l], l + 1 < p.L ? w + p.off[l + 1] : nullptr, p.n[l + 1],
        (int64_t*)top);
    ++g_up_launches;
  }
  return (int)cudaGetLastError();
}

// the down pass from top_inv (int64 [16], the inverse of logup_up_launch's
// total) over the same n elements and work: with sum 0 the inverses into
// out ([n, 16] int64); with sum 1 sum_i m_i * inv_i (m [n, nm] int64 rows,
// row stride sm, or null for 1) into out (int64 [16])
extern "C" int logup_down_launch(long long n, const void* m, long long sm, int nm, int levels,
                                 void* work, long long words, const void* top_inv, void* out,
                                 int sum, void* stream) {
  Plan p;
  int err = make_plan(n, levels, words, &p);
  if (err) return err;
  if (m != nullptr && (nm < 1 || nm > 16)) return (int)cudaErrorInvalidValue;
  uint32_t* w = (uint32_t*)work;
  cudaStream_t st = (cudaStream_t)stream;
  for (int l = p.L - 1; l >= 0; --l) {
    const bool last = l + 1 == p.L;
    down_kernel<<<(unsigned int)p.n[l + 1], kThreads, 0, st>>>(
        p.n[l], w + p.off[l], last ? nullptr : w + p.off[l + 1], p.n[l + 1],
        (const int64_t*)top_inv, l == 0, l == 0 && !sum ? (int64_t*)out : nullptr,
        (const int64_t*)m, sm, nm, sum, (int64_t*)out);
    ++g_down_launches;
  }
  // the tile sums sit in level 1's array
  if (sum && p.L > 1) {
    sum_kernel<<<1, kThreads, 0, st>>>(w + p.off[1], p.n[1], (int64_t*)out);
    ++g_down_launches;
  }
  return (int)cudaGetLastError();
}

// the kernels launched so far by each entry
extern "C" int logup_device_launches(int* up, int* down) {
  *up = g_up_launches;
  *down = g_down_launches;
  return 0;
}

// resident blocks an SM of the up and down kernels, from the CUDA
// occupancy calculator
extern "C" int logup_blocks_per_sm(int* up_blocks, int* down_blocks) {
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(up_blocks, up_kernel, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(down_blocks, down_kernel, kThreads, 0);
  return (int)err;
}
