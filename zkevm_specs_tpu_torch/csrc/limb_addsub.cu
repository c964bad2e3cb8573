// K3 limb_addsub: the carry and borrow chains over 16-bit limbs, for
// a [B|1, na] and b [B|1, nb], in four modes:
//   0 ADD     out [B, out_n] = (a + b) mod 2^(16 out_n)
//   1 SUB     out [B, n] = (a - b) mod 2^(16 n), n = max(na, nb), and
//             borrow [B] = 1 where a < b
//   2 FR_ADD  s = (a + b) mod 2^272; out [B, 16] = low 16 limbs of
//             (s >= p ? s - p : s)  (reduce_once when b = 0)
//   3 FR_SUB  d = (a - b) mod 2^256; out [B, 16] = borrow ? (d + p) mod
//             2^256 : d  (fr.neg when a = 0)
//
// Replaces zkevm_specs_tpu/ops/limbs.py:add and sub (limbs.py:228-252) and
// ops/fr.py:add, sub, neg and reduce_once (fr.py:66-94).  The TPU form
// resolves each chain with a packed carry-lookahead per 16-limb chunk, a
// vector-unit trick; one thread per lane rippling the carry through its
// limbs is the natural GPU form and is exact.
//
// What bounds it on the card: bytes.  A lane does a few integer operations
// per limb against 16 to 24 bytes of limbs read and 8 written.  A thread
// that reads its own lane's limbs from device memory makes every warp load
// of limb k touch 32 rows a row apart (32 sectors for 256 useful bytes)
// and every store a scatter of 8-byte partial sectors, so the design
// stages a tile of lanes through shared memory:
//   1. the block's threads load the tile's operand limbs flattened
//      (element e is lane e / span, limb e % span), consecutive threads on
//      consecutive limbs, 16 bytes a thread where the base address and the
//      row stride allow; a broadcast operand (stride 0) once a block;
//   2. rows sit in shared memory as 32-bit words at an odd pitch
//      (addsub_pitch), so a warp reading limb k of 32 lanes hits 32 banks;
//   3. one thread a lane runs the chain from shared memory, the mode and
//      the width (up to ADDSUB_MAX_UNROLLED limbs) template parameters, so
//      the loop unrolls with no branch;
//   4. the results go back into the tile in place and out as a flattened,
//      coalesced store, 16 bytes a thread.
// A batch under one tile gains nothing from staging: the kernel of its
// width runs it on its direct path, one thread a lane on device memory.
// A chain of ADDSUB_DIRECT_WIDTH limbs or fewer, whose rows a warp already
// reads nearly coalesced (the staged path's two barriers cost more there),
// runs the W = 0 kernel, direct, a loop over the width.  So do the chains
// wider than ADDSUB_MAX_UNROLLED limbs (up to 64), which no path of the
// verifier runs, and two broadcast rows (a batch of one).  The launcher
// counts the launches of each path.
#include "limb_common.cuh"

#ifndef ADDSUB_TILE
#define ADDSUB_TILE 128         // lanes (and threads) of a staged tile
#endif
#define ADDSUB_MAX_UNROLLED 17  // widest chain with its own kernel
#define ADDSUB_DIRECT_WIDTH 2   // chains this narrow run direct
#define ADDSUB_MAX_LIMBS 64     // ops/limbs.py:MAX_ADDSUB_LIMBS

namespace {

constexpr int MODE_ADD = 0;
constexpr int MODE_SUB = 1;
constexpr int MODE_FR_ADD = 2;
constexpr int MODE_FR_SUB = 3;

// words a staged row takes in shared memory: odd, so lanes a pitch apart
// fall in distinct banks
__host__ __device__ constexpr int addsub_pitch(int w) { return w | 1; }

static_assert(2 * ADDSUB_TILE * addsub_pitch(ADDSUB_MAX_UNROLLED) * 4 <= 48 * 1024,
              "a staged tile must fit 48 KB of shared memory");
static_assert(ADDSUB_TILE % 2 == 0, "an even tile keeps every tile's first limb 16-byte aligned");

// One operand as the staged path reads it: a row of n limbs every
// `stride` elements (0: one broadcast row).  The staged loop walks
// `span`-limb rows (n where the rows are dense, so the tile is one range;
// `copy` otherwise) and keeps the first `copy` = min(n, width) limbs.
struct Operand {
  const int64_t* p;
  long long stride;
  int n, copy, span;
  unsigned magic;  // div_by's reciprocal of span
  int vec;         // 16-byte loads: base 16-byte aligned, and pairs never straddle rows
};

struct Args {
  Operand a, b;
  int64_t* out;
  int out_n;
  unsigned out_magic;  // div_by's reciprocal of out_n
  int out_vec;         // out 16-byte aligned
  int64_t* borrow;
  long long batch;
  int width;  // the chain's limbs: out_n (ADD), n (SUB), 17 (FR_ADD), 16 (FR_SUB)
};

struct SmemRow {
  const uint32_t* p;
  __device__ __forceinline__ uint32_t operator[](int k) const { return p[k]; }
};

struct DeviceRow {  // a lane's row in device memory, zero beyond its n limbs
  const int64_t* p;
  int n;
  __device__ __forceinline__ uint32_t operator[](int k) const { return limb_at(p, k, n); }
};

struct SmemOut {
  uint32_t* p;
  __device__ __forceinline__ void set(int k, uint32_t v) const { p[k] = v; }
};

struct DeviceOut {
  int64_t* p;
  __device__ __forceinline__ void set(int k, uint32_t v) const { p[k] = (int64_t)v; }
};

// The chain of one lane over W limbs (W = 0: `width` limbs, a loop); the
// SUB borrow is returned.  o may alias a's row: limb k is read before it
// is written, and the Fr modes read every limb first.
template <int MODE, int W, class A, class B, class O>
__device__ __forceinline__ int chain(A a, B b, O o, int width) {
  const int n = W > 0 ? W : width;
  if constexpr (MODE == MODE_ADD) {
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < n; ++k) {
      const uint32_t s = a[k] + b[k] + carry;
      o.set(k, s & LIMB_MASK);
      carry = s >> LIMB_BITS;
    }
    return 0;
  } else if constexpr (MODE == MODE_SUB) {
    int borrow = 0;
#pragma unroll
    for (int k = 0; k < n; ++k) {
      const int v = (int)a[k] - (int)b[k] - borrow;
      o.set(k, (uint32_t)v & LIMB_MASK);
      borrow = v < 0;
    }
    return borrow;
  } else if constexpr (MODE == MODE_FR_ADD) {
    uint32_t s[17];
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < 17; ++k) {
      const uint32_t v = a[k] + b[k] + carry;
      s[k] = v & LIMB_MASK;
      carry = v >> LIMB_BITS;
    }
    uint32_t d[16];
    int borrow = 0;
#pragma unroll
    for (int k = 0; k < 17; ++k) {
      const int v = (int)s[k] - (int)c_p17[k] - borrow;
      if (k < 16) d[k] = (uint32_t)v & LIMB_MASK;
      borrow = v < 0;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) o.set(k, borrow ? s[k] : d[k]);
    return 0;
  } else {  // MODE_FR_SUB
    uint32_t d[16];
    int borrow = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int v = (int)a[k] - (int)b[k] - borrow;
      d[k] = (uint32_t)v & LIMB_MASK;
      borrow = v < 0;
    }
    const uint32_t add_p = borrow ? 1u : 0u;
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t v = d[k] + add_p * c_p17[k] + carry;
      o.set(k, v & LIMB_MASK);
      carry = v >> LIMB_BITS;
    }
    return 0;
  }
}

// the next element's (lane, limb) in rows of `span` limbs
__device__ __forceinline__ void next_elem(int& lane, int& k, int span) {
  if (++k == span) {
    k = 0;
    ++lane;
  }
}

// Loads the first `copy` limbs of the tile's rows of x into shared memory
// rows at `pitch`, zero up to `width`; a broadcast row once.
__device__ __forceinline__ void stage(const Operand& x, uint32_t* s, long long base, int lanes,
                                      int pitch, int width) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (x.stride == 0) {
    for (int k = tid; k < width; k += nt) s[k] = k < x.copy ? (uint32_t)x.p[k] : 0u;
    return;
  }
  const int64_t* src = x.p + base * x.stride;
  const int total = lanes * x.span;
  for (int e = 2 * tid; e < total; e += 2 * nt) {
    int lane = div_by(e, x.span, x.magic);
    int k = e - lane * x.span;
    const int64_t* p0 = src + lane * x.stride + k;
    int lane1 = lane, k1 = k;
    next_elem(lane1, k1, x.span);
    int64_t v0, v1 = 0;
    if (x.vec && e + 1 < total) {
      const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p0));
      v0 = v.x;
      v1 = v.y;
    } else {
      v0 = __ldg(reinterpret_cast<const long long*>(p0));
      if (e + 1 < total)
        v1 = __ldg(reinterpret_cast<const long long*>(src + lane1 * x.stride + k1));
    }
    if (k < x.copy) s[lane * pitch + k] = (uint32_t)v0;
    if (e + 1 < total && k1 < x.copy) s[lane1 * pitch + k1] = (uint32_t)v1;
  }
  for (int lane = tid; lane < lanes; lane += nt)
    for (int k = x.copy; k < width; ++k) s[lane * pitch + k] = 0u;
}

constexpr int ADDSUB_MAX_THREADS = ADDSUB_TILE > THREADS_PER_BLOCK ? ADDSUB_TILE : THREADS_PER_BLOCK;

// The kernel of a W-limb chain (W = 0: g.width limbs, a loop).  The
// direct path runs one thread a lane on device memory: every lane of the
// W = 0 instance, and a batch under one tile of the others (one block;
// staging cost it about 0.5 us a launch).  Otherwise a block stages a tile.
template <int MODE, int W>
__global__ void __launch_bounds__(ADDSUB_MAX_THREADS) limb_addsub_kernel(Args g) {
  if (W == 0 || g.batch < ADDSUB_TILE) {
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= g.batch) return;
    const int br = chain<MODE, W>(DeviceRow{g.a.p + lane * g.a.stride, g.a.n},
                                  DeviceRow{g.b.p + lane * g.b.stride, g.b.n},
                                  DeviceOut{g.out + lane * g.out_n}, g.width);
    if (MODE == MODE_SUB) g.borrow[lane] = br;
  } else if constexpr (W > 0) {
    extern __shared__ uint32_t smem[];
    constexpr int tile = ADDSUB_TILE;
    constexpr int pitch = addsub_pitch(W);
    const long long base = (long long)blockIdx.x * tile;
    const int lanes = (int)min((long long)tile, g.batch - base);
    uint32_t* sa = smem;
    uint32_t* sb = sa + (g.a.stride == 0 ? pitch : tile * pitch);
    stage(g.a, sa, base, lanes, pitch, W);
    stage(g.b, sb, base, lanes, pitch, W);
    __syncthreads();
    // the results overwrite the tile of an operand that has one row a lane
    uint32_t* so = g.a.stride == 0 ? sb : sa;
    const int t = threadIdx.x;
    if (t < lanes) {
      const int br = chain<MODE, W>(SmemRow{sa + (g.a.stride == 0 ? 0 : t * pitch)},
                                    SmemRow{sb + (g.b.stride == 0 ? 0 : t * pitch)},
                                    SmemOut{so + t * pitch}, W);
      if (MODE == MODE_SUB) g.borrow[base + t] = br;
    }
    __syncthreads();
    int64_t* dst = g.out + base * g.out_n;
    const int total = lanes * g.out_n;
    for (int f = 2 * t; f < total; f += 2 * tile) {
      const int lane = div_by(f, g.out_n, g.out_magic);
      const int k = f - lane * g.out_n;
      int lane1 = lane, k1 = k;
      next_elem(lane1, k1, g.out_n);
      const int64_t v0 = so[lane * pitch + k];
      if (f + 1 < total) {
        const int64_t v1 = so[lane1 * pitch + k1];
        if (g.out_vec) {
          *reinterpret_cast<longlong2*>(dst + f) = make_longlong2(v0, v1);
        } else {
          dst[f] = v0;
          dst[f + 1] = v1;
        }
      } else {
        dst[f] = v0;
      }
    }
  }
}

// launches per path since the library loaded: [staged, direct]
long long g_path_launches[2] = {0, 0};

template <int MODE, int W = 0>
cudaError_t launch_direct(const Args& g, cudaStream_t stream) {
  limb_addsub_kernel<MODE, W><<<grid_for(g.batch), THREADS_PER_BLOCK, 0, stream>>>(g);
  ++g_path_launches[1];
  return cudaGetLastError();
}

template <int MODE, int W>
cudaError_t launch_staged(const Args& g, cudaStream_t stream) {
  if (g.a.stride == 0 && g.b.stride == 0) return launch_direct<MODE>(g, stream);
  if (g.batch < ADDSUB_TILE) return launch_direct<MODE, W>(g, stream);
  const int rows = (g.a.stride == 0 ? 1 : ADDSUB_TILE) + (g.b.stride == 0 ? 1 : ADDSUB_TILE);
  const unsigned blocks = (unsigned)((g.batch + ADDSUB_TILE - 1) / ADDSUB_TILE);
  limb_addsub_kernel<MODE, W>
      <<<blocks, ADDSUB_TILE, (size_t)rows * addsub_pitch(W) * sizeof(uint32_t), stream>>>(g);
  ++g_path_launches[0];
  return cudaGetLastError();
}

// The plain modes' chains of ADDSUB_DIRECT_WIDTH + 1 .. ADDSUB_MAX_UNROLLED
// limbs each have their kernel; the others run the W = 0 one.
template <int MODE, int W = ADDSUB_DIRECT_WIDTH + 1>
cudaError_t launch_width(const Args& g, cudaStream_t stream) {
  if constexpr (W > ADDSUB_MAX_UNROLLED) {
    return launch_direct<MODE>(g, stream);
  } else {
    return g.width == W ? launch_staged<MODE, W>(g, stream)
                        : launch_width<MODE, W + 1>(g, stream);
  }
}

Operand operand(const void* p, long long stride, int n, int width) {
  Operand x;
  x.p = (const int64_t*)p;
  x.stride = stride;
  x.n = n;
  x.copy = n < width ? n : width;
  x.span = stride == n ? n : x.copy;
  x.magic = host_magic(x.span);
  const bool aligned = ((uintptr_t)p & 15) == 0;
  x.vec = aligned && (stride == n || (stride % 2 == 0 && x.span % 2 == 0));
  return x;
}

}  // namespace

extern "C" int limb_addsub_launch(const void* a, long long sa, int na, const void* b,
                                  long long sb, int nb, void* out, int out_n,
                                  void* borrow_out, int mode, long long batch,
                                  void* stream) {
  if (batch <= 0) return 0;
  if (mode < MODE_ADD || mode > MODE_FR_SUB || (mode == MODE_SUB && borrow_out == nullptr) ||
      out_n < 1 || out_n > ADDSUB_MAX_LIMBS || na < 1 || nb < 1 || na > ADDSUB_MAX_LIMBS ||
      nb > ADDSUB_MAX_LIMBS || sa < 0 || sb < 0)
    return (int)cudaErrorInvalidValue;
  const int width = mode == MODE_FR_ADD ? 17 : mode == MODE_FR_SUB ? 16
                    : mode == MODE_SUB ? (na > nb ? na : nb) : out_n;
  if ((mode == MODE_SUB && out_n != width) || (mode >= MODE_FR_ADD && out_n != 16))
    return (int)cudaErrorInvalidValue;
  Args g;
  g.a = operand(a, sa, na, width);
  g.b = operand(b, sb, nb, width);
  g.out = (int64_t*)out;
  g.out_n = out_n;
  g.out_magic = host_magic(out_n);
  g.out_vec = ((uintptr_t)out & 15) == 0;
  g.borrow = (int64_t*)borrow_out;
  g.batch = batch;
  g.width = width;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_ADD: return (int)launch_width<MODE_ADD>(g, s);
    case MODE_SUB: return (int)launch_width<MODE_SUB>(g, s);
    case MODE_FR_ADD: return (int)launch_staged<MODE_FR_ADD, 17>(g, s);
    default: return (int)launch_staged<MODE_FR_SUB, 16>(g, s);
  }
}

// the launches of each path since the library loaded
extern "C" int limb_addsub_path_launches(void* staged, void* direct) {
  *(long long*)staged = g_path_launches[0];
  *(long long*)direct = g_path_launches[1];
  return 0;
}
