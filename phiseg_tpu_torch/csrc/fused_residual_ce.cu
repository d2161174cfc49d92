// Fused multi-level residual softmax cross-entropy for Hopper (sm_90a).
//
// K1 (frce_fwd_kernel) replaces the Pallas TPU kernel
// phiseg_tpu/ops/fused_residual_ce.py::_fwd_kernel (driven by _fwd). For each
// level i, coarsest to finest, acc_i = sum_{j>=i} logits_j per pixel and
// CE_i = logsumexp(acc_i) - <y, acc_i>, in f32 with max subtraction. Output:
// sum over pixels of CE_i divided by the batch size, per level.
//
// K2 (frce_bwd_kernel) replaces ..._bwd_kernel (driven by _bwd_rule):
// grad_j = sum_{i<=j} (g_i / B) * (softmax(acc_i) - y) for all levels in one
// pass, written in the logits' dtype.
//
// Layout. The kernels read the L level tensors where the model leaves them,
// as L base pointers in a by-value struct: either NCHW planes (B, C, H, W) or
// pixel-major rows (B, H, W, C), the same for all levels of a launch, with
// the one-hot labels as (B, H, W, C) f32 rows. K2 writes L separate
// gradients in the levels' layout. The TPU kernel needed one (L*C, P) array
// with pixels on lanes; nothing is copied here to build a common array.
//
// Bound: memory bandwidth. Each pixel costs a few exp/log per level and is
// touched once; at the main-path shape (L=5, B=12, 128x128, C=2, f32 logits)
// K1 reads 9.44 MB (7.86 MB of logits + 1.57 MB of one-hot labels), 2.82 us at
// 3.35 TB/s, and K2 moves 17.30 MB (the same reads plus the gradients), 5.16 us.
//
// Design against that bound. At these sizes the time goes to latency more
// than to bytes: a back-to-back launch of a one-element kernel takes 2.4 us,
// and a grid-wide sum adds a chain of dependent global round trips.
//  * K1, 16-byte loads. A thread owns kVec = 4 consecutive pixels of one
//    image, reads each level's C x 4 values with C loads of 4 elements (16
//    bytes in f32, 8 in bf16: one per class plane, or C runs of the
//    pixel-major rows) and its labels as C 16-byte loads, issues all of them
//    before any arithmetic, and walks the levels coarsest to finest per pixel
//    in registers. The level and class loops are unrolled to the compile-time
//    maxima kMaxLevels and NC, so nothing goes to local memory. exp and log
//    are the SFU's (__expf, __logf: a few ulp, on arguments <= 0 and in
//    [1, C]), which cuts the instructions per pixel and level about threefold.
//  * K1's scalar instantiation (VEC = 1) takes H*W not a multiple of 4 and
//    base pointers not aligned to the load width; the wrapper chooses it by an
//    explicit check, and the host entry point refuses a vector launch on
//    tensors that do not fit it.
//  * K1 is one launch. At the main shape the grid is P/4 threads, 192 blocks
//    of 256, one wave on 132 SMs; a grid-stride loop covers larger P. Each
//    block sums its threads' (L,) terms in shared memory, one thread writes
//    the block's partials and takes a ticket with an acquire-release atomic;
//    the block that draws the last ticket sums all partials in block-index
//    order and divides by B. That order does not depend on which block is
//    last, so two runs give identical bits. The ticket counter (one unsigned
//    int per device, zeroed once by the wrapper) returns to 0 at the last
//    ticket by the atomic increment's wrap. One counter serves one launch at
//    a time, which holds because the port launches on one stream per process.
//  * K2 (replaces _bwd_kernel, phiseg_tpu/ops/fused_residual_ce.py:76; bound
//    5.16 us at the main shape) is one wave of independent threads with no
//    sum across them, so its time beyond the bytes is the DRAM round trip
//    and the store drain of one pass. Its design shortens what each thread
//    does before its loads go out and between its loads and its stores.
//    blockIdx.y is the image and blockIdx.x a tile of it: no division, one
//    64-bit image base per thread, 32-bit offsets inside the image. The
//    layout (planes or rows) is a template parameter, as is the access
//    width: the vector instantiation takes kBwdPx = 2 pixels a thread, one
//    access per level and class plane (8 bytes f32, 4 bf16) or per level in
//    rows (2 * C elements: 16 bytes f32 at C = 2) and one for its labels,
//    bf16 gradients stored as packed pairs. The two pixels' softmax chains
//    are independent (instruction-level parallelism, not a serial path:
//    4 pixels a thread measured slower, scripts/k2_variants.py). The scalar
//    instantiation (one pixel, element accesses) takes odd H*W and
//    misaligned tensors, chosen by the wrapper's explicit check; the host
//    entry point refuses a vector launch that does not fit. 1 / sum(exp) is
//    the SFU's approximate reciprocal (sum in [1, C]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxClasses = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;
constexpr int kBwdPx = 2;  // pixels a thread of K2's vector instantiation
static_assert(kBwdPx > 1, "one pixel a thread is K2's scalar instantiation");
constexpr int kMaxBatch = 65535;  // K2's images, on gridDim.y

// The L level tensors and K2's L gradients, all in one layout: NCHW planes
// (planes = 1) or pixel-major (B, H, W, C) rows (planes = 0).
struct Levels {
  const void* x[kMaxLevels];
  void* grad[kMaxLevels];
  int levels;
  int planes;
  long long hw;      // H*W
  long long pixels;  // B*H*W
};

// K1's loads: VEC consecutive elements widened to f32, VEC = kVec in one load
// of VEC * sizeof(T) bytes.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* o) { o[0] = __ldg(p); }
};

template <>
struct Vec<float, kVec> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* o) {
    o[0] = __bfloat162float(p[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, kVec> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* o) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
};

// The C classes of VEC pixels from pixel p (image b = p / hw, element offset
// plane_off of (b, class 0, p) in NCHW), in NC accesses of VEC elements:
// out[c][k] is class c of pixel p + k. NCHW reads one run per class plane;
// pixel-major reads the NC * VEC elements from p * NC in NC runs.
template <typename T, int NC, int VEC>
__device__ __forceinline__ void load_pixels(const T* x, bool planes, long long plane_off,
                                            long long p, long long hw, float (&out)[NC][VEC]) {
  if (planes) {
#pragma unroll
    for (int c = 0; c < NC; ++c) Vec<T, VEC>::load(x + plane_off + c * hw, out[c]);
  } else {
    float raw[NC][VEC];
#pragma unroll
    for (int j = 0; j < NC; ++j) Vec<T, VEC>::load(x + p * NC + j * VEC, raw[j]);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k = 0; k < VEC; ++k) out[c][k] = raw[(k * NC + c) / VEC][(k * NC + c) % VEC];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The labels of VEC pixels from pixel p, y[c][k], and every level's logits of
// them: v[i][c][k] is level i, class c, pixel p + k. All loads issue before
// any use.
template <typename T, int NC, int VEC>
__device__ __forceinline__ void load_group(const Levels& lv, const float* labels, long long p,
                                           float (&y)[NC][VEC], float (&v)[kMaxLevels][NC][VEC]) {
  const long long b = p / lv.hw;
  const long long off = b * NC * lv.hw + (p - b * lv.hw);
  load_pixels<float, NC, VEC>(labels, false, off, p, lv.hw, y);
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i)
    if (i < lv.levels)
      load_pixels<T, NC, VEC>(static_cast<const T*>(lv.x[i]), lv.planes, off, p, lv.hw, v[i]);
}

template <typename T, int NC, int VEC>
__global__ void __launch_bounds__(kThreads)
frce_fwd_kernel(const Levels lv, const float* __restrict__ labels, float* __restrict__ partials,
                unsigned int* __restrict__ ticket, float* __restrict__ out, int batch) {
  float ce[kMaxLevels];
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) ce[i] = 0.f;

  const long long groups = lv.pixels / VEC;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long gi = (long long)blockIdx.x * kThreads + threadIdx.x; gi < groups; gi += stride) {
    float y[NC][VEC], v[kMaxLevels][NC][VEC];
    load_group<T, NC, VEC>(lv, labels, gi * VEC, y, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float acc[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = 0.f;
#pragma unroll
      for (int i = kMaxLevels - 1; i >= 0; --i) {
        if (i < lv.levels) {
          float m = -INFINITY;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[c] += v[i][c][k];
            m = fmaxf(m, acc[c]);
          }
          float se = 0.f, dot = 0.f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            se += __expf(acc[c] - m);
            dot += y[c][k] * acc[c];
          }
          ce[i] += (m + __logf(se)) - dot;
        }
      }
    }
  }

  __shared__ float red[kWarps][kMaxLevels];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    const float s = warp_sum(ce[i]);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < lv.levels; ++i) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][i];
      partials[(long long)blockIdx.x * kMaxLevels + i] = s;
    }
    // release: the partials above are visible before the ticket; acquire:
    // the last block sees every block's partials (and, after the barrier
    // below, so do its other threads)
    unsigned int drawn;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(drawn)
                 : "l"(ticket), "r"(gridDim.x - 1)
                 : "memory");
    last = drawn == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block: thread t sums blocks t, t + kThreads, ... in order, then
  // a fixed tree over threads and warps.
  float s[kMaxLevels];
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) s[i] = 0.f;
  for (unsigned int blk = threadIdx.x; blk < gridDim.x; blk += kThreads) {
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i)
      if (i < lv.levels) s[i] += __ldcg(partials + (long long)blk * kMaxLevels + i);
  }
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    const float t = warp_sum(s[i]);
    if (lane == 0) red[warp][i] = t;
  }
  __syncthreads();
  if (threadIdx.x < lv.levels) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][threadIdx.x];
    out[threadIdx.x] = t / (float)batch;
  }
}

// ---------------------------------------------------------------------------
// K2's accesses: a run of N consecutive elements in accesses of W bytes, W
// fixed at compile time (W = sizeof(T): one element an access, any alignment)
// ---------------------------------------------------------------------------

// The widest access (16, 8 or 4 bytes) that tiles a run of `bytes`, else one
// element (`elem` bytes) an access.
__host__ __device__ constexpr int access_bytes(int bytes, int elem) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : elem;
}

template <int W>
__device__ __forceinline__ void load_words(const unsigned* p, unsigned* w) {
  if constexpr (W == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (W == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void store_words(unsigned* p, const unsigned* w) {
  if constexpr (W == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (W == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *p = w[0];
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Element k of a run held as 32-bit words (bf16: two to a word, low half first).
template <typename T>
__device__ __forceinline__ float word_elem(const unsigned* w, int k) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(w[k]);
  else
    return __uint_as_float(k % 2 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16);
}

template <typename T, int N, int W>
__device__ __forceinline__ void load_run(const T* p, float (&out)[N]) {
  if constexpr (W == sizeof(T)) {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = to_f32(__ldg(p + k));
  } else {
    constexpr int kWords = N * sizeof(T) / 4;
    unsigned w[kWords];
#pragma unroll
    for (int a = 0; a < kWords; a += W / 4)
      load_words<W>(reinterpret_cast<const unsigned*>(p) + a, w + a);
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = word_elem<T>(w, k);
  }
}

template <typename T, int N, int W>
__device__ __forceinline__ void store_run(T* p, const float (&v)[N]) {
  if constexpr (W == sizeof(T)) {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = from_f32<T>(v[k]);
  } else {
    constexpr int kWords = N * sizeof(T) / 4;
    unsigned w[kWords];
#pragma unroll
    for (int a = 0; a < kWords; ++a) {
      if constexpr (sizeof(T) == 4)
        w[a] = __float_as_uint(v[a]);
      else  // a packed pair, rounded to nearest even as __float2bfloat16
        w[a] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * a])) |
               (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * a + 1])) << 16;
    }
#pragma unroll
    for (int a = 0; a < kWords; a += W / 4)
      store_words<W>(reinterpret_cast<unsigned*>(p) + a, w + a);
  }
}

// K2's instantiation <T, NC, PLANES, PX>: PX pixels a thread, PX = 1 the
// scalar one (element accesses), else the vector one. A thread's run per
// level is PX elements of each class plane (NCHW) or the PX * NC elements of
// its pixels' rows; its labels are the PX * NC floats of their rows.
template <typename T, int NC, bool PLANES, int PX>
struct BwdAccess {
  static constexpr int kLevel =
      PX == 1 ? (int)sizeof(T) : access_bytes(PX * (PLANES ? 1 : NC) * sizeof(T), sizeof(T));
  static constexpr int kLabel = PX == 1 ? 4 : access_bytes(PX * NC * 4, 4);
};

// One level's C classes of PX pixels from pixel q of an image, x the image's
// first element: out[c][k] is class c of pixel q + k.
template <typename T, int NC, bool PLANES, int PX>
__device__ __forceinline__ void load_level(const T* x, unsigned q, unsigned hw,
                                           float (&out)[NC][PX]) {
  constexpr int W = BwdAccess<T, NC, PLANES, PX>::kLevel;
  if constexpr (PLANES) {
#pragma unroll
    for (int c = 0; c < NC; ++c) load_run<T, PX, W>(x + c * hw + q, out[c]);
  } else {
    float r[PX * NC];
    load_run<T, PX * NC, W>(x + q * NC, r);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k = 0; k < PX; ++k) out[c][k] = r[k * NC + c];
  }
}

// The inverse of load_level, narrowing to T.
template <typename T, int NC, bool PLANES, int PX>
__device__ __forceinline__ void store_level(T* x, unsigned q, unsigned hw,
                                            const float (&val)[NC][PX]) {
  constexpr int W = BwdAccess<T, NC, PLANES, PX>::kLevel;
  if constexpr (PLANES) {
#pragma unroll
    for (int c = 0; c < NC; ++c) store_run<T, PX, W>(x + c * hw + q, val[c]);
  } else {
    float r[PX * NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k = 0; k < PX; ++k) r[k * NC + c] = val[c][k];
    store_run<T, PX * NC, W>(x + q * NC, r);
  }
}

// The least blocks per SM ptxas must fit, so that no instantiation spills:
// the values a thread holds grow with PX * NC (at the main shape, C = 2 and
// PX = 2, four blocks of 256 fit, more than its grid puts on an SM).
__host__ __device__ constexpr int bwd_min_blocks(int nc, int px) {
  return px * nc <= 4 ? 4 : px * nc <= 6 ? 3 : px * nc <= 8 ? 2 : 1;
}

// blockIdx.y is the image, blockIdx.x the tile of kThreads * PX pixels in it;
// one thread a group of PX pixels. Offsets inside an image are 32-bit (the
// wrapper refuses images of 2^31 elements or more); each thread forms the
// image's 64-bit base once.
template <typename T, int NC, bool PLANES, int PX>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks(NC, PX))
frce_bwd_kernel(const Levels lv, const float* __restrict__ labels, const float* __restrict__ g,
                int batch) {
  const unsigned hw = static_cast<unsigned>(lv.hw);
  const unsigned q = (blockIdx.x * kThreads + threadIdx.x) * PX;
  if (q >= hw) return;  // H*W is a multiple of PX
  const long long image = static_cast<long long>(blockIdx.y) * NC * hw;

  float y[PX * NC], v[kMaxLevels][NC][PX];
  load_run<float, PX * NC, BwdAccess<T, NC, PLANES, PX>::kLabel>(labels + image + q * NC, y);
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i)
    if (i < lv.levels)
      load_level<T, NC, PLANES, PX>(static_cast<const T*>(lv.x[i]) + image, q, hw, v[i]);
  float gs[kMaxLevels];
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) gs[i] = i < lv.levels ? __ldg(g + i) / (float)batch : 0.f;

  // v[i][c][k] <- (g_i / B) * (softmax(acc_i) - y), level i's term; the PX
  // pixels are independent chains
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
#pragma unroll
    for (int i = kMaxLevels - 1; i >= 0; --i) {
      if (i < lv.levels) {
        float m = -INFINITY;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[c] += v[i][c][k];
          m = fmaxf(m, acc[c]);
        }
        float e[NC], se = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          e[c] = __expf(acc[c] - m);
          se += e[c];
        }
        const float r = __fdividef(1.f, se);  // se in [1, C]
#pragma unroll
        for (int c = 0; c < NC; ++c) v[i][c][k] = gs[i] * (e[c] * r - y[k * NC + c]);
      }
    }
  }
  // grad_j = the ascending cumulative sum of the terms
  float run[NC][PX];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int k = 0; k < PX; ++k) run[c][k] = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxLevels; ++j) {
    if (j < lv.levels) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int k = 0; k < PX; ++k) run[c][k] += v[j][c][k];
      store_level<T, NC, PLANES, PX>(static_cast<T*>(lv.grad[j]) + image, q, hw, run);
    }
  }
}

struct Fwd {
  template <typename T, int NC, int VEC>
  static void run(int blocks, cudaStream_t s, Levels lv, const float* labels, float* partials,
                  unsigned int* ticket, float* out, int batch) {
    frce_fwd_kernel<T, NC, VEC><<<blocks, kThreads, 0, s>>>(lv, labels, partials, ticket, out,
                                                            batch);
  }
};

struct Bwd {  // VEC = 1 launches the scalar instantiation, else the vector one
  template <typename T, int NC, int VEC>
  static void run(cudaStream_t s, Levels lv, const float* labels, const float* g, int batch) {
    constexpr int PX = VEC == 1 ? 1 : kBwdPx;
    const dim3 grid((unsigned)((lv.hw + kThreads * PX - 1) / (kThreads * PX)), (unsigned)batch);
    if (lv.planes)
      frce_bwd_kernel<T, NC, true, PX><<<grid, kThreads, 0, s>>>(lv, labels, g, batch);
    else
      frce_bwd_kernel<T, NC, false, PX><<<grid, kThreads, 0, s>>>(lv, labels, g, batch);
  }
};

template <class K, typename T, int VEC, typename... A>
bool by_classes(int nclass, A... a) {
  switch (nclass) {
    case 1: K::template run<T, 1, VEC>(a...); return true;
    case 2: K::template run<T, 2, VEC>(a...); return true;
    case 3: K::template run<T, 3, VEC>(a...); return true;
    case 4: K::template run<T, 4, VEC>(a...); return true;
    default: return false;
  }
}

template <class K, typename... A>
int dispatch(int is_bf16, int vec, int nclass, A... a) {
  bool ok;
  if (is_bf16)
    ok = vec ? by_classes<K, __nv_bfloat16, kVec>(nclass, a...)
             : by_classes<K, __nv_bfloat16, 1>(nclass, a...);
  else
    ok = vec ? by_classes<K, float, kVec>(nclass, a...) : by_classes<K, float, 1>(nclass, a...);
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

bool bad_args(int levels, long long hw, long long pixels, int batch, int blocks) {
  return levels < 1 || levels > kMaxLevels || hw < 1 || batch < 1 || blocks < 1 ||
         pixels != hw * batch;
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// Whether K1's vector kernel can take these tensors: H*W a multiple of kVec,
// every level pointer aligned to one load (kVec elements), the labels to 16.
bool vector_fits(const Levels& lv, const void* labels, int is_bf16) {
  const int width = kVec * (is_bf16 ? 2 : 4);
  bool ok = lv.hw % kVec == 0 && aligned(labels, 16);
  for (int i = 0; i < lv.levels; ++i) ok = ok && aligned(lv.x[i], width);
  return ok;
}

// Whether K2's vector instantiation can take these tensors: H*W a multiple
// of kBwdPx and every level, gradient and label pointer aligned to its
// access (BwdAccess, which the offsets inside a plane then keep).
bool bwd_vector_fits(const Levels& lv, const void* labels, int nclass, int is_bf16) {
  const int elem = is_bf16 ? 2 : 4;
  const int width = access_bytes(kBwdPx * (lv.planes ? 1 : nclass) * elem, elem);
  bool ok = lv.hw % kBwdPx == 0 && aligned(labels, access_bytes(kBwdPx * nclass * 4, 4));
  for (int i = 0; i < lv.levels; ++i)
    ok = ok && aligned(lv.x[i], width) && aligned(lv.grad[i], width);
  return ok;
}

Levels make_levels(const void* const* x, void* const* grad, int levels, int planes,
                   long long hw, long long pixels) {
  Levels lv{};
  for (int i = 0; i < levels; ++i) {
    lv.x[i] = x[i];
    lv.grad[i] = grad ? grad[i] : nullptr;
  }
  lv.levels = levels;
  lv.planes = planes;
  lv.hw = hw;
  lv.pixels = pixels;
  return lv;
}

}  // namespace

extern "C" {

int frce_max_levels() { return kMaxLevels; }
int frce_max_classes() { return kMaxClasses; }
int frce_vec() { return kVec; }
int frce_bwd_px() { return kBwdPx; }

// x: `levels` pointers to logits, f32 (is_bf16=0) or bf16, all NCHW
// (planes=1) or all (B, H, W, C) rows (planes=0); labels (B, H, W, C) f32;
// partials (num_blocks, kMaxLevels) f32 scratch; ticket one unsigned int, 0
// between launches; out (levels,) f32. vec=1 takes the vector kernel.
// Returns cudaGetLastError().
int frce_forward(const void* const* x, int levels, int planes, const void* labels,
                 void* partials, void* ticket, void* out, long long hw, long long pixels,
                 int nclass, int batch, int is_bf16, int vec, int num_blocks, void* stream) {
  if (bad_args(levels, hw, pixels, batch, num_blocks)) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(x, nullptr, levels, planes, hw, pixels);
  if (vec && !vector_fits(lv, labels, is_bf16)) return (int)cudaErrorMisalignedAddress;
  return dispatch<Fwd>(is_bf16, vec, nclass, num_blocks, static_cast<cudaStream_t>(stream), lv,
                       static_cast<const float*>(labels), static_cast<float*>(partials),
                       static_cast<unsigned int*>(ticket), static_cast<float*>(out), batch);
}

// g (levels,) f32 cotangent; grad: `levels` pointers to outputs in the
// logits' dtype and layout. vec=1 takes the vector instantiation. The grid
// holds at most kMaxBatch images of fewer than 2^31 elements each. Returns
// cudaGetLastError().
int frce_backward(const void* const* x, void* const* grad, int levels, int planes,
                  const void* labels, const void* g, long long hw, long long pixels, int nclass,
                  int batch, int is_bf16, int vec, void* stream) {
  if (bad_args(levels, hw, pixels, batch, 1) || batch > kMaxBatch || nclass * hw > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(x, grad, levels, planes, hw, pixels);
  if (vec && !bwd_vector_fits(lv, labels, nclass, is_bf16)) return (int)cudaErrorMisalignedAddress;
  return dispatch<Bwd>(is_bf16, vec, nclass, static_cast<cudaStream_t>(stream), lv,
                       static_cast<const float*>(labels), static_cast<const float*>(g), batch);
}

}  // extern "C"
