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
//  * K2 keeps one thread per pixel (4 pixels a thread measured slower: a
//    thread's softmax and cumulative sums over 4 pixels make a long serial
//    path, and the grid has a quarter of the threads to hide it). It reads
//    and writes the levels in their layout, keeps the per-level terms in
//    registers and writes their ascending cumulative sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxClasses = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;

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

// VEC consecutive elements widened to f32: VEC = kVec is one load of
// VEC * sizeof(T) bytes. VEC = 1 also stores, narrowing from f32.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* o) { o[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float* v) { p[0] = v[0]; }
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
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    p[0] = __float2bfloat16(v[0]);
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

// One pixel's C classes to pixel p of a level (the inverse of
// load_pixels with VEC = 1).
template <typename T, int NC>
__device__ __forceinline__ void store_pixel(T* x, bool planes, long long plane_off, long long p,
                                            long long hw, const float (&val)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) Vec<T, 1>::store(x + (planes ? plane_off + c * hw : p * NC + c),
                                                &val[c]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The labels of VEC pixels from pixel p, y[c][k], and every level's logits of
// them: v[i][c][k] is level i, class c, pixel p + k. All loads issue before
// any use. Returns the NCHW element offset of (image of p, class 0, pixel p).
template <typename T, int NC, int VEC>
__device__ __forceinline__ long long load_group(const Levels& lv, const float* labels, long long p,
                                                float (&y)[NC][VEC],
                                                float (&v)[kMaxLevels][NC][VEC]) {
  const long long b = p / lv.hw;
  const long long off = b * NC * lv.hw + (p - b * lv.hw);
  load_pixels<float, NC, VEC>(labels, false, off, p, lv.hw, y);
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i)
    if (i < lv.levels)
      load_pixels<T, NC, VEC>(static_cast<const T*>(lv.x[i]), lv.planes, off, p, lv.hw, v[i]);
  return off;
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

// One thread per pixel. At least four blocks per SM: with that bound ptxas
// keeps every instantiation free of spills (without it, f32 C=1 spilled).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 4)
frce_bwd_kernel(const Levels lv, const float* __restrict__ labels, const float* __restrict__ g,
                int batch) {
  float gs[kMaxLevels];
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) gs[i] = i < lv.levels ? g[i] / (float)batch : 0.f;

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < lv.pixels; p += stride) {
    float y[NC][1], v[kMaxLevels][NC][1];
    const long long off = load_group<T, NC, 1>(lv, labels, p, y, v);
    // v[i][c] <- (g_i / B) * (softmax(acc_i) - y), level i's term
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
#pragma unroll
    for (int i = kMaxLevels - 1; i >= 0; --i) {
      if (i < lv.levels) {
        float m = -INFINITY;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[c] += v[i][c][0];
          m = fmaxf(m, acc[c]);
        }
        float e[NC], se = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          e[c] = __expf(acc[c] - m);
          se += e[c];
        }
        const float r = __frcp_rn(se);
#pragma unroll
        for (int c = 0; c < NC; ++c) v[i][c][0] = gs[i] * (e[c] * r - y[c][0]);
      }
    }
    float run[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) run[c] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxLevels; ++j) {
      if (j < lv.levels) {
#pragma unroll
        for (int c = 0; c < NC; ++c) run[c] += v[j][c][0];
        store_pixel<T, NC>(static_cast<T*>(lv.grad[j]), lv.planes, off, p, lv.hw, run);
      }
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

struct Bwd {  // one instantiation per type and class count: VEC is not used
  template <typename T, int NC, int VEC>
  static void run(int blocks, cudaStream_t s, Levels lv, const float* labels, const float* g,
                  int batch) {
    frce_bwd_kernel<T, NC><<<blocks, kThreads, 0, s>>>(lv, labels, g, batch);
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
// logits' dtype and layout. Returns cudaGetLastError().
int frce_backward(const void* const* x, void* const* grad, int levels, int planes,
                  const void* labels, const void* g, long long hw, long long pixels, int nclass,
                  int batch, int is_bf16, int num_blocks, void* stream) {
  if (bad_args(levels, hw, pixels, batch, num_blocks)) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(x, grad, levels, planes, hw, pixels);
  return dispatch<Bwd>(is_bf16, 0, nclass, num_blocks, static_cast<cudaStream_t>(stream), lv,
                       static_cast<const float*>(labels), static_cast<const float*>(g), batch);
}

}  // extern "C"
