// Eval-mode batch norm, ReLU and the cast back, in one pass, for Hopper
// (sm_90a).
//
// It replaces no TPU kernel: the JAX package leaves BN and the activation to
// XLA, which fuses them into the convolution's consumers. It was added
// because the port's eval-mode conv block ran four kernels an element after
// each bf16 convolution: an upcast to f32, cuDNN's f32 NCHW inference BN, an
// f32 clamp (F.relu) and a cast back to bf16. Together they moved ~28 bytes
// of HBM an element where the function needs 4 (one bf16 read, one bf16
// write), and took about half of the PHiSeg eval's device time.
//
// The function, in f32: per channel c, invstd = rsqrtf(running_var[c] + eps);
// per element, y = fma((x - mean[c]) * weight[c], invstd, bias[c]) with x
// upcast to f32, max(y, 0) if ReLU follows (NaN kept, as F.relu keeps it),
// rounded once to x's dtype. That is the rounding of cuDNN's NCHW inference
// kernel and of PyTorch's own BN kernels in both layouts (found on the card
// by emulating candidates against F.batch_norm: every f32 output equal), so
// the result is the chain's bit for bit where the chain's f32 BN is one of
// those. cuDNN's NHWC kernel, which the chain reaches for channels_last f32
// input, rounds its per-channel terms otherwise (x * s + (b - m * s)) and
// differs in the last f32 bit on some channels. invstd is computed inside
// the kernel, by each thread for the channels it touches, so there is no
// launch before it.
//
// Bound: bytes. One read and one write of each element, in place (the conv's
// output buffer, which the calling block owns): 4 bytes an element in bf16.
// The eval's largest call, 800 x 128 x 128x128 bf16, moves 6.7 GB: 2.0 ms at
// 3.35 TB/s. Against that bound:
//  * The tensor is `groups` contiguous runs of `units` vectors of V elements:
//    NCHW planes (groups = N*C, one channel a run, channel = run mod C) or
//    channels_last pixels (groups = N*H*W, channel = element mod C). The
//    memory format the input arrives in chooses; other strides are made
//    contiguous by the wrapper.
//  * 16-byte accesses: V = 8 bf16 or 4 f32 elements a vector where the run
//    length (planes) or C (pixels) and the pointer allow; a scalar
//    instantiation (V = 1) takes the rest (the 2x2 level, misaligned storage).
//  * A block is `gpi` runs (groups an iteration) x `cols` vectors; a thread
//    keeps kUnroll vectors of kUnroll runs in flight, all loads issued
//    before the first store.
//  * The grid is one-dimensional and strided: gridDim.x is a multiple of the
//    column tiles of a run, so each thread keeps its vector column for the
//    whole kernel; over pixels that is its channels, whose terms it loads
//    once. Over planes a thread's channel follows its run (one
//    per-channel term a vector, read through L1). The eval's 800 x 192
//    channel calls have more than 65,535 runs; no grid dimension counts runs.
//  * One 64-bit base per run (group * run length), 32-bit offsets inside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // vectors in flight a thread
constexpr int kBlocksPerSm = 8;     // 2048 threads an SM at 256 a block
constexpr int kWaves = 4;           // the strided grid's size in full waves
constexpr int kSms = 132;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N consecutive elements, loaded or stored as one access of N * sizeof(T) bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

struct Stats {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
};

// The channel's f32 terms.
struct Affine {
  float mean, weight, invstd, bias;
};

__device__ __forceinline__ Affine affine(const Stats& s, int c) {
  return {__ldg(s.mean + c), __ldg(s.weight + c), rsqrtf(__fadd_rn(__ldg(s.var + c), s.eps)),
          __ldg(s.bias + c)};
}

__device__ __forceinline__ float apply(float x, Affine a, bool relu) {
  const float y = __fmaf_rn(__fmul_rn(__fsub_rn(x, a.mean), a.weight), a.invstd, a.bias);
  return relu && !(y != y) ? fmaxf(y, 0.0f) : y;
}

// `groups` runs of `units` vectors; a block iteration covers `gpi` runs of
// `cols` vectors (column tile blockIdx.x % col_tiles), kUnroll times.
struct Layout {
  long long groups;
  int units;
  int cols;
  int col_tiles;
  int gpi;
  int channels;
};

template <typename T, int V, bool PLANES>
__global__ void __launch_bounds__(kThreads)
    bn_act_eval_kernel(T* x, Layout L, Stats s, int relu) {
  const int q = threadIdx.x / L.cols;
  const int tile = blockIdx.x % L.col_tiles;
  const int j = tile * L.cols + (threadIdx.x - q * L.cols);  // the thread's vector in a run
  if (q >= L.gpi || j >= L.units) return;
  const long long run = (long long)L.units * V;  // elements a run
  const long long span = (long long)L.gpi * kUnroll;
  const long long stride = (long long)(gridDim.x / L.col_tiles) * span;
  Affine fixed[PLANES ? 1 : V];
  if constexpr (!PLANES) {
#pragma unroll
    for (int i = 0; i < V; ++i) fixed[i] = affine(s, j * V + i);
  }
  for (long long g0 = (long long)(blockIdx.x / L.col_tiles) * span + q; g0 < L.groups;
       g0 += stride) {
    Pack<T, V> v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long g = g0 + (long long)k * L.gpi;
      if (g < L.groups) v[k] = *reinterpret_cast<const Pack<T, V>*>(x + g * run + j * V);
    }
    const int c0 = PLANES ? (int)(g0 % L.channels) : 0;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long g = g0 + (long long)k * L.gpi;
      if (g >= L.groups) break;
      if constexpr (PLANES) {
        const Affine a = affine(s, (c0 + k * L.gpi) % L.channels);
#pragma unroll
        for (int i = 0; i < V; ++i) v[k].v[i] = from_f32<T>(apply(to_f32(v[k].v[i]), a, relu));
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          v[k].v[i] = from_f32<T>(apply(to_f32(v[k].v[i]), fixed[i], relu));
      }
      *reinterpret_cast<Pack<T, V>*>(x + g * run + j * V) = v[k];
    }
  }
}

template <typename T>
constexpr int vec() {
  return 16 / sizeof(T);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// The vector width a launch takes: V where the run length (planes) or the
// channels (pixels) divide by it and x is 16-byte aligned, else 1.
template <typename T>
int width_for(const void* x, int planes, long long run, int channels) {
  constexpr int v = vec<T>();
  const long long along = planes ? run : channels;
  return along % v == 0 && aligned(x, 16) ? v : 1;
}

int width_of(const void* x, int planes, long long run, int channels, int dtype) {
  switch (dtype) {
    case 0: return width_for<__nv_bfloat16>(x, planes, run, channels);
    case 1: return width_for<float>(x, planes, run, channels);
    default: return 0;
  }
}

template <typename T, int V, bool PLANES>
int launch(void* x, long long groups, long long run, int channels, Stats s, int relu,
           cudaStream_t stream) {
  Layout L;
  L.groups = groups;
  L.units = (int)(run / V);
  L.cols = L.units < kThreads ? L.units : kThreads;
  L.col_tiles = (L.units + L.cols - 1) / L.cols;
  L.gpi = kThreads / L.cols;
  L.channels = channels;
  const long long span = (long long)L.gpi * kUnroll;
  const long long row_blocks = (groups + span - 1) / span;
  long long per_tile = (long long)kSms * kBlocksPerSm * kWaves / L.col_tiles;
  if (per_tile < 1) per_tile = 1;
  if (per_tile > row_blocks) per_tile = row_blocks;
  const long long blocks = per_tile * L.col_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  bn_act_eval_kernel<T, V, PLANES>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(static_cast<T*>(x), L, s, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(int planes, int width, void* x, long long groups, long long run, int channels,
                 Stats s, int relu, cudaStream_t stream) {
  constexpr int v = vec<T>();
  if (planes)
    return width == v ? launch<T, v, true>(x, groups, run, channels, s, relu, stream)
                      : launch<T, 1, true>(x, groups, run, channels, s, relu, stream);
  return width == v ? launch<T, v, false>(x, groups, run, channels, s, relu, stream)
                    : launch<T, 1, false>(x, groups, run, channels, s, relu, stream);
}

}  // namespace

extern "C" {

// Elements a thread takes in one access for this tensor: 8 (bf16) or 4
// (f32) for the vector instantiation, 1 for the scalar one, 0 for a dtype
// no launch takes. dtype: 0 bf16, 1 f32.
int bn_act_eval_width(const void* x, int planes, long long run, int channels, int dtype) {
  return width_of(x, planes, run, channels, dtype);
}

// x, in place: `groups` contiguous runs of `run` elements, NCHW planes
// (planes = 1, groups = N*C, run = H*W) or channels_last pixels (planes = 0,
// groups = N*H*W, run = C); mean, var, weight, bias: `channels` f32 each.
// Returns cudaGetLastError() after the launch.
int bn_act_eval(void* x, long long groups, long long run, int planes, int channels,
                const float* mean, const float* var, const float* weight, const float* bias,
                float eps, int relu, int dtype, void* stream) {
  if (groups < 1 || run < 1 || run > INT_MAX || channels < 1 || (!planes && run != channels))
    return (int)cudaErrorInvalidValue;
  const int width = width_of(x, planes, run, channels, dtype);
  if (width == 0) return (int)cudaErrorInvalidValue;
  const Stats s{mean, var, weight, bias, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_typed<__nv_bfloat16>(planes, width, x, groups, run, channels, s, relu, st);
    case 1: return launch_typed<float>(planes, width, x, groups, run, channels, s, relu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
