// x2 bilinear upsample for Hopper (sm_90a) and its gather backward.
//
// It replaces no TPU kernel: the JAX package leaves the resize to XLA
// (phiseg_tpu/nn/layers.py upsample_bilinear -> jax.image.resize). It was
// added because PyTorch's NCHW upsample_bilinear2d_out_frame starts one
// thread per output pixel and loops serially over every image and channel
// (N*C). The sampler decodes 100 draws an image as one batch (800 rows at
// B = 8) through 18 x2 resizes of 2x2 .. 64x64 planes with 2-192 channels,
// so each call ran a few hundred to 16k threads of 1,600 to 153,600
// iterations: ~62 ms of the eval's 81 device ms an image, against 0.40 ms
// for its bytes at 3.35 TB/s.
//
// The function: jax.image.resize's "bilinear" at a factor of 2, which is
// F.interpolate(scale_factor=2, mode="bilinear", align_corners=False):
// half-pixel centres, the edge clamped. Along one axis output 2k is
// 0.25 v[k-1] + 0.75 v[k] (1 v[0] + 0 v[1] at k = 0) and output 2k+1 is
// 0.75 v[k] + 0.25 v[min(k+1, n-1)]: every input pixel owns a 2x2 output
// quad, a fixed 3x3 stencil (9/16, 3/16, 3/16, 1/16 in the interior). The
// sum is taken in F.interpolate's order, h0 * (w0 a + w1 b) + h1 * (w0 c +
// w1 d) with a, b on the upper input row, in f32 (f64 for f64), rounded once
// to the output dtype, and with the fused multiply-adds PyTorch's CUDA
// kernels contract it into, written out: Y = fma(w0, c, w1 * d), the result
// fma(h0, X, h1 * Y), and X = fma(w0, a, w1 * b) as in its NCHW kernel, or
// fma(w1, b, w0 * a) as in its NHWC kernel, which it takes for channels_last
// inputs of 16 channels or more (each pattern found on the card by emulating
// the candidates against F.interpolate on random f32 inputs). So the result
// is F.interpolate's, bit for bit.
//
// The backward is a gather: each input pixel sums its 4x4 output
// neighbourhood with per-axis weights (1/4, 3/4, 3/4, 1/4), the output
// indices clamped at the edge (the adjoint of the clamp above), in f32 and
// rounded once. No atomics and no zero fill, and the same bits every run;
// PyTorch's backward scatters with atomics into a zeroed buffer.
//
// Bound: bytes. The forward reads each input element once and writes four,
// 5 bytes an input element in bf16 (the backward reads four and writes one).
// The eval's largest call, 800 x 192 x 64x64 -> 128x128 bf16, moves 6.29 GB:
// 1.88 ms at 3.35 TB/s. Against that bound:
//  * The grid covers every output element. A unit of work is a run of an
//    input row (planes) or a vector of channels at one input pixel
//    (pixel-major rows), and every unit is a thread of its own. Small planes
//    are packed whole into one block (an 800 x 192 x 2x2 input: 64 planes a
//    block, 2,400 blocks), large ones are tiled (blockIdx.y), so every call
//    fills the 132 SMs.
//  * 16-byte stores. Two instantiations by the memory format the input
//    arrives in: planes (NCHW-contiguous, the sampler's), where a thread
//    takes 8 / sizeof(T) input columns of one row and writes both output
//    rows of them with one 16-byte store each (8 bytes in f64); pixel-major
//    (channels_last, the train step's), where a thread takes 16 / sizeof(T)
//    channels of one input pixel with 16-byte loads and writes its quad as
//    four 16-byte stores. A scalar instantiation of each (one column, one
//    channel) takes widths and pointers the vector accesses cannot;
//    bilinear2x_width chooses, and the launch takes its choice.
//  * Each input row a thread reads is interpolated along the row once and
//    serves both output rows (the 3x3 stencil's rows), so a thread issues 3
//    row loads of COLS + 2 elements for 2 * 2 * COLS outputs.
//  * 64-bit offsets between groups (the eval's largest call writes 2.5 G
//    elements), 32-bit inside a group (fewer than 2^31 output elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kTorchNhwcChannels = 16;  // PyTorch's NHWC resize kernel takes C >= 16

template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<double> {
  using type = double;
};

__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T>
__device__ __forceinline__ T from_acc(typename Acc<T>::type v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N consecutive elements, loaded or stored as one access of N * sizeof(T) bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const Pack<T, N>& v) {
  *reinterpret_cast<Pack<T, N>*>(p) = v;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// w0 * a + w1 * b as PyTorch's kernels round it: fma(w0, a, w1 * b), or
// fma(w1, b, w0 * a) where `swap`.
template <typename A>
__device__ __forceinline__ A lerp(A w0, A a, A w1, A b, bool swap) {
  return swap ? fma_rn(w1, b, mul_rn(w0, a)) : fma_rn(w0, a, mul_rn(w1, b));
}

// Outputs 2k and 2k+1 along one axis from v[k-1], v[k], v[k+1] (indices
// clamped to the axis), with F.interpolate's weights and operand order.
template <typename A>
__device__ __forceinline__ A lerp_even(bool first, A lo, A mid, A hi, bool swap = false) {
  return lerp(first ? A(1) : A(0.25), first ? mid : lo, first ? A(0) : A(0.75), first ? hi : mid,
              swap);
}

template <typename A>
__device__ __forceinline__ A lerp_odd(A mid, A hi, bool swap = false) {
  return lerp(A(0.75), mid, A(0.25), hi, swap);
}

// The adjoint along one axis: input k from outputs 2k-1, 2k, 2k+1, 2k+2
// (indices clamped), weights 1/4, 3/4, 3/4, 1/4.
template <typename A>
__device__ __forceinline__ A gather4(A a, A b, A c, A d) {
  return A(0.25) * (a + d) + A(0.75) * (b + c);
}

// What a launch covers: `groups` planes (N*C) or images (N) of `units`
// units each. A block packs `per_block` whole groups when a group has at
// most kThreads / 2 units; else per_block is 1 and the block takes tiles
// blockIdx.y, blockIdx.y + gridDim.y, ... of group blockIdx.x.
struct Grid {
  long long groups;
  int units;
  int per_block;
};

template <class F>
__device__ __forceinline__ void for_units(const Grid& g, F&& f) {
  if (g.per_block > 1) {
    const int k = threadIdx.x / g.units, u = threadIdx.x - k * g.units;
    const long long group = (long long)blockIdx.x * g.per_block + k;
    if (k < g.per_block && group < g.groups) f(group, u);
    return;
  }
  for (int u = blockIdx.y * kThreads + threadIdx.x; u < g.units; u += gridDim.y * kThreads)
    f((long long)blockIdx.x, u);
}

// Forward, planes: unit u of plane p is input row i, columns j0 .. j0+COLS-1;
// it writes output rows 2i and 2i+1, columns 2*j0 .. 2*j0+2*COLS-1.
template <typename T, int COLS>
__global__ void __launch_bounds__(kThreads)
    bilinear2x_fwd_planes_kernel(const T* __restrict__ x, T* __restrict__ y, Grid g, int h,
                                 int w) {
  using A = typename Acc<T>::type;
  const int segs = w / COLS;
  for_units(g, [&](long long p, int u) {
    const int i = u / segs, j0 = (u - i * segs) * COLS;
    const T* xp = x + p * h * w;
    T* yp = y + p * 4 * h * w;
    const int rows[3] = {max(i - 1, 0), i, min(i + 1, h - 1)};
    A hv[3][2 * COLS];  // each input row interpolated along the row
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T* row = xp + rows[r] * w;
      const Pack<T, COLS> mid = load<T, COLS>(row + j0);
      A v[COLS + 2];  // columns j0-1 .. j0+COLS, clamped
      v[0] = to_acc(row[max(j0 - 1, 0)]);
#pragma unroll
      for (int c = 0; c < COLS; ++c) v[c + 1] = to_acc(mid.v[c]);
      v[COLS + 1] = to_acc(row[min(j0 + COLS, w - 1)]);
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        hv[r][2 * c] = lerp_even(j0 + c == 0, v[c], v[c + 1], v[c + 2]);
        hv[r][2 * c + 1] = lerp_odd(v[c + 1], v[c + 2]);
      }
    }
    Pack<T, 2 * COLS> even, odd;
#pragma unroll
    for (int k = 0; k < 2 * COLS; ++k) {
      even.v[k] = from_acc<T>(lerp_even(i == 0, hv[0][k], hv[1][k], hv[2][k]));
      odd.v[k] = from_acc<T>(lerp_odd(hv[1][k], hv[2][k]));
    }
    store(yp + 2 * i * 2 * w + 2 * j0, even);
    store(yp + (2 * i + 1) * 2 * w + 2 * j0, odd);
  });
}

// Forward, pixel-major: unit u of image n is input pixel (i, j), channels
// c0 .. c0+VC-1; it writes the output quad (2i..2i+1, 2j..2j+1). An output
// row's upper input row (X) is interpolated along the row as PyTorch's
// kernel for these channels does it (`swap`), its lower one (Y) as both do.
template <typename T, int VC>
__global__ void __launch_bounds__(kThreads)
    bilinear2x_fwd_rows_kernel(const T* __restrict__ x, T* __restrict__ y, Grid g, int h, int w,
                               int c) {
  using A = typename Acc<T>::type;
  const int cvs = c / VC;
  for_units(g, [&](long long n, int u) {
    const int i = u / (w * cvs), rem = u - i * w * cvs, j = rem / cvs, c0 = (rem - j * cvs) * VC;
    const T* xi = x + n * h * w * c;
    T* yi = y + n * 4 * h * w * c;
    const int rows[3] = {max(i - 1, 0), i, min(i + 1, h - 1)};
    const int cols[3] = {max(j - 1, 0), j, min(j + 1, w - 1)};
    Pack<T, VC> px[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = 0; s < 3; ++s) px[r][s] = load<T, VC>(xi + (rows[r] * w + cols[s]) * c + c0);
    const bool swap = c >= kTorchNhwcChannels;
    Pack<T, VC> out[2][2];
#pragma unroll
    for (int k = 0; k < VC; ++k) {
      A hx[2][2], hy[2][2];  // rows 0, 1 as an upper row (X); rows 1, 2 as a lower row (Y)
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const A lo = to_acc(px[r][0].v[k]), mid = to_acc(px[r][1].v[k]),
                hi = to_acc(px[r][2].v[k]);
        if (r < 2) {
          hx[r][0] = lerp_even(j == 0, lo, mid, hi, swap);
          hx[r][1] = lerp_odd(mid, hi, swap);
        }
        if (r > 0) {
          hy[r - 1][0] = lerp_even(j == 0, lo, mid, hi);
          hy[r - 1][1] = lerp_odd(mid, hi);
        }
      }
      // output row 2i from rows i-1 (X) and i (Y), at i = 0 rows 0 (X) and
      // 1 (Y) with weights 1 and 0; row 2i+1 from rows i (X) and i+1 (Y)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool first = i == 0;
        out[0][q].v[k] = from_acc<T>(lerp(first ? A(1) : A(0.25), first ? hx[1][q] : hx[0][q],
                                          first ? A(0) : A(0.75), first ? hy[1][q] : hy[0][q],
                                          false));
        out[1][q].v[k] = from_acc<T>(lerp_odd(hx[1][q], hy[1][q]));
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        store(yi + ((2 * i + p) * 2 * w + 2 * j + q) * c + c0, out[p][q]);
  });
}

// Backward, planes: unit u of plane p is input row i, columns j0 ..
// j0+COLS-1, from output rows 2i-1 .. 2i+2 and columns 2*j0-1 .. 2*j0+2*COLS
// (clamped).
template <typename T, int COLS>
__global__ void __launch_bounds__(kThreads)
    bilinear2x_bwd_planes_kernel(const T* __restrict__ gy, T* __restrict__ gx, Grid g, int h,
                                 int w) {
  using A = typename Acc<T>::type;
  const int segs = w / COLS, ow = 2 * w;
  for_units(g, [&](long long p, int u) {
    const int i = u / segs, j0 = (u - i * segs) * COLS;
    const T* gp = gy + p * 4 * h * w;
    const int rows[4] = {max(2 * i - 1, 0), 2 * i, 2 * i + 1, min(2 * i + 2, 2 * h - 1)};
    A hs[4][COLS];  // each output row gathered along the row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const T* row = gp + rows[r] * ow;
      const Pack<T, 2 * COLS> mid = load<T, 2 * COLS>(row + 2 * j0);
      A v[2 * COLS + 2];  // output columns 2*j0-1 .. 2*j0+2*COLS, clamped
      v[0] = to_acc(row[max(2 * j0 - 1, 0)]);
#pragma unroll
      for (int k = 0; k < 2 * COLS; ++k) v[k + 1] = to_acc(mid.v[k]);
      v[2 * COLS + 1] = to_acc(row[min(2 * j0 + 2 * COLS, ow - 1)]);
#pragma unroll
      for (int k = 0; k < COLS; ++k)
        hs[r][k] = gather4(v[2 * k], v[2 * k + 1], v[2 * k + 2], v[2 * k + 3]);
    }
    Pack<T, COLS> out;
#pragma unroll
    for (int k = 0; k < COLS; ++k)
      out.v[k] = from_acc<T>(gather4(hs[0][k], hs[1][k], hs[2][k], hs[3][k]));
    store(gx + p * h * w + i * w + j0, out);
  });
}

// Backward, pixel-major: unit u of image n is input pixel (i, j), channels
// c0 .. c0+VC-1, from its 4x4 output neighbourhood (clamped).
template <typename T, int VC>
__global__ void __launch_bounds__(kThreads)
    bilinear2x_bwd_rows_kernel(const T* __restrict__ gy, T* __restrict__ gx, Grid g, int h, int w,
                               int c) {
  using A = typename Acc<T>::type;
  const int cvs = c / VC, ow = 2 * w;
  for_units(g, [&](long long n, int u) {
    const int i = u / (w * cvs), rem = u - i * w * cvs, j = rem / cvs, c0 = (rem - j * cvs) * VC;
    const T* gi = gy + n * 4 * h * w * c;
    const int rows[4] = {max(2 * i - 1, 0), 2 * i, 2 * i + 1, min(2 * i + 2, 2 * h - 1)};
    const int cols[4] = {max(2 * j - 1, 0), 2 * j, 2 * j + 1, min(2 * j + 2, ow - 1)};
    A hs[4][VC];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      Pack<T, VC> px[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) px[s] = load<T, VC>(gi + (rows[r] * ow + cols[s]) * c + c0);
#pragma unroll
      for (int k = 0; k < VC; ++k)
        hs[r][k] = gather4(to_acc(px[0].v[k]), to_acc(px[1].v[k]), to_acc(px[2].v[k]),
                           to_acc(px[3].v[k]));
    }
    Pack<T, VC> out;
#pragma unroll
    for (int k = 0; k < VC; ++k)
      out.v[k] = from_acc<T>(gather4(hs[0][k], hs[1][k], hs[2][k], hs[3][k]));
    store(gx + n * h * w * c + (i * w + j) * c + c0, out);
  });
}

// The vector instantiations' widths: input columns a planes thread takes
// (its two output runs are 16 bytes, 8 in f64), channels a pixel-major
// thread takes (16 bytes).
template <typename T>
constexpr int plane_cols() {
  return sizeof(T) >= 8 ? 1 : 8 / sizeof(T);
}
template <typename T>
constexpr int row_vec() {
  return 16 / sizeof(T);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// The widest width (vector or 1) that the shapes and both pointers take:
// `small` is the input-sized tensor (x, or the input's gradient), `big` the
// output-sized one. 0: `big` is not aligned to the pair of output elements
// that a planes thread of width 1 stores (or loads) at once.
template <typename T>
int width_for(const void* small, const void* big, int planes, int w, int c) {
  if (planes) {
    constexpr int cols = plane_cols<T>();
    if (!aligned(big, 2 * sizeof(T))) return 0;
    const int ok = w % cols == 0 && aligned(small, cols * sizeof(T)) &&
                   aligned(big, 2 * cols * sizeof(T));
    return ok ? cols : 1;
  }
  constexpr int vc = row_vec<T>();
  const int ok = c % vc == 0 && aligned(small, vc * sizeof(T)) && aligned(big, vc * sizeof(T));
  return ok ? vc : 1;
}

int width_of(const void* small, const void* big, int planes, int w, int c, int dtype) {
  switch (dtype) {
    case 0: return width_for<__nv_bfloat16>(small, big, planes, w, c);
    case 1: return width_for<float>(small, big, planes, w, c);
    case 2: return width_for<double>(small, big, planes, w, c);
    default: return 0;
  }
}

bool bad_shape(long long groups, int planes, int h, int w, int c) {
  return groups < 1 || h < 1 || w < 1 || c < 1 ||
         4LL * h * w * (planes ? 1 : c) > INT_MAX;  // a group's output in 32-bit offsets
}

template <typename T, int V, bool PLANES>
int launch(bool fwd, const void* src, void* dst, long long groups, int h, int w, int c,
           cudaStream_t stream) {
  Grid g;
  g.groups = groups;
  g.units = PLANES ? h * (w / V) : h * w * (c / V);
  g.per_block = g.units <= kThreads / 2 ? kThreads / g.units : 1;
  const long long blocks = (groups + g.per_block - 1) / g.per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int tiles = g.per_block > 1 ? 1 : (g.units + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)blocks, (unsigned)(tiles < kMaxGridY ? tiles : kMaxGridY));
  const T* in = static_cast<const T*>(src);
  T* out = static_cast<T*>(dst);
  if constexpr (PLANES) {
    if (fwd)
      bilinear2x_fwd_planes_kernel<T, V><<<grid, kThreads, 0, stream>>>(in, out, g, h, w);
    else
      bilinear2x_bwd_planes_kernel<T, V><<<grid, kThreads, 0, stream>>>(in, out, g, h, w);
  } else {
    if (fwd)
      bilinear2x_fwd_rows_kernel<T, V><<<grid, kThreads, 0, stream>>>(in, out, g, h, w, c);
    else
      bilinear2x_bwd_rows_kernel<T, V><<<grid, kThreads, 0, stream>>>(in, out, g, h, w, c);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(bool fwd, int planes, int width, const void* src, void* dst, long long groups,
                 int h, int w, int c, cudaStream_t stream) {
  constexpr int cols = plane_cols<T>(), vc = row_vec<T>();
  if (planes)
    return width == cols ? launch<T, cols, true>(fwd, src, dst, groups, h, w, c, stream)
                         : launch<T, 1, true>(fwd, src, dst, groups, h, w, c, stream);
  return width == vc ? launch<T, vc, false>(fwd, src, dst, groups, h, w, c, stream)
                     : launch<T, 1, false>(fwd, src, dst, groups, h, w, c, stream);
}

// src is read, dst written; small / big as in width_for.
int run(bool fwd, const void* src, void* dst, long long groups, int planes, int h, int w, int c,
        int dtype, void* stream) {
  if (bad_shape(groups, planes, h, w, c) || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const void* small = fwd ? src : dst;
  const void* big = fwd ? dst : src;
  const int width = width_of(small, big, planes, w, c, dtype);
  if (width == 0) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_typed<__nv_bfloat16>(fwd, planes, width, src, dst, groups, h, w, c, s);
    case 1: return launch_typed<float>(fwd, planes, width, src, dst, groups, h, w, c, s);
    case 2: return launch_typed<double>(fwd, planes, width, src, dst, groups, h, w, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Elements a thread takes along its vector axis for these tensors: input
// columns (planes = 1) or channels (planes = 0); 1 is the scalar
// instantiation, 0 tensors no launch takes (an unknown dtype, or planes
// whose output-sized pointer is not aligned to two elements). dtype: 0 bf16,
// 1 f32, 2 f64.
int bilinear2x_width(const void* small, const void* big, int planes, int w, int c, int dtype) {
  return width_of(small, big, planes, w, c, dtype);
}

// x (groups, H, W) planes (planes = 1, groups = N*C, c = 1) or (groups, H,
// W, C) pixel-major rows (planes = 0, groups = N) -> y of 2H x 2W in the
// same layout. Returns cudaGetLastError().
int bilinear2x_forward(const void* x, void* y, long long groups, int planes, int h, int w, int c,
                       int dtype, void* stream) {
  return run(true, x, y, groups, planes, h, w, c, dtype, stream);
}

// gy (the output's gradient, 2H x 2W) -> gx (H x W), both in the layout of
// bilinear2x_forward; gx is written whole. Returns cudaGetLastError().
int bilinear2x_backward(const void* gy, void* gx, long long groups, int planes, int h, int w,
                        int c, int dtype, void* stream) {
  return run(false, gy, gx, groups, planes, h, w, c, dtype, stream);
}

}  // extern "C"
