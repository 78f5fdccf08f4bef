// The ROI crop (POOLING_MODE 'crop', the reference's `_crop_pool_layer`:
// bilinear grid_sample with align_corners and zero padding) and its
// gradient with respect to the map, for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces no Pallas kernel: the JAX package computes the crop in plain
// XLA (lang2seg_tpu/ops/roi_align.py::crop_and_resize, :80) as two einsums
// against hat-function weights, because XLA's gathers and their
// scatter-add backward are slow on a TPU. Of each contraction's 64 (W) or
// 40 (H) weights at most 2 are not zero, and run eagerly the first einsum
// writes an (E, R, H, S, C) intermediate: 2.75 GB at serving (E = 16, R =
// 300, C = 1024, bf16), 46 GB in test mode 'top' at E = 16 (R = 5000). On
// this card the crop is a 4-tap gather again.
//
// Semantics, as the einsum pair's (ops/roi_align.py's plain version):
//   the sample coordinates ys, xs (E, R, S) are computed once in torch
//   (`_sample_coords`) and read by both routes; a tap's weight is the hat
//   max(0, 1 - |coord - index|) in f32, rounded to the map's dtype (never
//   1 - frac / frac: the two differ in the last f32 bit); taps off the map
//   do not exist (zero padding). The x pass is rounded to the map's dtype
//   before the y pass, as the bf16 einsum rounds its intermediate. The
//   file is built with -fmad=false: a bf16 product is exact in f32, so each
//   pass is one rounding of a two-term f32 sum, as the einsum's f32
//   accumulator gives it.
//
// What bounds it on an H100. The forward must write the crops (482 MB at
// serving, 0.15 ms at 3.35 TB/s) and, for each output vector, read four
// tap vectors: where samples are more than a cell apart no two outputs
// share a tap, so about 4 x 482 MB crosses from L2 to the SMs, and the
// kernel takes about what a copy of the crops takes (`tools/
// profile_crop.py`'s `copy_ms`). The backward must read the crops'
// gradient and write the maps' gradient (411 MB + 84 MB in training, 0.15
// ms); its sums in the fixed order cost tens of instructions a term, so it
// is bound by issue and by the latency of its loads.
//
// Forward (`roi_crop_fwd_kernel`): a thread a (expression, ROI, sample
// column j, 16-byte channel vector), the thread index running over the
// vectors first, so that a warp reads and writes 512 contiguous bytes. The
// thread computes its column's x taps once, then walks the S sample rows:
// no division an output, no shared memory and no barrier, few registers,
// a CTA of 128 threads. Each output is written once with a streaming
// store (`__stcs`), so that the crops do not evict the maps from L2.
//
// Backward (`roi_crop_bwd_kernel`): a CTA of one warp for each
// (expression, 4 pixels of a map row, slab of 256 bf16 or 128 f32
// channels), or 1 pixel where 4 would give fewer warps than the card
// holds; a lane owns one 16-byte vector of channels of the pixels, its
// sums in f32 registers. The warp takes the ROIs in order, 32 at a
// time: lane q tests whether ROI q's taps can reach its pixels (the box
// from floor(min) to floor(max) + 1 of its sample coordinates); for each
// that can, lanes j < S compute sample column j's x taps and lanes 16 + i
// sample row i's y weight on the warp's row, and one ballot gives the
// columns with a tap of weight not zero among its pixels and the rows
// with a weight on the row. For each such column j in order the warp sums
// u = wy_i * grad[i][j] over those rows i in order in f32 (the vectors
// read from L2, where the gradient of the expression the running warps
// share stays), rounds u to the map's dtype (the einsum's rounded
// intermediate) and adds wx * u at the column's taps among its pixels. A
// ROI costs a warp only its terms on the warp's pixels: the ROI's S x S
// samples spread over the warps they reach, at most 2S rows, whatever its
// area. Every control decision is the warp's, none a lane's. One warp a
// CTA lets 32 CTAs share an SM, so that a warp with many terms (the middle
// of the map) does not hold up others, as it did in a CTA of many warps.
//
// The summing order, the same as `crop_bwd_coords_plain` (bit for bit):
// every element of the maps' gradient belongs to one lane, which adds the
// ROIs' terms in the order (ROI r, sample column j, tap) in f32; each u
// sums its sample rows i in order; the element is rounded once, at the end,
// and written once. A term whose weight is zero is left out (adding it
// would change nothing). No atomics: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 128;
constexpr int kMaxS = 16;         // samples a side at most
// the backward: a warp (a CTA) 4 pixels of a row, or 1 (`band_plan` in
// ops/roi_crop_cuda.py chooses); at most 65536 / (32 x 64) = 32 of them
// an SM (64 registers a thread)
constexpr int kBwdMinBlocks = 32;
// elements of T a 16-byte vector
template <typename T>
constexpr int kVec = 16 / sizeof(T);

__device__ __forceinline__ float rounded(float v, float*) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// v rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return rounded(v, static_cast<T*>(nullptr));
}

// a 16-byte vector as floats, and back (rounding to nearest)
__device__ __forceinline__ void unpack(uint4 raw, float (&f)[8]) {
  const unsigned u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    u[i] = *reinterpret_cast<const unsigned*>(&b);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// A sample coordinate's two taps on an axis of n cells: the first tap's
// index, and each tap's weight rounded to T, 0 for a tap off the axis.
template <typename T>
__device__ __forceinline__ void taps(float coord, int n, int* first,
                                     float* w0, float* w1) {
  const float f0 = floorf(coord);
  const float f1 = f0 + 1.0f;
  const bool in0 = f0 >= 0.0f && f0 < static_cast<float>(n);
  const bool in1 = f1 >= 0.0f && f1 < static_cast<float>(n);
  *first = in0 ? static_cast<int>(f0) : (in1 ? static_cast<int>(f1) - 1 : -2);
  *w0 = in0 ? round_to<T>(fmaxf(0.0f, 1.0f - fabsf(coord - f0))) : 0.0f;
  *w1 = in1 ? round_to<T>(fmaxf(0.0f, 1.0f - fabsf(coord - f1))) : 0.0f;
}

// feat (E, H, W, C) with each expression's map contiguous at
// batch_stride elements from the last; ys, xs (E, R, S) f32; out (E, R,
// S, S, C). A thread a (ROI, sample column j, 16-byte vector), the thread
// index running over the vectors first: it computes its column's x taps
// once and walks the S sample rows.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    roi_crop_fwd_kernel(const T* __restrict__ feat, long long batch_stride,
                        int h, int w, int c, const float* __restrict__ ys,
                        const float* __restrict__ xs, long long rois, int r,
                        int s, T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  const int cv = c / V;
  const long long item =
      static_cast<long long>(blockIdx.x) * kFwdThreads + threadIdx.x;
  const long long per_roi = static_cast<long long>(cv) * s;
  const long long roi = item / per_roi;
  if (roi >= rois) return;
  const int rest = static_cast<int>(item - roi * per_roi);
  const int v = rest % cv, j = rest / cv;
  const int e = static_cast<int>(roi / r);
  int x0;
  float wx[2];
  taps<T>(xs[roi * s + j], w, &x0, &wx[0], &wx[1]);
  const T* map = feat + e * batch_stride + v * V;
  T* o = out + (roi * s * s + j) * c + v * V;
#pragma unroll 1
  for (int i = 0; i < s; ++i) {
    int y0;
    float wy[2];
    taps<T>(ys[roi * s + i], h, &y0, &wy[0], &wy[1]);
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int y = y0 + a;
      if (y < 0 || y >= h) continue;
      float row[V];
#pragma unroll
      for (int k = 0; k < V; ++k) row[k] = 0.0f;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int x = x0 + b;
        if (x < 0 || x >= w) continue;
        float f[V];
        unpack(*reinterpret_cast<const uint4*>(
                   map + (static_cast<long long>(y) * w + x) * c),
               f);
#pragma unroll
        for (int k = 0; k < V; ++k) row[k] = row[k] + wx[b] * f[k];
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        acc[k] = acc[k] + wy[a] * round_to<T>(row[k]);
      }
    }
    __stcs(reinterpret_cast<uint4*>(o + static_cast<long long>(i) * s * c),
           pack(acc));
  }
}

// What a warp needs of a ROI: lane j < S holds sample column j's first x
// tap and the two taps' weights, lane 16 + i sample row i's y weight on
// the warp's row; `cols` and `rows` the sample columns with a tap of
// weight not zero among the warp's pixels and the sample rows with a
// weight on its row (bit j, bit i).
struct RoiTerms {
  int x0;
  float wx0, wx1, wy;
  unsigned cols, rows;
};

template <typename T, int P>
__device__ __forceinline__ RoiTerms roi_terms(const float* yq,
                                              const float* xq, int s, int w,
                                              float fy, int xb, int lane) {
  RoiTerms o = {-2, 0.0f, 0.0f, 0.0f, 0u, 0u};
  bool take = false;
  if (lane < s) {
    taps<T>(xq[lane], w, &o.x0, &o.wx0, &o.wx1);
    take = (o.wx0 != 0.0f && o.x0 >= xb && o.x0 < xb + P) ||
           (o.wx1 != 0.0f && o.x0 + 1 >= xb && o.x0 + 1 < xb + P);
  } else if (lane >= 16 && lane - 16 < s) {
    o.wy = round_to<T>(fmaxf(0.0f, 1.0f - fabsf(yq[lane - 16] - fy)));
    take = o.wy != 0.0f;
  }
  const unsigned mask = __ballot_sync(0xffffffffu, take);
  o.cols = mask & 0xffffu;
  o.rows = mask >> 16;
  return o;
}

// grad (E, R, S, S, C), ys, xs (E, R, S) f32, dfeat (E, H, W, C), all
// contiguous. Grid (H * segments of P pixels a row, slabs of 32 * V
// channels, E), a CTA of one warp: the warp owns P pixels of a row
// and a lane a 16-byte vector (V elements) of their channels, its
// P sums in registers. The warp takes the ROIs 32 at a time, a
// lane a ROI testing whether its taps can reach the warp's pixels; then,
// in order, for each that can, it finds the terms (roi_terms) and sums
// them: for each sample column j in order, u = the sum over its rows i in
// order of wy_i * grad[i][j] in f32 (the 16-byte vectors read from
// global memory: L2, the warps of one expression run together), rounded
// to T, then wx * u at the column's taps among its pixels.
template <typename T, int P>
__global__ void __launch_bounds__(32, kBwdMinBlocks)
    roi_crop_bwd_kernel(const T* __restrict__ grad,
                        const float* __restrict__ ys,
                        const float* __restrict__ xs, int h, int w, int c,
                        int r, int s, T* __restrict__ dfeat) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x;
  const int segs = (w + P - 1) / P;
  const int y = blockIdx.x / segs;
  const int xb = blockIdx.x % segs * P;
  const int ch = blockIdx.y * 32 * V + lane * V;
  const int e = blockIdx.z;
  const long long roi0 = static_cast<long long>(e) * r;
  const float fy = static_cast<float>(y);

  float acc[P][V];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int m = 0; m < V; ++m) acc[p][m] = 0.0f;
  }

  for (int base = 0; base < r; base += 32) {
    // lane q: whether ROI base + q's taps can reach the warp's pixels (a
    // sample's taps are floor(coord) and the cell after it)
    bool hit = false;
    if (base + lane < r) {
      const float* yq = ys + (roi0 + base + lane) * s;
      const float* xq = xs + (roi0 + base + lane) * s;
      float ylo = yq[0], yhi = ylo, xlo = xq[0], xhi = xlo;
      for (int i = 1; i < s; ++i) {
        ylo = fminf(ylo, yq[i]);
        yhi = fmaxf(yhi, yq[i]);
        xlo = fminf(xlo, xq[i]);
        xhi = fmaxf(xhi, xq[i]);
      }
      hit = floorf(ylo) <= fy && floorf(yhi) + 1.0f >= fy &&
            floorf(xlo) <= static_cast<float>(xb + P - 1) &&
            floorf(xhi) + 1.0f >= static_cast<float>(xb);
    }
    for (unsigned m = __ballot_sync(0xffffffffu, hit); m; m &= m - 1) {
      const long long roi = roi0 + base + __ffs(m) - 1;
      const RoiTerms o = roi_terms<T, P>(ys + roi * s, xs + roi * s, s, w,
                                         fy, xb, lane);
      if (!o.cols || !o.rows) continue;
      const T* gq = grad + roi * s * s * c + ch;
      for (unsigned cj = o.cols; cj; cj &= cj - 1) {
        const int j = __ffs(cj) - 1;
        const int xj = __shfl_sync(0xffffffffu, o.x0, j);
        const float w0 = __shfl_sync(0xffffffffu, o.wx0, j);
        const float w1 = __shfl_sync(0xffffffffu, o.wx1, j);
        float u[V];
#pragma unroll
        for (int k = 0; k < V; ++k) u[k] = 0.0f;
        for (unsigned ci = o.rows; ci; ci &= ci - 1) {
          const int i = __ffs(ci) - 1;
          const float wi = __shfl_sync(0xffffffffu, o.wy, 16 + i);
          uint4 raw = make_uint4(0u, 0u, 0u, 0u);
          if (ch < c) {
            raw = *reinterpret_cast<const uint4*>(
                gq + static_cast<long long>(i * s + j) * c);
          }
          float f[V];
          unpack(raw, f);
#pragma unroll
          for (int k = 0; k < V; ++k) u[k] = u[k] + wi * f[k];
        }
#pragma unroll
        for (int k = 0; k < V; ++k) u[k] = round_to<T>(u[k]);
        // the column's taps at pixels xj and xj + 1, where they are this
        // warp's and their weights are not zero
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int x = xb + p;
          if (x == xj && w0 != 0.0f) {
#pragma unroll
            for (int k = 0; k < V; ++k) acc[p][k] = acc[p][k] + w0 * u[k];
          } else if (x == xj + 1 && w1 != 0.0f) {
#pragma unroll
            for (int k = 0; k < V; ++k) acc[p][k] = acc[p][k] + w1 * u[k];
          }
        }
      }
    }
  }
  // the warp's pixels out, 16 bytes a lane, each element rounded once
  if (ch >= c) return;
  T* out = dfeat + ((static_cast<long long>(e) * h + y) * w + xb) * c + ch;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (xb + p < w) {
      *reinterpret_cast<uint4*>(out + static_cast<long long>(p) * c) =
          pack(acc[p]);
    }
  }
}

template <typename T>
cudaError_t fwd(const void* feat, long long batch_stride, int e, int h, int w,
                int c, const float* ys, const float* xs, int r, int s,
                void* out, cudaStream_t stream) {
  const long long rois = static_cast<long long>(e) * r;
  const long long items = rois * s * (c / kVec<T>);
  const long long blocks = (items + kFwdThreads - 1) / kFwdThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  roi_crop_fwd_kernel<T><<<static_cast<unsigned>(blocks), kFwdThreads, 0,
                           stream>>>(static_cast<const T*>(feat),
                                     batch_stride, h, w, c, ys, xs, rois, r,
                                     s, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* grad, const float* ys, const float* xs, int e,
                int h, int w, int c, int r, int s, int pixels, void* dfeat,
                cudaStream_t stream) {
  const int slabs = (c + 32 * kVec<T> - 1) / (32 * kVec<T>);
  const long long warps =
      static_cast<long long>(h) * ((w + pixels - 1) / pixels);
  if (warps > 0x7fffffffLL || slabs > 65535 || e > 65535) {
    return cudaErrorInvalidValue;
  }
  auto kernel =
      pixels == 4 ? roi_crop_bwd_kernel<T, 4> : roi_crop_bwd_kernel<T, 1>;
  kernel<<<dim3(static_cast<unsigned>(warps), slabs, e), 32, 0, stream>>>(
      static_cast<const T*>(grad), ys, xs, h, w, c, r, s,
      static_cast<T*>(dfeat));
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// feat (E, H, W, C) of f32 or bf16 (is_bf16), each expression's map
// contiguous and batch_stride elements from the last (0 for a broadcast
// map); ys, xs (E, R, S) f32 sample coordinates in map cells, contiguous;
// out (E, R, S, S, C) of the map's dtype, contiguous, every element
// written. C a multiple of 8, the map, its stride and out 16-byte
// aligned, 2 <= S <= 16. Launches on `stream`, allocates nothing.
// Returns a cudaError_t.
extern "C" int roi_crop_fwd_launch(const void* feat, long long batch_stride,
                                   int e, int h, int w, int c, int is_bf16,
                                   const void* ys, const void* xs, int r,
                                   int s, void* out, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  if (c <= 0 || c % 8 || h <= 0 || w <= 0 || s < 2 || s > kMaxS || r < 0 ||
      e < 0 || (batch_stride * elem) % 16 || !aligned16(feat) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(e) * r == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* y = static_cast<const float*>(ys);
  const float* x = static_cast<const float*>(xs);
  const cudaError_t err =
      is_bf16 ? fwd<__nv_bfloat16>(feat, batch_stride, e, h, w, c, y, x, r, s,
                                   out, st)
              : fwd<float>(feat, batch_stride, e, h, w, c, y, x, r, s, out,
                           st);
  return static_cast<int>(err);
}

// grad (E, R, S, S, C) of the map's dtype, ys, xs (E, R, S) f32, dfeat
// (E, H, W, C) of the map's dtype, all contiguous and 16-byte aligned,
// C a multiple of 8, 2 <= S <= 16; pixels (1 or 4) of a row a warp.
// Every element of dfeat is written. Launches on `stream`, allocates
// nothing. Returns a cudaError_t.
extern "C" int roi_crop_bwd_launch(const void* grad, const void* ys,
                                   const void* xs, int e, int h, int w, int c,
                                   int is_bf16, int r, int s, int pixels,
                                   void* dfeat, void* stream) {
  if (c <= 0 || c % 8 || h <= 0 || w <= 0 || s < 2 || s > kMaxS || r < 0 ||
      e < 0 || (pixels != 1 && pixels != 4) || !aligned16(grad) ||
      !aligned16(dfeat)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* y = static_cast<const float*>(ys);
  const float* x = static_cast<const float*>(xs);
  const cudaError_t err =
      is_bf16 ? bwd<__nv_bfloat16>(grad, y, x, e, h, w, c, r, s, pixels,
                                   dfeat, st)
              : bwd<float>(grad, y, x, e, h, w, c, r, s, pixels, dfeat, st);
  return static_cast<int>(err);
}
