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
// What bounds it on an H100: bytes. The forward must write the crops
// (482 MB at serving) and read the maps under the ROIs (at most 84 MB);
// the backward must read the crops' gradient and write the maps' gradient
// (411 MB + 84 MB in training). At 3.35 TB/s that is about 0.17 ms and
// 0.15 ms; the operations (8 multiply-adds an output) are far below the
// card's rate.
//
// Design (simple first: making it fast is later work):
//   * forward (`roi_crop_fwd_kernel`): a CTA for each (expression, ROI).
//     Threads 0..2S-1 put the ROI's taps and weights in shared memory;
//     then each thread takes 16-byte channel vectors of output samples,
//     reads the up to 4 map pixels' vectors (the map's expression stride
//     is free, 0 for a broadcast map), and writes one 16-byte vector.
//   * backward (`roi_crop_bwd_kernel`): a CTA for each (expression,
//     32-byte channel slab, band of map rows) holds its band's gradient in
//     f32 in shared memory; a thread owns one row, one channel pair and one
//     of three ranges of columns of it (960 threads for a bf16 map of 40
//     rows). The CTA walks the ROIs r = 0..R-1 in order, up to 32 at a
//     time: their taps, their first and last tap row and column, and their
//     gradient's slab, (chunk, S, S, 32 bytes), staged in shared memory by
//     16-byte loads. A thread passes over a ROI whose taps miss its row or
//     its columns; else, for each sample column j in order whose two taps
//     fall in its range, it sums the S samples' y weights times the
//     gradient in f32 (i = 0..S-1 in order), rounds that to the map's
//     dtype (the einsum's rounded intermediate), and adds wx times it at
//     the taps. Every element is owned by one thread and summed in the one
//     order (r, j): there are no atomics, and two runs give the same bits.
//     The band is rounded once to the map's dtype and written once.
//     `crop_bwd_coords_plain` is this algorithm in torch ops, bit for bit.
//     What made it faster than a thread a row and channel pair reading the
//     gradient from global memory: the staged slab (one coalesced read),
//     three times the warps (the CTA's shared memory allows one CTA an
//     SM), the passes over ROIs and columns a thread has no tap of, and S
//     fixed at compile time (`tools/profile_crop.py --baseline` times an
//     earlier source beside this one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kMaxS = 16;        // samples a side at most
constexpr int kRoiChunk = 32;    // ROIs whose taps the backward stages
constexpr int kSlabBytes = 32;   // a backward CTA's channels of a pixel
constexpr int kXSplit = 3;       // column ranges of a band, a thread each

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
// S, S, C). Grid E * R CTAs.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    roi_crop_fwd_kernel(const T* __restrict__ feat, long long batch_stride,
                        int h, int w, int c, const float* __restrict__ ys,
                        const float* __restrict__ xs, int r, int s,
                        T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  __shared__ int tap0[2][kMaxS];      // [0] rows, [1] columns
  __shared__ float wt[2][kMaxS][2];
  const long long roi = blockIdx.x;   // e * R + r
  const int e = static_cast<int>(roi / r);
  const int t = threadIdx.x;
  if (t < 2 * s) {
    const int axis = t / s, k = t % s;
    const float coord = (axis ? xs : ys)[roi * s + k];
    if (axis) {
      taps<T>(coord, w, &tap0[1][k], &wt[1][k][0], &wt[1][k][1]);
    } else {
      taps<T>(coord, h, &tap0[0][k], &wt[0][k][0], &wt[0][k][1]);
    }
  }
  __syncthreads();
  const T* map = feat + e * batch_stride;
  const int cv = c / V;
  const int items = s * s * cv;
  T* o = out + roi * s * s * c;
  for (int it = t; it < items; it += blockDim.x) {
    const int v = it % cv;
    const int j = (it / cv) % s;
    const int i = it / (cv * s);
    const int y0 = tap0[0][i], x0 = tap0[1][j];
    const float wy[2] = {wt[0][i][0], wt[0][i][1]};
    const float wx[2] = {wt[1][j][0], wt[1][j][1]};
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
                   map + (static_cast<long long>(y) * w + x) * c + v * V),
               f);
#pragma unroll
        for (int k = 0; k < V; ++k) row[k] = row[k] + wx[b] * f[k];
      }
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = acc[k] + wy[a] * round_to<T>(row[k]);
    }
    *reinterpret_cast<uint4*>(o + (i * s + j) * c + v * V) = pack(acc);
  }
}

// a channel pair of shared memory as floats
__device__ __forceinline__ void load_pair(const float* p, float* a, float* b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  *a = v.x;
  *b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float* a,
                                          float* b) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  *a = v.x;
  *b = v.y;
}

// grad (E, R, S, S, C), ys, xs (E, R, S) f32, dfeat (E, H, W, C), all
// contiguous. Grid (slabs, E, bands); band_rows * CS / 2 * kXSplit
// threads, a thread a (row, channel pair, range of columns); a warp holds
// 4 rows of one range. S the samples a side when fixed at compile time
// (the 7 x 7 crop and the 14 x 14 of `max_pool`), else 0 and s is read.
// Dynamic shared memory: the band, rows of
// (W + 1) * CS f32 (a row padded by one pixel, so that a warp's rows fall
// on other banks), then the gradient's slab of `chunk` ROIs, (chunk, S, S,
// CS) of T.
template <typename T, int S>
__global__ void __launch_bounds__(1024)
    roi_crop_bwd_kernel(const T* __restrict__ grad,
                        const float* __restrict__ ys,
                        const float* __restrict__ xs, int h, int w, int c,
                        int r, int s, int band_rows, int chunk,
                        T* __restrict__ dfeat) {
  constexpr int CS = kSlabBytes / sizeof(T);   // channels a slab
  constexpr int PAIRS = CS / 2;
  constexpr int V = 16 / sizeof(T);
  constexpr int VS = CS / V;                   // 16-byte vectors a pixel
  constexpr int NS = S ? S : kMaxS;            // the weights a thread holds
  if (S) s = S;
  extern __shared__ __align__(16) float acc[];
  __shared__ float ys_s[kRoiChunk][kMaxS];
  __shared__ int x0_s[kRoiChunk][kMaxS];
  __shared__ float wx_s[kRoiChunk][kMaxS][2];
  // each staged ROI's first and last tap row and column
  __shared__ float span_s[kRoiChunk][4];
  const int slab = blockIdx.x, e = blockIdx.y;
  const int y_lo = blockIdx.z * band_rows;
  const int rows = min(band_rows, h - y_lo);
  const int row_floats = (w + 1) * CS;
  T* gs = reinterpret_cast<T*>(acc + band_rows * row_floats);
  const int t = threadIdx.x;
  const int part = t / (band_rows * PAIRS);
  const int ty = t / PAIRS % band_rows, cp = t % PAIRS;
  const int x_lo = part * w / kXSplit, x_hi = (part + 1) * w / kXSplit;
  const bool active = ty < rows && slab * CS + 2 * cp < c && x_lo < x_hi;
  for (int k = t; k < band_rows * row_floats; k += blockDim.x) acc[k] = 0.0f;
  const float fy = static_cast<float>(y_lo + ty);
  float* my = acc + ty * row_floats + 2 * cp;
  const int ss = s * s;
  for (int r0 = 0; r0 < r; r0 += chunk) {
    const int n = min(chunk, r - r0);
    __syncthreads();
    for (int k = t; k < n * s; k += blockDim.x) {
      const int q = k / s, j = k % s;
      const long long at = (static_cast<long long>(e) * r + r0 + q) * s + j;
      ys_s[q][j] = ys[at];
      taps<T>(xs[at], w, &x0_s[q][j], &wx_s[q][j][0], &wx_s[q][j][1]);
      if (j == 0) {
        // the samples run from the first to the last (a linspace), and a
        // sample's taps are floor(coord) and the cell after it
        const float* yq = ys + at;
        const float* xq = xs + at;
        span_s[q][0] = floorf(fminf(yq[0], yq[s - 1]));
        span_s[q][1] = floorf(fmaxf(yq[0], yq[s - 1])) + 1.0f;
        span_s[q][2] = floorf(fminf(xq[0], xq[s - 1]));
        span_s[q][3] = floorf(fmaxf(xq[0], xq[s - 1])) + 1.0f;
      }
    }
    // the chunk's gradient slab, 16 bytes a load (channels past C zero)
    const T* src = grad + (static_cast<long long>(e) * r + r0) * ss * c +
                   slab * CS;
    for (int k = t; k < n * ss * VS; k += blockDim.x) {
      const int v = k % VS, px = k / VS;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (slab * CS + v * V < c) {
        raw = *reinterpret_cast<const uint4*>(
            src + static_cast<long long>(px) * c + v * V);
      }
      *reinterpret_cast<uint4*>(gs + px * CS + v * V) = raw;
    }
    __syncthreads();
    if (!active) continue;
    for (int q = 0; q < n; ++q) {
      if (fy < span_s[q][0] || fy > span_s[q][1] ||
          span_s[q][3] < static_cast<float>(x_lo) ||
          span_s[q][2] >= static_cast<float>(x_hi)) {
        continue;
      }
      float wy[NS];
      bool any = false;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        wy[i] = i < s ? round_to<T>(
                            fmaxf(0.0f, 1.0f - fabsf(ys_s[q][i] - fy)))
                      : 0.0f;
        any = any || wy[i] != 0.0f;
      }
      if (!any) continue;
      const T* g = gs + q * ss * CS + 2 * cp;
      for (int j = 0; j < s; ++j) {
        // neither of the column's taps in this thread's range: it adds
        // nothing here
        const int x0 = x0_s[q][j];
        if (x0 + 1 < x_lo || x0 >= x_hi) continue;
        float u0 = 0.0f, u1 = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          if (wy[i] == 0.0f) continue;
          float g0, g1;
          load_pair(g + (i * s + j) * CS, &g0, &g1);
          u0 = u0 + wy[i] * g0;
          u1 = u1 + wy[i] * g1;
        }
        u0 = round_to<T>(u0);
        u1 = round_to<T>(u1);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int x = x0 + b;
          const float wx = wx_s[q][j][b];
          if (x < x_lo || x >= x_hi || wx == 0.0f) continue;
          float2* a = reinterpret_cast<float2*>(my + x * CS);
          float2 cur = *a;
          cur.x = cur.x + wx * u0;
          cur.y = cur.y + wx * u1;
          *a = cur;
        }
      }
    }
  }
  __syncthreads();
  // the band out, 16 bytes a store, each element rounded once
  T* out = dfeat + (static_cast<long long>(e) * h + y_lo) * w * c;
  for (int k = t; k < rows * w * VS; k += blockDim.x) {
    const int v = k % VS, x = (k / VS) % w, y = k / (VS * w);
    const int c0 = slab * CS + v * V;
    if (c0 >= c) continue;
    float f[V];
    const float* from = acc + y * row_floats + x * CS + v * V;
#pragma unroll
    for (int q = 0; q < V; ++q) f[q] = from[q];
    *reinterpret_cast<uint4*>(out + (static_cast<long long>(y) * w + x) * c +
                              c0) = pack(f);
  }
}

template <typename T>
cudaError_t fwd(const void* feat, long long batch_stride, int e, int h, int w,
                int c, const float* ys, const float* xs, int r, int s,
                void* out, cudaStream_t stream) {
  roi_crop_fwd_kernel<T><<<static_cast<unsigned>(static_cast<long long>(e) * r),
                           kFwdThreads, 0, stream>>>(
      static_cast<const T*>(feat), batch_stride, h, w, c, ys, xs, r, s,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* grad, const float* ys, const float* xs, int e,
                int h, int w, int c, int r, int s, int band_rows, int chunk,
                void* dfeat, cudaStream_t stream) {
  constexpr int CS = kSlabBytes / sizeof(T);
  const int threads = band_rows * (CS / 2) * kXSplit;
  if (threads > 1024 || chunk < 1 || chunk > kRoiChunk) {
    return cudaErrorInvalidValue;
  }
  const size_t smem =
      static_cast<size_t>(band_rows) * (w + 1) * CS * sizeof(float) +
      static_cast<size_t>(chunk) * s * s * kSlabBytes;
  auto kernel = s == 7    ? roi_crop_bwd_kernel<T, 7>
                : s == 14 ? roi_crop_bwd_kernel<T, 14>
                          : roi_crop_bwd_kernel<T, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int slabs = (c + CS - 1) / CS;
  const int bands = (h + band_rows - 1) / band_rows;
  kernel<<<dim3(slabs, e, bands), threads, smem, stream>>>(
      static_cast<const T*>(grad), ys, xs, h, w, c, r, s, band_rows, chunk,
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
  if (static_cast<long long>(e) * r > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
// (E, H, W, C) of the map's dtype, all contiguous and 16-byte aligned;
// band_rows rows of the map a CTA (band_rows * 16 / elem * 3 threads), the
// gradient staged `chunk` ROIs at a time (1 to 32): band_rows * (W + 1) *
// 32 / elem * 4 + chunk * S * S * 32 bytes of dynamic shared memory.
// Every element of dfeat is written. Returns a cudaError_t.
extern "C" int roi_crop_bwd_launch(const void* grad, const void* ys,
                                   const void* xs, int e, int h, int w, int c,
                                   int is_bf16, int r, int s, int band_rows,
                                   int chunk, void* dfeat, void* stream) {
  if (c <= 0 || c % 8 || h <= 0 || w <= 0 || s < 2 || s > kMaxS || r < 0 ||
      e < 0 || band_rows <= 0 || !aligned16(grad) || !aligned16(dfeat)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* y = static_cast<const float*>(ys);
  const float* x = static_cast<const float*>(xs);
  const cudaError_t err =
      is_bf16 ? bwd<__nv_bfloat16>(grad, y, x, e, h, w, c, r, s, band_rows,
                                   chunk, dfeat, st)
              : bwd<float>(grad, y, x, e, h, w, c, r, s, band_rows, chunk,
                           dfeat, st);
  return static_cast<int>(err);
}
