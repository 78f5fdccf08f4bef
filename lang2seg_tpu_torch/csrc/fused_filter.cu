// Fused language-conditioned gate for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces: lang2seg_tpu/ops/pallas_kernels.py, fused_dynamic_filter
// (Pallas forward `_pallas_forward`, body `_kernel`). Per expression e and
// pixel p of the (H, W, C) map:
//   resp_k = <conv[e, p, :], filt[e, :, k]> in f32, times `scale`
//            (1/sqrt(C) when the response is normalized, else 1);
//   K == 7: fused = sum_k resp_k * mask_k(p) * rfilt[e, k], with the seven
//           indicator masks (full, top, bottom, left, right, middle-row
//           band, middle-column band; integer-floor edges);
//   K == 1: fused = resp_0;
//   g = sigmoid(fused) or fused;
//   gated[e, p, :] = round(conv[e, p, :] (f32) * g) to the map's dtype;
//   resp[e, p] = fused (f32).
//
// Layout: one 256-thread block per (row tile, expression); each warp
// owns one pixel at a time, each thread 16-byte vectors of its channels,
// so a pixel's C channels are read once, with coalesced 16-byte loads,
// kept in registers for the gate multiply, and written once. The filter
// bank of the expression sits in shared memory in a lane-interleaved
// order so each thread's float2 reads are conflict free. The map may be
// a stride-0 broadcast over expressions (all expressions of one image
// share one C4 map): the batch stride is an argument and the map is
// never copied.
//
// What bounds it on an H100: bytes. At the flagship shape (16 x 40 x 64 x
// 1024 bf16) it reads the 5.2 MB map (once per expression, from L2 after
// the first) and writes 84 MB of gated map, against 0.6 GFLOP of f32 work,
// far below the card's f32 rate. The design therefore reads and writes
// each element once and keeps the response out of device memory between
// the contraction, the masks and the gate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;  // per 16-byte vector
  static __device__ __forceinline__ float2 pair(const uint4& v, int q) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
    return __bfloat1622float2(p[q]);
  }
  static __device__ __forceinline__ void set_pair(uint4& v, int q, float a,
                                                  float b) {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
    p[q] = __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  }
};

template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ float2 pair(const uint4& v, int q) {
    return reinterpret_cast<const float2*>(&v)[q];
  }
  static __device__ __forceinline__ void set_pair(uint4& v, int q, float a,
                                                  float b) {
    reinterpret_cast<float2*>(&v)[q] = make_float2(a, b);
  }
};

template <typename T, int K, int NV, bool kSigmoid>
__global__ void __launch_bounds__(kThreads)
fused_filter_kernel(const T* __restrict__ conv, long long conv_batch_stride,
                    const float* __restrict__ filt,
                    const float* __restrict__ rfilt, int h, int w,
                    int rows_per_block, float scale, T* __restrict__ gated,
                    float* __restrict__ resp) {
  constexpr int kElems = Vec<T>::kElems;
  constexpr int kPairs = kElems / 2;
  constexpr int kC = NV * 32 * kElems;
  // filter bank, float2 index ((k * NV + j) * kPairs + q) * 32 + lane
  __shared__ float2 sf[K * kC / 2];

  const int e = blockIdx.y;
  const float* fe = filt + (size_t)e * kC * K;
  float* sff = reinterpret_cast<float*>(sf);
  for (int idx = threadIdx.x; idx < kC * K; idx += kThreads) {
    const int ch = idx / K;
    const int k = idx - ch * K;
    const int j = ch / (32 * kElems);
    const int rem = ch - j * 32 * kElems;
    const int ln = rem / kElems;
    const int el = rem - ln * kElems;
    sff[((((k * NV + j) * kPairs + (el >> 1)) * 32 + ln) << 1) + (el & 1)] =
        fe[idx];
  }
  float rf[K];
#pragma unroll
  for (int k = 0; k < K; ++k) rf[k] = (K == 7) ? rfilt[e * K + k] : 1.0f;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(row0 + rows_per_block, h);
  const T* ce = conv + (size_t)e * conv_batch_stride;
  T* ge = gated + (size_t)e * h * w * kC;
  float* re = resp + (size_t)e * h * w;

  for (int p = row0 * w + warp; p < row1 * w; p += kThreads / 32) {
    const uint4* src = reinterpret_cast<const uint4*>(ce + (size_t)p * kC);
    uint4 v[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] = src[j * 32 + lane];

    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const float2 x = Vec<T>::pair(v[j], q);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float2 f = sf[((k * NV + j) * kPairs + q) * 32 + lane];
          acc[k] = fmaf(x.x, f.x, acc[k]);
          acc[k] = fmaf(x.y, f.y, acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      }
    }

    float fused;
    if (K == 7) {
      const int y = p / w;
      const int x = p - y * w;
      const bool m[7] = {true,
                         y < h / 2,
                         y >= h / 2,
                         x < w / 2,
                         x >= w / 2,
                         y >= h / 4 && y < (h * 3) / 4,
                         x >= w / 4 && x < (w * 3) / 4};
      fused = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float r = m[k] ? acc[k] * scale : 0.0f;
        fused += r * rf[k];
      }
    } else {
      fused = acc[0] * scale;
    }
    const float g = kSigmoid ? 1.0f / (1.0f + expf(-fused)) : fused;

    uint4* dst = reinterpret_cast<uint4*>(ge + (size_t)p * kC);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      uint4 o;
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const float2 x = Vec<T>::pair(v[j], q);
        Vec<T>::set_pair(o, q, x.x * g, x.y * g);
      }
      dst[j * 32 + lane] = o;
    }
    if (lane == 0) re[p] = fused;
  }
}

template <typename T, int K, int NV>
cudaError_t launch_gate(const void* conv, long long stride, const float* filt,
                        const float* rfilt, int e, int h, int w, int sigmoid,
                        float scale, void* gated, float* resp,
                        cudaStream_t s) {
  const int rows_per_block = 1;
  const dim3 grid((h + rows_per_block - 1) / rows_per_block, e);
  const T* c = static_cast<const T*>(conv);
  T* g = static_cast<T*>(gated);
  if (sigmoid) {
    fused_filter_kernel<T, K, NV, true><<<grid, kThreads, 0, s>>>(
        c, stride, filt, rfilt, h, w, rows_per_block, scale, g, resp);
  } else {
    fused_filter_kernel<T, K, NV, false><<<grid, kThreads, 0, s>>>(
        c, stride, filt, rfilt, h, w, rows_per_block, scale, g, resp);
  }
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t dispatch_nv(int nv, const void* conv, long long stride,
                        const float* filt, const float* rfilt, int e, int h,
                        int w, int sigmoid, float scale, void* gated,
                        float* resp, cudaStream_t s) {
  switch (nv) {
    case 1: return launch_gate<T, K, 1>(conv, stride, filt, rfilt, e, h, w,
                                        sigmoid, scale, gated, resp, s);
    case 2: return launch_gate<T, K, 2>(conv, stride, filt, rfilt, e, h, w,
                                        sigmoid, scale, gated, resp, s);
    case 4: return launch_gate<T, K, 4>(conv, stride, filt, rfilt, e, h, w,
                                        sigmoid, scale, gated, resp, s);
    case 8:
      // f32 only: a bf16 map of 2048 channels would need 57 KB of filter
      // bank, beyond the 48 KB of static shared memory
      if constexpr (sizeof(T) == 4) {
        return launch_gate<T, K, 8>(conv, stride, filt, rfilt, e, h, w,
                                    sigmoid, scale, gated, resp, s);
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_k(int k, int nv, const void* conv, long long stride,
                       const float* filt, const float* rfilt, int e, int h,
                       int w, int sigmoid, float scale, void* gated,
                       float* resp, cudaStream_t s) {
  if (k == 7) return dispatch_nv<T, 7>(nv, conv, stride, filt, rfilt, e, h, w,
                                       sigmoid, scale, gated, resp, s);
  if (k == 1) return dispatch_nv<T, 1>(nv, conv, stride, filt, rfilt, e, h, w,
                                       sigmoid, scale, gated, resp, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// conv: (e, h, w, c) map of `is_bf16 ? bf16 : f32`, each (h, w, c) map
// contiguous, map i at conv + i * conv_batch_stride elements (0 for a
// broadcast map), 16-byte aligned; filt (e, c, k) f32 and rfilt (e, k)
// f32 contiguous; gated (e, h, w, c) of the map's dtype and resp (e, h, w)
// f32 are written in full. c is 1, 2 or 4 (f32 also 8) vectors of 16 bytes
// per thread (bf16: 256, 512, 1024; f32: 128, 256, 512, 1024). k is 1 or 7.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_filter_launch(const void* conv,
                                   long long conv_batch_stride,
                                   const void* filt, const void* rfilt, int e,
                                   int h, int w, int c, int k, int is_bf16,
                                   int sigmoid, float scale, void* gated,
                                   void* resp, void* stream) {
  if (e <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_vec = is_bf16 ? 8 : 4;
  if (c % (32 * per_vec) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nv = c / (32 * per_vec);
  const float* f = static_cast<const float*>(filt);
  const float* r = static_cast<const float*>(rfilt);
  float* out_r = static_cast<float*>(resp);
  const cudaError_t err =
      is_bf16 ? dispatch_k<__nv_bfloat16>(k, nv, conv, conv_batch_stride, f, r,
                                          e, h, w, sigmoid, scale, gated,
                                          out_r, s)
              : dispatch_k<float>(k, nv, conv, conv_batch_stride, f, r, e, h,
                                  w, sigmoid, scale, gated, out_r, s);
  return static_cast<int>(err);
}

// ------------------------------------------------------------------ backward
//
// Replaces: lang2seg_tpu/ops/pallas_kernels.py, the gradient rule `_fdf_bwd`
// of the custom_vjp `fused_dynamic_filter`. Per expression e and pixel p,
// given the forward's response fused[p] and the cotangents d_gated[p, :]
// and d_resp[p]:
//   d_g      = sum_c d_gated[p, c] * conv[p, c]
//   d_fused  = d_resp[p] + d_g * g'(fused[p])
//   d_resp0k = d_fused * rfilt[k] * mask_k(p)    (K == 1: d_fused)
//   d_conv[p, c] = round(d_gated[p, c] * g(fused[p])
//                        + (sum_k d_resp0k * filt[c, k]) * scale)
//   d_filt[c, k] = scale * sum_p conv[p, c] * d_resp0k
//   d_rfilt[k]   = sum_p (scale * <conv[p], filt[:, k]>) * mask_k(p) * d_fused
// The response <conv[p], filt[:, k]> is recomputed in the same pass, as
// `_fdf_bwd` recomputes it.
//
// Layout: a 256-thread block owns a range of one expression's pixels. The
// block is split into groups of G = C / kElems threads; a group works on one
// pixel at a time, each thread on one 16-byte vector of its channels, so
// conv and d_gated are read once, with coalesced loads, and d_conv is
// written once. The per-pixel sums over C (the K responses and d_g) are a
// warp butterfly, then, when a group spans several warps, a fixed-order sum
// of the warps' results through double-buffered shared memory (one barrier
// per pixel step). Each thread keeps its channels' d_filt partial sums (K x
// kElems floats) in registers over the block's pixels; at the end the
// groups of a block are summed in group order in shared memory and the
// block writes one partial (C, K) tile to scratch. A second kernel sums the
// tiles of each expression in tile order: the result does not depend on
// block scheduling, and no atomics are used.
//
// What bounds it on an H100: bytes. At the training shape (16 x 40 x 64 x
// 1024 bf16, a map gathered from 2 images) it reads conv and d_gated (2 x
// 84 MB) and writes d_conv (84 MB), against ~1.3 GFLOP of f32 work, far
// below the card's f32 rate; the partial tiles add ~16 MB of traffic.

namespace {

template <typename T, int K, int G, bool kSigmoid>
__global__ void __launch_bounds__(kThreads)
fused_filter_bwd_kernel(const T* __restrict__ conv, long long conv_batch_stride,
                        const T* __restrict__ d_gated,
                        const float* __restrict__ filt,
                        const float* __restrict__ rfilt,
                        const float* __restrict__ fused,
                        const float* __restrict__ d_resp, int h, int w,
                        int pix_per_block, float scale,
                        T* __restrict__ d_conv, float* __restrict__ filt_part,
                        float* __restrict__ rfilt_part) {
  constexpr int kElems = Vec<T>::kElems;
  constexpr int kPairs = kElems / 2;
  constexpr int kC = G * kElems;
  constexpr int kGroups = kThreads / G;
  constexpr int kWarps = G / 32;           // warps per group
  constexpr int kR = K + 1;                // per-pixel sums: K responses, d_g
  static_assert(G % 32 == 0 && kThreads % G == 0, "group shape");
  // filter bank, float2 index ((k * kPairs + q) * G + j); reused at the end
  // for the block's (C, K) partial in filt's own layout
  __shared__ float2 sf[K * kC / 2];
  __shared__ float red[2][kGroups][kWarps][kR];
  __shared__ float rsum[kGroups][K];

  const int e = blockIdx.y;
  const int tile = blockIdx.x;
  const float* fe = filt + (size_t)e * kC * K;
  float* sff = reinterpret_cast<float*>(sf);
  for (int idx = threadIdx.x; idx < kC * K; idx += kThreads) {
    const int ch = idx / K;
    const int k = idx - ch * K;
    const int jj = ch / kElems;
    const int el = ch - jj * kElems;
    sff[((((k * kPairs + (el >> 1)) * G) + jj) << 1) + (el & 1)] = fe[idx];
  }
  float rf[K];
#pragma unroll
  for (int k = 0; k < K; ++k) rf[k] = (K == 7) ? rfilt[e * K + k] : 1.0f;
  __syncthreads();

  const int grp = threadIdx.x / G;
  const int j = threadIdx.x - grp * G;
  const int lane = threadIdx.x & 31;
  const int wg = j >> 5;
  const int npix = h * w;
  const int p0 = tile * pix_per_block;
  const int p1 = min(p0 + pix_per_block, npix);
  const T* ce = conv + (size_t)e * conv_batch_stride;
  const T* ge = d_gated + (size_t)e * npix * kC;
  T* de = d_conv + (size_t)e * npix * kC;
  const float* fz = fused + (size_t)e * npix;
  const float* dr = d_resp + (size_t)e * npix;

  float fp[K][kElems];                     // this thread's d_filt partials
  float rp[K];                             // d_rfilt partials (per group)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    rp[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < kElems; ++i) fp[k][i] = 0.0f;
  }

  const int steps = p1 > p0 ? (p1 - p0 + kGroups - 1) / kGroups : 0;
  for (int it = 0; it < steps; ++it) {
    const int p = p0 + it * kGroups + grp;
    const bool live = p < p1;
    uint4 vx = make_uint4(0, 0, 0, 0);
    uint4 vg = make_uint4(0, 0, 0, 0);
    if (live) {
      vx = reinterpret_cast<const uint4*>(ce + (size_t)p * kC)[j];
      vg = reinterpret_cast<const uint4*>(ge + (size_t)p * kC)[j];
    }
    float part[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) part[r] = 0.0f;
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const float2 x = Vec<T>::pair(vx, q);
      const float2 d = Vec<T>::pair(vg, q);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 f = sf[(k * kPairs + q) * G + j];
        part[k] = fmaf(x.x, f.x, part[k]);
        part[k] = fmaf(x.y, f.y, part[k]);
      }
      part[K] = fmaf(d.x, x.x, part[K]);
      part[K] = fmaf(d.y, x.y, part[K]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
      }
    }
    if constexpr (kWarps > 1) {
      const int buf = it & 1;
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kR; ++r) red[buf][grp][wg][r] = part[r];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        float s = 0.0f;
#pragma unroll
        for (int u = 0; u < kWarps; ++u) s += red[buf][grp][u][r];
        part[r] = s;
      }
    }
    if (!live) continue;

    const float fv = fz[p];
    const float g = kSigmoid ? 1.0f / (1.0f + expf(-fv)) : fv;
    const float gp = kSigmoid ? g * (1.0f - g) : 1.0f;
    const float dfu = dr[p] + part[K] * gp;
    float d0[K];
    if (K == 7) {
      const int y = p / w;
      const int x = p - y * w;
      const bool m[7] = {true,
                         y < h / 2,
                         y >= h / 2,
                         x < w / 2,
                         x >= w / 2,
                         y >= h / 4 && y < (h * 3) / 4,
                         x >= w / 4 && x < (w * 3) / 4};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        d0[k] = m[k] ? dfu * rf[k] : 0.0f;
        rp[k] = fmaf(m[k] ? part[k] * scale : 0.0f, dfu, rp[k]);
      }
    } else {
      d0[0] = dfu;
    }

    uint4 o;
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const float2 x = Vec<T>::pair(vx, q);
      const float2 d = Vec<T>::pair(vg, q);
      float s0 = 0.0f;
      float s1 = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 f = sf[(k * kPairs + q) * G + j];
        s0 = fmaf(d0[k], f.x, s0);
        s1 = fmaf(d0[k], f.y, s1);
        fp[k][2 * q] = fmaf(x.x, d0[k], fp[k][2 * q]);
        fp[k][2 * q + 1] = fmaf(x.y, d0[k], fp[k][2 * q + 1]);
      }
      Vec<T>::set_pair(o, q, d.x * g + s0 * scale, d.y * g + s1 * scale);
    }
    reinterpret_cast<uint4*>(de + (size_t)p * kC)[j] = o;
  }

  // block partial of d_filt, groups summed in group order, in filt's
  // (C, K) layout, over the filter bank's shared memory
  __syncthreads();
  for (int u = 0; u < kGroups; ++u) {
    if (grp == u) {
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float* slot = &sff[(j * kElems + i) * K + k];
          *slot = (u == 0) ? fp[k][i] : *slot + fp[k][i];
        }
      }
    }
    __syncthreads();
  }
  float* out = filt_part + ((size_t)e * gridDim.x + tile) * kC * K;
  for (int idx = threadIdx.x; idx < kC * K; idx += kThreads) {
    out[idx] = sff[idx];
  }
  if (j == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) rsum[grp][k] = rp[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
    for (int u = 0; u < kGroups; ++u) s += rsum[u][threadIdx.x];
    rfilt_part[((size_t)e * gridDim.x + tile) * K + threadIdx.x] = s;
  }
}

// d_filt[e, c, k] = scale * sum over tiles t (in order) of the partials;
// d_rfilt[e, k] = the same sum of the d_rfilt partials
__global__ void fused_filter_bwd_reduce(const float* __restrict__ filt_part,
                                        const float* __restrict__ rfilt_part,
                                        int e, int tiles, int ck, int k,
                                        float scale, float* __restrict__ d_filt,
                                        float* __restrict__ d_rfilt) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < e * ck) {
    const int ei = idx / ck;
    const int r = idx - ei * ck;
    const float* src = filt_part + (size_t)ei * tiles * ck + r;
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t) s += src[(size_t)t * ck];
    d_filt[idx] = s * scale;
  } else if (idx < e * ck + e * k) {
    const int i2 = idx - e * ck;
    const int ei = i2 / k;
    const int kk = i2 - ei * k;
    const float* src = rfilt_part + (size_t)ei * tiles * k + kk;
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t) s += src[(size_t)t * k];
    d_rfilt[i2] = s;
  }
}

template <typename T, int K, int G>
cudaError_t launch_gate_bwd(const void* conv, long long stride,
                            const void* d_gated, const float* filt,
                            const float* rfilt, const float* fused,
                            const float* d_resp, int e, int h, int w,
                            int sigmoid, float scale, int tiles,
                            float* filt_part, float* rfilt_part, void* d_conv,
                            float* d_filt, float* d_rfilt, cudaStream_t s) {
  const int npix = h * w;
  const int ppb = (npix + tiles - 1) / tiles;
  const dim3 grid(tiles, e);
  const T* c = static_cast<const T*>(conv);
  const T* dg = static_cast<const T*>(d_gated);
  T* dc = static_cast<T*>(d_conv);
  if (sigmoid) {
    fused_filter_bwd_kernel<T, K, G, true><<<grid, kThreads, 0, s>>>(
        c, stride, dg, filt, rfilt, fused, d_resp, h, w, ppb, scale, dc,
        filt_part, rfilt_part);
  } else {
    fused_filter_bwd_kernel<T, K, G, false><<<grid, kThreads, 0, s>>>(
        c, stride, dg, filt, rfilt, fused, d_resp, h, w, ppb, scale, dc,
        filt_part, rfilt_part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ck = G * Vec<T>::kElems * K;
  const int total = e * ck + e * K;
  fused_filter_bwd_reduce<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                            s>>>(filt_part, rfilt_part, e, tiles, ck, K, scale,
                                 d_filt, d_rfilt);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t dispatch_bwd_g(int g, const void* conv, long long stride,
                           const void* d_gated, const float* filt,
                           const float* rfilt, const float* fused,
                           const float* d_resp, int e, int h, int w,
                           int sigmoid, float scale, int tiles,
                           float* filt_part, float* rfilt_part, void* d_conv,
                           float* d_filt, float* d_rfilt, cudaStream_t s) {
#define L2S_GATE_BWD(GV)                                                    \
  return launch_gate_bwd<T, K, GV>(conv, stride, d_gated, filt, rfilt, fused, \
                                   d_resp, e, h, w, sigmoid, scale, tiles,   \
                                   filt_part, rfilt_part, d_conv, d_filt,    \
                                   d_rfilt, s)
  switch (g) {
    case 32: L2S_GATE_BWD(32);
    case 64: L2S_GATE_BWD(64);
    case 128: L2S_GATE_BWD(128);
    case 256:
      // f32 only: a bf16 map of 2048 channels would need 57 KB of filter
      // bank, beyond the 48 KB of static shared memory
      if constexpr (sizeof(T) == 4) {
        L2S_GATE_BWD(256);
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef L2S_GATE_BWD
}

}  // namespace

// Gradient of fused_filter_launch. conv as there (batch stride may be 0);
// d_gated and d_conv (e, h, w, c) contiguous maps of the same dtype, 16-byte
// aligned; fused and d_resp (e, h, w) f32; filt (e, c, k), rfilt (e, k) f32.
// tiles: pixel tiles per expression (grid x); filt_part (e, tiles, c, k) and
// rfilt_part (e, tiles, k) f32 scratch. Writes d_conv, d_filt (e, c, k) and
// d_rfilt (e, k) in full (d_rfilt is 0 for k == 1). Same c and k as the
// forward. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int fused_filter_bwd_launch(
    const void* conv, long long conv_batch_stride, const void* d_gated,
    const void* filt, const void* rfilt, const void* fused, const void* d_resp,
    int e, int h, int w, int c, int k, int is_bf16, int sigmoid, float scale,
    int tiles, void* filt_part, void* rfilt_part, void* d_conv, void* d_filt,
    void* d_rfilt, void* stream) {
  if (e <= 0 || h <= 0 || w <= 0 || tiles <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_vec = is_bf16 ? 8 : 4;
  if (c % (32 * per_vec) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int g = c / per_vec;
  const float* f = static_cast<const float*>(filt);
  const float* r = static_cast<const float*>(rfilt);
  const float* fz = static_cast<const float*>(fused);
  const float* dr = static_cast<const float*>(d_resp);
  float* fpart = static_cast<float*>(filt_part);
  float* rpart = static_cast<float*>(rfilt_part);
  float* df = static_cast<float*>(d_filt);
  float* drf = static_cast<float*>(d_rfilt);
  cudaError_t err;
  if (is_bf16) {
    err = (k == 7)
        ? dispatch_bwd_g<__nv_bfloat16, 7>(g, conv, conv_batch_stride, d_gated,
                                           f, r, fz, dr, e, h, w, sigmoid,
                                           scale, tiles, fpart, rpart, d_conv,
                                           df, drf, s)
        : (k == 1)
        ? dispatch_bwd_g<__nv_bfloat16, 1>(g, conv, conv_batch_stride, d_gated,
                                           f, r, fz, dr, e, h, w, sigmoid,
                                           scale, tiles, fpart, rpart, d_conv,
                                           df, drf, s)
        : cudaErrorInvalidValue;
  } else {
    err = (k == 7)
        ? dispatch_bwd_g<float, 7>(g, conv, conv_batch_stride, d_gated, f, r,
                                   fz, dr, e, h, w, sigmoid, scale, tiles,
                                   fpart, rpart, d_conv, df, drf, s)
        : (k == 1)
        ? dispatch_bwd_g<float, 1>(g, conv, conv_batch_stride, d_gated, f, r,
                                   fz, dr, e, h, w, sigmoid, scale, tiles,
                                   fpart, rpart, d_conv, df, drf, s)
        : cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
