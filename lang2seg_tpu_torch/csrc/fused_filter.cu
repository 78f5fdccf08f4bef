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
