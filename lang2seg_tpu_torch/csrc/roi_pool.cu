// ROI max pooling (POOLING_MODE 'pool') and its argmax backward for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces no Pallas kernel: the JAX package computes this op in plain
// XLA (lang2seg_tpu/ops/roi_align.py::roi_max_pool, `_roi_max_pool_fwd_impl`
// and `_roi_max_pool_bwd`, :149-211), where XLA fuses the masked maxima
// over whole rows and columns into the reduction. Run eagerly, that
// formulation builds an (R, P, H, W, C) tensor forward and an (R, P, P, H,
// W, C) one backward (about 150 GB and over 1 TB at the training shape),
// so on the card the op is this kernel. The reference itself shipped it as
// CUDA (roi_pooling_kernel.cu, forward with argmax and argmax backward).
//
// Semantics, as the JAX package's (and ops/roi_align.py's plain version):
//   corners round(roi * scale) half to even (rintf semantics, never C
//   round, which takes .5 away from zero: corners at 8, 24 or 40 px with
//   scale 1/16 land on .5); extent max(x2 - x1 + 1, 1); bin width
//   rw / pooled in f32; bin k covers [floor(k * bw), ceil((k + 1) * bw))
//   plus the corner, clipped to the map; an empty bin gives 0 and no
//   gradient. Each output's gradient goes to its bin's FIRST maximum in
//   row-major order (jnp.argmax over the flattened masked window): the scan
//   walks rows, then columns, and replaces the best only on a strictly
//   greater value. The file is built with -fmad=false and every product
//   and quotient is an explicit round-to-nearest intrinsic, so the bins are
//   the f32 reference's bit for bit.
//
// Design: one thread per (expression, ROI, bin row, bin column, channel
// pair); neighbouring threads take neighbouring channel pairs of the same
// window, so a warp reads 64 channels of a pixel in one coalesced load.
// The forward writes the maximum and, when the caller passes a buffer for
// it (a node that needs the map's gradient), an int32 argmax (y * W + x,
// -1 for an empty bin); serving passes none and writes the outputs alone.
// The backward scatters each output's gradient at its saved argmax into an
// f32 buffer with atomicAdd (a pixel that is the maximum of several bins
// sums them in no fixed order: within 1 bf16 ulp of the reference after
// the cast), then casts that buffer once to the map's dtype, as the
// reference's f32 `.at[].add` then `astype` does.
//
// What bounds it on an H100: bytes. The least the forward must move is the
// E maps read once, the ROIs read and the outputs written: at the serving
// shape (16 x 300 ROIs on (16, 40, 64, 512) bf16 gated maps) 42 MB in and
// 241 MB out. Training adds the argmax, 4 bytes an output, which the JAX
// formulation does not store (its backward recomputes it from the map).
// The compares (window pixels x channels) stay far below the card's rate.
// This first kernel keeps the simple one-thread-a-bin scan;
// tools/profile_roi_pool.py times it beside that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}

__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}

// the values are the map's own (a maximum, or 0): the conversion is exact
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// one bin's [start, end) rows and columns, in the reference's f32 order
__device__ __forceinline__ void bin_window(const float* roi, float scale,
                                           int pooled, int ph, int pw, int h,
                                           int w, int& hs, int& he, int& ws,
                                           int& we) {
  const int x1 = __float2int_rn(__fmul_rn(roi[0], scale));
  const int y1 = __float2int_rn(__fmul_rn(roi[1], scale));
  const int x2 = __float2int_rn(__fmul_rn(roi[2], scale));
  const int y2 = __float2int_rn(__fmul_rn(roi[3], scale));
  const float bw = __fdiv_rn(static_cast<float>(max(x2 - x1 + 1, 1)),
                             static_cast<float>(pooled));
  const float bh = __fdiv_rn(static_cast<float>(max(y2 - y1 + 1, 1)),
                             static_cast<float>(pooled));
  hs = static_cast<int>(floorf(__fmul_rn(static_cast<float>(ph), bh))) + y1;
  he = static_cast<int>(ceilf(__fmul_rn(static_cast<float>(ph + 1), bh))) + y1;
  ws = static_cast<int>(floorf(__fmul_rn(static_cast<float>(pw), bw))) + x1;
  we = static_cast<int>(ceilf(__fmul_rn(static_cast<float>(pw + 1), bw))) + x1;
  hs = min(max(hs, 0), h);
  he = min(max(he, 0), h);
  ws = min(max(ws, 0), w);
  we = min(max(we, 0), w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_pool_fwd_kernel(const T* __restrict__ feat, long long batch_stride,
                        int h, int w, int c, const float* __restrict__ rois,
                        int r, int pooled, float scale, long long total,
                        T* __restrict__ out, int* __restrict__ argmax) {
  const int pairs = c / 2;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int pair = static_cast<int>(i % pairs);
    long long t = i / pairs;
    const int pw = static_cast<int>(t % pooled);
    t /= pooled;
    const int ph = static_cast<int>(t % pooled);
    const long long er = t / pooled;            // expression * R + ROI
    const long long ei = er / r;
    int hs, he, ws, we;
    bin_window(rois + er * 4, scale, pooled, ph, pw, h, w, hs, he, ws, we);
    const long long o = 2 * i;                  // (E, R, P, P, C) offset
    if (he <= hs || we <= ws) {
      store2(out + o, 0.0f, 0.0f);
      if (argmax != nullptr) {
        argmax[o] = -1;
        argmax[o + 1] = -1;
      }
      continue;
    }
    const T* base = feat + ei * batch_stride + 2 * pair;
    float best0, best1;
    int arg0 = hs * w + ws;
    int arg1 = arg0;
    load2(base + static_cast<long long>(arg0) * c, best0, best1);
    for (int y = hs; y < he; ++y) {
      for (int x = (y == hs ? ws + 1 : ws); x < we; ++x) {
        const int pos = y * w + x;
        float v0, v1;
        load2(base + static_cast<long long>(pos) * c, v0, v1);
        if (v0 > best0) {
          best0 = v0;
          arg0 = pos;
        }
        if (v1 > best1) {
          best1 = v1;
          arg1 = pos;
        }
      }
    }
    store2(out + o, best0, best1);
    if (argmax != nullptr) {
      argmax[o] = arg0;
      argmax[o + 1] = arg1;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_pool_bwd_kernel(const T* __restrict__ grad,
                        const int* __restrict__ argmax, long long total,
                        long long per_expr, int c, long long hwc,
                        float* __restrict__ dfeat32) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int a = argmax[i];
    if (a < 0) continue;
    const long long ei = i / per_expr;
    const int ch = static_cast<int>(i % c);
    atomicAdd(dfeat32 + ei * hwc + static_cast<long long>(a) * c + ch,
              to_float(grad[i]));
  }
}

__global__ void __launch_bounds__(kThreads)
    cast_bf16_kernel(const float* __restrict__ src,
                     __nv_bfloat16* __restrict__ dst, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < (1LL << 30) ? blocks : (1LL << 30));
}

}  // namespace

// feat (E, H, W, C) with each expression's (H, W, C) map contiguous, the
// expression stride `batch_stride` elements (0 for a broadcast map); rois
// (E, R, 4) f32 contiguous; out (E, R, P, P, C) of feat's dtype and argmax
// (E, R, P, P, C) int32 or null (no argmax written), contiguous. C even,
// pointers aligned to a channel pair. Returns a cudaError_t.
extern "C" int roi_pool_fwd_launch(const void* feat, long long batch_stride,
                                   int e, int h, int w, int c, int is_bf16,
                                   const void* rois, int r, int pooled,
                                   float scale, void* out, void* argmax,
                                   void* stream) {
  if (c <= 0 || c % 2 || pooled <= 0 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total =
      static_cast<long long>(e) * r * pooled * pooled * (c / 2);
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rr = static_cast<const float*>(rois);
  int* am = static_cast<int*>(argmax);
  if (is_bf16) {
    roi_pool_fwd_kernel<__nv_bfloat16><<<grid_for(total), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feat), batch_stride, h, w, c, rr, r,
        pooled, scale, total, static_cast<__nv_bfloat16*>(out), am);
  } else {
    roi_pool_fwd_kernel<float><<<grid_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(feat), batch_stride, h, w, c, rr, r, pooled,
        scale, total, static_cast<float*>(out), am);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad and argmax (E, R, P, P, C) contiguous; dfeat32 (E, H, W, C) f32
// scratch, zeroed here; dfeat (E, H, W, C) of the map's dtype (for an f32
// map the same buffer as dfeat32). Returns a cudaError_t.
extern "C" int roi_pool_bwd_launch(const void* grad, const void* argmax,
                                   int e, int h, int w, int c, int is_bf16,
                                   int r, int pooled, void* dfeat32,
                                   void* dfeat, void* stream) {
  if (c <= 0 || pooled <= 0 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hwc = static_cast<long long>(h) * w * c;
  const long long n_feat = hwc * e;
  if (n_feat == 0) return 0;
  float* acc = static_cast<float*>(dfeat32);
  cudaError_t err = cudaMemsetAsync(acc, 0, n_feat * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_expr = static_cast<long long>(r) * pooled * pooled * c;
  const long long total = per_expr * e;
  const int* am = static_cast<const int*>(argmax);
  if (total > 0) {
    if (is_bf16) {
      roi_pool_bwd_kernel<__nv_bfloat16><<<grid_for(total), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(grad), am, total, per_expr, c,
          hwc, acc);
    } else {
      roi_pool_bwd_kernel<float><<<grid_for(total), kThreads, 0, s>>>(
          static_cast<const float*>(grad), am, total, per_expr, c, hwc, acc);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (is_bf16) {
    cast_bf16_kernel<<<grid_for(n_feat), kThreads, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(dfeat), n_feat);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
