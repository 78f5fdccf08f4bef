// The frozen BatchNorm of every ResNet bottleneck (and of MobileNetV1's
// blocks), with the residual and the ReLU that follow it, in one pass;
// and its backward. For Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no Pallas kernel: the JAX package leaves BatchNorm, residual
// and ReLU to XLA, which fuses them into the convolution's epilogue on a
// TPU. Eager PyTorch does not: `FrozenBatchNorm.forward` rebuilt its
// (inv, offset) from the four f32 buffers (seven small launches) and then
// made two passes, x * inv and + offset, each in TensorIterator's
// non-vectorised kernel (a (C, 1, 1) operand broadcast over a
// channels_last tensor); the residual add and the ReLU were two more.
//
// Semantics, as that composition computes them (bit for bit, bf16 and
// f32), with r() rounding to the activation's dtype T:
//   inv = r(w / sqrt(var + eps)), off = r(b - mean * inv)  (each op in f32,
//     rounded as torch rounds it: IEEE, no FMA)
//   y = r(r(x * inv) + off)
//   mode 1 (residual): y = r(y + res)
//   mode 2 (downsample): y = r(y + r(r(x_d * inv_d) + off_d))
//   out = y != y ? y : fmaxf(y, 0)  (torch's clamp_min(y, 0))
// Backward, from the saved output: gz = out <= 0 ? 0 : g (threshold_
// backward), gx = r(gz * inv); mode 1 gives gz as the residual's
// gradient, mode 2 gx_d = r(gz * inv_d). Every product and sum is an
// explicit round-to-nearest intrinsic, and the file is built with
// -fmad=false besides.
//
// What bounds it on an H100: bytes. The forward reads x (and the residual
// or x_d) and writes out once: at layer4's serving shape (4,800 crops of
// 7 x 7, C = 2048, bf16) a 963 MB map, so 2.89 GB with a residual (0.86
// ms at 3.35 TB/s) and 3.85 GB with the downsample branch (1.15 ms). The
// backward reads g and out and writes one or two gradients: 3 or 4 maps.
//
// Design. Activations are NCHW tensors in channels_last memory: (P
// pixels, C channels), channels innermost. A thread owns one 16-byte
// channel vector (8 bf16 or 4 f32 channels) for the whole launch: it
// computes that vector's (inv, off) once, keeps them packed in registers,
// and walks pixels with a grid stride. A CTA is `rows` pixels x `cv`
// vectors (rows = 256 / cv, at least 1), so that a warp reads and writes
// 512 contiguous bytes; the grid is as many CTAs as the card holds at
// once (occupancy x SMs), or fewer for a small map. Two pixels a trip are
// loaded before either is computed, to keep more bytes in flight. Loads
// and stores are streaming (`__ldcs` / `__stcs`): each byte is touched
// once. No shared memory, no barrier, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kMaxThreads = 512;   // a CTA: rows x cv threads
constexpr int kTarget = 256;       // threads a CTA where cv allows
constexpr int kUnroll = 2;         // pixels loaded before computing
// elements of T a 16-byte vector
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// a frozen BatchNorm: its four f32 buffers (C) and eps
struct Bn {
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
  float eps;
};

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

// torch's clamp_min(v, 0): NaN passes, else fmaxf
__device__ __forceinline__ float relu(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

// (inv, off) of channel vector v, rounded to T and packed
template <typename T>
__device__ __forceinline__ void affine(const Bn& bn, int v, uint4* inv,
                                       uint4* off) {
  constexpr int L = kVec<T>;
  float i[L], o[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int c = v * L + k;
    const float s = __fsqrt_rn(__fadd_rn(bn.var[c], bn.eps));
    i[k] = __fdiv_rn(bn.weight[c], s);
    o[k] = __fsub_rn(bn.bias[c], __fmul_rn(bn.mean[c], i[k]));
  }
  *inv = pack(i);
  *off = pack(o);
}

// r(r(x * inv) + off), element by element, in place
template <typename T>
__device__ __forceinline__ void apply_affine(float (&x)[kVec<T>], uint4 inv,
                                             uint4 off) {
  constexpr int L = kVec<T>;
  float i[L], o[L];
  unpack(inv, i);
  unpack(off, o);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    x[k] = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x[k], i[k])), o[k]));
  }
}

// x, other (mode 1: the residual; mode 2: x_d) and out: (pixels, cv)
// 16-byte vectors. A CTA of rows x cv threads; thread (row, v) walks
// pixels row, row + rows x grid, ... of vector v.
template <typename T, int kMode>
__global__ void __launch_bounds__(kMaxThreads)
    bn_act_fwd_kernel(const uint4* __restrict__ x, Bn bn,
                      const uint4* __restrict__ other, Bn bn_d,
                      long long pixels, int cv, int rows,
                      uint4* __restrict__ out) {
  constexpr int L = kVec<T>;
  const int v = threadIdx.x % cv;
  uint4 inv, off, inv_d, off_d;
  affine<T>(bn, v, &inv, &off);
  if (kMode == 2) affine<T>(bn_d, v, &inv_d, &off_d);
  const long long step = static_cast<long long>(gridDim.x) * rows;
  for (long long p = static_cast<long long>(blockIdx.x) * rows +
                     threadIdx.x / cv;
       p < pixels; p += kUnroll * step) {
    uint4 xr[kUnroll], orr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u * step;
      if (q < pixels) {
        xr[u] = __ldcs(x + q * cv + v);
        if (kMode != 0) orr[u] = __ldcs(other + q * cv + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u * step;
      if (q >= pixels) break;
      float y[L];
      unpack(xr[u], y);
      apply_affine<T>(y, inv, off);
      if (kMode != 0) {
        float o[L];
        unpack(orr[u], o);
        if (kMode == 2) apply_affine<T>(o, inv_d, off_d);
#pragma unroll
        for (int k = 0; k < L; ++k) y[k] = round_to<T>(__fadd_rn(y[k], o[k]));
      }
#pragma unroll
      for (int k = 0; k < L; ++k) y[k] = relu(y[k]);
      __stcs(out + q * cv + v, pack(y));
    }
  }
}

// g, out: (pixels, cv) vectors; gx (may be null) r(gz * inv); g2 (may be
// null): mode 1 gz, mode 2 r(gz * inv_d); mode 0 has none.
template <typename T, int kMode>
__global__ void __launch_bounds__(kMaxThreads)
    bn_act_bwd_kernel(const uint4* __restrict__ g,
                      const uint4* __restrict__ out, Bn bn, Bn bn_d,
                      long long pixels, int cv, int rows,
                      uint4* __restrict__ gx, uint4* __restrict__ g2) {
  constexpr int L = kVec<T>;
  const int v = threadIdx.x % cv;
  uint4 inv, off, inv_d, off_d;
  if (gx) affine<T>(bn, v, &inv, &off);
  if (kMode == 2 && g2) affine<T>(bn_d, v, &inv_d, &off_d);
  const long long step = static_cast<long long>(gridDim.x) * rows;
  for (long long p = static_cast<long long>(blockIdx.x) * rows +
                     threadIdx.x / cv;
       p < pixels; p += kUnroll * step) {
    uint4 gr[kUnroll], outr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u * step;
      if (q < pixels) {
        gr[u] = __ldcs(g + q * cv + v);
        outr[u] = __ldcs(out + q * cv + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u * step;
      if (q >= pixels) break;
      float gz[L], o[L];
      unpack(gr[u], gz);
      unpack(outr[u], o);
#pragma unroll
      for (int k = 0; k < L; ++k) gz[k] = o[k] <= 0.0f ? 0.0f : gz[k];
      const long long i = q * cv + v;
      if (gx) {
        float a[L], d[L];
        unpack(inv, a);
#pragma unroll
        for (int k = 0; k < L; ++k) d[k] = __fmul_rn(gz[k], a[k]);
        __stcs(gx + i, pack(d));
      }
      if (kMode == 1 && g2) __stcs(g2 + i, pack(gz));
      if (kMode == 2 && g2) {
        float a[L], d[L];
        unpack(inv_d, a);
#pragma unroll
        for (int k = 0; k < L; ++k) d[k] = __fmul_rn(gz[k], a[k]);
        __stcs(g2 + i, pack(d));
      }
    }
  }
}

// CTAs of `threads` threads of `kernel` the card holds at once, cached
// by (device, kernel, threads)
int resident_ctas(const void* kernel, int threads) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int> cache;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const auto key = std::make_tuple(dev, kernel, threads);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess) {
    return 0;
  }
  return cache[key] = sms * per_sm;
}

// the CTA shape and grid of a map of `pixels` x `cv` vectors
bool plan(const void* kernel, long long pixels, int cv, int* rows,
          unsigned* grid) {
  if (cv <= 0 || cv > kMaxThreads || pixels < 0) return false;
  *rows = cv >= kTarget ? 1 : kTarget / cv;
  const int ctas = resident_ctas(kernel, *rows * cv);
  if (ctas <= 0) return false;
  const long long need = (pixels + *rows - 1) / *rows;
  *grid = static_cast<unsigned>(need < ctas ? need : ctas);
  return true;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int kMode>
cudaError_t fwd(const void* x, Bn bn, const void* other, Bn bn_d,
                long long pixels, int c, void* out, cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(bn_act_fwd_kernel<T, kMode>);
  const int cv = c / kVec<T>;
  int rows = 0;
  unsigned grid = 0;
  if (!plan(kernel, pixels, cv, &rows, &grid)) return cudaErrorInvalidValue;
  if (grid == 0) return cudaSuccess;
  bn_act_fwd_kernel<T, kMode><<<grid, rows * cv, 0, stream>>>(
      static_cast<const uint4*>(x), bn, static_cast<const uint4*>(other),
      bn_d, pixels, cv, rows, static_cast<uint4*>(out));
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t bwd(const void* g, const void* out, Bn bn, Bn bn_d,
                long long pixels, int c, void* gx, void* g2,
                cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(bn_act_bwd_kernel<T, kMode>);
  const int cv = c / kVec<T>;
  int rows = 0;
  unsigned grid = 0;
  if (!plan(kernel, pixels, cv, &rows, &grid)) return cudaErrorInvalidValue;
  if (grid == 0) return cudaSuccess;
  bn_act_bwd_kernel<T, kMode><<<grid, rows * cv, 0, stream>>>(
      static_cast<const uint4*>(g), static_cast<const uint4*>(out), bn, bn_d,
      pixels, cv, rows, static_cast<uint4*>(gx), static_cast<uint4*>(g2));
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_mode(int mode, const void* x, Bn bn, const void* other,
                     Bn bn_d, long long pixels, int c, void* out,
                     cudaStream_t st) {
  switch (mode) {
    case 0: return fwd<T, 0>(x, bn, other, bn_d, pixels, c, out, st);
    case 1: return fwd<T, 1>(x, bn, other, bn_d, pixels, c, out, st);
    case 2: return fwd<T, 2>(x, bn, other, bn_d, pixels, c, out, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_mode(int mode, const void* g, const void* out, Bn bn,
                     Bn bn_d, long long pixels, int c, void* gx, void* g2,
                     cudaStream_t st) {
  switch (mode) {
    case 0: return bwd<T, 0>(g, out, bn, bn_d, pixels, c, gx, g2, st);
    case 1: return bwd<T, 1>(g, out, bn, bn_d, pixels, c, gx, g2, st);
    case 2: return bwd<T, 2>(g, out, bn, bn_d, pixels, c, gx, g2, st);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(int c, int is_bf16, long long pixels) {
  return c > 0 && c % (is_bf16 ? 8 : 4) == 0 && pixels >= 0;
}

}  // namespace

// x, other and out: (pixels, C) of f32 or bf16 (is_bf16), channels
// innermost, contiguous and 16-byte aligned; C a multiple of a 16-byte
// vector's elements, at most 512 vectors. mode 0: out = relu(bn(x));
// mode 1: relu(bn(x) + other); mode 2: relu(bn(x) + bn_d(other)). w, b,
// mean, var (and their _d): the BatchNorms' f32 buffers (C). Every
// element of out is written. Launches on `stream`, allocates nothing.
// Returns a cudaError_t.
extern "C" int bn_act_fwd_launch(
    const void* x, const float* w, const float* b, const float* mean,
    const float* var, float eps, const void* other, const float* w_d,
    const float* b_d, const float* mean_d, const float* var_d, float eps_d,
    long long pixels, int c, int is_bf16, int mode, void* out, void* stream) {
  if (!valid(c, is_bf16, pixels) || !aligned16(x) || !aligned16(out) ||
      (mode != 0 && !aligned16(other))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Bn bn{w, b, mean, var, eps};
  const Bn bn_d{w_d, b_d, mean_d, var_d, eps_d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? fwd_mode<__nv_bfloat16>(mode, x, bn, other, bn_d, pixels, c,
                                        out, st)
              : fwd_mode<float>(mode, x, bn, other, bn_d, pixels, c, out, st);
  return static_cast<int>(err);
}

// g, out (the forward's output) and the gradients: (pixels, C) as above.
// gx (null: not computed) the gradient of x; g2 (null: not computed) of
// the residual (mode 1) or of x_d (mode 2). Returns a cudaError_t.
extern "C" int bn_act_bwd_launch(
    const void* g, const void* out, const float* w, const float* b,
    const float* mean, const float* var, float eps, const float* w_d,
    const float* b_d, const float* mean_d, const float* var_d, float eps_d,
    long long pixels, int c, int is_bf16, int mode, void* gx, void* g2,
    void* stream) {
  if (!valid(c, is_bf16, pixels) || !aligned16(g) || !aligned16(out) ||
      !aligned16(gx) || !aligned16(g2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Bn bn{w, b, mean, var, eps};
  const Bn bn_d{w_d, b_d, mean_d, var_d, eps_d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? bwd_mode<__nv_bfloat16>(mode, g, out, bn, bn_d, pixels, c, gx,
                                        g2, st)
              : bwd_mode<float>(mode, g, out, bn, bn_d, pixels, c, gx, g2,
                                st);
  return static_cast<int>(err);
}
