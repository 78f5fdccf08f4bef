// ROI max pooling (POOLING_MODE 'pool') and its argmax backward for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces no Pallas kernel: the JAX package computes this op in plain
// XLA (lang2seg_tpu/ops/roi_align.py::roi_max_pool, `_roi_max_pool_fwd_impl`
// and `_roi_max_pool_bwd`, :149-211), where XLA fuses the masked maxima
// over whole rows and columns into the reduction. Run eagerly, that
// formulation builds an (R, P, H, W, C) tensor forward and an (R, P, P, H,
// W, C) one backward (about 150 GB and over 1 TB at the training shape),
// so on the card the op is these kernels. The reference itself shipped it
// as CUDA (roi_pooling_kernel.cu, forward with argmax and argmax backward).
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
// What bounds the op on an H100: bytes. The least it must move is each
// map pixel under some window read once, the ROIs read and the outputs
// written: at the training shape (16 x 256 ROIs on (16, 40, 64, 512) bf16
// maps) 42 MB in and 205 MB out. A first design (one thread a bin and
// channel pair, every window rescanned from global memory; an int32
// argmax; global f32 atomics into a scratch, then a cast pass) read each
// map pixel about 26 times from L2 and ran at 12% of that bound.
//
// Design, the route of every map up to 7006 pixels forward and 3375
// backward (`ops/roi_pool_cuda.py::slab_plan`; the 40 x 64 map of the
// 640 x 1024 canvas is 2560):
//   * forward (`roi_pool_fwd_smem_kernel`): a CTA for each (expression,
//     channel slab), a slab 32 bytes of a pixel (16 bf16 or 8 f32
//     channels, a whole sector); when those CTAs would leave SMs idle (a
//     request of one or a few expressions) an expression's ROIs are split
//     over several. The CTA finds the rectangle its ROIs cover, copies it
//     from its slab into shared memory once (cp.async, 16 B a copy) beside
//     the ROIs' corners and bin sizes, and reduces every (ROI, bin) from
//     there, a thread a (ROI, bin, 16-byte chunk), the bins of a ROI side
//     by side so that a warp's windows are alike in size. bf16 maps
//     compare two channels an instruction (set.gt.bf16x2 masks) and keep
//     the maxima as raw bits. Outputs go out as 16-byte chunks of
//     channels.
//   * a few ROIs an expression (the mask crops: at most 512 items) take
//     `roi_pool_fwd_band_kernel` where the slab CTAs, two an SM, would
//     take more than one wave of the card or less than half of one: a
//     thread an item, the rectangle staged in bands of whole rows through
//     48 KiB of shared memory, so that several small CTAs share an SM
//     (`ops/roi_pool_cuda.py::forward_kernel` gives the timed shapes).
//   * the argmax is a bin-local offset (y - hs) * (we - ws) + (x - ws) of
//     one byte (two for a map whose in-map bins exceed 255 pixels), stored
//     slab-major: (E, slabs, R, P, P, slab channels), so a backward CTA
//     reads its slab's codes as one contiguous run. A bin too large for
//     the code (only a ROI reaching far off the map makes one) stores the
//     largest code, which tells the backward to rescan that bin's window
//     in the map; an empty bin is recomputed from its ROI, its code unused.
//   * backward (`roi_pool_bwd_smem_kernel`): a CTA for each (expression,
//     channel slab, band of rows) adds each output's gradient at its
//     decoded argmax into an f32 slab in shared memory, then writes its
//     band of the map's gradient once, rounded once to the map's dtype. At
//     40 x 64 one band holds the whole map (160 KiB for a bf16 map's 16
//     channels); a larger map takes several bands, each adding the
//     argmaxes that land in it. Shared-memory f32 atomicAdd is a
//     compare-and-swap loop on this card (ATOMS.CAST.SPIN), as cheap as a
//     plain add when no two lanes of the instruction share a bank and
//     several times dearer when they do: the adds go out so that at most
//     two share one (see the kernel). A pixel that is the maximum of several
//     bins sums them in no fixed order: within 1 bf16 ulp of the
//     reference after the cast. Bins too large for their codes are
//     rescanned after the adds, each by the whole CTA.
//   * a map beyond the forward's single-CTA slab takes
//     `roi_pool_fwd_scan_kernel`, a thread a (expression, ROI, bin, channel
//     pair) scanning its window in global memory, with the same codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 1024;
constexpr int kPrefetch = 2;       // backward items a thread loads ahead
constexpr int kMagicTable = 256;   // bin widths whose magic(d) is tabled
constexpr int kScanThreads = 256;
constexpr int kSlabBytes = 32;   // a pixel of a slab in shared memory

template <typename T>
struct Chunk {                    // 16 bytes of a pixel's channels
  static constexpr int V = 16 / sizeof(T);
  static constexpr int CS = 2 * V;          // channels a slab
};

#ifdef ROI_POOL_PHASE_CLOCKS
// Built only into the measuring variant (tools/profile_roi_pool.py): for
// each CTA of the last forward [0] and backward [1] launch, thread 0's
// clock64() cycles of three phases (forward: the ROIs' rectangle, the
// slab's load, the reduction with its writes; backward: zeroing and the ROIs,
// the adds, the write of the band), the CTA's start and end on the
// globaltimer (ns), and the backward's cycles in its block-wide rescans.
constexpr int kClockCtas = 16384;
__device__ long long roi_pool_clocks[2][kClockCtas][6];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define RP_CLOCKS_BEGIN                                                   \
  const long long rp_ns0 = global_ns();                                   \
  long long rp_t = clock64();                                             \
  long long rp_ph[3] = {0, 0, 0};
#define RP_PHASE(k)                                                       \
  if (threadIdx.x == 0) {                                                 \
    const long long now = clock64();                                      \
    rp_ph[k] += now - rp_t;                                               \
    rp_t = now;                                                           \
  }
#define RP_CLOCKS_END(which, extra)                                       \
  if (threadIdx.x == 0) {                                                 \
    const int id = blockIdx.x + gridDim.x * (blockIdx.y +                 \
                                             gridDim.y * blockIdx.z);     \
    if (id < kClockCtas) {                                                \
      long long* o = roi_pool_clocks[which][id];                          \
      o[0] = rp_ph[0];                                                    \
      o[1] = rp_ph[1];                                                    \
      o[2] = rp_ph[2];                                                    \
      o[3] = rp_ns0;                                                      \
      o[4] = global_ns();                                                 \
      o[5] = (extra);                                                     \
    }                                                                     \
  }
#else
#define RP_CLOCKS_BEGIN
#define RP_PHASE(k)
#define RP_CLOCKS_END(which, extra)
#endif

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// a 16-byte chunk as floats, and back (rounding to nearest)
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

// n channels of global memory at p as floats: one 16-byte load when the
// chunk is whole and aligned, else channel by channel
template <typename T, int V>
__device__ __forceinline__ void load_chunk(const T* p, int n, bool vec,
                                           float (&f)[V]) {
  if (vec && n == V) {
    unpack(*reinterpret_cast<const uint4*>(p), f);
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = k < n ? to_float(p[k]) : 0.0f;
}

template <typename T, int V>
__device__ __forceinline__ void store_chunk(T* p, int n, bool vec,
                                            const float (&f)[V]) {
  if (vec && n == V) {
    *reinterpret_cast<uint4*>(p) = pack(f);
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k < n) from_float(f[k], p + k);
  }
}

// V codes, stored or loaded as one V * sizeof(Code)-byte word (4, 8 or 16)
template <int Bytes>
struct WordOf;
template <>
struct WordOf<4> {
  using type = unsigned;
};
template <>
struct WordOf<8> {
  using type = uint2;
};
template <>
struct WordOf<16> {
  using type = uint4;
};

template <typename Code, int V>
union CodeVec {
  typename WordOf<sizeof(Code) * V>::type word;
  Code c[V];
};

template <typename Code, int V>
__device__ __forceinline__ void store_codes(Code* p, const int (&a)[V]) {
  CodeVec<Code, V> v;
#pragma unroll
  for (int k = 0; k < V; ++k) v.c[k] = static_cast<Code>(a[k]);
  *reinterpret_cast<decltype(v.word)*>(p) = v.word;
}

template <typename Code>
__device__ __forceinline__ constexpr int sentinel() {
  return static_cast<int>(static_cast<Code>(~Code(0)));
}

// a ROI's rounded corner and f32 bin sizes, in the reference's order
struct RoiGeom {
  int x1, y1;
  float bw, bh;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* roi, float scale,
                                            int pooled) {
  RoiGeom g;
  g.x1 = __float2int_rn(__fmul_rn(roi[0], scale));
  g.y1 = __float2int_rn(__fmul_rn(roi[1], scale));
  const int x2 = __float2int_rn(__fmul_rn(roi[2], scale));
  const int y2 = __float2int_rn(__fmul_rn(roi[3], scale));
  g.bw = __fdiv_rn(static_cast<float>(max(x2 - g.x1 + 1, 1)),
                   static_cast<float>(pooled));
  g.bh = __fdiv_rn(static_cast<float>(max(y2 - g.y1 + 1, 1)),
                   static_cast<float>(pooled));
  return g;
}

// bin k's [s, e) along one axis, from the corner, clipped to [0, lim]
__device__ __forceinline__ void bin_edges(int k, float b, int origin, int lim,
                                          int& s, int& e) {
  s = static_cast<int>(floorf(__fmul_rn(static_cast<float>(k), b))) + origin;
  e = static_cast<int>(ceilf(__fmul_rn(static_cast<float>(k + 1), b))) +
      origin;
  s = min(max(s, 0), lim);
  e = min(max(e, 0), lim);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n / d as a product with a 32-bit reciprocal, m = magic(d): exact for
// n * d < 2^32
__device__ __forceinline__ unsigned magic(unsigned d) {
  return 0xffffffffu / d + 1u;
}
__device__ __forceinline__ unsigned div_by(unsigned n, unsigned d,
                                           unsigned m) {
  return d == 1 ? n : __umulhi(n, m);
}

// a chunk of T's raw bits: one 16-byte store when whole and aligned, else
// element by element
template <typename T>
__device__ __forceinline__ void store_raw(T* p, int n, bool vec, uint4 raw) {
  if (vec && n == Chunk<T>::V) {
    *reinterpret_cast<uint4*>(p) = raw;
    return;
  }
  union {
    uint4 v;
    T e[Chunk<T>::V];
  } u;
  u.v = raw;
#pragma unroll
  for (int k = 0; k < Chunk<T>::V; ++k) {
    if (k < n) p[k] = u.e[k];
  }
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// One bin's window [hs, he) x [ws, we) of a slab chunk in shared memory
// (`base` the chunk of pixel (hs, 0) of the band, `stride` uint4s a row, 2
// a pixel): the first maximum of each channel, its bin-local offset in
// `arg`. bf16 maps compare two channels at once (set.gt.bf16x2 masks, an
// ordered strict greater-than, as the f32 compare of the same values) and
// keep the maxima as raw bits; f32 maps compare one channel at a time.
template <typename T, bool kArg>
__device__ __forceinline__ uint4 scan_bin(const uint4* base, int stride,
                                          int rows, int ws, int we,
                                          int (&arg)[Chunk<T>::V]) {
  constexpr int V = Chunk<T>::V;
  const uint4 first = base[2 * ws];
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    unsigned best[4] = {first.x, first.y, first.z, first.w};
    unsigned at[4] = {0u, 0u, 0u, 0u};     // two 16-bit offsets a word
    unsigned off = 0;
    // the window's pixels in row-major order as one loop (the windows
    // are a few pixels wide: a loop a row costs more than the compares)
    const uint4* row = base;
    int x = ws;
#pragma unroll 2
    for (int q = 0; q < rows * (we - ws); ++q, off += 0x10001u) {
      const uint4 v4 = row[2 * x];
      if (++x == we) {
        x = ws;
        row += stride;
      }
      const unsigned v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned m = __hgt2_mask(as_bf162(v[i]), as_bf162(best[i]));
        best[i] = (v[i] & m) | (best[i] & ~m);
        if (kArg) at[i] = (off & m) | (at[i] & ~m);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      arg[2 * i] = static_cast<int>(at[i] & 0xffffu);
      arg[2 * i + 1] = static_cast<int>(at[i] >> 16);
    }
    return make_uint4(best[0], best[1], best[2], best[3]);
  } else {
    float best[V];
    unpack(first, best);
#pragma unroll
    for (int k = 0; k < V; ++k) arg[k] = 0;
    int off = 0;
    for (int y = 0; y < rows; ++y) {
      const uint4* row = base + y * stride;
      for (int x = ws; x < we; ++x, ++off) {
        float v[V];
        unpack(row[2 * x], v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (v[k] > best[k]) {
            best[k] = v[k];
            if (kArg) arg[k] = off;
          }
        }
      }
    }
    return pack(best);
  }
}

// A bin's scan carried across bands of rows (the few-ROI forward): the
// running maxima as raw bits and their offsets (two 16-bit offsets a word
// for bf16, one a word for f32), taken as scan_bin takes them; `off` is
// the bin-local offset of the first pixel of `rows`.
template <typename T, bool kArg>
__device__ __forceinline__ void scan_rows(uint4& best4, unsigned (&at)[4],
                                          bool& started, const uint4* base,
                                          int stride, int rows, int ws,
                                          int we, int off) {
  unsigned best[4] = {best4.x, best4.y, best4.z, best4.w};
  for (int y = 0; y < rows; ++y) {
    const uint4* row = base + y * stride;
    for (int x = ws; x < we; ++x, ++off) {
      const uint4 v4 = row[2 * x];
      const unsigned v[4] = {v4.x, v4.y, v4.z, v4.w};
      if (!started) {
#pragma unroll
        for (int i = 0; i < 4; ++i) best[i] = v[i];
        started = true;
      }
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const unsigned offp = static_cast<unsigned>(off) * 0x10001u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned m = __hgt2_mask(as_bf162(v[i]), as_bf162(best[i]));
          best[i] = (v[i] & m) | (best[i] & ~m);
          if (kArg) at[i] = (offp & m) | (at[i] & ~m);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (__uint_as_float(v[i]) > __uint_as_float(best[i])) {
            best[i] = v[i];
            if (kArg) at[i] = static_cast<unsigned>(off);
          }
        }
      }
    }
  }
  best4 = make_uint4(best[0], best[1], best[2], best[3]);
}

// ROIs whose corners and bin sizes a CTA keeps in shared memory at once
constexpr int kRoiBlock = 512;

// geo[i] = roi_geom of ROIs b0 + i, i < min(kRoiBlock, r - b0) (r the end
// of the CTA's ROIs)
__device__ __forceinline__ void cache_geoms(RoiGeom* geo, const float* er,
                                            int b0, int r, float scale,
                                            int pooled) {
  for (int i = threadIdx.x; i < min(kRoiBlock, r - b0); i += blockDim.x) {
    geo[i] = roi_geom(er + 4 * (b0 + i), scale, pooled);
  }
}

// grid (slabs, E, ROI groups of rchunk ROIs); dynamic shared memory h * w
// * 32 bytes (the slab) and kRoiBlock RoiGeoms
template <typename T, typename Code, bool kArg>
__global__ void __launch_bounds__(kFwdThreads, 2)
    roi_pool_fwd_smem_kernel(const T* __restrict__ feat,
                             long long batch_stride, int h, int w, int c,
                             const float* __restrict__ rois, int r,
                             int rchunk, int pooled, float scale, int vec,
                             T* __restrict__ out, Code* __restrict__ codes) {
  constexpr int V = Chunk<T>::V;
  constexpr int CS = Chunk<T>::CS;
  RP_CLOCKS_BEGIN
  extern __shared__ uint4 slab[];
  RoiGeom* geo = reinterpret_cast<RoiGeom*>(slab + 2 * h * w);
  __shared__ int s_y0, s_y1, s_x0, s_x1;
  const int s = blockIdx.x;
  const int ei = blockIdx.y;
  const int r0 = blockIdx.z * rchunk;
  const int r1 = min(r, r0 + rchunk);
  const int c0 = s * CS;
  const int nc = min(CS, c - c0);
  const float* er = rois + static_cast<long long>(ei) * r * 4;
  if (threadIdx.x == 0) {
    s_y0 = h;
    s_y1 = 0;
    s_x0 = w;
    s_x1 = 0;
  }
  __syncthreads();
  // the rectangle under some bin of this CTA's ROIs: a ROI's bins tile
  // [hs(0), he(P-1)) x [ws(0), we(P-1))
  for (int i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const RoiGeom g = roi_geom(er + 4 * i, scale, pooled);
    if (i - r0 < kRoiBlock) geo[i - r0] = g;
    int hs, he, ws, we, t;
    bin_edges(0, g.bh, g.y1, h, hs, t);
    bin_edges(pooled - 1, g.bh, g.y1, h, t, he);
    bin_edges(0, g.bw, g.x1, w, ws, t);
    bin_edges(pooled - 1, g.bw, g.x1, w, t, we);
    if (hs < he && ws < we) {
      atomicMin(&s_y0, hs);
      atomicMax(&s_y1, he);
      atomicMin(&s_x0, ws);
      atomicMax(&s_x1, we);
    }
  }
  __syncthreads();
  RP_PHASE(0)
  // the rectangle's pixels of the slab, row by row, bwid pixels a row
  const int lo = s_y0, x0 = s_x0;
  const int bwid = max(s_x1 - x0, 0);
  const int npix = max(s_y1 - lo, 0) * bwid;
  const T* src = feat + ei * batch_stride +
                 (static_cast<long long>(lo) * w + x0) * c + c0;
  if (vec && nc == CS) {
    for (int i = threadIdx.x; i < 2 * npix; i += blockDim.x) {
      const int p = i >> 1;
      const int yl = p / bwid;
      cp_async16(&slab[i], src + static_cast<long long>(yl * w + p -
                                                        yl * bwid) * c +
                               (i & 1) * V);
    }
  } else {
    // 4-byte words: a bf16 channel pair or one f32 channel
    constexpr int kPer = 4 / sizeof(T);
    const int words = nc / kPer;
    for (int i = threadIdx.x; i < words * npix; i += blockDim.x) {
      const int p = i / words;
      const int k = i - p * words;
      const int yl = p / bwid;
      cp_async4(reinterpret_cast<unsigned*>(slab + 2 * p) + k,
                src + static_cast<long long>(yl * w + p - yl * bwid) * c +
                    k * kPer);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  RP_PHASE(1)

  const int chunks = (nc + V - 1) / V;
  const int pp = pooled * pooled;
  const unsigned m_pp = magic(pp), m_p = magic(pooled);
  const bool vec_out = vec != 0;
  for (int b0 = r0; b0 < r1; b0 += kRoiBlock) {
    if (b0 > r0) {
      __syncthreads();
      cache_geoms(geo, er, b0, r1, scale, pooled);
      __syncthreads();
    }
    const int items = 2 * pp * min(kRoiBlock, r1 - b0);
    // an item: (ROI, bin, 16-byte chunk), the bins of a ROI side by side
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int j = it & 1;
      if (j >= chunks) continue;
      const unsigned bi = static_cast<unsigned>(it >> 1);
      const int rl = static_cast<int>(div_by(bi, pp, m_pp));
      const int bin = static_cast<int>(bi) - rl * pp;
      const int ph = static_cast<int>(div_by(bin, pooled, m_p));
      const int pw = bin - ph * pooled;
      const RoiGeom g = geo[rl];
      int hs, he, ws, we;
      bin_edges(ph, g.bh, g.y1, h, hs, he);
      bin_edges(pw, g.bw, g.x1, w, ws, we);
      int arg[V];
      uint4 best = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int k = 0; k < V; ++k) arg[k] = 0;
      if (he > hs && we > ws) {
        best = scan_bin<T, kArg>(slab + (hs - lo) * 2 * bwid + j, 2 * bwid,
                                 he - hs, ws - x0, we - x0, arg);
        if (kArg && (he - hs) * (we - ws) > sentinel<Code>()) {
#pragma unroll
          for (int k = 0; k < V; ++k) arg[k] = sentinel<Code>();
        }
      }
      const int roi = b0 + rl;
      const int cb = c0 + j * V;
      store_raw<T>(out + ((static_cast<long long>(ei) * r + roi) * pp + bin)
                             * c + cb,
                   min(V, c - cb), vec_out, best);
      if (kArg) {
        store_codes<Code, V>(codes + ((static_cast<long long>(ei) * gridDim.x
                                       + s) * r + roi) * pp * CS +
                                 bin * CS + j * V,
                             arg);
      }
    }
  }
#ifdef ROI_POOL_PHASE_CLOCKS
  __syncthreads();
#endif
  RP_PHASE(2)
  RP_CLOCKS_END(0, 0)
}

// The forward for an expression of a few ROIs (2 * P * P * R items at
// most kFwdThreads: the mask crops, a box an expression): grid (slabs, E),
// a thread an item (ROI, bin, 16-byte chunk), the ROIs' rectangle of the
// slab staged through shared memory in bands of band_px pixels (whole
// rows), each item's scan carried across the bands in row order. Small
// CTAs with little shared memory, so that many share an SM.
template <typename T, typename Code, bool kArg>
__global__ void __launch_bounds__(kFwdThreads)
    roi_pool_fwd_band_kernel(const T* __restrict__ feat,
                             long long batch_stride, int h, int w, int c,
                             const float* __restrict__ rois, int r,
                             int pooled, float scale, int vec, int band_px,
                             T* __restrict__ out, Code* __restrict__ codes) {
  constexpr int V = Chunk<T>::V;
  constexpr int CS = Chunk<T>::CS;
  extern __shared__ uint4 slab[];
  const int s = blockIdx.x;
  const int ei = blockIdx.y;
  const int c0 = s * CS;
  const int nc = min(CS, c - c0);
  const int chunks = (nc + V - 1) / V;
  const float* er = rois + static_cast<long long>(ei) * r * 4;
  // the ROIs' rectangle, worked out by every thread
  int lo = h, hi = 0, x0 = w, x1 = 0;
  for (int i = 0; i < r; ++i) {
    const RoiGeom g = roi_geom(er + 4 * i, scale, pooled);
    int hs, he, ws, we, t;
    bin_edges(0, g.bh, g.y1, h, hs, t);
    bin_edges(pooled - 1, g.bh, g.y1, h, t, he);
    bin_edges(0, g.bw, g.x1, w, ws, t);
    bin_edges(pooled - 1, g.bw, g.x1, w, t, we);
    if (hs < he && ws < we) {
      lo = min(lo, hs);
      hi = max(hi, he);
      x0 = min(x0, ws);
      x1 = max(x1, we);
    }
  }
  const int bwid = max(x1 - x0, 0);
  const int band_rows = bwid > 0 ? max(1, band_px / bwid) : 1;
  // this thread's item
  const int pp = pooled * pooled;
  const int it = threadIdx.x;
  const int j = it & 1;
  const int roi = (it >> 1) / pp;
  const int bin = (it >> 1) - roi * pp;
  const bool active = it < 2 * pp * r && j < chunks;
  int hs = 0, he = 0, ws = 0, we = 0;
  if (active) {
    const RoiGeom g = roi_geom(er + 4 * roi, scale, pooled);
    const int ph = bin / pooled;
    bin_edges(ph, g.bh, g.y1, h, hs, he);
    bin_edges(bin - ph * pooled, g.bw, g.x1, w, ws, we);
  }
  const bool live = active && he > hs && we > ws;
  uint4 best = make_uint4(0u, 0u, 0u, 0u);
  unsigned at[4] = {0u, 0u, 0u, 0u};
  bool started = false;
  const T* src = feat + ei * batch_stride + c0;
  for (int y0 = lo; y0 < hi; y0 += band_rows) {
    const int yb = min(hi, y0 + band_rows);
    const int npix = (yb - y0) * bwid;
    __syncthreads();                    // the previous band is read
    if (vec && nc == CS) {
      for (int i = threadIdx.x; i < 2 * npix; i += blockDim.x) {
        const int p = i >> 1;
        const int yl = p / bwid;
        cp_async16(&slab[i],
                   src + (static_cast<long long>(y0 + yl) * w + x0 + p -
                          yl * bwid) * c + (i & 1) * V);
      }
    } else {
      constexpr int kPer = 4 / sizeof(T);
      const int words = nc / kPer;
      for (int i = threadIdx.x; i < words * npix; i += blockDim.x) {
        const int p = i / words;
        const int k = i - p * words;
        const int yl = p / bwid;
        cp_async4(reinterpret_cast<unsigned*>(slab + 2 * p) + k,
                  src + (static_cast<long long>(y0 + yl) * w + x0 + p -
                         yl * bwid) * c + k * kPer);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const int ya = max(hs, y0), yz = min(he, yb);
    if (live && ya < yz) {
      scan_rows<T, kArg>(best, at, started,
                         slab + (ya - y0) * 2 * bwid + j, 2 * bwid, yz - ya,
                         ws - x0, we - x0, (ya - hs) * (we - ws));
    }
  }
  if (!active) return;
  int arg[V];
  if constexpr (V == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      arg[2 * i] = static_cast<int>(at[i] & 0xffffu);
      arg[2 * i + 1] = static_cast<int>(at[i] >> 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) arg[i] = static_cast<int>(at[i]);
  }
  if (live && (he - hs) * (we - ws) > sentinel<Code>()) {
#pragma unroll
    for (int k = 0; k < V; ++k) arg[k] = sentinel<Code>();
  }
  const int cb = c0 + j * V;
  store_raw<T>(out + ((static_cast<long long>(ei) * r + roi) * pp + bin) * c +
                   cb,
               min(V, c - cb), vec != 0, best);
  if (kArg) {
    store_codes<Code, V>(codes + ((static_cast<long long>(ei) * gridDim.x +
                                   s) * r + roi) * pp * CS + bin * CS + j * V,
                         arg);
  }
}

// the large-map route: a thread a (expression, ROI, bin, channel pair)
// scanning its window in global memory
template <typename T, typename Code, bool kArg>
__global__ void __launch_bounds__(kScanThreads)
    roi_pool_fwd_scan_kernel(const T* __restrict__ feat,
                             long long batch_stride, int h, int w, int c,
                             const float* __restrict__ rois, int r,
                             int pooled, float scale, int slabs,
                             long long total, T* __restrict__ out,
                             Code* __restrict__ codes) {
  constexpr int CS = Chunk<T>::CS;
  const int pairs = c / 2;
  const int pp = pooled * pooled;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int pair = static_cast<int>(i % pairs);
    long long t = i / pairs;
    const int bin = static_cast<int>(t % pp);
    const long long er = t / pp;                // expression * R + ROI
    const long long ei = er / r;
    const int roi = static_cast<int>(er - ei * r);
    const int ph = bin / pooled;
    const int pw = bin - ph * pooled;
    const RoiGeom g = roi_geom(rois + er * 4, scale, pooled);
    int hs, he, ws, we;
    bin_edges(ph, g.bh, g.y1, h, hs, he);
    bin_edges(pw, g.bw, g.x1, w, ws, we);
    const int ch = 2 * pair;
    float best0 = 0.0f, best1 = 0.0f;
    int arg0 = 0, arg1 = 0;
    if (he > hs && we > ws) {
      const T* base = feat + ei * batch_stride + ch;
      best0 = to_float(base[static_cast<long long>(hs * w + ws) * c]);
      best1 = to_float(base[static_cast<long long>(hs * w + ws) * c + 1]);
      int off = 0;
      for (int y = hs; y < he; ++y) {
        for (int x = ws; x < we; ++x, ++off) {
          const T* p = base + static_cast<long long>(y * w + x) * c;
          const float v0 = to_float(p[0]);
          const float v1 = to_float(p[1]);
          if (v0 > best0) {
            best0 = v0;
            arg0 = off;
          }
          if (v1 > best1) {
            best1 = v1;
            arg1 = off;
          }
        }
      }
      if (off > sentinel<Code>()) arg0 = arg1 = sentinel<Code>();
    }
    T* o = out + er * pp * c + static_cast<long long>(bin) * c + ch;
    from_float(best0, o);
    from_float(best1, o + 1);
    if (kArg) {
      Code* cd = codes + ((ei * slabs + ch / CS) * r + roi) * pp * CS +
                 bin * CS + ch % CS;
      cd[0] = static_cast<Code>(arg0);
      cd[1] = static_cast<Code>(arg1);
    }
  }
}

// merge two (value, offset) candidates of a first maximum: the greater,
// then the earlier; INT_MAX marks no candidate
__device__ __forceinline__ void merge_max(float& bv, int& ba, float ov,
                                          int oa) {
  if (oa != INT_MAX && (ba == INT_MAX || ov > bv || (ov == bv && oa < ba))) {
    bv = ov;
    ba = oa;
  }
}

// The first maximum in row-major order of each of n channels of a window
// [hs, he) x [ws, we) of the map in global memory (`base` at channel 0 of
// pixel (0, 0), `c` channels a pixel), found by the whole CTA: each thread
// scans every blockDim-th pixel in order, taking its first value that is
// not NaN and then only strictly greater ones; the threads' results are
// merged (warps by shuffles, then warp 0 over `red`, 2 * 32 * V words) by
// value, then by the earlier offset, and a NaN first pixel, which the
// sequential scan never replaces, wins outright. Thread k < n of warp 0
// gets channel k's y * W + x. The backward's rescan of a bin too large for
// its code.
template <typename T, int V>
__device__ int block_rescan(const T* base, int w, int c, int n, bool vec,
                            int hs, int he, int ws, int we, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bw = we - ws;
  const int npx = (he - hs) * bw;
  float best[V];
  int at[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    best[k] = 0.0f;
    at[k] = INT_MAX;
  }
  for (int q = threadIdx.x; q < npx; q += blockDim.x) {
    const int y = hs + q / bw;
    const int x = ws + q % bw;
    float v[V];
    load_chunk<T, V>(base + static_cast<long long>(y * w + x) * c, n, vec,
                     v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (at[k] == INT_MAX ? v[k] == v[k] : v[k] > best[k]) {
        best[k] = v[k];
        at[k] = q;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    for (int d = 16; d > 0; d >>= 1) {
      merge_max(best[k], at[k], __shfl_xor_sync(0xffffffffu, best[k], d),
                __shfl_xor_sync(0xffffffffu, at[k], d));
    }
  }
  int* red_at = reinterpret_cast<int*>(red + 32 * V);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[warp * V + k] = best[k];
      red_at[warp * V + k] = at[k];
    }
  }
  __syncthreads();
  int pos = -1;
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float bv = lane < warps ? red[lane * V + k] : 0.0f;
      int ba = lane < warps ? red_at[lane * V + k] : INT_MAX;
      for (int d = 16; d > 0; d >>= 1) {
        merge_max(bv, ba, __shfl_xor_sync(0xffffffffu, bv, d),
                  __shfl_xor_sync(0xffffffffu, ba, d));
      }
      if (lane == k) {
        const float v0 =
            to_float(base[static_cast<long long>(hs * w + ws) * c + k]);
        const int q = v0 != v0 || ba == INT_MAX ? 0 : ba;
        pos = (hs + q / bw) * w + ws + q % bw;
      }
    }
  }
  __syncthreads();
  return pos;
}

// a[i] = a[(i + rot) % N] for N = 4 or 8: a barrel shift by fixed steps,
// so that the array stays in registers
template <typename U, int N>
__device__ __forceinline__ void rotate(U (&a)[N], int rot) {
#pragma unroll
  for (int step = 1; step < N; step <<= 1) {
    if (rot & step) {
      U b[N];
#pragma unroll
      for (int i = 0; i < N; ++i) b[i] = a[(i + step) % N];
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] = b[i];
    }
  }
}

// grid (slabs, E, bands); dynamic shared memory band_rows * w * CS f32
// and kRoiBlock RoiGeoms. A thread takes items (ROI, bin, 16-byte chunk),
// kPrefetch at a time (all their loads in flight before the adds).
// Shared-memory f32 atomicAdd is a compare-and-swap loop on this card,
// cheap only when few lanes of an instruction share a bank: with CS words
// a pixel, a word's bank is its channel, plus CS times the pixel's index
// modulo 32 / CS. So the adds go out channel by channel, each thread's
// channel order rotated by its bin's place among V bins: for a bf16 map
// an instruction's 32 adds fall on at most two words a bank (the bins 8
// apart, when their pixels' parities agree; two conflict-free passes of
// 16 lanes measured 10% slower). Bins too large for their codes are
// rescanned afterwards,
// each by the whole CTA (`block_rescan`): listed as they are met, or,
// when more than a list holds, found again in order.
template <typename T, typename Code>
__global__ void __launch_bounds__(kBwdThreads, 1)
    roi_pool_bwd_smem_kernel(const T* __restrict__ grad,
                             const Code* __restrict__ codes,
                             const T* __restrict__ feat,
                             long long batch_stride, int h, int w, int c,
                             const float* __restrict__ rois, int r,
                             int pooled, float scale, int band_rows, int vec,
                             T* __restrict__ dfeat) {
  constexpr int V = Chunk<T>::V;
  constexpr int CS = Chunk<T>::CS;
  RP_CLOCKS_BEGIN
  extern __shared__ float acc[];
  RoiGeom* geo = reinterpret_cast<RoiGeom*>(acc + band_rows * w * CS);
  // the items to rescan (ROI block-local item index) and their count, the
  // ordered rounds' counts by warp, the rescan's reduction scratch
  __shared__ int deferred[kBwdThreads];
  __shared__ int n_deferred;
  __shared__ int warp_count[kBwdThreads / 32 + 1];
  __shared__ float red[2 * 32 * V];
  // magic(d) of the bin widths d < kMagicTable, worked out once
  __shared__ unsigned magic_tab[kMagicTable];
  for (int d = threadIdx.x; d < kMagicTable; d += blockDim.x) {
    magic_tab[d] = d > 1 ? magic(d) : 0u;
  }
  if (threadIdx.x == 0) n_deferred = 0;
#ifdef ROI_POOL_PHASE_CLOCKS
  long long rp_rescan = 0;
#endif
  const int s = blockIdx.x;
  const int ei = blockIdx.y;
  const int lo = blockIdx.z * band_rows;
  const int hi = min(h, lo + band_rows);
  const int c0 = s * CS;
  const int nc = min(CS, c - c0);
  const int chunks = (nc + V - 1) / V;
  const int lane = threadIdx.x & 31;
  const int rot = (lane >> 1) & (V - 1);
  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (int i = threadIdx.x; i < (hi - lo) * w * CS / 4; i += blockDim.x) {
    acc4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float* er = rois + static_cast<long long>(ei) * r * 4;
  const T* map = feat + ei * batch_stride;
  const int pp = pooled * pooled;
  const unsigned m_pp = magic(pp), m_p = magic(pooled);
  const bool vec_in = vec != 0;
  const Code* ecodes =
      codes + (static_cast<long long>(ei) * gridDim.x + s) * r * pp * CS;
  const T* egrad = grad + static_cast<long long>(ei) * r * pp * c;
  for (int b0 = 0; b0 < r; b0 += kRoiBlock) {
    __syncthreads();
    cache_geoms(geo, er, b0, r, scale, pooled);
    __syncthreads();
    RP_PHASE(b0 == 0 ? 0 : 1)
    const int items = 2 * pp * min(kRoiBlock, r - b0);
    // kPrefetch items a round, all their loads in flight before the adds
    for (int it0 = threadIdx.x; it0 < items; it0 += kPrefetch * blockDim.x) {
      using CodeWord = typename WordOf<sizeof(Code) * V>::type;
      uint4 graw[kPrefetch];
      CodeWord craw[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int it = it0 + u * blockDim.x;
        const int j = it & 1;
        const int bin = b0 * pp + (it >> 1);
        graw[u] = make_uint4(0u, 0u, 0u, 0u);
        craw[u] = {};
        if (it < items && j < chunks) {
          const int cb = c0 + j * V;
          if (vec_in && cb + V <= c) {
            graw[u] = *reinterpret_cast<const uint4*>(
                egrad + static_cast<long long>(bin) * c + cb);
          } else {
            union {
              uint4 v;
              T e[V];
            } g;
            g.v = make_uint4(0u, 0u, 0u, 0u);
            for (int kk = 0; kk < min(V, c - cb); ++kk) {
              g.e[kk] = egrad[static_cast<long long>(bin) * c + cb + kk];
            }
            graw[u] = g.v;
          }
          craw[u] = *reinterpret_cast<const CodeWord*>(
              ecodes + static_cast<long long>(bin) * CS + j * V);
        }
      }
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int it = it0 + u * blockDim.x;
        const int j = it & 1;
        const unsigned bi = static_cast<unsigned>(it >> 1);
        const int rl = static_cast<int>(div_by(bi, pp, m_pp));
        const int k = static_cast<int>(bi) - rl * pp;
        int hs = 0, he = 0, ws = 0, we = 0;
        if (it < items && j < chunks) {
          const int ph = static_cast<int>(div_by(k, pooled, m_p));
          const RoiGeom g = geo[rl];
          bin_edges(ph, g.bh, g.y1, h, hs, he);
          bin_edges(k - ph * pooled, g.bw, g.x1, w, ws, we);
        }
        const bool live = he > hs && we > ws && he > lo && hs < hi;
        CodeVec<Code, V> cv;
        cv.word = craw[u];
        // the forward marks every channel of a bin too large for its code
        const bool redo = live && cv.c[0] == sentinel<Code>();
        const int cb = c0 + j * V;
        const int n = min(V, c - cb);
        float gv[V];
        unpack(graw[u], gv);
        int dst[V];
#pragma unroll
        for (int kk = 0; kk < V; ++kk) dst[kk] = -1;
        if (live && !redo) {
          const unsigned bw = static_cast<unsigned>(we - ws);
          const unsigned mb = bw < kMagicTable ? magic_tab[bw] : magic(bw);
#pragma unroll
          for (int kk = 0; kk < V; ++kk) {
            const unsigned off = static_cast<unsigned>(cv.c[kk]);
            const unsigned q = div_by(off, bw, mb);
            const int y = hs + static_cast<int>(q);
            const int x = ws + static_cast<int>(off - q * bw);
            if (kk < n && y >= lo && y < hi) {
              dst[kk] = ((y - lo) * w + x) * CS + cb - c0 + kk;
            }
          }
          rotate(dst, rot);
          rotate(gv, rot);
        }
#pragma unroll
        for (int kk = 0; kk < V; ++kk) {
          if (dst[kk] >= 0) atomicAdd(&acc[dst[kk]], gv[kk]);
        }
        if (redo) {
          const int slot = atomicAdd(&n_deferred, 1);
          if (slot < kBwdThreads) deferred[slot] = it;
        }
      }
    }
    // the bins too large for their codes, each rescanned by the whole CTA:
    // those listed above, or, when the list overflowed, every item again
    // in rounds of blockDim, in order
    __syncthreads();
#ifdef ROI_POOL_PHASE_CLOCKS
    const long long rp_r0 = clock64();
#endif
    const int listed = n_deferred;
    const bool again = listed > kBwdThreads;
    for (int base = 0; listed > 0 && base < (again ? items : 1);
         base += blockDim.x) {
      if (again) {
        const int it = base + threadIdx.x;
        const int j = it & 1;
        const unsigned bi = static_cast<unsigned>(it >> 1);
        const int rl = static_cast<int>(div_by(bi, pp, m_pp));
        const int k = static_cast<int>(bi) - rl * pp;
        bool redo = false;
        if (it < items && j < chunks) {
          const int ph = static_cast<int>(div_by(k, pooled, m_p));
          const RoiGeom g = geo[rl];
          int hs, he, ws, we;
          bin_edges(ph, g.bh, g.y1, h, hs, he);
          bin_edges(k - ph * pooled, g.bw, g.x1, w, ws, we);
          const long long bin = static_cast<long long>(b0 + rl) * pp + k;
          redo = he > hs && we > ws && he > lo && hs < hi &&
                 static_cast<int>(ecodes[bin * CS + j * V]) ==
                     sentinel<Code>();
        }
        // compact the round's items in order: a warp's, then the warps'
        const unsigned mask = __ballot_sync(0xffffffffu, redo);
        if (lane == 0) warp_count[threadIdx.x >> 5] = __popc(mask);
        __syncthreads();
        if (threadIdx.x == 0) {
          int total = 0;
          for (int q = 0; q < (blockDim.x >> 5); ++q) {
            const int n_q = warp_count[q];
            warp_count[q] = total;
            total += n_q;
          }
          warp_count[blockDim.x >> 5] = total;
        }
        __syncthreads();
        if (redo) {
          deferred[warp_count[threadIdx.x >> 5] +
                   __popc(mask & ((1u << lane) - 1))] = it;
        }
        __syncthreads();
      }
      const int n_round = again ? warp_count[blockDim.x >> 5] : listed;
      for (int t = 0; t < n_round; ++t) {
        const int item = deferred[t];
        const int jj = item & 1;
        const unsigned bb = static_cast<unsigned>(item >> 1);
        const int rr = static_cast<int>(div_by(bb, pp, m_pp));
        const int kk = static_cast<int>(bb) - rr * pp;
        const int ph = static_cast<int>(div_by(kk, pooled, m_p));
        const RoiGeom g = geo[rr];
        int hs, he, ws, we;
        bin_edges(ph, g.bh, g.y1, h, hs, he);
        bin_edges(kk - ph * pooled, g.bw, g.x1, w, ws, we);
        const int cb = c0 + jj * V;
        const int nn = min(V, c - cb);
        const int pos = block_rescan<T, V>(map + cb, w, c, nn, vec_in, hs,
                                           he, ws, we, red);
        // thread k of warp 0 holds channel k's argmax; no other add is in
        // flight
        if (threadIdx.x < nn && pos / w >= lo && pos / w < hi) {
          const long long bin = static_cast<long long>(b0 + rr) * pp + kk;
          acc[(pos - lo * w) * CS + cb - c0 + threadIdx.x] +=
              to_float(egrad[bin * c + cb + threadIdx.x]);
        }
        __syncthreads();
      }
    }
#ifdef ROI_POOL_PHASE_CLOCKS
    rp_rescan += clock64() - rp_r0;
#endif
    __syncthreads();
    if (threadIdx.x == 0) n_deferred = 0;
  }
  __syncthreads();
  RP_PHASE(1)

  // the band of the map's gradient, every pixel written once
  T* dst = dfeat + static_cast<long long>(ei) * h * w * c +
           static_cast<long long>(lo) * w * c;
  for (int i = threadIdx.x; i < 2 * (hi - lo) * w; i += blockDim.x) {
    const int jj = i & 1;
    if (jj >= chunks) continue;
    const int p = i >> 1;
    const int cb = c0 + jj * V;
    float f[V];
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = acc[p * CS + jj * V + k];
    store_chunk<T, V>(dst + static_cast<long long>(p) * c + cb,
                      min(V, c - cb), vec_in, f);
  }
#ifdef ROI_POOL_PHASE_CLOCKS
  __syncthreads();
#endif
  RP_PHASE(2)
  RP_CLOCKS_END(1, rp_rescan)
}

unsigned grid_for(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return static_cast<unsigned>(blocks < (1LL << 30) ? blocks : (1LL << 30));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr size_t kGeomBytes = kRoiBlock * sizeof(RoiGeom);

template <typename T, typename Code, bool kArg>
cudaError_t fwd(const void* feat, long long batch_stride, int e, int h, int w,
                int c, const float* rois, int r, int pooled, float scale,
                int route, int groups, void* out, void* codes,
                cudaStream_t s) {
  const int slabs = (c + Chunk<T>::CS - 1) / Chunk<T>::CS;
  const T* f = static_cast<const T*>(feat);
  T* o = static_cast<T*>(out);
  Code* cd = static_cast<Code*>(codes);
  if (route == 2) {
    // groups carries the band's pixels
    const size_t smem = static_cast<size_t>(groups) * kSlabBytes;
    auto kernel = roi_pool_fwd_band_kernel<T, Code, kArg>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int vec = (c * sizeof(T)) % 16 == 0 &&
                    (batch_stride * sizeof(T)) % 16 == 0 &&
                    aligned16(feat) && aligned16(out);
    const int threads = (2 * pooled * pooled * r + 31) / 32 * 32;
    if (threads > kFwdThreads) return cudaErrorInvalidValue;
    kernel<<<dim3(slabs, e), threads, smem, s>>>(
        f, batch_stride, h, w, c, rois, r, pooled, scale, vec, groups, o,
        cd);
  } else if (route == 0) {
    const size_t smem = static_cast<size_t>(h) * w * kSlabBytes + kGeomBytes;
    auto kernel = roi_pool_fwd_smem_kernel<T, Code, kArg>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int vec = (c * sizeof(T)) % 16 == 0 &&
                    (batch_stride * sizeof(T)) % 16 == 0 &&
                    aligned16(feat) && aligned16(out);
    const int rchunk = (r + groups - 1) / groups;
    kernel<<<dim3(slabs, e, (r + rchunk - 1) / rchunk), kFwdThreads, smem,
             s>>>(f, batch_stride, h, w, c, rois, r, rchunk, pooled, scale,
                  vec, o, cd);
  } else {
    const long long total =
        static_cast<long long>(e) * r * pooled * pooled * (c / 2);
    roi_pool_fwd_scan_kernel<T, Code, kArg>
        <<<grid_for(total, kScanThreads), kScanThreads, 0, s>>>(
            f, batch_stride, h, w, c, rois, r, pooled, scale, slabs, total, o,
            cd);
  }
  return cudaGetLastError();
}

template <typename T, typename Code>
cudaError_t bwd(const void* grad, const void* codes, const void* feat,
                long long batch_stride, int e, int h, int w, int c,
                const float* rois, int r, int pooled, float scale,
                int band_rows, void* dfeat, cudaStream_t s) {
  constexpr int CS = Chunk<T>::CS;
  const int slabs = (c + CS - 1) / CS;
  const int bands = (h + band_rows - 1) / band_rows;
  const size_t smem =
      static_cast<size_t>(band_rows) * w * CS * sizeof(float) + kGeomBytes;
  auto kernel = roi_pool_bwd_smem_kernel<T, Code>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec = (c * sizeof(T)) % 16 == 0 &&
                  (batch_stride * sizeof(T)) % 16 == 0 && aligned16(grad) &&
                  aligned16(dfeat) && aligned16(feat);
  kernel<<<dim3(slabs, e, bands), kBwdThreads, smem, s>>>(
      static_cast<const T*>(grad), static_cast<const Code*>(codes),
      static_cast<const T*>(feat), batch_stride, h, w, c, rois, r, pooled,
      scale, band_rows, vec, static_cast<T*>(dfeat));
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_codes(int code_bytes, const void* feat, long long bs, int e,
                      int h, int w, int c, const float* rois, int r,
                      int pooled, float scale, int route, int groups,
                      void* out, void* codes, cudaStream_t s) {
  switch (code_bytes) {
    case 0:
      return fwd<T, uint8_t, false>(feat, bs, e, h, w, c, rois, r, pooled,
                                    scale, route, groups, out, nullptr, s);
    case 1:
      return fwd<T, uint8_t, true>(feat, bs, e, h, w, c, rois, r, pooled,
                                   scale, route, groups, out, codes, s);
    case 2:
      return fwd<T, uint16_t, true>(feat, bs, e, h, w, c, rois, r, pooled,
                                    scale, route, groups, out, codes, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// feat (E, H, W, C) with each expression's (H, W, C) map contiguous, the
// expression stride `batch_stride` elements (0 for a broadcast map); rois
// (E, R, 4) f32 contiguous; out (E, R, P, P, C) of feat's dtype; codes
// (E, slabs, R, P, P, CS) of `code_bytes` (1 or 2; 0: no argmax, codes
// may be null), CS = 32 bytes of channels, contiguous. `route` 0 takes the
// shared-memory kernel (h * w * 32 bytes and 8 KiB of ROIs of dynamic
// shared memory; an expression's ROIs split over `groups` CTAs of each
// slab), 2 the few-ROI kernel (bands of `groups` pixels, whole rows, of
// shared memory; 2 * P * P * R <= 512), 1 the global scan. C even,
// pointers aligned to a channel pair. Returns a cudaError_t.
extern "C" int roi_pool_fwd_launch(const void* feat, long long batch_stride,
                                   int e, int h, int w, int c, int is_bf16,
                                   const void* rois, int r, int pooled,
                                   float scale, int route, int groups,
                                   void* out, void* codes, int code_bytes,
                                   void* stream) {
  if (c <= 0 || c % 2 || pooled <= 0 || h <= 0 || w <= 0 || code_bytes < 0 ||
      code_bytes > 2 || route < 0 || route > 2 || groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(e) * r == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rr = static_cast<const float*>(rois);
  const cudaError_t err =
      is_bf16 ? fwd_codes<__nv_bfloat16>(code_bytes, feat, batch_stride, e, h,
                                         w, c, rr, r, pooled, scale, route,
                                         groups, out, codes, s)
              : fwd_codes<float>(code_bytes, feat, batch_stride, e, h, w, c,
                                 rr, r, pooled, scale, route, groups, out,
                                 codes, s);
  return static_cast<int>(err);
}

// grad (E, R, P, P, C) of the map's dtype and codes as the forward wrote
// them, contiguous; feat and rois as the forward took them (the map is
// read only to rescan a bin too large for its code); band_rows rows of the
// map a CTA (band_rows * w * CS * 4 bytes and 8 KiB of ROIs of dynamic
// shared memory); dfeat (E, H, W, C) of the map's dtype, contiguous,
// every element written. Returns a cudaError_t.
extern "C" int roi_pool_bwd_launch(const void* grad, const void* codes,
                                   int code_bytes, const void* feat,
                                   long long batch_stride, int e, int h,
                                   int w, int c, int is_bf16,
                                   const void* rois, int r, int pooled,
                                   float scale, int band_rows, void* dfeat,
                                   void* stream) {
  if (c <= 0 || c % 2 || pooled <= 0 || h <= 0 || w <= 0 || band_rows <= 0 ||
      (code_bytes != 1 && code_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rr = static_cast<const float*>(rois);
  cudaError_t err;
  if (is_bf16) {
    err = code_bytes == 1
              ? bwd<__nv_bfloat16, uint8_t>(grad, codes, feat, batch_stride,
                                            e, h, w, c, rr, r, pooled, scale,
                                            band_rows, dfeat, s)
              : bwd<__nv_bfloat16, uint16_t>(grad, codes, feat, batch_stride,
                                             e, h, w, c, rr, r, pooled, scale,
                                             band_rows, dfeat, s);
  } else {
    err = code_bytes == 1
              ? bwd<float, uint8_t>(grad, codes, feat, batch_stride, e, h, w,
                                    c, rr, r, pooled, scale, band_rows, dfeat,
                                    s)
              : bwd<float, uint16_t>(grad, codes, feat, batch_stride, e, h, w,
                                     c, rr, r, pooled, scale, band_rows,
                                     dfeat, s);
  }
  return static_cast<int>(err);
}

#ifdef ROI_POOL_PHASE_CLOCKS
// out[n][6]: the clocks of the first n CTAs of the last forward (which 0)
// or backward (1) launch. Returns a cudaError_t.
extern "C" int roi_pool_phase_clocks(long long* out, int which, int n) {
  if (which < 0 || which > 1 || n < 0 || n > kClockCtas) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, roi_pool_clocks, static_cast<size_t>(n) * 6 * sizeof(long long),
      static_cast<size_t>(which) * kClockCtas * 6 * sizeof(long long)));
}
#endif
