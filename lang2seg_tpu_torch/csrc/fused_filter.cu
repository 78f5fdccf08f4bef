// Fused language-conditioned gate and its gradient for Hopper (sm_90a),
// plain C interface for ctypes.
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
// What bounds it on an H100. The work is bytes: at the flagship shape (16
// x 40 x 64 x 1024 bf16, K = 7) it writes 84 MB of gated map and reads the
// map (5.2 MB through a stride-0 map when serving, 84 MB gathered when
// training) against 0.63 GFLOP of f32 work, 9.4 us at the card's f32 rate:
// bounds of 26.8 and 50.3 us. An eval dispatch of N images x S
// expressions reads each image's map in place (`exprs_per_map` S:
// expression e reads map e / S; one integer divide a block), N maps
// rather than N x S gathered copies. The earlier kernel (one warp a
// pixel, the expression's filter bank in shared memory, one 256-thread
// block a map row) reached a third of that: measured by phase
// (tools/profile_gate.py), its contraction re-read the whole 28 KB bank
// from shared memory for every pixel (112 8-byte reads a thread; 76% of a
// pixel step when serving), each 64-pixel block rebuilt the bank before
// its first pixel
// (10,500 cycles a block, as long as 1.5 of its 8 pixel steps), and a
// warp's next pixel was loaded only after its stores.
//
// Design. Persistent blocks: two 256-thread blocks an SM, each walking a
// fixed run of pixel tiles of one expression (`tile_plan` in
// ops/fused_filter.py), in one wave; the filter bank is read once a block
// and never re-read from shared memory per pixel; each tile is copied into
// a 3-stage shared-memory ring with cp.async, so the next tiles are in
// flight while one is computed. bf16 maps (the main path) take
// fused_filter_mma_kernel below: the contraction on the tensor cores, the
// bank in registers as mma fragments. f32 maps take fused_filter_kernel:
// each thread owns one 16-byte vector of the pixel (4 channels) and holds
// their K filter values in registers; it copies only its own channels, so
// no barrier guards the ring. Its per-pixel sums over C are summed 32 at a
// time (4 pixels x 8 slots) by a reduce-scatter over the warp's lanes (31
// shuffles for 32 sums), then across the warps of a pixel through shared
// memory in a fixed order: one block barrier a tile. The lane that holds
// a pixel's response k applies mask k and rfilt[k]; eight lanes sum the
// fuse, apply the gate and hand g to the epilogue, which multiplies the
// thread's channels, rounds once and stores them. That kernel spends more
// issue slots on the reduce-scatter than on the products (measured with
// bf16 maps: 0.055 ms at the serving shape, against 0.044 ms with the
// tensor cores), which is why bf16 maps take the other one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;           // blocks an SM (fused_filter_tiling)

#ifdef FUSED_FILTER_PHASE_CLOCKS
// Built only into the measuring variant (tools/profile_gate.py): clock64()
// cycles of each phase, as thread 0 of block (0, 0) sees them: [0] the
// forward, [1] the backward; phases: set-up, wait on loads, contraction,
// cross-warp sum, epilogue; then the steps (tiles) walked.
constexpr int kPhases = 5;
__device__ long long gate_phase_clocks[2][kPhases + 2];
#define CLOCKS_BEGIN                                                     \
  const bool clocked =                                                   \
      blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;            \
  long long clk[kPhases] = {};                                           \
  long long stamp = clock64();
#define PHASE(k)                                                         \
  if (clocked) {                                                         \
    const long long now = clock64();                                     \
    clk[k] += now - stamp;                                               \
    stamp = now;                                                         \
  }
#define CLOCKS_END(which, steps)                                         \
  if (clocked) {                                                         \
    for (int q = 0; q < kPhases; ++q) gate_phase_clocks[which][q] = clk[q]; \
    gate_phase_clocks[which][kPhases] = (steps);                         \
  }
#else
#define CLOCKS_BEGIN
#define PHASE(k)
#define CLOCKS_END(which, steps)
#endif

// N channels of a pixel, 8 or 16 bytes: N = 4 or 8 of bf16, 4 of f32
template <typename T, int N>
struct Chunk;

template <int N>
struct Chunk<__nv_bfloat16, N> {
  static_assert(N == 4 || N == 8, "bf16 chunk");
  static __device__ __forceinline__ void load(const void* p, float (&x)[N]) {
    unsigned u[N / 2];
    if constexpr (N == 4) {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      u[0] = r.x;
      u[1] = r.y;
    } else {
      const uint4 r = *reinterpret_cast<const uint4*>(p);
      u[0] = r.x;
      u[1] = r.y;
      u[2] = r.z;
      u[3] = r.w;
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(void* p, const float (&y)[N]) {
    unsigned u[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&b);
    }
    if constexpr (N == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
};

template <>
struct Chunk<float, 4> {
  static __device__ __forceinline__ void load(const void* p, float (&x)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    x[0] = r.x;
    x[1] = r.y;
    x[2] = r.z;
    x[3] = r.w;
  }
  static __device__ __forceinline__ void store(void* p, const float (&y)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  }
};

// Copies kBytes from global to shared memory without registers; with
// `live` false it writes zeros and reads nothing (src must still be a
// valid address).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = live ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One step of reduce_scatter32: lanes with bit O set keep v[O..2O) and
// send v[0..O), the others the reverse; v[i] then stands for index i + (O
// if the bit is set) of the values before the step.
template <int O>
__device__ __forceinline__ void scatter_step(float (&v)[32], int lane) {
  const bool hi = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = hi ? v[i] : v[i + O];
    const float keep = hi ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// v[i] summed over the warp's 32 lanes, for each i < 32; lane l gets the
// sum of index l. Five butterfly steps, each keeping half of the values
// and sending the other half: 31 shuffles in all, in a fixed order.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  return v[0];
}

// mask r (0..6) at pixel p of an (h, w) map, as spatial_masks_7
__device__ __forceinline__ bool region(int r, int p, int h, int w) {
  const int y = p / w;
  const int x = p - y * w;
  switch (r) {
    case 0: return true;
    case 1: return y < h / 2;
    case 2: return y >= h / 2;
    case 3: return x < w / 2;
    case 4: return x >= w / 2;
    case 5: return y >= h / 4 && y < (h * 3) / 4;
    default: return x >= w / 4 && x < (w * 3) / 4;
  }
}

// The tiling of a map of C = G * KCh channels of T, with kTensors maps
// staged per tile (1 forward: conv; 2 backward: conv and d_gated), in a
// ring of kStages tiles. Threads form kGroups groups of G, each thread KCh
// channels; a group owns one pixel's C channels at a time. A tile is KP
// pixels a group; its sums are taken 4 pixels (32 slots: 8 a pixel) at a
// time, kQ times.
template <typename T, int G, int KCh, int KP, int kTensors, int kStages_>
struct Tiling {
  static constexpr int kCh = KCh;
  static constexpr int kP = KP;
  static constexpr int kStages = kStages_;
  static constexpr int kC = G * kCh;
  static constexpr int kGroups = kThreads / G;
  static constexpr int kWarps = G / 32;            // warps a group
  static constexpr int kQ = kP / 4;
  static constexpr int kTilePix = kGroups * kP;
  static constexpr int kMapBytes = kTilePix * kC * sizeof(T);
  static constexpr int kStageBytes = kTensors * kMapBytes;
  static constexpr int kRedFloats = 2 * kGroups * kWarps * 32 * kQ;
  static constexpr int kFinFloats = (kThreads / 32) * 32 * kQ;
  static constexpr size_t kSmemBytes =
      (size_t)kStages * kStageBytes + (kRedFloats + kFinFloats) * 4;
  static_assert(G % 32 == 0 && kThreads % G == 0 && kP % 4 == 0, "tiling");
};

// The f32 forward: a 16-byte vector a thread (4 channels), 8 pixels a
// group: tiles of 32 KB of map, 3 in the ring. The backward: 4
// channels a thread (its d_filt sums, 4 x K, stay in registers), 16 KB of
// each map a tile, 3 in the ring. fused_filter_tiling reports their
// pixels a tile.
template <int G>
using FwdTiling = Tiling<float, G, 4, 8, 1, 3>;
template <typename T, int G>
using BwdTiling = Tiling<T, G, 4, 16 / sizeof(T), 2, 3>;

// Copies the kP pixels of group `grp` of tile `tile`, this thread's
// channels only, into `dst` (the tile's rows of one map).
template <typename T, typename L>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const T* map,
                                           int tile, int grp, int j,
                                           int npix) {
#pragma unroll
  for (int i = 0; i < L::kP; ++i) {
    const int row = grp * L::kP + i;
    const int p = tile * L::kTilePix + row;
    const bool live = p < npix;
    cp_async<L::kCh * static_cast<int>(sizeof(T))>(
        dst + ((size_t)row * L::kC + L::kCh * j) * sizeof(T),
        map + (live ? (size_t)p * L::kC + L::kCh * j : 0), live);
  }
}

// The forward on the CUDA cores, for f32 maps (bf16 maps take
// fused_filter_mma_kernel). Grid (blocks per expression, e); block b walks
// tiles [b * tiles_per_block, ...) of its expression.
template <int K, int G, bool kSigmoid>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_filter_kernel(const float* __restrict__ conv,
                    long long conv_batch_stride, int exprs_per_map,
                    const float* __restrict__ filt,
                    const float* __restrict__ rfilt, int h, int w,
                    int tiles_per_block, float scale,
                    float* __restrict__ gated, float* __restrict__ resp) {
  using T = float;
  using L = FwdTiling<G>;
  constexpr int kCh = L::kCh;
  CLOCKS_BEGIN
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + L::kStages * L::kStageBytes);
  float* fin = red + L::kRedFloats + (threadIdx.x >> 5) * 32 * L::kQ;

  const int e = blockIdx.y;
  const int t = threadIdx.x;
  const int grp = t / G;
  const int j = t - grp * G;
  const int lane = t & 31;
  const int wg = j >> 5;
  const int npix = h * w;
  const int ntiles = (npix + L::kTilePix - 1) / L::kTilePix;
  const int t0 = min((int)blockIdx.x * tiles_per_block, ntiles);
  const int n = min(t0 + tiles_per_block, ntiles) - t0;
  const T* ce = conv + (size_t)(e / exprs_per_map) * conv_batch_stride;
  T* ge = gated + (size_t)e * npix * L::kC;

  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n) stage_rows<T, L>(smem + s * L::kStageBytes, ce, t0 + s, grp,
                                j, npix);
    cp_async_commit();
  }
  float f[kCh][K];                         // this thread's filters
  const float* fe = filt + ((size_t)e * L::kC + kCh * j) * K;
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) f[c][k] = fe[c * K + k];
  }
  // after the reduce-scatter, lane (sp, r) holds slot r of pixel sp of
  // each 4 pixels: response r for r < K
  const int sp = lane >> 3;
  const int r = lane & 7;
  const float rf = r < K ? (K == 7 ? rfilt[e * K + r] : 1.0f) : 0.0f;
  PHASE(0)

  for (int it = 0; it < n; ++it) {
    const int tile = t0 + it;
    if (it + L::kStages - 1 < n) {
      stage_rows<T, L>(smem + ((it + L::kStages - 1) % L::kStages) *
                                  L::kStageBytes,
                       ce, tile + L::kStages - 1, grp, j, npix);
    }
    cp_async_commit();
    cp_async_wait<L::kStages - 1>();
    PHASE(1)
    const unsigned char* rows = smem + (it % L::kStages) * L::kStageBytes +
                                ((size_t)grp * L::kP * L::kC + kCh * j) *
                                    sizeof(T);

    float sum[L::kQ];
#pragma unroll
    for (int q = 0; q < L::kQ; ++q) {
      float v[32];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float x[kCh];
        Chunk<T, kCh>::load(rows + (size_t)(q * 4 + u) * L::kC * sizeof(T), x);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float a = 0.0f;
          if (k < K) {
#pragma unroll
            for (int c = 0; c < kCh; ++c) a = fmaf(x[c], f[c][k], a);
          }
          v[u * 8 + k] = a;
        }
      }
      sum[q] = reduce_scatter32(v, lane);
    }
    PHASE(2)
    if constexpr (L::kWarps > 1) {
      float* rb = red + ((it & 1) * L::kGroups + grp) * L::kWarps * 32 * L::kQ;
#pragma unroll
      for (int q = 0; q < L::kQ; ++q) rb[(wg * L::kQ + q) * 32 + lane] = sum[q];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < L::kQ; ++q) {
        float s = rb[q * 32 + lane];
#pragma unroll
        for (int u = 1; u < L::kWarps; ++u) s += rb[(u * L::kQ + q) * 32 + lane];
        sum[q] = s;
      }
    }
#pragma unroll
    for (int q = 0; q < L::kQ; ++q) {
      const int p = tile * L::kTilePix + grp * L::kP + q * 4 + sp;
      float fz = (r < K && region(r, p, h, w)) ? sum[q] * scale * rf : 0.0f;
      fz += __shfl_xor_sync(0xffffffffu, fz, 1);
      fz += __shfl_xor_sync(0xffffffffu, fz, 2);
      fz += __shfl_xor_sync(0xffffffffu, fz, 4);
      if (r == 0) {
        fin[q * 4 + sp] = kSigmoid ? 1.0f / (1.0f + expf(-fz)) : fz;
        if (wg == 0 && p < npix) resp[(size_t)e * npix + p] = fz;
      }
    }
    __syncwarp();
    PHASE(3)

#pragma unroll
    for (int i = 0; i < L::kP; ++i) {
      const int p = tile * L::kTilePix + grp * L::kP + i;
      if (p < npix) {
        const float g = fin[i];
        float x[kCh];
        Chunk<T, kCh>::load(rows + (size_t)i * L::kC * sizeof(T), x);
#pragma unroll
        for (int c = 0; c < kCh; ++c) x[c] *= g;
        Chunk<T, kCh>::store(ge + (size_t)p * L::kC + kCh * j, x);
      }
    }
    __syncwarp();
    PHASE(4)
  }
  cp_async_wait<0>();
  CLOCKS_END(0, n)
}

// ------------------------------------------------------- forward, bf16 maps
//
// bf16 maps take the tensor cores for the contraction: the kernel above
// spends more issue slots summing its per-thread partial dot products
// across lanes than on the products themselves. A tile is 16 pixels (the
// rows of an mma.sync m16n8k16); warp w owns channels [w C/8, (w+1) C/8)
// and multiplies the tile's 16 x C/8 slice (ldmatrix from the ring) by its
// (C/8) x 8 slice of the filter bank, held in registers as a hi and a lo
// bf16 part (filt = hi + lo to 2^-16) with f32 accumulation: the map is
// exact in bf16, so the response keeps f32 precision. The 8 warps' 16 x 8
// partials are summed in warp order through shared memory; 128 threads,
// one a (pixel, filter), apply masks, rfilt and the gate. The ring holds 3
// tiles, copied with cp.async in 16-byte chunks swizzled by pixel (chunk
// ^ pixel % 8) so that ldmatrix reads are conflict free; the epilogue
// multiplies the chunks each thread copied itself. Three block barriers a
// tile: the tile in shared memory, the partials, g.
template <int C>
struct MmaTiling {
  static constexpr int kPix = 16;                   // pixels a tile
  static constexpr int kChunks = C / 8;             // 16-byte chunks a pixel
  static constexpr int kSteps = C / (8 * 16);       // k-steps of 16 a warp
  static constexpr int kPerThread = kPix * kChunks / kThreads;
  static constexpr int kStageBytes = kPix * C * 2;
  static constexpr int kStages = 3;
  static constexpr int kRedFloats = (kThreads / 32) * kPix * 8;
  static constexpr size_t kSmemBytes =
      (size_t)kStages * kStageBytes + (kRedFloats + kPix) * 4;
  static_assert(kSteps >= 1 && kPix * kChunks % kThreads == 0, "tiling");
};

// byte offset of 16-byte chunk `ch` of pixel `px` in a ring stage
template <int C>
__device__ __forceinline__ int swizzled(int px, int ch) {
  return px * C * 2 + ((ch ^ (px & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int K, int C, bool kSigmoid>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_filter_mma_kernel(const __nv_bfloat16* __restrict__ conv,
                        long long conv_batch_stride, int exprs_per_map,
                        const float* __restrict__ filt,
                        const float* __restrict__ rfilt, int h, int w,
                        int tiles_per_block, float scale,
                        __nv_bfloat16* __restrict__ gated,
                        float* __restrict__ resp) {
  using L = MmaTiling<C>;
  CLOCKS_BEGIN
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + L::kStages * L::kStageBytes);
  float* fin = red + L::kRedFloats;

  const int e = blockIdx.y;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int npix = h * w;
  const int ntiles = (npix + L::kPix - 1) / L::kPix;
  const int t0 = min((int)blockIdx.x * tiles_per_block, ntiles);
  const int n = min(t0 + tiles_per_block, ntiles) - t0;
  const __nv_bfloat16* ce =
      conv + (size_t)(e / exprs_per_map) * conv_batch_stride;
  __nv_bfloat16* ge = gated + (size_t)e * npix * C;

  // thread t copies (and later gates) chunks f = i * kThreads + t of a tile
  auto stage = [&](int tile, int slot) {
    unsigned char* st = smem + slot * L::kStageBytes;
#pragma unroll
    for (int i = 0; i < L::kPerThread; ++i) {
      const int f = i * kThreads + t;
      const int px = f / L::kChunks;
      const int ch = f - px * L::kChunks;
      const int p = tile * L::kPix + px;
      const bool live = p < npix;
      cp_async<16>(st + swizzled<C>(px, ch),
                   ce + (live ? (size_t)p * C + ch * 8 : 0), live);
    }
  };
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n) stage(t0 + s, s);
    cp_async_commit();
  }
  const float* fe = filt + (size_t)e * C * K;
  // B fragments of this warp's channels: lane (g, q) holds filter g at
  // channels 2q, 2q + 1 (b0) and 2q + 8, 2q + 9 (b1) of each k-step
  const int g = lane >> 2;
  const int q = lane & 3;
  unsigned bhi[L::kSteps][2], blo[L::kSteps][2];
#pragma unroll
  for (int ks = 0; ks < L::kSteps; ++ks) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = warp * (C / 8) + ks * 16 + 2 * q + 8 * half;
      const float f0 = g < K ? fe[c * K + g] : 0.0f;
      const float f1 = g < K ? fe[(c + 1) * K + g] : 0.0f;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(f0, f1);
      bhi[ks][half] = bf16x2_bits(hi);
      blo[ks][half] = bf16x2_bits(__floats2bfloat162_rn(
          f0 - __low2float(hi), f1 - __high2float(hi)));
    }
  }
  // the finishing thread t < 128: filter r of pixel t / 8
  const int r = t & 7;
  const float rf = r < K ? (K == 7 ? rfilt[e * K + r] : 1.0f) : 0.0f;
  // ldmatrix rows: lanes 0-15 give rows 0-15 at the k-step's first chunk,
  // lanes 16-31 the same rows at its second
  const int arow = lane & 15;
  const int ach = warp * 2 * L::kSteps + (lane >> 4);
  PHASE(0)

  for (int it = 0; it < n; ++it) {
    const int tile = t0 + it;
    cp_async_wait<L::kStages - 2>();
    __syncthreads();                 // the tile is in; the last is done with
    PHASE(1)
    if (it + L::kStages - 1 < n) {
      stage(tile + L::kStages - 1, (it + L::kStages - 1) % L::kStages);
    }
    cp_async_commit();
    const unsigned char* st = smem + (it % L::kStages) * L::kStageBytes;

    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ks = 0; ks < L::kSteps; ++ks) {
      unsigned a[4];
      ldmatrix_x4(a, st + swizzled<C>(arow, ach + 2 * ks));
      mma_bf16(d, a, bhi[ks][0], bhi[ks][1]);
      mma_bf16(d, a, blo[ks][0], blo[ks][1]);
    }
    // d: pixels g and g + 8, filters 2q and 2q + 1
    *reinterpret_cast<float2*>(&red[(warp * L::kPix + g) * 8 + 2 * q]) =
        make_float2(d[0], d[1]);
    *reinterpret_cast<float2*>(&red[(warp * L::kPix + g + 8) * 8 + 2 * q]) =
        make_float2(d[2], d[3]);
    PHASE(2)
    __syncthreads();
    if (t < L::kPix * 8) {
      const int px = t >> 3;
      float s = red[px * 8 + r];
#pragma unroll
      for (int u = 1; u < kThreads / 32; ++u) s += red[(u * L::kPix + px) * 8 + r];
      const int p = tile * L::kPix + px;
      float fz = (r < K && region(r, p, h, w)) ? s * scale * rf : 0.0f;
      fz += __shfl_xor_sync(0xffffffffu, fz, 1);
      fz += __shfl_xor_sync(0xffffffffu, fz, 2);
      fz += __shfl_xor_sync(0xffffffffu, fz, 4);
      if (r == 0) {
        fin[px] = kSigmoid ? 1.0f / (1.0f + expf(-fz)) : fz;
        if (p < npix) resp[(size_t)e * npix + p] = fz;
      }
    }
    __syncthreads();
    PHASE(3)

#pragma unroll
    for (int i = 0; i < L::kPerThread; ++i) {
      const int f = i * kThreads + t;
      const int px = f / L::kChunks;
      const int ch = f - px * L::kChunks;
      const int p = tile * L::kPix + px;
      if (p < npix) {
        float x[8];
        Chunk<__nv_bfloat16, 8>::load(st + swizzled<C>(px, ch), x);
        const float gv = fin[px];
#pragma unroll
        for (int c = 0; c < 8; ++c) x[c] *= gv;
        Chunk<__nv_bfloat16, 8>::store(ge + (size_t)p * C + ch * 8, x);
      }
    }
    PHASE(4)
  }
  cp_async_wait<0>();
  CLOCKS_END(0, n)
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
// What bounds it on an H100. Bytes again: at the training shape (16 x 40 x
// 64 x 1024 bf16, a map gathered from 2 images) it reads conv and d_gated
// and writes d_conv (3 x 84 MB), against 2.0 GFLOP of f32 work (29 us at
// the card's f32 rate): a 75.5 us bound. The earlier kernel took 0.395
// ms. Measured by phase (tools/profile_gate.py), a pixel step cost ~4,970
// cycles: 1,400 waiting on its own loads (the next pixel was loaded only
// after the previous step's barrier and stores), 920 for the contraction,
// 590 for the per-pixel cross-warp barrier and 2,060 for the epilogue,
// which re-read the 28 KB filter bank from shared memory a second time.
// Its d_filt accumulators (56 a thread) took it to 128-153 registers: one
// block an SM, and 272 blocks made 2.06 waves.
//
// Design: the forward's. Persistent blocks walk a fixed run of one
// expression's tiles; each thread keeps its 4 channels' K filter values
// and their 4 x K d_filt sums in registers for the whole kernel. A tile
// is 16 KB of conv and 16 KB of d_gated, copied by each thread for its own
// channels into a 3-stage cp.async ring. The 8 per-pixel sums (K
// responses, then d_g) of 4 pixels are reduce-scattered over the warp's
// lanes and summed across the group's warps in a fixed order (one block
// barrier a tile); the lane holding slot k of a pixel computes d_fused,
// d_resp0k and its d_rfilt term, and the epilogue reads a pixel's 8
// finished values (d_resp0 and g) back with two broadcast reads. At the
// end the block's groups are summed in group order and the block writes
// one (C, K) partial to scratch; a second kernel sums each expression's
// partials in block order. Tiles map to blocks statically and no atomics
// are used, so two calls give the same bits.

template <typename T, int K, int G, bool kSigmoid>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fused_filter_bwd_kernel(const T* __restrict__ conv, long long conv_batch_stride,
                        const T* __restrict__ d_gated,
                        const float* __restrict__ filt,
                        const float* __restrict__ rfilt,
                        const float* __restrict__ fused,
                        const float* __restrict__ d_resp, int h, int w,
                        int tiles_per_block, float scale,
                        T* __restrict__ d_conv, float* __restrict__ filt_part,
                        float* __restrict__ rfilt_part) {
  using L = BwdTiling<T, G>;
  constexpr int kCh = L::kCh;
  CLOCKS_BEGIN
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rsum[L::kGroups][8];
  float* red = reinterpret_cast<float*>(smem + L::kStages * L::kStageBytes);
  float* fin = red + L::kRedFloats + (threadIdx.x >> 5) * 32 * L::kQ;

  const int e = blockIdx.y;
  const int t = threadIdx.x;
  const int grp = t / G;
  const int j = t - grp * G;
  const int lane = t & 31;
  const int wg = j >> 5;
  const int npix = h * w;
  const int ntiles = (npix + L::kTilePix - 1) / L::kTilePix;
  const int t0 = min((int)blockIdx.x * tiles_per_block, ntiles);
  const int n = min(t0 + tiles_per_block, ntiles) - t0;
  const T* ce = conv + (size_t)e * conv_batch_stride;
  const T* dge = d_gated + (size_t)e * npix * L::kC;
  T* de = d_conv + (size_t)e * npix * L::kC;
  const float* fz = fused + (size_t)e * npix;
  const float* dr = d_resp + (size_t)e * npix;

  auto stage = [&](int tile, int slot) {
    unsigned char* st = smem + slot * L::kStageBytes;
    stage_rows<T, L>(st, ce, tile, grp, j, npix);
    stage_rows<T, L>(st + L::kMapBytes, dge, tile, grp, j, npix);
  };
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < n) stage(t0 + s, s);
    cp_async_commit();
  }
  float f[kCh][K];                         // this thread's filters
  float fp[kCh][K];                        // and its d_filt sums
  const float* fe = filt + ((size_t)e * L::kC + kCh * j) * K;
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      f[c][k] = fe[c * K + k];
      fp[c][k] = 0.0f;
    }
  }
  // lane (sp, r) holds slot r of pixel sp of each 4 pixels: response r
  // for r < K, d_g for r == 7; and the d_rfilt sum of k = r
  const int sp = lane >> 3;
  const int r = lane & 7;
  const float rf = r < K ? (K == 7 ? rfilt[e * K + r] : 1.0f) : 0.0f;
  float rp = 0.0f;
  PHASE(0)

  for (int it = 0; it < n; ++it) {
    const int tile = t0 + it;
    if (it + L::kStages - 1 < n) {
      stage(tile + L::kStages - 1, (it + L::kStages - 1) % L::kStages);
    }
    cp_async_commit();
    // this lane's pixels' response and d_resp, for after the contraction
    float fv[L::kQ], drv[L::kQ];
#pragma unroll
    for (int q = 0; q < L::kQ; ++q) {
      const int p = tile * L::kTilePix + grp * L::kP + q * 4 + sp;
      fv[q] = p < npix ? fz[p] : 0.0f;
      drv[q] = p < npix ? dr[p] : 0.0f;
    }
    cp_async_wait<L::kStages - 1>();
    PHASE(1)
    const unsigned char* xrows = smem + (it % L::kStages) * L::kStageBytes +
                                 ((size_t)grp * L::kP * L::kC + kCh * j) *
                                     sizeof(T);
    const unsigned char* grows = xrows + L::kMapBytes;

    float sum[L::kQ];
#pragma unroll
    for (int q = 0; q < L::kQ; ++q) {
      float v[32];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const size_t off = (size_t)(q * 4 + u) * L::kC * sizeof(T);
        float x[kCh], dg[kCh];
        Chunk<T, kCh>::load(xrows + off, x);
        Chunk<T, kCh>::load(grows + off, dg);
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          float a = 0.0f;
          if (k < K) {
#pragma unroll
            for (int c = 0; c < kCh; ++c) a = fmaf(x[c], f[c][k], a);
          }
          v[u * 8 + k] = a;
        }
        float a = 0.0f;
#pragma unroll
        for (int c = 0; c < kCh; ++c) a = fmaf(dg[c], x[c], a);
        v[u * 8 + 7] = a;
      }
      sum[q] = reduce_scatter32(v, lane);
    }
    PHASE(2)
    if constexpr (L::kWarps > 1) {
      float* rb = red + ((it & 1) * L::kGroups + grp) * L::kWarps * 32 * L::kQ;
#pragma unroll
      for (int q = 0; q < L::kQ; ++q) rb[(wg * L::kQ + q) * 32 + lane] = sum[q];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < L::kQ; ++q) {
        float s = rb[q * 32 + lane];
#pragma unroll
        for (int u = 1; u < L::kWarps; ++u) s += rb[(u * L::kQ + q) * 32 + lane];
        sum[q] = s;
      }
    }
#pragma unroll
    for (int q = 0; q < L::kQ; ++q) {
      const int p = tile * L::kTilePix + grp * L::kP + q * 4 + sp;
      const float d_g = __shfl_sync(0xffffffffu, sum[q], lane | 7);
      const float g = kSigmoid ? 1.0f / (1.0f + expf(-fv[q])) : fv[q];
      const float gp = kSigmoid ? g * (1.0f - g) : 1.0f;
      const float dfu = drv[q] + d_g * gp;
      const bool m = r < K && region(r, p, h, w);
      if (K == 7 && m && p < npix) rp = fmaf(sum[q] * scale, dfu, rp);
      fin[q * 32 + lane] = r == 7 ? g : (m ? dfu * rf : 0.0f);
    }
    __syncwarp();
    PHASE(3)

#pragma unroll
    for (int i = 0; i < L::kP; ++i) {
      const int p = tile * L::kTilePix + grp * L::kP + i;
      if (p < npix) {
        const float* fi = fin + (i >> 2) * 32 + (i & 3) * 8;
        const float4 lo = *reinterpret_cast<const float4*>(fi);
        const float4 hi = *reinterpret_cast<const float4*>(fi + 4);
        const float d0[7] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z};
        const float g = hi.w;
        const size_t off = (size_t)i * L::kC * sizeof(T);
        float x[kCh], dg[kCh], o[kCh];
        Chunk<T, kCh>::load(xrows + off, x);
        Chunk<T, kCh>::load(grows + off, dg);
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            s = fmaf(d0[k], f[c][k], s);
            fp[c][k] = fmaf(x[c], d0[k], fp[c][k]);
          }
          o[c] = dg[c] * g + s * scale;
        }
        Chunk<T, kCh>::store(de + (size_t)p * L::kC + kCh * j, o);
      }
    }
    __syncwarp();
    PHASE(4)
  }
  cp_async_wait<0>();
  CLOCKS_END(1, n)

  // the block's d_filt partial, groups summed in group order, in filt's
  // (C, K) layout, over the ring's shared memory
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  for (int u = 0; u < L::kGroups; ++u) {
    if (grp == u) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float* slot = &part[(kCh * j + c) * K + k];
          *slot = (u == 0) ? fp[c][k] : *slot + fp[c][k];
        }
      }
    }
    __syncthreads();
  }
  float* out = filt_part + ((size_t)e * gridDim.x + blockIdx.x) * L::kC * K;
  for (int idx = t; idx < L::kC * K; idx += kThreads) out[idx] = part[idx];
  // d_rfilt: the 4 lanes of each k in lane order, then the groups
  rp += __shfl_xor_sync(0xffffffffu, rp, 8);
  rp += __shfl_xor_sync(0xffffffffu, rp, 16);
  if (wg == 0 && lane < 8) rsum[grp][lane] = rp;
  __syncthreads();
  if (t < K) {
    float s = 0.0f;
    for (int u = 0; u < L::kGroups; ++u) s += rsum[u][t];
    rfilt_part[((size_t)e * gridDim.x + blockIdx.x) * K + t] = s;
  }
}

// d_filt[e, c, k] = scale * sum over blocks b (in order) of the partials;
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

// Dynamic shared memory above 48 KB and the largest shared-memory carve-out
// for `kernel`, so that kBlocksPerSM blocks fit an SM. The attributes
// persist, so they are set once a device: `done` (a static of the launch
// site, one a kernel instance) keeps a bit a device (0-63), and a later
// launch pays one cudaGetDevice. A failed call is returned and tried again
// on the next launch.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes,
                     std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The forward's launches: grid (blocks, e), each block walking
// ceil(ntiles / blocks) tiles (the wrapper's tile_plan).
template <int K, int G>
cudaError_t launch_gate(const void* conv, long long stride, int per_map,
                        const float* filt, const float* rfilt, int e, int h,
                        int w, int sigmoid, float scale, int blocks,
                        void* gated, float* resp, cudaStream_t s) {
  using T = float;
  using L = FwdTiling<G>;
  const int ntiles = (h * w + L::kTilePix - 1) / L::kTilePix;
  const int tpb = (ntiles + blocks - 1) / blocks;
  const dim3 grid(blocks, e);
  const T* c = static_cast<const T*>(conv);
  T* g = static_cast<T*>(gated);
  cudaError_t err;
  if (sigmoid) {
    static std::atomic<unsigned long long> once{0};
    auto kernel = fused_filter_kernel<K, G, true>;
    if ((err = set_smem(kernel, L::kSmemBytes, once)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, L::kSmemBytes, s>>>(c, stride, per_map, filt,
                                                   rfilt, h, w, tpb, scale, g,
                                                   resp);
  } else {
    static std::atomic<unsigned long long> once{0};
    auto kernel = fused_filter_kernel<K, G, false>;
    if ((err = set_smem(kernel, L::kSmemBytes, once)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, L::kSmemBytes, s>>>(c, stride, per_map, filt,
                                                   rfilt, h, w, tpb, scale, g,
                                                   resp);
  }
  return cudaGetLastError();
}

template <int K, int C>
cudaError_t launch_gate_mma(const void* conv, long long stride, int per_map,
                            const float* filt, const float* rfilt, int e,
                            int h, int w, int sigmoid, float scale, int blocks,
                            void* gated, float* resp, cudaStream_t s) {
  using L = MmaTiling<C>;
  const int ntiles = (h * w + L::kPix - 1) / L::kPix;
  const int tpb = (ntiles + blocks - 1) / blocks;
  const dim3 grid(blocks, e);
  const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(conv);
  __nv_bfloat16* g = static_cast<__nv_bfloat16*>(gated);
  cudaError_t err;
  if (sigmoid) {
    static std::atomic<unsigned long long> once{0};
    auto kernel = fused_filter_mma_kernel<K, C, true>;
    if ((err = set_smem(kernel, L::kSmemBytes, once)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, L::kSmemBytes, s>>>(c, stride, per_map, filt,
                                                   rfilt, h, w, tpb, scale, g,
                                                   resp);
  } else {
    static std::atomic<unsigned long long> once{0};
    auto kernel = fused_filter_mma_kernel<K, C, false>;
    if ((err = set_smem(kernel, L::kSmemBytes, once)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, L::kSmemBytes, s>>>(c, stride, per_map, filt,
                                                   rfilt, h, w, tpb, scale, g,
                                                   resp);
  }
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch_fwd_mma(int c, const void* conv, long long stride,
                             int per_map, const float* filt,
                             const float* rfilt, int e, int h, int w,
                             int sigmoid, float scale,
                             int blocks, void* gated, float* resp,
                             cudaStream_t s) {
#define L2S_MMA(CV)                                                          \
  launch_gate_mma<K, CV>(conv, stride, per_map, filt, rfilt, e, h, w,       \
                         sigmoid, scale, blocks, gated, resp, s)
  switch (c) {
    case 256: return L2S_MMA(256);
    case 512: return L2S_MMA(512);
    case 1024: return L2S_MMA(1024);
    default: return cudaErrorInvalidValue;
  }
#undef L2S_MMA
}

template <typename T, int K, int G>
cudaError_t launch_gate_bwd(const void* conv, long long stride,
                            const void* d_gated, const float* filt,
                            const float* rfilt, const float* fused,
                            const float* d_resp, int e, int h, int w,
                            int sigmoid, float scale, int blocks,
                            float* filt_part, float* rfilt_part, void* d_conv,
                            float* d_filt, float* d_rfilt, cudaStream_t s) {
  using L = BwdTiling<T, G>;
  const int ntiles = (h * w + L::kTilePix - 1) / L::kTilePix;
  const int tpb = (ntiles + blocks - 1) / blocks;
  const dim3 grid(blocks, e);
  const T* c = static_cast<const T*>(conv);
  const T* dg = static_cast<const T*>(d_gated);
  T* dc = static_cast<T*>(d_conv);
  cudaError_t err;
  if (sigmoid) {
    static std::atomic<unsigned long long> once{0};
    auto kernel = fused_filter_bwd_kernel<T, K, G, true>;
    if ((err = set_smem(kernel, L::kSmemBytes, once)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, L::kSmemBytes, s>>>(
        c, stride, dg, filt, rfilt, fused, d_resp, h, w, tpb, scale, dc,
        filt_part, rfilt_part);
  } else {
    static std::atomic<unsigned long long> once{0};
    auto kernel = fused_filter_bwd_kernel<T, K, G, false>;
    if ((err = set_smem(kernel, L::kSmemBytes, once)) != cudaSuccess) return err;
    kernel<<<grid, kThreads, L::kSmemBytes, s>>>(
        c, stride, dg, filt, rfilt, fused, d_resp, h, w, tpb, scale, dc,
        filt_part, rfilt_part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ck = L::kC * K;
  const int total = e * ck + e * K;
  fused_filter_bwd_reduce<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                            s>>>(filt_part, rfilt_part, e, blocks, ck, K,
                                 scale, d_filt, d_rfilt);
  return cudaGetLastError();
}

// G, the threads a pixel, from C: the maps `_check_inputs` takes, bf16
// C = 256, 512, 1024 and f32 C = 128, 256, 512, 1024
#define L2S_DISPATCH_G(g, CALL)            \
  switch (g) {                             \
    case 32: return CALL(32);              \
    case 64: return CALL(64);              \
    case 128: return CALL(128);            \
    case 256: return CALL(256);            \
    default: return cudaErrorInvalidValue; \
  }

bool supported_c(int c, int is_bf16) {
  return c == 256 || c == 512 || c == 1024 || (!is_bf16 && c == 128);
}

template <int K>
cudaError_t dispatch_fwd(int g, const void* conv, long long stride,
                         int per_map, const float* filt, const float* rfilt,
                         int e, int h, int w, int sigmoid, float scale,
                         int blocks,
                         void* gated, float* resp, cudaStream_t s) {
#define L2S_FWD(GV)                                                          \
  launch_gate<K, GV>(conv, stride, per_map, filt, rfilt, e, h, w, sigmoid,  \
                     scale, blocks, gated, resp, s)
  L2S_DISPATCH_G(g, L2S_FWD)
#undef L2S_FWD
}

template <typename T, int K>
cudaError_t dispatch_bwd(int g, const void* conv, long long stride,
                         const void* d_gated, const float* filt,
                         const float* rfilt, const float* fused,
                         const float* d_resp, int e, int h, int w, int sigmoid,
                         float scale, int blocks, float* filt_part,
                         float* rfilt_part, void* d_conv, float* d_filt,
                         float* d_rfilt, cudaStream_t s) {
#define L2S_BWD(GV)                                                         \
  launch_gate_bwd<T, K, GV>(conv, stride, d_gated, filt, rfilt, fused,      \
                            d_resp, e, h, w, sigmoid, scale, blocks,        \
                            filt_part, rfilt_part, d_conv, d_filt, d_rfilt, \
                            s)
  L2S_DISPATCH_G(g, L2S_BWD)
#undef L2S_BWD
}

#undef L2S_DISPATCH_G

// Pixels a tile of the kernel that a launch takes for maps of c channels
// (supported_c): MmaTiling's for a bf16 forward, else FwdTiling's or
// BwdTiling's at G = c / 4 threads a pixel.
int tile_pixels(int backward, int c, int is_bf16) {
#define L2S_PIX(GV)                                            \
  (!backward  ? FwdTiling<GV>::kTilePix                        \
   : is_bf16 ? BwdTiling<__nv_bfloat16, GV>::kTilePix          \
             : BwdTiling<float, GV>::kTilePix)
  if (!backward && is_bf16) {
    return c == 256 ? MmaTiling<256>::kPix
         : c == 512 ? MmaTiling<512>::kPix : MmaTiling<1024>::kPix;
  }
  switch (c / 4) {
    case 32: return L2S_PIX(32);
    case 64: return L2S_PIX(64);
    case 128: return L2S_PIX(128);
    default: return L2S_PIX(256);
  }
#undef L2S_PIX
}

}  // namespace

// conv: the maps of `is_bf16 ? bf16 : f32`, each (h, w, c) map
// contiguous, expression i reading map i / exprs_per_map at conv +
// (i / exprs_per_map) * conv_batch_stride elements (stride 0 for one
// broadcast map; exprs_per_map S for N images of S expressions each,
// image-major), 16-byte aligned; filt (e, c, k) f32 and rfilt (e, k) f32
// contiguous; gated (e, h, w, c) of the map's dtype and resp (e, h, w)
// f32 are written in full. c: bf16 256, 512 or 1024; f32 128, 256, 512
// or 1024. k is 1 or 7. blocks: blocks per expression (grid x,
// `tile_plan`'s blocks_per_expr), block b walking tiles [b * t, (b + 1) *
// t) of the fused_filter_tiling tiles, t = ceil(tiles / blocks). Returns
// the first CUDA error of the launch (0 on success).
extern "C" int fused_filter_grouped_launch(
    const void* conv, long long conv_batch_stride, int exprs_per_map,
    const void* filt, const void* rfilt, int e, int h, int w, int c, int k,
    int is_bf16, int sigmoid, float scale, int blocks, void* gated,
    void* resp, void* stream) {
  if (e <= 0 || h <= 0 || w <= 0) return 0;
  if (blocks <= 0 || exprs_per_map <= 0 || !supported_c(c, is_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = c / 4;                     // FwdTiling: 4 channels a thread
  const int per = exprs_per_map;
  const float* f = static_cast<const float*>(filt);
  const float* r = static_cast<const float*>(rfilt);
  float* out_r = static_cast<float*>(resp);
  cudaError_t err;
  if (is_bf16) {
    err = k == 7 ? dispatch_fwd_mma<7>(c, conv, conv_batch_stride, per, f, r,
                                       e, h, w, sigmoid, scale, blocks, gated,
                                       out_r, s)
        : k == 1 ? dispatch_fwd_mma<1>(c, conv, conv_batch_stride, per, f, r,
                                       e, h, w, sigmoid, scale, blocks, gated,
                                       out_r, s)
                 : cudaErrorInvalidValue;
  } else {
    err = k == 7 ? dispatch_fwd<7>(g, conv, conv_batch_stride, per, f, r, e, h,
                                   w, sigmoid, scale, blocks, gated, out_r, s)
        : k == 1 ? dispatch_fwd<1>(g, conv, conv_batch_stride, per, f, r, e, h,
                                   w, sigmoid, scale, blocks, gated, out_r, s)
                 : cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Gradient of fused_filter_grouped_launch with exprs_per_map 1. conv as
// there (batch stride may be 0); d_gated and d_conv (e, h, w, c) contiguous
// maps of the same dtype, 16-byte aligned; fused and d_resp (e, h, w) f32; filt (e, c, k), rfilt (e, k) f32.
// tiles: blocks per expression (grid x, `tile_plan`'s blocks_per_expr),
// walking the fused_filter_tiling tiles as the forward's blocks do;
// filt_part (e, tiles, c, k) and rfilt_part (e, tiles, k) f32 scratch.
// Writes d_conv, d_filt (e, c, k) and d_rfilt (e, k) in full (d_rfilt is 0
// for k == 1). Same c and k as the forward. Returns the first CUDA error of
// the launches (0 on success).
extern "C" int fused_filter_bwd_launch(
    const void* conv, long long conv_batch_stride, const void* d_gated,
    const void* filt, const void* rfilt, const void* fused, const void* d_resp,
    int e, int h, int w, int c, int k, int is_bf16, int sigmoid, float scale,
    int tiles, void* filt_part, void* rfilt_part, void* d_conv, void* d_filt,
    void* d_rfilt, void* stream) {
  if (e <= 0 || h <= 0 || w <= 0 || tiles <= 0 || !supported_c(c, is_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = c / 4;                     // BwdTiling: 4 channels a thread
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
        ? dispatch_bwd<__nv_bfloat16, 7>(g, conv, conv_batch_stride, d_gated,
                                         f, r, fz, dr, e, h, w, sigmoid, scale,
                                         tiles, fpart, rpart, d_conv, df, drf,
                                         s)
        : (k == 1)
        ? dispatch_bwd<__nv_bfloat16, 1>(g, conv, conv_batch_stride, d_gated,
                                         f, r, fz, dr, e, h, w, sigmoid, scale,
                                         tiles, fpart, rpart, d_conv, df, drf,
                                         s)
        : cudaErrorInvalidValue;
  } else {
    err = (k == 7)
        ? dispatch_bwd<float, 7>(g, conv, conv_batch_stride, d_gated, f, r, fz,
                                 dr, e, h, w, sigmoid, scale, tiles, fpart,
                                 rpart, d_conv, df, drf, s)
        : (k == 1)
        ? dispatch_bwd<float, 1>(g, conv, conv_batch_stride, d_gated, f, r, fz,
                                 dr, e, h, w, sigmoid, scale, tiles, fpart,
                                 rpart, d_conv, df, drf, s)
        : cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The tiling of the kernel that fused_filter_grouped_launch (backward 0)
// or fused_filter_bwd_launch (backward 1) takes for maps of c channels of
// bf16 or f32: out[0] pixels a tile, out[1] the blocks an SM each kernel is
// built to hold (its __launch_bounds__). The wrapper plans the grids from
// them. Returns cudaErrorInvalidValue for maps the kernels do not take.
extern "C" int fused_filter_tiling(int backward, int c, int is_bf16,
                                   int* out) {
  if (!supported_c(c, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = tile_pixels(backward, c, is_bf16);
  out[1] = kBlocksPerSM;
  return 0;
}

#ifdef FUSED_FILTER_PHASE_CLOCKS
// The last launches' phase cycles: 2 x (kPhases + 2) values, forward then
// backward.
extern "C" int fused_filter_phase_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, gate_phase_clocks,
                                               sizeof(gate_phase_clocks)));
}
#endif
