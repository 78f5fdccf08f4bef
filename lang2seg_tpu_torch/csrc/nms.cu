// Batched greedy NMS for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: lang2seg_tpu/ops/nms_pallas.py, nms_pallas_batched (Pallas
// kernel body `_kernel`), whose wire format is ops/nms.py::nms_padded:
// keep_idx (E, max_out) int32 with 0 in padded slots, keep_mask (E,
// max_out) bool. Boxes arrive sorted by descending score; a box is
// suppressed iff its +1-pixel IoU with an earlier KEPT box is > thresh
// (an f32 compare against the f32 threshold); invalid rows are never kept
// and suppress nothing; at most max_out boxes are kept (early exit).
//
// Design: the Pallas kernel's frontier algorithm, one launch, no device
// scratch. A lane (one expression) is a thread-block cluster of C CTAs of
// 1024 threads (C = 1..8: the wrapper takes the largest the card holds E
// of at once, one CTA per SM). The lane walks its boxes in tiles of 64
// (one 64-bit word a tile); for each tile every CTA of the cluster
//   (a) takes the tile's valid bits (rows past N count as invalid);
//   (b) tests each valid candidate against ITS share of the kept
//       frontier (kept box k lives in CTA k mod C, in shared memory), one
//       warp a candidate, stopping at the first hit (a warp vote); after
//       one cluster barrier every warp ORs the C hit words through
//       distributed shared memory;
//   (c) computes the tile's own "row i suppresses later j" words among
//       the boxes still alive (the 2016 pairs spread evenly, two a
//       thread), and walks the alive bits with __ffsll, jumping straight
//       to the next alive row whose word is not zero (rows that suppress
//       nothing in the tile are kept without a step);
//   (d) appends its kept boxes (coordinates and area) to its frontier
//       share and writes their indices;
//   (e) stops once max_out boxes are kept, then writes the 0 padding and
//       keep_mask itself, so a request has no host synchronisation.
// Every CTA of a cluster walks the same words, so all see the same count
// and leave the loop together. The next tile's boxes are fetched into
// registers while the current one is worked on.
//
// What bounds it on an H100: the work is data-dependent. The bytes are
// the lane's boxes and valid bits, read once, and the outputs: 1.7 MB at
// (16, 6000) -> 300, 0.5 us at 3.35 TB/s. The operations are the pair
// tests greedy NMS needs on these inputs (each box up to the last one
// examined against the kept boxes before it, 15 f32 operations a test):
// on an RPN draw at (16, 12000) -> 2000, 54 M tests, 12 us at 67 TFLOP/s.
// Neither holds the kernel. The tiles of a lane are a chain, and each
// tile costs one cluster barrier, the hit-word exchange, the tile's own
// pairs, the walk and three block barriers, whatever its frontier; the
// frontier test adds a chain of dependent IoU tests per warp. So a lane
// costs about (tiles examined) x (one tile's latency), which
// tools/profile_nms.py splits by phase (a build with -DNMS_PHASE_CLOCKS).
// The design keeps that chain short: no second pass and no global round
// trip per tile, the frontier split across the cluster's SMs, 32 warps a
// CTA to overlap the tests' latency, pair tests only among alive boxes,
// zero-word rows skipped in the walk, and the next tile prefetched.
//
// Bit identity with the f32 reference: the IoU is written with explicit
// round-to-nearest intrinsics (no FMA contraction; the file is also built
// with -fmad=false) in the reference's operation order, with the kept
// (earlier) box as `a`, and compared in f32 against the f32 threshold.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
// (c) gives each thread 2 of the tile's 2016 pairs, 16 distances a round
static_assert(kThreads % kTile == 0 && kThreads / kTile <= kTile / 2,
              "pair distances");

#ifdef NMS_PHASE_CLOCKS
// Built only into the measuring variant (tools/profile_nms.py): clock64()
// cycles of each phase of the tile loop, summed over the tiles, as thread
// 0 of lane 0's first CTA sees them, then the tiles walked.
constexpr int kPhases = 6;
__device__ long long phase_clocks[kPhases + 1];
#define PHASE(k)                                     \
  if (clocked) {                                     \
    const long long now = clock64();                 \
    clk[k] += now - stamp;                           \
    stamp = now;                                     \
  }
#else
#define PHASE(k)
#endif

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// IoU(a, b) > thresh, as ops/boxes.py::box_iou computes it in f32:
// inter = max(min(x2) - max(x1) + 1, 0) * max(min(y2) - max(y1) + 1, 0);
// union = (area_a + area_b) - inter; iou = inter / union.
// Where iw or ih clamps to 0 the intersection is 0 and 0 / union is never
// above a threshold >= 0 (NaN included), so the division is skipped.
__device__ __forceinline__ bool suppresses(const float4 a, float area_a,
                                           const float4 b, float area_b,
                                           float thresh) {
  const float ix1 = fmaxf(a.x, b.x);
  const float iy1 = fmaxf(a.y, b.y);
  const float ix2 = fminf(a.z, b.z);
  const float iy2 = fminf(a.w, b.w);
  const float iw = fmaxf(__fadd_rn(__fsub_rn(ix2, ix1), 1.0f), 0.0f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(iy2, iy1), 1.0f), 0.0f);
  if ((iw == 0.0f || ih == 0.0f) && thresh >= 0.0f) return false;
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, uni) > thresh;
}

// grid: e clusters of C CTAs along x; dynamic shared memory: `slots`
// frontier boxes (float4) then their areas (float)
__global__ void __launch_bounds__(kThreads)
nms_frontier_kernel(const float4* __restrict__ boxes,
                    const unsigned char* __restrict__ valid, int n,
                    int max_out, int slots, float thresh,
                    int* __restrict__ keep_idx, bool* __restrict__ keep_mask) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int lane = blockIdx.x / csize;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int wl = t % 32;
  const float4* lb = boxes + (size_t)lane * n;
  const unsigned char* lv = valid + (size_t)lane * n;
  int* out = keep_idx + (size_t)lane * max_out;
  const int ntiles = (n + kTile - 1) / kTile;
#ifdef NMS_PHASE_CLOCKS
  const bool clocked = blockIdx.x == 0 && t == 0;
  long long clk[kPhases] = {};
  long long stamp = clock64();
#endif

  extern __shared__ float4 frontier[];          // this CTA's kept boxes
  float* fr_area = reinterpret_cast<float*>(frontier + slots);
  __shared__ float4 tile_box[2][kTile];         // by tile parity
  __shared__ float tile_area[2][kTile];
  __shared__ unsigned long long tile_valid[2];
  __shared__ unsigned long long rows[kTile];    // bit j: row i suppresses j
  __shared__ unsigned long long part[2];        // frontier hits, by parity;
                                                // read by the whole cluster
  __shared__ unsigned long long zrows;          // rows whose word is not 0
  __shared__ unsigned long long keep_word;

  // threads 0..63 (warps 0 and 1) carry one box of the next tile
  float4 nb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool nv = false;
  auto fetch = [&](int tile) {
    const int i = tile * kTile + t;
    nv = false;
    if (t < kTile && i < n) {
      nb = lb[i];
      nv = lv[i] != 0;
    }
  };
  auto stage = [&](int buf) {                   // called by warps 0 and 1
    tile_box[buf][t] = nb;
    tile_area[buf][t] = box_area(nb);
    const unsigned bits = __ballot_sync(0xffffffffu, nv);
    if (wl == 0) reinterpret_cast<unsigned*>(&tile_valid[buf])[warp] = bits;
  };

  if (t < kTile) {
    rows[t] = 0ULL;
    fetch(0);
    stage(0);
    fetch(1);
  }
  if (t == 0) {
    part[0] = part[1] = 0ULL;
    zrows = 0ULL;
  }
  __syncthreads();

  int cnt = 0;
  int tile = 0;
  for (; tile < ntiles && cnt < max_out; ++tile) {
    const int buf = tile & 1;
    const unsigned long long vword = tile_valid[buf];
    // kept boxes crank, crank + C, ... < cnt live here
    const int nloc = cnt > crank ? (cnt - crank + csize - 1) / csize : 0;

    // (b) each valid candidate against this CTA's share of the frontier
    for (int c = warp; c < kTile; c += kWarps) {
      if (!((vword >> c) & 1ULL)) continue;
      const float4 b = tile_box[buf][c];
      const float ab = tile_area[buf][c];
      for (int f0 = 0; f0 < nloc; f0 += 32) {
        const int f = f0 + wl;
        const bool h =
            f < nloc && suppresses(frontier[f], fr_area[f], b, ab, thresh);
        if (__any_sync(0xffffffffu, h)) {
          if (wl == 0) atomicOr(&part[buf], 1ULL << c);
          break;
        }
      }
    }
    PHASE(0)                                    // frontier test
    // the cluster's hit words are complete
    cluster.sync();
    PHASE(1)                                    // cluster barrier

    // every warp ORs them, one rank a thread: the tile's alive boxes
    const unsigned long long hw =
        wl < csize ? cluster.map_shared_rank(part, wl)[buf] : 0ULL;
    const unsigned long long alive =
        vword &
        ~(__reduce_or_sync(0xffffffffu, static_cast<unsigned>(hw)) |
          static_cast<unsigned long long>(__reduce_or_sync(
              0xffffffffu, static_cast<unsigned>(hw >> 32))) << 32);
    PHASE(2)                                    // hit words over DSMEM

    // (c) the tile's own words among its alive boxes: the 2016 pairs
    // {i, i + d mod 64}, d = 1..32 (d = 32 from i < 32 only); a hit sets
    // bit `later` of row `earlier`
    {
      const int i = t % kTile;
      for (int d = 1 + t / kTile; d <= kTile / 2; d += kThreads / kTile) {
        if (d == kTile / 2 && i >= kTile / 2) continue;
        const int j = (i + d) % kTile;
        const int lo = min(i, j);
        const int hi = max(i, j);
        if (((alive >> lo) & (alive >> hi) & 1ULL) &&
            suppresses(tile_box[buf][lo], tile_area[buf][lo],
                       tile_box[buf][hi], tile_area[buf][hi], thresh)) {
          atomicOr(&rows[lo], 1ULL << hi);
          atomicOr(&zrows, 1ULL << lo);
        }
      }
    }
    __syncthreads();
    PHASE(3)                                    // the tile's own pairs

    if (t == 0) {
      // every alive bit below the next nonzero row is kept as is
      unsigned long long keep = alive;
      unsigned long long pending = keep & zrows;
      while (pending) {
        const int i = __ffsll(static_cast<long long>(pending)) - 1;
        keep &= ~rows[i];
        pending = keep & zrows & (~1ULL << i);
      }
      // (e) keep the first max_out - cnt of them
      const int room = max_out - cnt;
      while (__popcll(keep) > room) keep &= ~(1ULL << (63 - __clzll(keep)));
      keep_word = keep;
      // the next tile's hit word: the cluster read it before this barrier
      part[buf ^ 1] = 0ULL;
      zrows = 0ULL;
    }
    __syncthreads();
    PHASE(4)                                    // the walk

    // (d) append: kept box k goes to CTA k mod C, slot k / C
    const unsigned long long keep = keep_word;
    if (t < kTile && ((keep >> t) & 1ULL)) {
      const int k = cnt + __popcll(keep & ((1ULL << t) - 1ULL));
      if (k % csize == crank) {
        frontier[k / csize] = tile_box[buf][t];
        fr_area[k / csize] = tile_area[buf][t];
        out[k] = tile * kTile + t;
      }
    }
    if (t < kTile) {
      rows[t] = 0ULL;
      stage(buf ^ 1);
      fetch(tile + 2);
    }
    __syncthreads();
    PHASE(5)                                    // append, next tile
    cnt += __popcll(keep);
  }
#ifdef NMS_PHASE_CLOCKS
  if (clocked) {
    for (int k = 0; k < kPhases; ++k) phase_clocks[k] = clk[k];
    phase_clocks[kPhases] = tile;
  }
#endif

  // (e) 0 padding after the kept indices; the mask
  bool* out_mask = keep_mask + (size_t)lane * max_out;
  for (int s = crank * kThreads + t; s < max_out; s += csize * kThreads) {
    if (s >= cnt) out[s] = 0;
    out_mask[s] = s < cnt;
  }
  // no CTA leaves while another may still read its hit words
  cluster.sync();
}

}  // namespace

#ifdef NMS_PHASE_CLOCKS
// The last launch's phase cycles and tiles (kPhases + 1 values).
extern "C" int nms_phase_clocks(long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, phase_clocks, sizeof(phase_clocks)));
}
#endif

// The launch of e lanes of `cluster` CTAs, minus its arguments.
static cudaLaunchConfig_t launch_config(int e, int n, int max_out,
                                        int cluster, cudaStream_t stream,
                                        cudaLaunchAttribute* attr,
                                        int* slots) {
  // the frontier never holds more than min(max_out, n) boxes
  const int cap = max_out < n ? max_out : n;
  *slots = (cap + cluster - 1) / cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(e * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)*slots * (sizeof(float4) + sizeof(float));
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(nms_frontier_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The largest cluster size (CTAs per lane, <= 8) at which the current
// device holds all e lanes' clusters at once (cudaOccupancyMaxActiveClusters;
// one 1024-thread CTA per SM); 1 if none does. Negative: a CUDA error.
extern "C" int nms_cluster_size(int e, int n, int max_out) {
  for (int c = kMaxCluster; c > 1; --c) {
    cudaLaunchAttribute attr[1];
    int slots;
    const cudaLaunchConfig_t cfg =
        launch_config(e, n, max_out, c, nullptr, attr, &slots);
    cudaError_t err = allow_smem(cfg.dynamicSmemBytes);
    int clusters = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, nms_frontier_kernel,
                                           &cfg);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (clusters >= e) return c;
  }
  return 1;
}

// boxes (e, n, 4) f32 and valid (e, n) bool, contiguous, 16-byte aligned;
// keep_idx (e, max_out) int32 and keep_mask (e, max_out) bool are written
// in full. `cluster` CTAs (1..8) work on each lane. Returns the CUDA error
// of the launch (0 on success).
extern "C" int nms_launch(const void* boxes, const void* valid, int e, int n,
                          int max_out, float thresh, int cluster,
                          void* keep_idx, void* keep_mask, void* stream) {
  if (e <= 0 || max_out <= 0) return 0;
  if (n < 0 || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  int slots;
  const cudaLaunchConfig_t cfg =
      launch_config(e, n, max_out, cluster,
                    static_cast<cudaStream_t>(stream), attr, &slots);
  cudaError_t err = allow_smem(cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(
      &cfg, nms_frontier_kernel, static_cast<const float4*>(boxes),
      static_cast<const unsigned char*>(valid), n, max_out, slots, thresh,
      static_cast<int*>(keep_idx), static_cast<bool*>(keep_mask));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
