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
// Shape follows the reference's lib/nms/src/cuda/nms_kernel.cu:
//   pass 1 (nms_mask_kernel): one 64-thread block per (lane, row tile,
//     column tile) of the upper triangle writes a 64-bit word per row:
//     bit j set iff row i suppresses column box j (j > i).
//   pass 2 (nms_reduce_kernel): one warp per lane walks the boxes in
//     order with the removed-bits in shared memory, ORs each kept row's
//     words into it, stops at max_out, and writes keep_idx / keep_mask
//     itself, so a request has no host synchronisation.
//
// What bounds it on an H100: pass 2 is a serial chain per lane (one
// dependent global read of the kept row per kept box), so it is bound by
// latency, not by bytes (the inputs are 16 x 6000 x 17 B = 1.6 MB) or by
// operations (~0.3 G pair IoUs in pass 1, a few tens of microseconds of
// f32 work). The design keeps the chain short: free boxes are found with
// __ffsll over the removed word instead of a per-box test, the 64 boxes of
// a word need no global read unless one is kept, and the lanes run as
// independent blocks on separate SMs.
//
// Bit identity with the f32 reference: the IoU is written with explicit
// round-to-nearest intrinsics (no FMA contraction; the file is also built
// with -fmad=false) in the reference's operation order, and compared in
// f32 against the f32 threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// IoU(a, b) > thresh, as ops/boxes.py::box_iou computes it in f32:
// inter = max(min(x2) - max(x1) + 1, 0) * max(min(y2) - max(y1) + 1, 0);
// union = (area_a + area_b) - inter; iou = inter / union.
__device__ __forceinline__ bool suppresses(const float4 a, float area_a,
                                           const float4 b, float area_b,
                                           float thresh) {
  const float ix1 = fmaxf(a.x, b.x);
  const float iy1 = fmaxf(a.y, b.y);
  const float ix2 = fminf(a.z, b.z);
  const float iy2 = fminf(a.w, b.w);
  const float iw = fmaxf(__fadd_rn(__fsub_rn(ix2, ix1), 1.0f), 0.0f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(iy2, iy1), 1.0f), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, uni) > thresh;
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, int n, int col_blocks,
                float thresh, unsigned long long* __restrict__ mask) {
  const int col_start = blockIdx.x;
  const int row_start = blockIdx.y;
  const int lane = blockIdx.z;
  // lower-triangle tiles are never read by the reduce pass
  if (row_start > col_start) return;

  const int row_size = min(n - row_start * kTile, kTile);
  const int col_size = min(n - col_start * kTile, kTile);
  const float4* lane_boxes = boxes + (size_t)lane * n;

  __shared__ float4 col_boxes[kTile];
  __shared__ float col_area[kTile];
  if (threadIdx.x < col_size) {
    const float4 b = lane_boxes[col_start * kTile + threadIdx.x];
    col_boxes[threadIdx.x] = b;
    col_area[threadIdx.x] = box_area(b);
  }
  __syncthreads();

  if (threadIdx.x < row_size) {
    const int i = row_start * kTile + threadIdx.x;
    const float4 b = lane_boxes[i];
    const float area = box_area(b);
    unsigned long long bits = 0ULL;
    const int start = (row_start == col_start) ? threadIdx.x + 1 : 0;
    for (int j = start; j < col_size; ++j) {
      if (suppresses(b, area, col_boxes[j], col_area[j], thresh)) {
        bits |= 1ULL << j;
      }
    }
    mask[((size_t)lane * n + i) * col_blocks + col_start] = bits;
  }
}

__global__ void __launch_bounds__(32)
nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                  const unsigned char* __restrict__ valid, int n,
                  int col_blocks, int max_out, int* __restrict__ keep_idx,
                  bool* __restrict__ keep_mask) {
  extern __shared__ unsigned long long removed[];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const unsigned char* v = valid + (size_t)lane * n;

  // start with invalid rows and the tail past n marked removed
  for (int w = t; w < col_blocks; w += 32) {
    unsigned long long bits = 0ULL;
    for (int b = 0; b < kTile; ++b) {
      const int i = w * kTile + b;
      if (i >= n || !v[i]) bits |= 1ULL << b;
    }
    removed[w] = bits;
  }
  __syncwarp();

  const unsigned long long* lane_mask =
      mask + (size_t)lane * n * col_blocks;
  int* out = keep_idx + (size_t)lane * max_out;
  int cnt = 0;
  // every thread runs the same control flow on the same values; the
  // threads split only the OR of each kept row into the later words
  for (int nb = 0; nb < col_blocks && cnt < max_out; ++nb) {
    unsigned long long cur = removed[nb];
    while (cur != ~0ULL && cnt < max_out) {
      const int ib = __ffsll((long long)~cur) - 1;
      const int i = nb * kTile + ib;
      if (t == 0) out[cnt] = i;
      ++cnt;
      cur |= 1ULL << ib;
      if (cnt == max_out) break;
      const unsigned long long* row = lane_mask + (size_t)i * col_blocks;
      cur |= row[nb];
      for (int w = nb + 1 + t; w < col_blocks; w += 32) removed[w] |= row[w];
    }
    __syncwarp();
  }

  bool* out_mask = keep_mask + (size_t)lane * max_out;
  for (int s = t; s < max_out; s += 32) {
    if (s >= cnt) out[s] = 0;
    out_mask[s] = s < cnt;
  }
}

}  // namespace

// boxes (e, n, 4) f32 and valid (e, n) bool, contiguous, 16-byte aligned;
// mask_scratch holds e * n * ceil(n / 64) 64-bit words; keep_idx (e,
// max_out) int32 and keep_mask (e, max_out) bool are written in full.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int nms_launch(const void* boxes, const void* valid, int e, int n,
                          int max_out, float thresh, void* mask_scratch,
                          void* keep_idx, void* keep_mask, void* stream) {
  if (e <= 0 || max_out <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kTile - 1) / kTile;
  if (n > 0) {
    const dim3 grid(col_blocks, col_blocks, e);
    nms_mask_kernel<<<grid, kTile, 0, s>>>(
        static_cast<const float4*>(boxes), n, col_blocks, thresh,
        static_cast<unsigned long long*>(mask_scratch));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_reduce_kernel<<<e, 32, (size_t)col_blocks * sizeof(unsigned long long),
                      s>>>(
      static_cast<const unsigned long long*>(mask_scratch),
      static_cast<const unsigned char*>(valid), n, col_blocks, max_out,
      static_cast<int*>(keep_idx), static_cast<bool*>(keep_mask));
  return static_cast<int>(cudaGetLastError());
}
