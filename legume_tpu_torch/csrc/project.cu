// Sparse JL projection of a column-sorted COO block: out[c, :] = sum over
// the nonzeros (g, c, v) of cell c of w(v) * basis[g, :].
//
// Replaces two Pallas kernels of the JAX package:
//   - legume_tpu/ops/pallas_kernels.py `tiled_call` (`_tiled_kernel`), the
//     projection of `random_projection._project_block_normed`: normed mode,
//     w = log1p(v), and the row is divided by max(sqrt(sum w^2), 1e-8);
//   - legume_tpu/ops/pallas_kernels.py `coo_project_pallas` (`_kernel`), the
//     function of `sparse.project_block`: raw mode, w = v, no norm.
//
// What bounds it on an H100: device memory, if the basis stays in L2. Each
// nonzero is read once (4 B gene id + 4 B value), each output row written
// once (K * 4 B), and the basis rows gathered per nonzero come from L2
// (34,008 x 64 x 4 B = 8.7 MB at the largest shape, well inside the 50 MB
// L2). The TPU kernel bucketed entries on the host into (gene tile, cell
// tile) chunks so that gather and scatter became one-hot matmuls; here the
// block's column sort already gives each cell a contiguous run of
// nonzeros, so no bucketing is needed.
//
// Design: one warp per cell. The warp loads 32 (gene, value) pairs at a
// time, coalesced, then broadcasts them one by one with shuffles; lane l
// owns output columns l, l + 32, l + 64 and l + 96 (K <= 128) and
// accumulates w * basis[g, col] in registers, so each basis row is read as
// one coalesced 128-byte line per 32 columns. No atomics: the sum order is
// the entry order within the cell, so the result is the same every run.
// Simple first; tiling the basis through shared memory, or wgmma over
// gathered tiles, is work for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxK = 128;
constexpr int kColsPerLane = kMaxK / 32;

template <bool kNormed>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
project_kernel(const int* __restrict__ row_ids, const int* __restrict__ col_ptr,
               const float* __restrict__ vals, const float* __restrict__ basis,
               float* __restrict__ out, int ncols, int k) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (cell >= ncols) return;  // whole warp leaves together
  const int lb = col_ptr[cell];
  const int ub = col_ptr[cell + 1];

  float acc[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;
  float sq = 0.f;

  for (int base = lb; base < ub; base += 32) {
    const int j = base + lane;
    int g = 0;
    float w = 0.f;
    if (j < ub) {
      g = row_ids[j];
      w = vals[j];
      if (kNormed) {
        w = log1pf(w);
        sq += w * w;
      }
    }
    const int n = min(32, ub - base);
    for (int t = 0; t < n; ++t) {
      const int gt = __shfl_sync(0xffffffffu, g, t);
      const float wt = __shfl_sync(0xffffffffu, w, t);
      const float* brow = basis + static_cast<size_t>(gt) * k;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int col = lane + 32 * c;
        if (col < k) acc[c] += wt * __ldg(brow + col);
      }
    }
  }

  float norm = 1.f;
  if (kNormed) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    norm = fmaxf(sqrtf(sq), 1e-8f);
  }
  float* orow = out + static_cast<size_t>(cell) * k;
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    const int col = lane + 32 * c;
    if (col < k) orow[col] = kNormed ? acc[c] / norm : acc[c];
  }
}

}  // namespace

// row_ids [nnz] int32, col_ptr [ncols + 1] int32, vals [nnz] f32,
// basis [D, k] f32 row-major with k <= 128, out [ncols, k] f32.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int legume_project(const void* row_ids, const void* col_ptr, const void* vals,
                              const void* basis, void* out, int ncols, int k, int normed,
                              void* stream) {
  if (ncols <= 0) return 0;
  if (k <= 0 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ncols + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(row_ids);
  const int* p = static_cast<const int*>(col_ptr);
  const float* v = static_cast<const float*>(vals);
  const float* b = static_cast<const float*>(basis);
  float* o = static_cast<float*>(out);
  if (normed) {
    project_kernel<true><<<grid, block, 0, s>>>(r, p, v, b, o, ncols, k);
  } else {
    project_kernel<false><<<grid, block, 0, s>>>(r, p, v, b, o, ncols, k);
  }
  return static_cast<int>(cudaGetLastError());
}
