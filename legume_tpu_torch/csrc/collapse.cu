// Pseudobulk collapse of a column-sorted COO block into a resident
// [num_genes, num_groups] f32 plane: out[g, seg_of_col[c]] += v for every
// nonzero (g, c, v); a cell whose segment is outside [0, num_groups) is
// dropped.
//
// Replaces legume_tpu/ops/pallas_kernels.py `collapse_tiled_call`
// (`_collapse_kernel`), the function of `sparse.collapse_block` that
// `collapse.collect_basic_stats` and `collect_matched_stats` accumulate.
//
// What bounds it on an H100: device memory for the entries (4 B gene id +
// 4 B value per nonzero, read once) and the L2 for the scattered adds. The
// plane is at most 2,000 x 1,024 x 4 B = 8 MB on the main path (34,008 x
// 607 x 4 B = 83 MB at the largest shape), so on the main path it stays in
// the 50 MB L2 and the adds resolve there. The TPU kernel turned the
// scatter into one-hot matmuls over host-bucketed (gene tile, group tile)
// chunks because TPU scatter serialises; Hopper has fast L2 atomics, so
// the simple design scatters directly.
//
// Design: one warp per cell walks the cell's contiguous run of nonzeros,
// coalesced, and each lane issues a float atomicAdd (a fire-and-forget RED)
// into the plane. The lanes of a warp touch distinct genes, so they never
// collide on one address; different cells of the same group do. Because of
// the atomics the order of the sums, and so the last bits of the result,
// can change from run to run. A deterministic design (sort entries by
// (gene, group) key, then a segmented reduce) is planned for the redesign.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
collapse_kernel(const int* __restrict__ row_ids, const int* __restrict__ col_ptr,
                const float* __restrict__ vals, const int* __restrict__ seg_of_col,
                float* __restrict__ out, int ncols, int num_groups) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (cell >= ncols) return;
  const int seg = seg_of_col[cell];
  if (seg < 0 || seg >= num_groups) return;
  const int ub = col_ptr[cell + 1];
  for (int j = col_ptr[cell] + lane; j < ub; j += 32) {
    atomicAdd(out + static_cast<size_t>(row_ids[j]) * num_groups + seg, vals[j]);
  }
}

}  // namespace

// row_ids [nnz] int32, col_ptr [ncols + 1] int32, vals [nnz] f32,
// seg_of_col [ncols] int32, out [num_genes, num_groups] f32 (accumulated
// into, not cleared). Returns cudaGetLastError() after the launch.
extern "C" int legume_collapse(const void* row_ids, const void* col_ptr, const void* vals,
                               const void* seg_of_col, void* out, int ncols, int num_groups,
                               void* stream) {
  if (ncols <= 0 || num_groups <= 0) return 0;
  const dim3 grid((ncols + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  collapse_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ids), static_cast<const int*>(col_ptr),
      static_cast<const float*>(vals), static_cast<const int*>(seg_of_col),
      static_cast<float*>(out), ncols, num_groups);
  return static_cast<int>(cudaGetLastError());
}
