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
// What bounds it on an H100: the bytes that must move are each nonzero
// once (4 B gene id + 4 B value), the basis once and each output row once
// (48.5 MB, 0.0145 ms at the main path's 2,000-gene block); the operations
// are 2 K per nonzero. The first design (one warp per cell) gathered a
// K-wide basis row from L2 for every nonzero: 1.16 GB at that block, 24x
// the bytes above, and it ran at about the rate of those gathers. The TPU
// kernel bucketed entries on the host into (gene tile, cell tile) chunks
// for one-hot matmuls.
//
// Design: reuse each basis row from shared memory across the cells of a
// CTA. A CTA takes 128 cells (32 warps, 4 cells each) and one slice of 16
// basis columns (grid: cell tile, slice), so any K works. It stages the
// slice's basis rows into shared memory with cp.async, a gene tile at a
// time: at 2,000 genes the whole slice is one tile (128 KB); above 3,632
// genes tiles of 1,536 rows are double-buffered, the next one loading
// while the current one is used. In a round each lane loads one entry of
// each of its warp's cells (coalesced), and the warp then broadcasts them
// 8 at a time with shuffles, in four unrolled sub-steps: lane (e, q) takes
// entry e of the 8 and multiplies columns 4q..4q+3 of its basis row, read
// as one 16-byte shared load, into per-cell register sums. At the end the
// 8 entry groups are added by a butterfly and one lane quad writes the
// row. What bounds this design is latency, not bytes: 32 warps per SM
// (56 registers a thread) with 4 cells' loads in flight each; a
// 16-warp, 16-cell form (128 registers) was slower. Each slice
// rereads its cells' entries (4x at K = 50), mostly from L2.
// A pre-pass (one warp per cell) writes the normed mode's weights
// log1p(v) and row norm once per cell, whatever the number of slices,
// and with several gene tiles records where each tile starts in each
// cell's entries and whether the cell's genes increase; a cell whose
// genes do not is rescanned whole in every tile, with the entries outside
// the tile masked. Every sum runs in an order fixed by the shape, so the
// result is the same every run; no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 32;
constexpr int kCellsPerWarp = 4;
constexpr int kCellsPerCta = kWarps * kCellsPerWarp;
constexpr int kSlice = 16;  // basis columns per CTA: 4 lanes x 4 columns
constexpr int kIlp = 4;     // cells whose entries a round loads together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [g0, g0 + dt) x columns [k0, k0 + kSlice) of the basis into dst
// [dt][kSlice]; columns at or past k are zero-filled. 16-byte copies when
// every basis row starts on a 16-byte boundary, else 4-byte ones.
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ basis, int k,
                                           int g0, int dt, int k0) {
  if ((k & 3) == 0 && (reinterpret_cast<size_t>(basis) & 15) == 0) {
    for (int i = threadIdx.x; i < dt * (kSlice / 4); i += blockDim.x) {
      const int r = i / (kSlice / 4);
      const int q = i - r * (kSlice / 4);
      const int col = k0 + 4 * q;
      const bool in = col < k;
      cp_async16(dst + r * kSlice + 4 * q,
                 basis + static_cast<size_t>(g0 + r) * k + (in ? col : 0), in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < dt * kSlice; i += blockDim.x) {
      const int r = i / kSlice;
      const int q = i - r * kSlice;
      const int col = k0 + q;
      const bool in = col < k;
      cp_async4(dst + r * kSlice + q, basis + static_cast<size_t>(g0 + r) * k + (in ? col : 0),
                in ? 4 : 0);
    }
  }
  cp_async_commit();
}

// One warp per cell: the normed mode's weights log1p(v) (into wts) and
// row norm, and with several gene tiles where each tile's entries start
// (bounds[c][t], t in [0, tiles]) and whether the cell's genes strictly
// increase (sorted[c]).
template <bool kNormed, bool kTiled>
__global__ void __launch_bounds__(256)
project_prep(const int* __restrict__ row_ids, const int* __restrict__ col_ptr,
             const float* __restrict__ vals, float* __restrict__ wts, float* __restrict__ norm,
             int* __restrict__ bounds, int* __restrict__ sorted, int ncols, int gene_tile,
             int tiles) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (cell >= ncols) return;  // whole warp leaves together
  const int lb = col_ptr[cell];
  const int ub = col_ptr[cell + 1];
  int* bnd = kTiled ? bounds + static_cast<size_t>(cell) * (tiles + 1) : nullptr;
  float sq = 0.f;
  bool inc = true;
  int last_tile = -1;  // tile of the entry before this run
  int last_gene = -1;
  for (int base = lb; base < ub; base += 32) {
    const int j = base + lane;
    const bool valid = j < ub;
    if (kNormed && valid) {
      const float w = log1pf(vals[j]);
      wts[j] = w;
      sq += w * w;
    }
    if (kTiled) {
      const int g = valid ? row_ids[j] : 0;
      int prev = __shfl_up_sync(kFull, g, 1);
      if (lane == 0) prev = last_gene;
      inc = inc && __all_sync(kFull, !valid || g > prev);
      const int t = g / gene_tile;
      int pt = __shfl_up_sync(kFull, t, 1);
      if (lane == 0) pt = last_tile;
      // this entry starts every tile after the previous entry's
      if (valid) {
        for (int u = pt + 1; u <= min(t, tiles - 1); ++u) bnd[u] = j;
      }
      const int n = min(32, ub - base);
      last_gene = __shfl_sync(kFull, g, n - 1);
      last_tile = __shfl_sync(kFull, t, n - 1);
    }
  }
  if (kTiled) {
    for (int u = last_tile + 1 + lane; u <= tiles; u += 32) bnd[u] = ub;
    if (lane == 0) sorted[cell] = inc ? 1 : 0;
  }
  if (kNormed) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(kFull, sq, o);
    if (lane == 0) norm[cell] = fmaxf(sqrtf(sq), 1e-8f);
  }
}

// vals holds the weights w: v itself in raw mode, log1p(v) from the
// pre-pass in normed mode (then `norm` holds the row norms)
template <bool kNormed>
__global__ void __launch_bounds__(kWarps * 32, 1)
project_kernel(const int* __restrict__ row_ids, const int* __restrict__ col_ptr,
               const float* __restrict__ vals, const float* __restrict__ basis,
               const float* __restrict__ norm, const int* __restrict__ bounds,
               const int* __restrict__ sorted, float* __restrict__ out, int ncols, int num_genes,
               int k, int gene_tile, int tiles) {
  extern __shared__ __align__(16) float sb[];  // [min(tiles, 2)][gene_tile][kSlice]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = lane >> 2;  // entry of the 8 a sub-step broadcasts
  const int q = lane & 3;   // column quad
  const int k0 = blockIdx.y * kSlice;
  const int cell0 = blockIdx.x * kCellsPerCta + warp * kCellsPerWarp;
  // lane i < kCellsPerWarp keeps cell i's entry range and tile layout
  const int my_cell = cell0 + lane;
  const bool has_cell = lane < kCellsPerWarp && my_cell < ncols;
  const int my_lb = has_cell ? col_ptr[my_cell] : 0;
  const int my_ub = has_cell ? col_ptr[my_cell + 1] : 0;
  const bool my_sorted = tiles == 1 || (has_cell && sorted[my_cell] != 0);

  float acc[kCellsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kCellsPerWarp; ++i) {
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[i][m] = 0.f;
  }

  const size_t tile_floats = static_cast<size_t>(gene_tile) * kSlice;
  stage_tile(sb, basis, k, 0, min(gene_tile, num_genes), k0);
  for (int t = 0; t < tiles; ++t) {
    const int g0 = t * gene_tile;
    if (t + 1 < tiles) {
      const int g1 = g0 + gene_tile;
      stage_tile(sb + ((t + 1) & 1) * tile_floats, basis, k, g1,
                 min(gene_tile, num_genes - g1), k0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tile = sb + (t & 1) * tile_floats;

    int lo = my_lb, hi = my_ub;
    if (tiles > 1 && has_cell && my_sorted) {
      const int* bnd = bounds + static_cast<size_t>(my_cell) * (tiles + 1);
      lo = bnd[t];
      hi = bnd[t + 1];
    }
    int len = hi - lo;
    int rounds = (len + 31) >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) rounds = max(rounds, __shfl_xor_sync(kFull, rounds, o));

    for (int r = 0; r < rounds; ++r) {
#pragma unroll
      for (int h = 0; h < kCellsPerWarp; h += kIlp) {
        int g[kIlp];
        float w[kIlp];
        int n[kIlp];
#pragma unroll
        for (int i = 0; i < kIlp; ++i) {
          const int ci_lo = __shfl_sync(kFull, lo, h + i);
          n[i] = min(32, __shfl_sync(kFull, len, h + i) - 32 * r);
          const int j = ci_lo + 32 * r + lane;
          const bool valid = lane < n[i];
          g[i] = valid ? __ldg(row_ids + j) : -1;
          w[i] = valid ? __ldg(vals + j) : 0.f;
        }
        // four predicated sub-steps of 8 entries each, unrolled so that
        // the shuffles and shared loads of one cell's sub-steps overlap
#pragma unroll
        for (int i = 0; i < kIlp; ++i) {
          if (n[i] <= 0) continue;  // warp-uniform
#pragma unroll
          for (int u = 0; u < 32; u += 8) {
            const int gu = __shfl_sync(kFull, g[i], u + e);
            const float wu = __shfl_sync(kFull, w[i], u + e);
            const int gl = gu - g0;
            if (u + e < n[i] && static_cast<unsigned>(gl) < static_cast<unsigned>(gene_tile)) {
              const float4 b = *reinterpret_cast<const float4*>(tile + gl * kSlice + 4 * q);
              acc[h + i][0] += wu * b.x;
              acc[h + i][1] += wu * b.y;
              acc[h + i][2] += wu * b.z;
              acc[h + i][3] += wu * b.w;
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer is restaged two tiles on
  }

#pragma unroll
  for (int i = 0; i < kCellsPerWarp; ++i) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) acc[i][m] += __shfl_xor_sync(kFull, acc[i][m], o);
    }
    const int cell = cell0 + i;
    if (e == 0 && cell < ncols) {
      const float nrm = kNormed ? norm[cell] : 1.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int col = k0 + 4 * q + m;
        if (col < k) {
          out[static_cast<size_t>(cell) * k + col] = kNormed ? acc[i][m] / nrm : acc[i][m];
        }
      }
    }
  }
}

template <bool kNormed>
int launch(const int* r, const int* p, const float* v, const float* b, float* o, float* wts,
           float* norm, int* bounds, int* sorted, int ncols, int num_genes, int k, int gene_tile,
           int tiles, cudaStream_t s) {
  if (kNormed || tiles > 1) {
    const dim3 pgrid((ncols + 7) / 8);
    if (kNormed && tiles > 1) {
      project_prep<true, true><<<pgrid, 256, 0, s>>>(r, p, v, wts, norm, bounds, sorted, ncols,
                                                      gene_tile, tiles);
    } else if (kNormed) {
      project_prep<true, false><<<pgrid, 256, 0, s>>>(r, p, v, wts, norm, bounds, sorted, ncols,
                                                       gene_tile, tiles);
    } else {
      project_prep<false, true><<<pgrid, 256, 0, s>>>(r, p, v, wts, norm, bounds, sorted, ncols,
                                                       gene_tile, tiles);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = static_cast<size_t>(tiles > 1 ? 2 : 1) * gene_tile * kSlice * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      project_kernel<kNormed>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ncols + kCellsPerCta - 1) / kCellsPerCta, (k + kSlice - 1) / kSlice);
  project_kernel<kNormed><<<grid, kWarps * 32, smem, s>>>(
      r, p, kNormed ? wts : v, b, norm, bounds, sorted, o, ncols, num_genes, k, gene_tile, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row_ids [nnz] int32, col_ptr [ncols + 1] int32, vals [nnz] f32,
// basis [num_genes, k] f32 row-major, out [ncols, k] f32. Scratch: wts
// [nnz] and norm [ncols] f32 (normed mode), bounds [ncols, tiles + 1]
// int32 and sorted [ncols] int32 (tiles > 1). gene_tile >= num_genes when tiles == 1, else
// tiles = ceil(num_genes / gene_tile). Returns cudaGetLastError() after
// the launches (0 = success).
extern "C" int legume_project(const void* row_ids, const void* col_ptr, const void* vals,
                              const void* basis, void* out, void* wts, void* norm, void* bounds,
                              void* sorted, int ncols, int num_genes, int k, int normed,
                              int gene_tile, int tiles, void* stream) {
  if (ncols <= 0) return 0;
  if (k <= 0 || num_genes <= 0 || gene_tile <= 0 || tiles < 1 ||
      static_cast<long long>(gene_tile) * tiles < num_genes ||
      (tiles == 1 && gene_tile < num_genes) ||
      static_cast<size_t>(tiles > 1 ? 2 : 1) * gene_tile * kSlice * sizeof(float) > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(row_ids);
  const int* p = static_cast<const int*>(col_ptr);
  const float* v = static_cast<const float*>(vals);
  const float* b = static_cast<const float*>(basis);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(wts);
  float* nm = static_cast<float*>(norm);
  int* bd = static_cast<int*>(bounds);
  int* so = static_cast<int*>(sorted);
  return normed
             ? launch<true>(r, p, v, b, o, w, nm, bd, so, ncols, num_genes, k, gene_tile, tiles, s)
             : launch<false>(r, p, v, b, o, w, nm, bd, so, ncols, num_genes, k, gene_tile, tiles, s);
}
