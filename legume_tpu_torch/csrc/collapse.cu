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
// 4 B value per nonzero, read once) and one read-modify-write of the
// plane; 46.5 MB and 0.014 ms on the main path's 2,000-gene blocks. The
// first design scattered each nonzero with a float atomicAdd into the
// plane in L2: on a 2-group plane 5.8M atomics fell on 4,000 addresses and
// serialised there, and the order of the adds, so the last bits, changed
// from run to run. The TPU kernel turned the scatter into one-hot matmuls
// over host-bucketed (gene tile, group tile) chunks.
//
// Design: no atomics on floats, and a sum order fixed by the inputs. Every
// warp owns a private gene column in shared memory (a tile of it when the
// column passes ~3,000 genes; each gene tile then rescans the entries).
// Its lanes take four entries of one cell each with 16-byte loads, four
// loads in flight, and add them into the column: the genes of a cell are
// distinct, so lanes do not collide. A run of entries whose genes do not
// strictly increase is added lane by lane, in lane order, so a gene that
// repeats is never lost (right for any cell, fast for cells whose genes
// are sorted, as CSC readers give them). Two paths, picked by
// `ops/kernels.py::collapse_plan` from the shape alone:
//   - Few groups (S < 8; the batch plane, S = 2): the 8 warps of a CTA
//     share a group's cells by cell index, chunks of cells fill the card,
//     each CTA writes a partial [genes, S] plane once, and a second kernel
//     adds the partials into `out` in chunk order.
//   - Many groups (the group, matched and bge planes, S = 256 to 1,024,
//     with sizes skewed by the binary sort): a counting sort orders the
//     kept cells by group, then by index (per-256-cell block counts, one
//     CTA's scan to block bases, and a stable placement in which a block's
//     warps take turns); each group's run is cut into items of at most
//     `cap` cells, a warp each, so one large group spreads over many
//     warps; each item's column goes to a buffer row, and a last kernel
//     adds a group's items in item order and writes `out` through a
//     transposed shared-memory tile, in 128-byte runs.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;  // 16-byte loads a lane has in flight
constexpr unsigned kFull = 0xffffffffu;

// add one run of up to 32 entries (one per lane) into the warp's column;
// unless the run's genes strictly increase, the lanes add one after
// another in lane order, so a gene that repeats is never lost
__device__ __forceinline__ void add_run(float* col, int g, float v, int g0, int dt, int lane) {
  const int gl = g - g0;
  const bool in = g >= 0 && static_cast<unsigned>(gl) < static_cast<unsigned>(dt);
  const int prev = __shfl_up_sync(kFull, g, 1);
  if (__all_sync(kFull, lane == 0 || g < 0 || g > prev)) {
    if (in) col[gl] += v;
    return;
  }
  for (int t = 0; t < 32; ++t) {
    if (lane == t && in) col[gl] += v;
    __syncwarp();
  }
}

// add entries [lb, ub) of one cell, one per lane, into the warp's column
__device__ __forceinline__ void add_scalar(float* col, const int* __restrict__ row_ids,
                                           const float* __restrict__ vals, int lb, int ub, int g0,
                                           int dt, int lane) {
  for (int jb = lb; jb < ub; jb += 32) {
    const int j = jb + lane;
    add_run(col, j < ub ? __ldg(row_ids + j) : -1, j < ub ? __ldg(vals + j) : 0.f, g0, dt, lane);
  }
}

// add four entries a lane (one 16-byte load each of gene ids and values)
// into the warp's column; unless the warp's 128 genes strictly increase,
// the lanes add one after another in lane order, so a gene that repeats
// is never lost
__device__ __forceinline__ void add_quad(float* col, int4 g, float4 v, int g0, int dt, int lane) {
  const int prev = __shfl_up_sync(kFull, g.w, 1);
  const bool inc = g.x < 0 || ((lane == 0 || g.x > prev) && g.y > g.x && g.z > g.y && g.w > g.z);
  const int gi[4] = {g.x - g0, g.y - g0, g.z - g0, g.w - g0};
  const float vi[4] = {v.x, v.y, v.z, v.w};
  if (__all_sync(kFull, inc)) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (gi[m] + g0 >= 0 && static_cast<unsigned>(gi[m]) < static_cast<unsigned>(dt)) {
        col[gi[m]] += vi[m];
      }
    }
    return;
  }
  for (int t = 0; t < 32; ++t) {
    if (lane == t) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (gi[m] + g0 >= 0 && static_cast<unsigned>(gi[m]) < static_cast<unsigned>(dt)) {
          col[gi[m]] += vi[m];
        }
      }
    }
    __syncwarp();
  }
}

// add all entries of one cell into the warp's column, in entry order for
// each gene: a scalar head up to a 16-byte boundary, 16-byte loads of
// four entries a lane (kUnroll loads in flight), a scalar tail
__device__ __forceinline__ void add_cell(float* col, const int* __restrict__ row_ids,
                                         const float* __restrict__ vals, int lb, int ub, int g0,
                                         int dt, int lane) {
  // 16-byte loads need both arrays on 16-byte boundaries; else all scalar
  const bool vec = ((reinterpret_cast<size_t>(row_ids) | reinterpret_cast<size_t>(vals)) & 15) == 0;
  const int a = vec ? min(ub, (lb + 3) & ~3) : ub;
  const int b = a + ((ub - a) & ~3);
  add_scalar(col, row_ids, vals, lb, a, g0, dt, lane);
  for (int jb = a; jb < b; jb += 128 * kUnroll) {
    int4 g[kUnroll];
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = jb + 128 * u + 4 * lane;
      g[u] = j < b ? __ldg(reinterpret_cast<const int4*>(row_ids + j)) : make_int4(-1, -1, -1, -1);
      v[u] = j < b ? __ldg(reinterpret_cast<const float4*>(vals + j)) : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_quad(col, g[u], v[u], g0, dt, lane);
  }
  add_scalar(col, row_ids, vals, b, ub, g0, dt, lane);
}

__global__ void __launch_bounds__(kWarps * 32)
collapse_kernel(const int* __restrict__ row_ids, const int* __restrict__ col_ptr,
                const float* __restrict__ vals, const int* __restrict__ seg_of_col,
                float* __restrict__ out, float* __restrict__ partial, int ncols, int num_genes,
                int num_groups, int replicas, int gene_tile, int chunk_cells, int chunks) {
  extern __shared__ float plane[];  // [kWarps][gene_tile + 4]
  const int stride = gene_tile + 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slots = kWarps / replicas;
  const int g0 = blockIdx.x * gene_tile;
  const int s0 = blockIdx.y * slots;
  const int chunk = blockIdx.z;
  const int c0 = chunk * chunk_cells;
  const int c1 = min(c0 + chunk_cells, ncols);
  const int dt = min(gene_tile, num_genes - g0);

  for (int i = threadIdx.x; i < kWarps * stride; i += blockDim.x) plane[i] = 0.f;
  __syncthreads();

  const int slot = warp % slots;
  const int rep = warp / slots;
  const int my_s = s0 + slot;
  float* col = plane + warp * stride;
  if (my_s < num_groups) {
    for (int base = c0; base < c1; base += 32) {
      const int c = base + lane;
      const int s = c < c1 ? __ldg(seg_of_col + c) : -1;
      unsigned mine = __ballot_sync(kFull, s == my_s && ((c - c0) & (replicas - 1)) == rep);
      while (mine) {
        const int cell = base + __ffs(mine) - 1;
        mine &= mine - 1;
        add_cell(col, row_ids, vals, __ldg(col_ptr + cell), __ldg(col_ptr + cell + 1), g0, dt,
                 lane);
      }
    }
  }
  __syncthreads();

  // replicas in order, then one write of the [dt, slots] tile
  for (int i = threadIdx.x; i < dt * slots; i += blockDim.x) {
    const int gl = i / slots;
    const int t = i - gl * slots;
    const int s = s0 + t;
    if (s >= num_groups) continue;
    float acc = 0.f;
    for (int r = 0; r < replicas; ++r) acc += plane[(t + r * slots) * stride + gl];
    const size_t o = static_cast<size_t>(g0 + gl) * num_groups + s;
    if (chunks == 1) {
      out[o] += acc;
    } else {
      partial[static_cast<size_t>(chunk) * num_genes * num_groups + o] = acc;
    }
  }
}

// out[i] += sum over chunks k, in order, of partial[k, i]
__global__ void collapse_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                long long n, int chunks) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int k = 0; k < chunks; ++k) acc += __ldg(partial + k * n + i);
  out[i] += acc;
}

// ---- many groups: cells ordered by group, cut into balanced items -----

constexpr int kPlanThreads = 1024;
constexpr int kBlockCells = 256;    // cells of one counting block, a thread each
constexpr int kSmemCounts = 12000;  // groups whose counters fit static shared memory

// Counting block b (cells [256 b, 256 b + 256)): its kept cells per
// group, into row b of the [blocks, S] table `bcount`.
__global__ void __launch_bounds__(kBlockCells)
collapse_count(const int* __restrict__ seg_of_col, int ncols, int num_groups,
               int* __restrict__ bcount) {
  int* row = bcount + static_cast<size_t>(blockIdx.x) * num_groups;
  for (int s = threadIdx.x; s < num_groups; s += kBlockCells) row[s] = 0;
  __syncthreads();
  const int c = blockIdx.x * kBlockCells + threadIdx.x;
  if (c < ncols) {
    const int s = seg_of_col[c];
    if (s >= 0 && s < num_groups) atomicAdd(row + s, 1);  // integer counts: exact
  }
}

// One CTA. Per group: its cells over all blocks, then scans over groups
// of (cells, items) into gptr [S + 1] (each group's first position in
// cell order) and iptr [S + 1] (its first item), the item table items[i]
// = {group, first position, end position, 0} and meta[0] = the item
// count; and turns each bcount[b][s] into block b's first position for
// group s.
__global__ void __launch_bounds__(kPlanThreads)
collapse_plan_kernel(int* __restrict__ bcount, int blocks, int num_groups, int cap,
                     int* __restrict__ gptr, int* __restrict__ iptr, int4* __restrict__ items,
                     int* __restrict__ meta) {
  __shared__ int2 warp_sums[kPlanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // each thread takes a contiguous range of groups
  const int per = (num_groups + kPlanThreads - 1) / kPlanThreads;
  const int s_lo = min(tid * per, num_groups);
  const int s_hi = min(s_lo + per, num_groups);
  int2 mine = make_int2(0, 0);  // cells, items
  for (int s = s_lo; s < s_hi; ++s) {
    int n = 0;
    for (int b = 0; b < blocks; ++b) n += bcount[static_cast<size_t>(b) * num_groups + s];
    mine.x += n;
    mine.y += (n + cap - 1) / cap;
  }
  int2 incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, incl.x, o);
    const int y = __shfl_up_sync(kFull, incl.y, o);
    if (lane >= o) {
      incl.x += x;
      incl.y += y;
    }
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int2 run = make_int2(incl.x - mine.x, incl.y - mine.y);
  for (int w = 0; w < warp; ++w) {
    run.x += warp_sums[w].x;
    run.y += warp_sums[w].y;
  }
  for (int s = s_lo; s < s_hi; ++s) {
    gptr[s] = run.x;
    iptr[s] = run.y;
    int pos = run.x;
    for (int b = 0; b < blocks; ++b) {
      int* cell = bcount + static_cast<size_t>(b) * num_groups + s;
      const int n = *cell;
      *cell = pos;
      pos += n;
    }
    const int n = pos - run.x;
    const int it = (n + cap - 1) / cap;
    for (int j = 0; j < it; ++j) {
      items[run.y + j] = make_int4(s, run.x + j * cap, run.x + min((j + 1) * cap, n), 0);
    }
    run.x = pos;
    run.y += it;
  }
  if (tid == kPlanThreads - 1) {
    gptr[num_groups] = run.x;
    iptr[num_groups] = run.y;
    meta[0] = run.y;
  }
}

// Counting block b places its kept cells at order[...], each group's in
// cell order: the block's first position per group (bcount row b) is a
// cursor, and the 8 warps take turns, each ranking its lanes of one
// group with a match.
__global__ void __launch_bounds__(kBlockCells)
collapse_place(const int* __restrict__ seg_of_col, int* __restrict__ bcount,
               int* __restrict__ order, int ncols, int num_groups) {
  __shared__ int cursor_smem[kSmemCounts];
  int* row = bcount + static_cast<size_t>(blockIdx.x) * num_groups;
  int* cursor = num_groups <= kSmemCounts ? cursor_smem : row;
  if (num_groups <= kSmemCounts) {
    for (int s = threadIdx.x; s < num_groups; s += kBlockCells) cursor[s] = row[s];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kBlockCells + threadIdx.x;
  const int s = c < ncols ? seg_of_col[c] : -1;
  const bool kept = s >= 0 && s < num_groups;
  const unsigned peers = __match_any_sync(kFull, kept ? s : -1 - lane);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const bool last = (peers >> lane) == 1u;  // the highest lane of its group
  __syncthreads();
  for (int w = 0; w < kBlockCells / 32; ++w) {
    if (warp == w && kept) {
      const int pos = cursor[s] + rank;
      order[pos] = c;
      __syncwarp(peers);
      if (last) cursor[s] = pos + 1;
    }
    __syncthreads();
  }
}

// A CTA of 8 warps takes 8 consecutive items over one gene tile; a warp
// adds its item's cells, in order, into its private column and writes the
// column to colbuf[item] (one contiguous row per item).
__global__ void __launch_bounds__(kWarps * 32)
collapse_items(const int* __restrict__ row_ids, const int* __restrict__ col_ptr,
               const float* __restrict__ vals, const int* __restrict__ order,
               const int4* __restrict__ items, const int* __restrict__ meta,
               float* __restrict__ colbuf, int num_genes, int gene_tile) {
  extern __shared__ float plane[];  // [kWarps][gene_tile + 4]
  const int stride = gene_tile + 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g0 = blockIdx.x * gene_tile;
  const int dt = min(gene_tile, num_genes - g0);
  const int n_items = meta[0];
  const int i = blockIdx.y * kWarps + warp;
  if (i >= n_items) return;  // whole warps; no CTA-wide barrier follows
  float* col = plane + warp * stride;
  for (int gl = lane; gl < dt; gl += 32) col[gl] = 0.f;
  __syncwarp();
  const int4 it = items[i];
  const int len = it.z - it.y;  // cells, at most 32
  int lb = 0, ub = 0;
  if (lane < len) {
    const int cell = order[it.y + lane];
    lb = col_ptr[cell];
    ub = col_ptr[cell + 1];
  }
  for (int q = 0; q < len; ++q) {
    add_cell(col, row_ids, vals, __shfl_sync(kFull, lb, q), __shfl_sync(kFull, ub, q), g0, dt,
             lane);
  }
  __syncwarp();
  float* dst = colbuf + static_cast<size_t>(i) * num_genes + g0;
  for (int gl = lane; gl < dt; gl += 32) dst[gl] = col[gl];
}

// out[g, s] += the columns of group s's items, in item order. A CTA takes
// 32 genes x 32 groups and turns the tile through shared memory, so that
// it reads item rows and writes rows of `out` in 128-byte runs.
__global__ void __launch_bounds__(256)
collapse_combine(const float* __restrict__ colbuf, const int* __restrict__ iptr,
                 float* __restrict__ out, int num_genes, int num_groups) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;  // 8 rows at a time
  const int g0 = blockIdx.x * 32;
  const int s0 = blockIdx.y * 32;
  for (int r = ty; r < 32; r += 8) {
    const int s = s0 + r;
    const int g = g0 + tx;
    float acc = 0.f;
    if (s < num_groups && g < num_genes) {
      // item i goes to partial sum (i - first) % 8, then the 8 in order:
      // a fixed order, with 8 loads in flight for a group of many items
      const int i0 = iptr[s];
      const int i1 = iptr[s + 1];
      float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int i = i0;
      for (; i + 8 <= i1; i += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          part[u] += __ldg(colbuf + static_cast<size_t>(i + u) * num_genes + g);
        }
      }
      for (int u = 0; i < i1; ++i, ++u) part[u] += __ldg(colbuf + static_cast<size_t>(i) * num_genes + g);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += part[u];
    }
    tile[r][tx] = acc;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int g = g0 + r;
    const int s = s0 + tx;
    if (g < num_genes && s < num_groups) out[static_cast<size_t>(g) * num_groups + s] += tile[tx][r];
  }
}

struct ManyGroups {  // the many-group path's scratch layout, in 4-byte words
  long long max_items, blocks, items, bcount, gptr, iptr, order, meta, colbuf, words;
};

ManyGroups many_groups(int ncols, int num_genes, int num_groups, int cap) {
  ManyGroups m;
  m.max_items = min(static_cast<long long>(ncols),
                    ncols / cap + static_cast<long long>(min(num_groups, ncols)));
  m.blocks = (ncols + kBlockCells - 1) / kBlockCells;
  m.items = 0;  // the int4 table first, 16-byte aligned
  m.bcount = 4 * m.max_items;
  m.gptr = m.bcount + m.blocks * num_groups;
  m.iptr = m.gptr + num_groups + 1;
  m.order = m.iptr + num_groups + 1;
  m.meta = m.order + ncols;
  m.colbuf = (m.meta + 1 + 3) / 4 * 4;
  m.words = m.colbuf + m.max_items * num_genes;
  return m;
}

}  // namespace

// 4-byte words of scratch a call needs: with cap == 0 (few groups) the
// chunk partials, else the many-group path's tables and item columns.
extern "C" long long legume_collapse_scratch(int ncols, int num_genes, int num_groups, int chunks,
                                             int cap) {
  if (ncols <= 0 || num_genes <= 0 || num_groups <= 0) return 0;
  if (cap == 0) return chunks > 1 ? static_cast<long long>(chunks) * num_genes * num_groups : 0;
  return many_groups(ncols, num_genes, num_groups, cap).words;
}

// row_ids [nnz] int32, col_ptr [ncols + 1] int32, vals [nnz] f32,
// seg_of_col [ncols] int32, out [num_genes, num_groups] f32 (accumulated
// into, not cleared), scratch of legume_collapse_scratch() words, 16-byte
// aligned. cap == 0 takes the few-group path: replicas a power of two
// dividing 8, chunk_cells * chunks >= ncols. cap in [1, 32] takes the
// many-group path with items of at most cap cells. gene_tile is a
// multiple of 32. Returns cudaGetLastError() after the launches.
extern "C" int legume_collapse(const void* row_ids, const void* col_ptr, const void* vals,
                               const void* seg_of_col, void* out, void* scratch, int ncols,
                               int num_genes, int num_groups, int replicas, int gene_tile,
                               int chunk_cells, int chunks, int cap, void* stream) {
  if (ncols <= 0 || num_genes <= 0 || num_groups <= 0) return 0;
  if (gene_tile < 32 || gene_tile % 32 != 0 || cap < 0 || cap > 32 ||
      (cap == 0 && (replicas < 1 || kWarps % replicas != 0 ||
                    (replicas & (replicas - 1)) != 0 || chunk_cells < 1 || chunks < 1 ||
                    static_cast<long long>(chunk_cells) * chunks < ncols))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kWarps) * (gene_tile + 4) * sizeof(float);
  const int gene_tiles = (num_genes + gene_tile - 1) / gene_tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(row_ids);
  const int* p = static_cast<const int*>(col_ptr);
  const float* v = static_cast<const float*>(vals);
  const int* sg = static_cast<const int*>(seg_of_col);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (cap == 0) {
    err = cudaFuncSetAttribute(collapse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int slots = kWarps / replicas;
    const dim3 grid(gene_tiles, (num_groups + slots - 1) / slots, chunks);
    float* partial = static_cast<float*>(scratch);
    collapse_kernel<<<grid, kWarps * 32, smem, s>>>(r, p, v, sg, o, partial, ncols, num_genes,
                                                    num_groups, replicas, gene_tile,
                                                    chunk_cells, chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
    const long long n = static_cast<long long>(num_genes) * num_groups;
    collapse_reduce<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(partial, o, n, chunks);
    return static_cast<int>(cudaGetLastError());
  }
  const ManyGroups m = many_groups(ncols, num_genes, num_groups, cap);
  int* w = static_cast<int*>(scratch);
  int4* items = reinterpret_cast<int4*>(w + m.items);
  float* colbuf = reinterpret_cast<float*>(w + m.colbuf);
  const int blocks = static_cast<int>(m.blocks);
  collapse_count<<<blocks, kBlockCells, 0, s>>>(sg, ncols, num_groups, w + m.bcount);
  collapse_plan_kernel<<<1, kPlanThreads, 0, s>>>(w + m.bcount, blocks, num_groups, cap,
                                                  w + m.gptr, w + m.iptr, items, w + m.meta);
  collapse_place<<<blocks, kBlockCells, 0, s>>>(sg, w + m.bcount, w + m.order, ncols,
                                                 num_groups);
  err = cudaFuncSetAttribute(collapse_items, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(gene_tiles, static_cast<unsigned>((m.max_items + kWarps - 1) / kWarps));
  collapse_items<<<grid, kWarps * 32, smem, s>>>(r, p, v, w + m.order, items, w + m.meta, colbuf,
                                                 num_genes, gene_tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 cgrid((num_genes + 31) / 32, (num_groups + 31) / 32);
  collapse_combine<<<cgrid, 256, 0, s>>>(colbuf, w + m.iptr, o, num_genes, num_groups);
  return static_cast<int>(cudaGetLastError());
}
