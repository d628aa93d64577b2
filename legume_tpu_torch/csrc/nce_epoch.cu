// One epoch of the expected-NCE objective: the loss and the gradients in
// one pass over the [P, D] count plane, for count planes in f32 or bf16.
//
//   s    = e_a . e_f^T + b_f + b_a                       [P, D], never stored
//   a    = c + k_neg * (m_p * q_g)                       never stored
//   loss = sum c*s - a*softplus(s)
//   g_s  = c - a*sigmoid(s)                              [P, D], never stored
//   g_ea = g_s . e_f,  g_ef = g_s^T . e_a,  g_ba = row sums,  g_bf = column sums
//
// Unscaled: the caller multiplies by -1/total and adds the ridge term. The
// axis form (need_feat = 0, bge's phase 2, where the feature side is frozen)
// skips g_ef and g_bf: their product, their partial planes and their sums.
//
// Replaces legume_tpu/embedding/nce_pallas.py `_epoch_call` (`_epoch_kernel`),
// the phase-1 step of `embedding/nce.py::fit_bge` (and, in the port, its
// phase-2 block fit as well).
//
// What bounds it on an H100: at the anchor shape (P = 2,627, D = 34,008,
// H = 16) the CUDA cores do the score product (2*P*D*H) and ~20 operations
// per element in f32, 4.6 GFLOP or 0.069 ms at 67 TFLOP/s; the tensor cores
// do the two backward products in split TF32, 3 x 4*P*D*H = 17 GFLOP or
// 0.035 ms at 495 TFLOP/s, alongside. The inputs and outputs are 362 MB
// with f32 counts (0.108 ms at 3.35 TB/s) and 184 MB with bf16 counts
// (0.055 ms). So the bound is 0.108 ms (bytes) in f32 and 0.069 ms (the
// CUDA cores' operations) in bf16.
//
// Precision. The two backward products run on the tensor cores in split
// TF32: x = big + small with big = to_tf32(x), small = to_tf32(x - big),
// and a.b ~ a_big.b_big + a_big.b_small + a_small.b_big (three mma.sync),
// because one TF32 pass (10 mantissa bits) puts the gradients past the
// 1e-4 normwise bar against the f32 plain version on an anchor-like plane
// (tests/test_torch_schedule.py emulates both). The score runs in f32 on
// the CUDA cores (16 FMAs an element at H = 16): split TF32 still
// represents each e_a and e_f entry with an error of ~2^-22, and that
// error is the same for every element of its row or column, so the bias
// gradients, which sum g_s = c - a*sigmoid(s) along rows and columns with
// a in the thousands on pseudobulk planes, gather it coherently and left
// the 1e-4 bar on bge's trained phase-1 plane (chip_smoke.py; the same
// test file emulates such a plane); f32 rounding does not line up that way.
//
// Design (deterministic, no atomics):
// - A CTA of 4 warps takes a band of rows in chunks of 64 (16 per warp)
//   and a range of genes in tiles of 64; the grid is (gene ranges, row
//   bands), chosen by `ops/kernels.py::nce_plan` from (P, D, H) alone. The
//   chunk's e_a and the tile's e_f are staged in shared memory (H padded
//   with zeros to a multiple of 16); at H <= 16 they come through
//   registers one iteration ahead, so their loads overlap the work.
// - Per 8-gene n-tile each lane scores the four elements of an mma.sync C
//   fragment (rows g, g + 8 of its warp's 16, genes 2t, 2t + 1) with
//   float4 loads of e_a and e_f rows, runs the epilogue on them in
//   registers, and feeds them straight back as the A fragment of
//   g_ea += g_s . e_f (k = t is gene 2t and k = t + 4 gene 2t + 1, so
//   e_f's rows are read in that order and no value moves between lanes).
//   g_ea and the row sums g_ba stay in registers over the CTA's gene range.
// - g_ef^T = e_a^T . g_s needs g_s with rows as k: each lane stores its
//   g_s values once to a [64 rows x 64 genes] tile (over the f32 count
//   tile it has just read), and after a barrier each warp takes two of the
//   tile's 8-gene n-tiles per 16-column block, summing over the chunk's 64
//   rows; the column sums g_bf come from the same loads. The results are
//   added to a shared accumulator of the gene range that one lane owns per
//   entry, chunk after chunk.
// - Count tiles come through cp.async 16-byte copies, double-buffered, one
//   (chunk, tile) ahead; a plane whose rows do not start on 16 bytes (D not
//   a multiple of 4 in f32, of 8 in bf16) is staged with plain loads.
//   Rows and genes outside [P, D] are zero-filled: zero counts, masses and
//   q contribute nothing to the loss or the gradients.
// - Cross-CTA sums: each CTA writes its g_ea | g_ba for its band's rows
//   ([ranges, P, H + 1]) and its g_ef | g_bf for its range's genes
//   ([bands, D, H + 1]); a second kernel sums them in a fixed order, a third
//   the loss partials. Bands and ranges hold many chunks and tiles, so the
//   partials stay under 40 MB at the anchor (47.5 MB of g_ea partials alone
//   before).
//
// What this does about the old kernel's limits: its products read both
// operands from shared memory per FMA (~2.7 wavefronts an element); here a
// tensor-core fragment load serves 8 to 16 multiply-adds, and the score
// reads float4s that 8 lanes share. Its plan ran 2 CTAs an SM walking 83
// chunks; here three CTAs share an SM and the plan fits the grid to them.
// Its g_ea partials were written per 128-gene tile; here per gene range.
// The axis form writes no feature-side partial at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;    // rows per chunk, 16 per warp
constexpr int kGenes = 64;            // genes per tile
constexpr int kNTiles = kGenes / 8;   // 8-gene n-tiles per tile
constexpr int kCStride = kGenes + 8;  // count and g_s tiles: row stride (elements)
constexpr int kMaxH = 128;
constexpr size_t kMaxSmem = 232448;   // shared memory one CTA may use on an H100

// Shared memory of one CTA, in bytes: count tiles (2 buffers), the g_s tile
// (full form; an f32 count tile is overwritten with g_s in place, so only
// bf16 counts need their own), the e_a chunk and e_f tile, b_f and q, and
// the full form's g_ef | g_bf accumulator of the gene range.
// ops/kernels.py `nce_smem_bytes` computes the same.
size_t smem_bytes(int H, int range_tiles, int esize, bool feat) {
  const int s = ((H + 15) & ~15) + 4;
  size_t b = 2ull * kRows * kCStride * esize;
  b += sizeof(float) * ((kRows + kGenes) * static_cast<size_t>(s) + 2ull * kGenes);
  if (feat) {
    if (esize != sizeof(float)) b += sizeof(float) * kRows * kCStride;
    b += sizeof(float) * static_cast<size_t>(range_tiles) * kGenes * (H + 1);
  }
  return b;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), in two integer operations: the conversion instruction issues
// at a fraction of the integer rate, and the split runs eight times an
// element.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in the split form: the small terms first, then big . big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                     uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + a . b over four terms, in order
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__device__ __forceinline__ T zero_count();
template <>
__device__ __forceinline__ float zero_count<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_count<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// 1 / y to ~1 ulp: the special-function unit's estimate and one Newton
// step (IEEE division calls a slow path).
__device__ __forceinline__ float recip(float y) {
  const float r = __fdividef(1.f, y);
  return fmaf(r, fmaf(-y, r, 1.f), r);
}

// loss term of one element; returns g_s. g_s = c - a*sigmoid(s) needs
// sigmoid to ~1 ulp: a reaches thousands on pseudobulk planes, and the
// bias gradients sum g_s over thousands of genes, so __expf's error
// (2^-21 and growing with |s|) pushes them past the 1e-4 bar there. The
// loss takes the SFU's log2: softplus errs by ~1e-7 absolute, inside its
// bar of 2e-5 relative.
__device__ __forceinline__ float epilogue(float sc, float cv, float mq, float k_neg, float& loss) {
  const float a = cv + k_neg * mq;
  const float e = expf(-fabsf(sc));
  const float softplus = fmaxf(sc, 0.f) + __logf(1.f + e);
  const float sigmoid = (sc >= 0.f ? 1.f : e) * recip(1.f + e);
  loss += cv * sc - a * softplus;
  return cv - a * sigmoid;
}

// KH: the most 8-wide steps of H this instance takes (kh <= KH at run time)
template <typename T, bool kFeat, int KH>
__global__ void __launch_bounds__(kThreads)
nce_epoch_kernel(const T* __restrict__ c, const float* __restrict__ q,
                 const float* __restrict__ e_f, const float* __restrict__ b_f,
                 const float* __restrict__ e_a, const float* __restrict__ b_a,
                 const float* __restrict__ m, float k_neg, int P, int D, int H,
                 int band_chunks, int range_tiles, int vec,
                 float* __restrict__ gea_part,    // [ranges, P, H + 1]
                 float* __restrict__ gef_part,    // [bands, D, H + 1]
                 float* __restrict__ loss_part) { // [bands, ranges]
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  const int h16 = (H + 15) & ~15, S = h16 + 4, hs = H + 1, kh = (H + 7) >> 3;
  constexpr bool kInPlace = sizeof(T) == sizeof(float);  // g_s over the f32 count tile
  T* ct = reinterpret_cast<T*>(smem);  // [2][kRows][kCStride] counts
  float* gs_own = reinterpret_cast<float*>(smem + 2 * kRows * kCStride * sizeof(T));
  float* ea = gs_own + (kFeat && !kInPlace ? kRows * kCStride : 0);  // [kRows][S] e_a chunk
  float* ef = ea + kRows * S;         // [kGenes][S] e_f tile
  float* bf_s = ef + kGenes * S;
  float* q_s = bf_s + kGenes;
  float* acc = q_s + kGenes;  // [range_tiles * kGenes][hs] g_ef | g_bf (full form)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (D + kGenes - 1) / kGenes, n_chunks = (P + kRows - 1) / kRows;
  const int tile_lb = blockIdx.x * range_tiles;
  const int chunk_lb = blockIdx.y * band_chunks;
  const int n_rt = min(n_tiles, tile_lb + range_tiles) - tile_lb;
  const int iters = (min(n_chunks, chunk_lb + band_chunks) - chunk_lb) * n_rt;
  const int wr = 16 * warp;  // the warp's first row in a chunk

  if (kFeat) {
    for (int i = tid; i < n_rt * kGenes * hs; i += kThreads) acc[i] = 0.f;
  }

  // count tile of iteration `it` into buffer `buf`, as one cp.async group
  auto load_counts = [&](int it, int buf) {
    const int p0 = (chunk_lb + it / n_rt) * kRows, g0 = (tile_lb + it % n_rt) * kGenes;
    T* dst = ct + buf * kRows * kCStride;
    if (vec) {
      constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte copy
      constexpr int kSeg = kGenes / kPer;
      for (int i = tid; i < kRows * kSeg; i += kThreads) {
        const int r = i / kSeg, j = (i - r * kSeg) * kPer;
        const bool ok = p0 + r < P && g0 + j < D;
        const T* src = ok ? c + static_cast<size_t>(p0 + r) * D + g0 + j : c;
        cp_async16(dst + r * kCStride + j, src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kRows * kGenes; i += kThreads) {
        const int r = i / kGenes, j = i - r * kGenes;
        T v = zero_count<T>();
        if (p0 + r < P && g0 + j < D) v = c[static_cast<size_t>(p0 + r) * D + g0 + j];
        dst[r * kCStride + j] = v;
      }
    }
    cp_async_commit();
  };

  // H <= 16: the next iteration's e_f tile (and, before a new chunk, its
  // e_a rows, b_a and m) are loaded into registers one iteration ahead;
  // past H = 16 they are staged from device memory when they are needed.
  constexpr bool kAhead = KH == 2;
  constexpr int kPer = kAhead ? kRows * 16 / kThreads : 1;  // values a thread stages
  static_assert(kRows == kGenes, "e_a and e_f tiles share the staging shape");
  float ef_next[kPer], ea_next[kPer];
  float bf_next = 0.f, q_next = 0.f, ba_next[2] = {0.f, 0.f}, m_next[2] = {0.f, 0.f};

  // rows [row0, row0 + 64) of an [n, H] side, zero past n and H
  auto fetch_rows = [&](float (&dst)[kPer], const float* src, int row0, int n) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads, r = i / h16, h = i - r * h16;
      dst[k] = (row0 + r < n && h < H) ? src[static_cast<size_t>(row0 + r) * H + h] : 0.f;
    }
  };
  auto stage_rows = [&](const float (&src)[kPer], float* dst) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kThreads;
      dst[i + (i / h16) * (S - h16)] = src[k];
    }
  };
  auto fetch_next = [&](int it) {
    const int ci = it / n_rt, ti = it - ci * n_rt;
    const int p0 = (chunk_lb + ci) * kRows, g0 = (tile_lb + ti) * kGenes;
    fetch_rows(ef_next, e_f, g0, D);
    if (tid < kGenes) {
      bf_next = g0 + tid < D ? b_f[g0 + tid] : 0.f;
      q_next = g0 + tid < D ? q[g0 + tid] : 0.f;
    }
    if (ti == 0) {
      fetch_rows(ea_next, e_a, p0, P);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = p0 + wr + g + 8 * u;
        ba_next[u] = r < P ? b_a[r] : 0.f;
        m_next[u] = r < P ? m[r] : 0.f;
      }
    }
  };

  float loss_acc = 0.f;
  float gea[KH][4];  // g_ea of the warp's 16 rows, columns 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int j = 0; j < KH; ++j) gea[j][0] = gea[j][1] = gea[j][2] = gea[j][3] = 0.f;
  float rs0 = 0.f, rs1 = 0.f;  // row sums, rows g and g + 8
  float ba0 = 0.f, ba1 = 0.f, m0 = 0.f, m1 = 0.f;

  load_counts(0, 0);
  if constexpr (kAhead) fetch_next(0);
  for (int it = 0; it < iters; ++it) {
    const int ci = it / n_rt, ti = it - ci * n_rt;
    const int p0 = (chunk_lb + ci) * kRows, g0 = (tile_lb + ti) * kGenes;
    if constexpr (kAhead) {
      if (ti == 0) {
        stage_rows(ea_next, ea);
        ba0 = ba_next[0];
        ba1 = ba_next[1];
        m0 = m_next[0];
        m1 = m_next[1];
      }
      stage_rows(ef_next, ef);
      if (tid < kGenes) {
        bf_s[tid] = bf_next;
        q_s[tid] = q_next;
      }
      if (it + 1 < iters) fetch_next(it + 1);
    } else {
      if (ti == 0) {  // a new chunk: stage its e_a
        for (int i = tid; i < kRows * h16; i += kThreads) {
          const int r = i / h16, h = i - r * h16;
          ea[r * S + h] = (p0 + r < P && h < H) ? e_a[static_cast<size_t>(p0 + r) * H + h] : 0.f;
        }
        const int r0 = p0 + wr + g, r1 = r0 + 8;
        ba0 = r0 < P ? b_a[r0] : 0.f;
        m0 = r0 < P ? m[r0] : 0.f;
        ba1 = r1 < P ? b_a[r1] : 0.f;
        m1 = r1 < P ? m[r1] : 0.f;
      }
      for (int i = tid; i < kGenes * h16; i += kThreads) {
        const int r = i / h16, h = i - r * h16;
        ef[r * S + h] = (g0 + r < D && h < H) ? e_f[static_cast<size_t>(g0 + r) * H + h] : 0.f;
      }
      for (int i = tid; i < kGenes; i += kThreads) {
        bf_s[i] = g0 + i < D ? b_f[g0 + i] : 0.f;
        q_s[i] = g0 + i < D ? q[g0 + i] : 0.f;
      }
    }
    if (it + 1 < iters) {
      load_counts(it + 1, (it + 1) & 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();

    const T* cb = ct + (it & 1) * kRows * kCStride;
    float* gs = kInPlace ? reinterpret_cast<float*>(ct + (it & 1) * kRows * kCStride) : gs_own;
    float tile_loss = 0.f;
#pragma unroll 2
    for (int nt = 0; nt < kNTiles; ++nt) {
      const int n0 = 8 * nt;
      // the scores of the C fragment's four elements, in f32 on the CUDA
      // cores: rows g and g + 8 of the warp, genes 2t and 2t + 1
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const float* ra = ea + (wr + g) * S;
      const float* rf = ef + (n0 + 2 * t) * S;
#pragma unroll
      for (int k = 0; k < 2 * KH; ++k) {
        if (k < 2 * kh) {
          const float4 a0 = load_quad(ra + 4 * k), a1 = load_quad(ra + 8 * S + 4 * k);
          const float4 f0 = load_quad(rf + 4 * k), f1 = load_quad(rf + S + 4 * k);
          s[0] = dot4(a0, f0, s[0]);
          s[1] = dot4(a0, f1, s[1]);
          s[2] = dot4(a1, f0, s[2]);
          s[3] = dot4(a1, f1, s[3]);
        }
      }
      const float2 bfv = load_pair(bf_s + n0 + 2 * t);
      const float2 qv = load_pair(q_s + n0 + 2 * t);
      const float2 clo = load_pair(cb + (wr + g) * kCStride + n0 + 2 * t);
      const float2 chi = load_pair(cb + (wr + g + 8) * kCStride + n0 + 2 * t);
      const float g0v = epilogue(s[0] + bfv.x + ba0, clo.x, m0 * qv.x, k_neg, tile_loss);
      const float g1v = epilogue(s[1] + bfv.y + ba0, clo.y, m0 * qv.y, k_neg, tile_loss);
      const float g2v = epilogue(s[2] + bfv.x + ba1, chi.x, m1 * qv.x, k_neg, tile_loss);
      const float g3v = epilogue(s[3] + bfv.y + ba1, chi.y, m1 * qv.y, k_neg, tile_loss);
      rs0 += g0v + g1v;
      rs1 += g2v + g3v;
      if (kFeat) {
        *reinterpret_cast<float2*>(gs + (wr + g) * kCStride + n0 + 2 * t) = make_float2(g0v, g1v);
        *reinterpret_cast<float2*>(gs + (wr + g + 8) * kCStride + n0 + 2 * t) = make_float2(g2v, g3v);
      }
      // g_ea += g_s . e_f over these 8 genes, the C fragment as A
      uint32_t ab[4], as[4];
      split_tf32(g0v, ab[0], as[0]);
      split_tf32(g2v, ab[1], as[1]);
      split_tf32(g1v, ab[2], as[2]);
      split_tf32(g3v, ab[3], as[3]);
      const float* fo = ef + (n0 + 2 * t) * S + g;
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        if (j < kh) {
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(fo[8 * j], bb0, bs0);
          split_tf32(fo[S + 8 * j], bb1, bs1);
          mma3(gea[j], ab, as, bb0, bb1, bs0, bs1);
        }
      }
    }
    loss_acc += tile_loss;

    if (kFeat) {
      __syncthreads();  // the g_s tile is complete
      // warp w takes gene n-tiles w and w + 4 of each 16-column block,
      // both at once: they share the A fragments
      static_assert(kNTiles == 2 * kWarps, "two output n-tiles per warp and column block");
      for (int hm = 0; hm < h16 / 16; ++hm) {
        float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
        float cs0 = 0.f, cs1 = 0.f;
        const int n0 = 8 * warp + g, n1 = n0 + 8 * kWarps;
#pragma unroll 4
        for (int k0 = 0; k0 < kRows; k0 += 8) {
          const float* ao = ea + (k0 + t) * S + 16 * hm + g;
          uint32_t ab[4], as[4];
          split_tf32(ao[0], ab[0], as[0]);
          split_tf32(ao[8], ab[1], as[1]);
          split_tf32(ao[4 * S], ab[2], as[2]);
          split_tf32(ao[4 * S + 8], ab[3], as[3]);
          const float* r0 = gs + (k0 + t) * kCStride;
          const float* r1 = r0 + 4 * kCStride;
          const float v0 = r0[n0], v1 = r1[n0], w0 = r0[n1], w1 = r1[n1];
          cs0 += v0 + v1;
          cs1 += w0 + w1;
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(v0, bb0, bs0);
          split_tf32(v1, bb1, bs1);
          mma3(d0, ab, as, bb0, bb1, bs0, bs1);
          split_tf32(w0, bb0, bs0);
          split_tf32(w1, bb1, bs1);
          mma3(d1, ab, as, bb0, bb1, bs0, bs1);
        }
        // d: (column 16hm + g [+8], genes 2t, 2t + 1 of the n-tile)
        const int h0 = 16 * hm + g, h1 = h0 + 8;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* d = u ? d1 : d0;
          float* at = acc + (ti * kGenes + 8 * (warp + u * kWarps)) * hs;
          if (h0 < H) {
            at[2 * t * hs + h0] += d[0];
            at[(2 * t + 1) * hs + h0] += d[1];
          }
          if (h1 < H) {
            at[2 * t * hs + h1] += d[2];
            at[(2 * t + 1) * hs + h1] += d[3];
          }
          if (hm == 0) {  // column sums: rows t, t + 4 per lane, then over t
            float cs = u ? cs1 : cs0;
            cs += __shfl_xor_sync(0xffffffffu, cs, 1);
            cs += __shfl_xor_sync(0xffffffffu, cs, 2);
            if (t == 0) at[g * hs + H] += cs;
          }
        }
      }
    }

    if (ti == n_rt - 1) {  // the chunk's g_ea | g_ba over this range are complete
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
      const int r0 = p0 + wr + g, r1 = r0 + 8;
      float* o0 = gea_part + (static_cast<size_t>(blockIdx.x) * P + r0) * hs;
      float* o1 = o0 + 8 * hs;
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        const int h = 8 * j + 2 * t;
        if (j < kh) {
          if (r0 < P && h < H) o0[h] = gea[j][0];
          if (r0 < P && h + 1 < H) o0[h + 1] = gea[j][1];
          if (r1 < P && h < H) o1[h] = gea[j][2];
          if (r1 < P && h + 1 < H) o1[h + 1] = gea[j][3];
        }
        gea[j][0] = gea[j][1] = gea[j][2] = gea[j][3] = 0.f;
      }
      if (t == 0) {
        if (r0 < P) o0[H] = rs0;
        if (r1 < P) o1[H] = rs1;
      }
      rs0 = rs1 = 0.f;
    }
    __syncthreads();  // the tiles of this iteration are free
  }

  if (kFeat) {
    float* out = gef_part + (static_cast<size_t>(blockIdx.y) * D + tile_lb * kGenes) * hs;
    const int n_genes = min(D - tile_lb * kGenes, n_rt * kGenes);
    for (int i = tid; i < n_genes * hs; i += kThreads) out[i] = acc[i];
  }
  for (int off = 16; off > 0; off >>= 1) loss_acc += __shfl_down_sync(0xffffffffu, loss_acc, off);
  if (lane == 0) red[warp] = loss_acc;
  __syncthreads();
  if (tid == 0) {
    float tl = 0.f;
    for (int w = 0; w < kWarps; ++w) tl += red[w];
    loss_part[blockIdx.y * gridDim.x + blockIdx.x] = tl;
  }
}

// Sums the partials in a fixed order: g_ea | g_ba over gene ranges, g_ef |
// g_bf over row bands (D = 0: the axis form, no feature side).
__global__ void nce_reduce_grads(const float* __restrict__ gea_part,
                                 const float* __restrict__ gef_part, int P, int D, int H,
                                 int n_ranges, int n_bands, float* __restrict__ g_ea,
                                 float* __restrict__ g_ba, float* __restrict__ g_ef,
                                 float* __restrict__ g_bf) {
  const int hs = H + 1;
  const size_t n_a = static_cast<size_t>(P) * hs;
  const size_t n_f = static_cast<size_t>(D) * hs;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_a + n_f;
       i += stride) {
    float sum = 0.f;
    if (i < n_a) {
      for (int r = 0; r < n_ranges; ++r) sum += gea_part[r * n_a + i];
      const size_t p = i / hs;
      const int h = static_cast<int>(i - p * hs);
      if (h < H) {
        g_ea[p * H + h] = sum;
      } else {
        g_ba[p] = sum;
      }
    } else {
      const size_t j = i - n_a;
      for (int b = 0; b < n_bands; ++b) sum += gef_part[b * n_f + j];
      const size_t gi = j / hs;
      const int h = static_cast<int>(j - gi * hs);
      if (h < H) {
        g_ef[gi * H + h] = sum;
      } else {
        g_bf[gi] = sum;
      }
    }
  }
}

// One CTA: strided sums, then a fixed tree.
__global__ void nce_reduce_loss(const float* __restrict__ loss_part, int n,
                                float* __restrict__ loss) {
  constexpr int kReduceThreads = 256;
  __shared__ float red[kReduceThreads];
  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) sum += loss_part[i];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[0] = red[0];
}

template <typename T, bool kFeat>
auto pick_kernel(int H) {
  return H <= 16 ? nce_epoch_kernel<T, kFeat, 2> : nce_epoch_kernel<T, kFeat, kMaxH / 8>;
}

// The kernel's dynamic shared memory, and the whole of the SM's unified
// L1/shared memory as shared memory, so that the plan's CTAs fit side by
// side; set once per kernel, device and size, not on every launch (bge
// launches the kernel thousands of times a run).
cudaError_t configure(const void* kern, size_t smem) {
  static const void* done_kern[16];
  static int done_dev[16];
  static size_t done_smem[16];
  static int n_done = 0;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int slot = 0;
  while (slot < n_done && (done_kern[slot] != kern || done_dev[slot] != dev)) ++slot;
  if (slot < n_done && done_smem[slot] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && slot < 16) {
    done_kern[slot] = kern;
    done_dev[slot] = dev;
    done_smem[slot] = smem;
    if (slot == n_done) ++n_done;
  }
  return err;
}

template <typename T, bool kFeat>
int launch(const void* c, const void* q, const void* e_f, const void* b_f, const void* e_a,
           const void* b_a, const void* m, float k_neg, int P, int D, int H, int band_chunks,
           int range_tiles, void* scratch, void* loss, void* g_ef, void* g_bf, void* g_ea,
           void* g_ba, cudaStream_t stream) {
  const auto kern = pick_kernel<T, kFeat>(H);
  const size_t smem = smem_bytes(H, range_tiles, sizeof(T), kFeat);
  cudaError_t err = configure(reinterpret_cast<const void*>(kern), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ranges = ((D + kGenes - 1) / kGenes + range_tiles - 1) / range_tiles;
  const int n_bands = ((P + kRows - 1) / kRows + band_chunks - 1) / band_chunks;
  const int hs = H + 1;
  const int d_feat = kFeat ? D : 0;
  float* gea_part = static_cast<float*>(scratch);
  float* gef_part = gea_part + static_cast<size_t>(n_ranges) * P * hs;
  float* loss_part = gef_part + static_cast<size_t>(n_bands) * d_feat * hs;
  constexpr int kPer = 16 / sizeof(T);
  const int vec = reinterpret_cast<uintptr_t>(c) % 16 == 0 && D % kPer == 0;
  kern<<<dim3(n_ranges, n_bands), kThreads, smem, stream>>>(
      static_cast<const T*>(c), static_cast<const float*>(q), static_cast<const float*>(e_f),
      static_cast<const float*>(b_f), static_cast<const float*>(e_a),
      static_cast<const float*>(b_a), static_cast<const float*>(m), k_neg, P, D, H, band_chunks,
      range_tiles, vec, gea_part, gef_part, loss_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_out = static_cast<size_t>(P + d_feat) * hs;
  const int blocks = static_cast<int>((n_out + 255) / 256);
  nce_reduce_grads<<<blocks, 256, 0, stream>>>(
      gea_part, gef_part, P, d_feat, H, n_ranges, n_bands, static_cast<float*>(g_ea),
      static_cast<float*>(g_ba), static_cast<float*>(g_ef), static_cast<float*>(g_bf));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nce_reduce_loss<<<1, 256, 0, stream>>>(loss_part, n_bands * n_ranges, static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kFeat>
int ctas_per_sm(int H, int range_tiles) {
  const auto kern = pick_kernel<T, kFeat>(H);
  const size_t smem = smem_bytes(H, range_tiles, sizeof(T), kFeat);
  int n = 0;
  if (configure(reinterpret_cast<const void*>(kern), smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, smem) != cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace

// c [P, D] f32 (c_bf16 = 0) or bf16 (c_bf16 = 1); q [D], e_f [D, H], b_f [D],
// e_a [P, H], b_a [P], m [P] f32; the plan of ops/kernels.py `nce_plan`
// (band_chunks chunks of 64 rows a band, range_tiles tiles of 64 genes a
// range) and scratch of `NcePlan.scratch_floats`. Writes loss [1],
// g_ea [P, H], g_ba [P] and, with need_feat, g_ef [D, H], g_bf [D], all
// f32. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int legume_nce_epoch(const void* c, int c_bf16, const void* q, const void* e_f,
                                const void* b_f, const void* e_a, const void* b_a,
                                const void* m, float k_neg, int P, int D, int H, int need_feat,
                                int band_chunks, int range_tiles, void* scratch, void* loss,
                                void* g_ef, void* g_bf, void* g_ea, void* g_ba, void* stream) {
  if (P < 1 || D < 1 || H < 1 || H > kMaxH || band_chunks < 1 || range_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (c_bf16) {
    auto fn = need_feat ? launch<BF, true> : launch<BF, false>;
    return fn(c, q, e_f, b_f, e_a, b_a, m, k_neg, P, D, H, band_chunks, range_tiles, scratch, loss,
              g_ef, g_bf, g_ea, g_ba, s);
  }
  auto fn = need_feat ? launch<float, true> : launch<float, false>;
  return fn(c, q, e_f, b_f, e_a, b_a, m, k_neg, P, D, H, band_chunks, range_tiles, scratch, loss,
            g_ef, g_bf, g_ea, g_ba, s);
}

// CTAs of the main kernel that fit one SM at once (registers and shared
// memory), for a width H, a plan's range_tiles and a form; -1 on an error.
extern "C" int legume_nce_epoch_ctas_per_sm(int H, int range_tiles, int c_bf16, int need_feat) {
  if (H < 1 || H > kMaxH || range_tiles < 1) return -1;
  using BF = __nv_bfloat16;
  if (c_bf16) return need_feat ? ctas_per_sm<BF, true>(H, range_tiles) : ctas_per_sm<BF, false>(H, range_tiles);
  return need_feat ? ctas_per_sm<float, true>(H, range_tiles) : ctas_per_sm<float, false>(H, range_tiles);
}
