// One epoch of the expected-NCE objective: the loss and all four gradients
// in one pass over the [P, D] count plane, for count planes in f32 or bf16.
//
//   s    = e_a . e_f^T + b_f + b_a                       [P, D], never stored
//   a    = c + k_neg * (m_p * q_g)                       never stored
//   loss = sum c*s - a*softplus(s)
//   g_s  = c - a*sigmoid(s)                              [P, D], never stored
//   g_ea = g_s . e_f,  g_ef = g_s^T . e_a,  g_ba = row sums,  g_bf = column sums
//
// Unscaled: the caller multiplies by -1/total and adds the ridge term.
//
// Replaces legume_tpu/embedding/nce_pallas.py `_epoch_call` (`_epoch_kernel`),
// the phase-1 step of `embedding/nce.py::fit_bge` (and, in the port, its
// phase-2 block fit as well).
//
// What bounds it on an H100: at the anchor shape (P = 2,627, D = 34,008,
// H = 16) the plane is 357 MB in f32 (0.107 ms at 3.35 TB/s) and the three
// products are 6*P*D*H = 8.6 GFLOP plus ~20 operations per element
// (0.155 ms at 67 TFLOP/s f32), so operations bound it. The TPU kernel padded
// H to 128 lanes for its MXU; here H is not padded (H = 16 on every bge
// path), and the products run on the CUDA cores from shared memory.
//
// Design (simple first version, deterministic, no atomics):
// - grid (gene tiles of kTileD, splits of P); each CTA stages its e_f tile
//   once and walks its rows in chunks of kChunkP, staging the e_a chunk;
// - per chunk each thread scores one gene against kRowsPerThread rows in
//   registers, applies the elementwise epilogue (loss partial, g_s) and
//   stores g_s to a shared sub-tile; then the CTA accumulates g_ef | g_bf of
//   its tile in shared memory (each entry owned by one thread) and writes
//   the chunk's g_ea | g_ba partial for its tile to scratch;
// - a second kernel sums the partials over tiles (g_ea, g_ba) and over
//   splits (g_ef, g_bf) in a fixed order, and a third the loss partials,
//   so the result is the same from run to run.
// Rows and genes outside [P, D] contribute nothing: bounds checks replace
// the TPU's zero padding. A column of ones appended to the staged e_a and
// e_f tiles turns the bias gradients into the same products.
// `wgmma` score tiles and TMA-staged count tiles are for the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileD = 128;  // genes per CTA
constexpr int kChunkP = 32;  // rows per chunk
constexpr int kRowStep = kThreads / kTileD;
constexpr int kRowsPerThread = kChunkP / kRowStep;
constexpr int kMaxH = 128;
constexpr int kTargetCtas = 264;  // two per SM of an H100

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Plan {
  int n_tiles, n_split, rows_per_split;
};

// Splits P so that the grid holds about kTargetCtas CTAs; a function of
// (P, D) only, so the sum order, and so the result, depends on the shape
// alone.
Plan make_plan(int P, int D) {
  Plan pl;
  pl.n_tiles = (D + kTileD - 1) / kTileD;
  const int chunks = (P + kChunkP - 1) / kChunkP;
  int want = (kTargetCtas + pl.n_tiles - 1) / pl.n_tiles;
  if (want > chunks) want = chunks;
  if (want < 1) want = 1;
  const int chunks_per_split = (chunks + want - 1) / want;
  pl.rows_per_split = chunks_per_split * kChunkP;
  pl.n_split = (P + pl.rows_per_split - 1) / pl.rows_per_split;
  return pl;
}

size_t smem_bytes(int H) {
  const int hs = H + 1;
  return sizeof(float) *
         (2 * kTileD * hs + kChunkP * hs + kChunkP * kTileD + 2 * kTileD + 2 * kChunkP);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nce_epoch_kernel(const T* __restrict__ c, const float* __restrict__ q,
                 const float* __restrict__ e_f, const float* __restrict__ b_f,
                 const float* __restrict__ e_a, const float* __restrict__ b_a,
                 const float* __restrict__ m, float k_neg, int P, int D, int H,
                 int rows_per_split,
                 float* __restrict__ gea_part,    // [n_tiles, P, H + 1]
                 float* __restrict__ gef_part,    // [n_split, D, H + 1]
                 float* __restrict__ loss_part) { // [n_split, n_tiles]
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  const int hs = H + 1;
  float* ef_s = smem;                      // [kTileD][hs] e_f tile | 1
  float* ea_s = ef_s + kTileD * hs;        // [kChunkP][hs] e_a chunk | 1
  float* gs_s = ea_s + kChunkP * hs;       // [kChunkP][kTileD] g_s
  float* gef_s = gs_s + kChunkP * kTileD;  // [kTileD][hs] g_ef | g_bf
  float* bf_s = gef_s + kTileD * hs;       // [kTileD]
  float* q_s = bf_s + kTileD;              // [kTileD]
  float* ba_s = q_s + kTileD;              // [kChunkP]
  float* m_s = ba_s + kChunkP;             // [kChunkP]

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int g0 = tile * kTileD;
  const int p_lb = split * rows_per_split;
  const int p_ub = min(P, p_lb + rows_per_split);

  for (int i = tid; i < kTileD * hs; i += kThreads) {
    const int g = i / hs, h = i - g * hs;
    float v = 0.f;
    if (g0 + g < D) v = h < H ? e_f[static_cast<size_t>(g0 + g) * H + h] : 1.f;
    ef_s[i] = v;
    gef_s[i] = 0.f;
  }
  for (int g = tid; g < kTileD; g += kThreads) {
    bf_s[g] = g0 + g < D ? b_f[g0 + g] : 0.f;
    q_s[g] = g0 + g < D ? q[g0 + g] : 0.f;
  }

  const int gl = tid % kTileD;  // this thread's gene within the tile
  const int pr = tid / kTileD;  // its first row within a chunk
  const int gg = g0 + gl;
  const bool g_ok = gg < D;
  float loss_acc = 0.f;

  for (int p0 = p_lb; p0 < p_ub; p0 += kChunkP) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < kChunkP * hs; i += kThreads) {
      const int p = i / hs, h = i - p * hs;
      float v = 0.f;
      if (p0 + p < p_ub) v = h < H ? e_a[static_cast<size_t>(p0 + p) * H + h] : 1.f;
      ea_s[i] = v;
    }
    for (int p = tid; p < kChunkP; p += kThreads) {
      ba_s[p] = p0 + p < p_ub ? b_a[p0 + p] : 0.f;
      m_s[p] = p0 + p < p_ub ? m[p0 + p] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) s[i] = 0.f;
    for (int k = 0; k < H; ++k) {
      const float ef = ef_s[gl * hs + k];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        s[i] = fmaf(ea_s[(pr + kRowStep * i) * hs + k], ef, s[i]);
      }
    }
    const float bf = bf_s[gl], qg = q_s[gl];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int p = pr + kRowStep * i;
      float gs = 0.f;
      if (g_ok && p0 + p < p_ub) {
        const float sc = s[i] + bf + ba_s[p];
        const float cv = to_f32(c[static_cast<size_t>(p0 + p) * D + gg]);
        const float a = cv + k_neg * (m_s[p] * qg);
        const float e = expf(-fabsf(sc));
        const float softplus = fmaxf(sc, 0.f) + log1pf(e);
        const float sigmoid = (sc >= 0.f ? 1.f : e) / (1.f + e);
        loss_acc += cv * sc - a * softplus;
        gs = cv - a * sigmoid;
      }
      gs_s[p * kTileD + gl] = gs;
    }
    __syncthreads();

    const int n_rows = min(kChunkP, p_ub - p0);
    // g_ef | g_bf of the tile, accumulated over the chunk's rows
    for (int i = tid; i < kTileD * hs; i += kThreads) {
      const int g = i / hs, h = i - g * hs;
      float acc = 0.f;
      for (int p = 0; p < n_rows; ++p) acc = fmaf(gs_s[p * kTileD + g], ea_s[p * hs + h], acc);
      gef_s[i] += acc;
    }
    // g_ea | g_ba of the chunk's rows over this tile's genes
    for (int i = tid; i < n_rows * hs; i += kThreads) {
      const int p = i / hs, h = i - p * hs;
      float acc = 0.f;
      for (int g = 0; g < kTileD; ++g) acc = fmaf(gs_s[p * kTileD + g], ef_s[g * hs + h], acc);
      gea_part[(static_cast<size_t>(tile) * P + p0 + p) * hs + h] = acc;
    }
  }
  __syncthreads();

  for (int i = tid; i < kTileD * hs; i += kThreads) {
    if (g0 + i / hs < D) gef_part[(static_cast<size_t>(split) * D + g0) * hs + i] = gef_s[i];
  }
  for (int off = 16; off > 0; off >>= 1) loss_acc += __shfl_down_sync(0xffffffffu, loss_acc, off);
  if ((tid & 31) == 0) red[tid >> 5] = loss_acc;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += red[w];
    loss_part[split * gridDim.x + tile] = t;
  }
}

// Sums the partials in a fixed order: g_ea | g_ba over tiles, g_ef | g_bf
// over splits.
__global__ void nce_reduce_grads(const float* __restrict__ gea_part,
                                 const float* __restrict__ gef_part, int P, int D, int H,
                                 int n_tiles, int n_split, float* __restrict__ g_ea,
                                 float* __restrict__ g_ba, float* __restrict__ g_ef,
                                 float* __restrict__ g_bf) {
  const int hs = H + 1;
  const size_t n_a = static_cast<size_t>(P) * hs;
  const size_t n_f = static_cast<size_t>(D) * hs;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_a + n_f;
       i += stride) {
    float acc = 0.f;
    if (i < n_a) {
      for (int t = 0; t < n_tiles; ++t) acc += gea_part[t * n_a + i];
      const size_t p = i / hs;
      const int h = static_cast<int>(i - p * hs);
      if (h < H) {
        g_ea[p * H + h] = acc;
      } else {
        g_ba[p] = acc;
      }
    } else {
      const size_t j = i - n_a;
      for (int s = 0; s < n_split; ++s) acc += gef_part[s * n_f + j];
      const size_t g = j / hs;
      const int h = static_cast<int>(j - g * hs);
      if (h < H) {
        g_ef[g * H + h] = acc;
      } else {
        g_bf[g] = acc;
      }
    }
  }
}

// One CTA: strided sums, then a fixed tree.
__global__ void nce_reduce_loss(const float* __restrict__ loss_part, int n,
                                float* __restrict__ loss) {
  __shared__ float red[kThreads];
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += loss_part[i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[0] = red[0];
}

template <typename T>
int launch(const void* c, const void* q, const void* e_f, const void* b_f, const void* e_a,
           const void* b_a, const void* m, float k_neg, int P, int D, int H, void* scratch,
           void* loss, void* g_ef, void* g_bf, void* g_ea, void* g_ba, cudaStream_t stream) {
  const Plan pl = make_plan(P, D);
  const size_t smem = smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(nce_epoch_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hs = H + 1;
  float* gea_part = static_cast<float*>(scratch);
  float* gef_part = gea_part + static_cast<size_t>(pl.n_tiles) * P * hs;
  float* loss_part = gef_part + static_cast<size_t>(pl.n_split) * D * hs;
  nce_epoch_kernel<T><<<dim3(pl.n_tiles, pl.n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(c), static_cast<const float*>(q), static_cast<const float*>(e_f),
      static_cast<const float*>(b_f), static_cast<const float*>(e_a),
      static_cast<const float*>(b_a), static_cast<const float*>(m), k_neg, P, D, H,
      pl.rows_per_split, gea_part, gef_part, loss_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_out = static_cast<size_t>(P + D) * hs;
  const int blocks = static_cast<int>((n_out + kThreads - 1) / kThreads);
  nce_reduce_grads<<<blocks, kThreads, 0, stream>>>(
      gea_part, gef_part, P, D, H, pl.n_tiles, pl.n_split, static_cast<float*>(g_ea),
      static_cast<float*>(g_ba), static_cast<float*>(g_ef), static_cast<float*>(g_bf));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nce_reduce_loss<<<1, kThreads, 0, stream>>>(loss_part, pl.n_split * pl.n_tiles,
                                               static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch that `legume_nce_epoch` needs for a [P, D] plane.
extern "C" long long legume_nce_epoch_scratch(int P, int D, int H) {
  const Plan pl = make_plan(P, D);
  const long long hs = H + 1;
  return static_cast<long long>(pl.n_tiles) * P * hs + static_cast<long long>(pl.n_split) * D * hs +
         static_cast<long long>(pl.n_split) * pl.n_tiles;
}

// c [P, D] f32 (c_bf16 = 0) or bf16 (c_bf16 = 1); q [D], e_f [D, H], b_f [D],
// e_a [P, H], b_a [P], m [P] f32; scratch of `legume_nce_epoch_scratch`
// floats. Writes loss [1], g_ef [D, H], g_bf [D], g_ea [P, H], g_ba [P], all
// f32. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int legume_nce_epoch(const void* c, int c_bf16, const void* q, const void* e_f,
                                const void* b_f, const void* e_a, const void* b_a,
                                const void* m, float k_neg, int P, int D, int H, void* scratch,
                                void* loss, void* g_ef, void* g_bf, void* g_ea, void* g_ba,
                                void* stream) {
  if (P < 1 || D < 1 || H < 1 || H > kMaxH) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_bf16) {
    return launch<__nv_bfloat16>(c, q, e_f, b_f, e_a, b_a, m, k_neg, P, D, H, scratch, loss,
                                 g_ef, g_bf, g_ea, g_ba, s);
  }
  return launch<float>(c, q, e_f, b_f, e_a, b_a, m, k_neg, P, D, H, scratch, loss, g_ef, g_bf,
                       g_ea, g_ba, s);
}
