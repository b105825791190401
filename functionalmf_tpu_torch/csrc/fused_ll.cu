// Fused GASS candidate log-likelihood kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of functionalmf_tpu/ops/fused_ll.py,
// each with and without its EP extras (mu_ep, sigma_ep):
//   * fmf_row_ll        <- fused_row_ll        (_row_kernel)
//   * fmf_col_block_ll  <- fused_col_block_ll  (_col_kernel)
// Both compute, for every candidate g of a batch item,
//     ll[g] = sum over cells c of cell(y[c], tau[g, c])
//             [ - 1{mu[c] not NaN} log N(tau[g, c]; mu[c], sig[c]) ]
// with tau = cands . b_c, without writing the (candidates x cells) tau
// tensor to device memory. The bracketed EP term is compiled in only for
// the EP instantiations (template flag EP), chosen at launch by whether
// the caller passed mu/sig.
//
// What bounds them on this card: neither reaches the memory or the
// arithmetic roof at the main-path shapes (k = 5, ~100 candidates, a few
// thousand cells per row, 152 cells per column block, 4332 per column in
// the joint update). Per cell and candidate the work is a k-term dot, one
// logf and a few FMAs (two more with EP); the bytes read are the cells'
// y, mu, sig and k-vectors, once per block. The kernels are bound by
// latency and by the number of blocks in flight, so the design keeps one
// launch per Gibbs phase over every (chain, row) or every (chain, column,
// block) pair, and does no cross-block reduction:
//   * one thread block per (batch item, tile of kGT candidates);
//   * the candidate tile sits in shared memory; each thread strides over
//     the item's cells, keeps the cell's k-vector and EP constants in
//     registers and accumulates kGT partial sums in registers;
//   * the block reduces with warp shuffles and writes its kGT outputs
//     without atomics (blocks run in no order; the Pallas kernels carried
//     the sum across sequential grid steps, which Hopper does not give).
// A cell is skipped only when it contributes nothing: y is NaN (the cell
// contract returns 0 there) and, with EP, mu is NaN too. With EP a cell
// with NaN y and finite mu still subtracts the EP log-density, as the
// model's cellfn_ep and its unfused path do (constrained.py:466-468,
// 502-504). Ragged edges are masked, never padded: the Pallas kernels'
// padded cells (y NaN, mu = sig = 1, tau = 0) each add the constant
// -log N(0; 1, 1), which these kernels do not reproduce.
//
// The column-block candidate tile is kGT * Tb * k floats of dynamic shared
// memory: 72,960 bytes for the joint update (Tb = T = 228, k = 5), above
// the default 48 KB, so the launch opts in to more (up to the card's
// per-block maximum, 227 KB on an H100).
//
// The cell log-likelihood is chosen when the kernel is compiled: a functor
// per supported cell function, selected at launch by an integer id that
// the Python side maps from the CellFn name.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kGT = 16;           // candidates per block tile
constexpr int kRowThreads = 256;  // threads per block, row kernel
constexpr int kColThreads = 128;  // threads per block, column-block kernel
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kHalfLog2Pi = 0.91893853320467274f;

// y * log(max(tau, 1e-8)) - max(tau, 1e-8): the Poisson cell without its
// y-only term. The clamp propagates a NaN tau, as torch.clamp does.
struct PoissonCell {
  __device__ __forceinline__ static float apply(float y, float tau) {
    const float rate = (tau < 1e-8f) ? 1e-8f : tau;
    return y * logf(rate) - rate;
  }
};

// The per-cell part of one term: whether y and the EP factor are present,
// and the EP constants mu, 1/sig and -log(sig) - log(2 pi)/2.
struct CellTerm {
  float y, mu, inv_sig, lconst;
  bool has_y, has_ep;
};

template <bool EP>
__device__ __forceinline__ CellTerm load_term(float yv, const float* mu,
                                              const float* sig, size_t idx) {
  CellTerm c;
  c.y = yv;
  c.has_y = !isnan(yv);
  c.mu = 0.f;
  c.inv_sig = 0.f;
  c.lconst = 0.f;
  c.has_ep = false;
  if constexpr (EP) {
    c.mu = mu[idx];
    c.has_ep = !isnan(c.mu);
    if (c.has_ep) {
      const float s = sig[idx];
      c.inv_sig = 1.f / s;
      c.lconst = -logf(s) - kHalfLog2Pi;
    }
  }
  return c;
}

// cell(y, tau) - 1{mu not NaN} log N(tau; mu, sig), with the absent parts 0.
template <class Cell, bool EP>
__device__ __forceinline__ float term(const CellTerm& c, float tau) {
  float v = c.has_y ? Cell::apply(c.y, tau) : 0.f;
  if constexpr (EP) {
    if (c.has_ep) {
      const float z = (tau - c.mu) * c.inv_sig;
      v -= fmaf(-0.5f * z, z, c.lconst);
    }
  }
  return v;
}

// Sum each of the kGT per-thread accumulators over the block and store the
// block's outputs out_row[g0 .. g0 + kGT) that fall below G.
template <int NT>
__device__ __forceinline__ void block_reduce_store(const float (&acc)[kGT],
                                                   float* s_red,
                                                   float* out_row, int g0,
                                                   int G) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kGT; ++g) {
    float v = acc[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[warp * kGT + g] = v;
  }
  __syncthreads();
  if (threadIdx.x < kGT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += s_red[w * kGT + threadIdx.x];
    const int g = g0 + threadIdx.x;
    if (g < G) out_row[g] = s;
  }
}

// Row kernel: item r has candidates cands[r] (G, k), cell vectors
// bt[row_chain[r]] (C, k), data y[row_idx[r]] (C,) and, with EP,
// mu[row_idx[r]], sig[row_idx[r]] (C,).
template <class Cell, int KMAX, bool EP>
__global__ void __launch_bounds__(kRowThreads)
row_ll_kernel(const float* __restrict__ cands, const float* __restrict__ bt,
              const float* __restrict__ y, const float* __restrict__ mu,
              const float* __restrict__ sig,
              const int* __restrict__ row_chain,
              const int* __restrict__ row_idx, float* __restrict__ out, int G,
              int k, int C, int nchains, int nrows) {
  __shared__ float s_cand[kGT * KMAX];
  __shared__ float s_red[(kRowThreads / 32) * kGT];
  const int r = blockIdx.x;
  const int g0 = blockIdx.y * kGT;
  const int tid = threadIdx.x;
  const int chain = row_chain[r];
  const int row = row_idx[r];
  if (chain < 0 || chain >= nchains || row < 0 || row >= nrows) {
    if (tid < kGT && g0 + tid < G) out[(size_t)r * G + g0 + tid] = nanf("");
    return;
  }
  for (int idx = tid; idx < kGT * k; idx += blockDim.x) {
    const int g = idx / k;
    s_cand[idx] = (g0 + g < G)
                      ? cands[((size_t)r * G + g0 + g) * k + (idx - g * k)]
                      : 0.f;
  }
  __syncthreads();

  const float* b = bt + (size_t)chain * C * k;
  const size_t row_off = (size_t)row * C;
  float acc[kGT];
#pragma unroll
  for (int g = 0; g < kGT; ++g) acc[g] = 0.f;

  for (int c = tid; c < C; c += blockDim.x) {
    const CellTerm ct = load_term<EP>(y[row_off + c], mu, sig, row_off + c);
    if (!ct.has_y && !ct.has_ep) continue;
    float bv[KMAX];
#pragma unroll
    for (int a = 0; a < KMAX; ++a) bv[a] = (a < k) ? b[(size_t)c * k + a] : 0.f;
#pragma unroll
    for (int g = 0; g < kGT; ++g) {
      float tau = 0.f;
#pragma unroll
      for (int a = 0; a < KMAX; ++a)
        if (a < k) tau = fmaf(s_cand[g * k + a], bv[a], tau);
      acc[g] += term<Cell, EP>(ct, tau);
    }
  }
  block_reduce_store<kRowThreads>(acc, s_red, out + (size_t)r * G, g0, G);
}

// Column-block kernel: item p has candidates cands[p] (G, Tb, k); cell
// (t, i) reads y[i, pair_col[p], pair_t0[p] + t], W[pair_chain[p], i] and,
// with EP, mu and sig at the same (i, j, t) as y.
template <class Cell, int KMAX, bool EP>
__global__ void __launch_bounds__(kColThreads)
col_block_ll_kernel(const float* __restrict__ cands,
                    const float* __restrict__ w, const float* __restrict__ y,
                    const float* __restrict__ mu,
                    const float* __restrict__ sig,
                    const int* __restrict__ pair_chain,
                    const int* __restrict__ pair_col,
                    const int* __restrict__ pair_t0, float* __restrict__ out,
                    int G, int Tb, int k, int n, int m, int T, int nchains) {
  extern __shared__ float s_cand[];  // kGT * Tb * k
  __shared__ float s_red[(kColThreads / 32) * kGT];
  const int p = blockIdx.x;
  const int g0 = blockIdx.y * kGT;
  const int tid = threadIdx.x;
  const int chain = pair_chain[p];
  const int j = pair_col[p];
  const int t0 = pair_t0[p];
  if (chain < 0 || chain >= nchains || j < 0 || j >= m) {
    if (tid < kGT && g0 + tid < G) out[(size_t)p * G + g0 + tid] = nanf("");
    return;
  }
  const int D = Tb * k;
  for (int idx = tid; idx < kGT * D; idx += blockDim.x) {
    const int g = idx / D;
    s_cand[idx] = (g0 + g < G)
                      ? cands[((size_t)p * G + g0 + g) * D + (idx - g * D)]
                      : 0.f;
  }
  __syncthreads();

  const float* wc = w + (size_t)chain * n * k;
  float acc[kGT];
#pragma unroll
  for (int g = 0; g < kGT; ++g) acc[g] = 0.f;

  for (int cell = tid; cell < Tb * n; cell += blockDim.x) {
    const int i = cell / Tb;  // t fastest: neighbouring threads read
    const int t = cell - i * Tb;  // neighbouring y addresses
    const int tt = t0 + t;
    if (tt < 0 || tt >= T) continue;
    const size_t yi = ((size_t)i * m + j) * T + tt;
    const CellTerm ct = load_term<EP>(y[yi], mu, sig, yi);
    if (!ct.has_y && !ct.has_ep) continue;
    float wv[KMAX];
#pragma unroll
    for (int a = 0; a < KMAX; ++a) wv[a] = (a < k) ? wc[(size_t)i * k + a] : 0.f;
#pragma unroll
    for (int g = 0; g < kGT; ++g) {
      float tau = 0.f;
#pragma unroll
      for (int a = 0; a < KMAX; ++a)
        if (a < k) tau = fmaf(s_cand[g * D + t * k + a], wv[a], tau);
      acc[g] += term<Cell, EP>(ct, tau);
    }
  }
  block_reduce_store<kColThreads>(acc, s_red, out + (size_t)p * G, g0, G);
}

template <class Cell, int KMAX, bool EP>
cudaError_t launch_row(dim3 grid, cudaStream_t s, const float* cands,
                       const float* bt, const float* y, const float* mu,
                       const float* sig, const int* row_chain,
                       const int* row_idx, float* out, int G, int k, int C,
                       int nchains, int nrows) {
  row_ll_kernel<Cell, KMAX, EP><<<grid, kRowThreads, 0, s>>>(
      cands, bt, y, mu, sig, row_chain, row_idx, out, G, k, C, nchains,
      nrows);
  return cudaGetLastError();
}

template <class Cell, int KMAX, bool EP>
cudaError_t launch_col(dim3 grid, size_t smem, cudaStream_t s,
                       const float* cands, const float* w, const float* y,
                       const float* mu, const float* sig,
                       const int* pair_chain, const int* pair_col,
                       const int* pair_t0, float* out, int G, int Tb, int k,
                       int n, int m, int T, int nchains) {
  if (smem > kDefaultSmem) {
    // above 48 KB of dynamic shared memory a kernel must opt in (per
    // device; the call is cheap, so it is not cached)
    const cudaError_t err = cudaFuncSetAttribute(
        col_block_ll_kernel<Cell, KMAX, EP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  col_block_ll_kernel<Cell, KMAX, EP><<<grid, kColThreads, smem, s>>>(
      cands, w, y, mu, sig, pair_chain, pair_col, pair_t0, out, G, Tb, k, n,
      m, T, nchains);
  return cudaGetLastError();
}

constexpr int kCellPoisson = 0;

}  // namespace

extern "C" {

const char* fmf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// mu and sig are both null (no EP) or both (nrows, C) beside y.
int fmf_row_ll(int cell, const float* cands, const float* bt, const float* y,
               const float* mu, const float* sig, const int* row_chain,
               const int* row_idx, float* out, int R, int G, int k, int C,
               int nchains, int nrows, void* stream) {
  if (R == 0 || G == 0) return 0;
  if (k < 1 || k > 32 || (mu == nullptr) != (sig == nullptr))
    return (int)cudaErrorInvalidValue;
  if (cell != kCellPoisson) return (int)cudaErrorInvalidValue;
  const dim3 grid(R, (G + kGT - 1) / kGT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ep = mu != nullptr;
  cudaError_t err;
  if (k <= 8)
    err = ep ? launch_row<PoissonCell, 8, true>(grid, s, cands, bt, y, mu, sig,
                                                row_chain, row_idx, out, G, k,
                                                C, nchains, nrows)
             : launch_row<PoissonCell, 8, false>(grid, s, cands, bt, y, mu,
                                                 sig, row_chain, row_idx, out,
                                                 G, k, C, nchains, nrows);
  else
    err = ep ? launch_row<PoissonCell, 32, true>(grid, s, cands, bt, y, mu,
                                                 sig, row_chain, row_idx, out,
                                                 G, k, C, nchains, nrows)
             : launch_row<PoissonCell, 32, false>(grid, s, cands, bt, y, mu,
                                                  sig, row_chain, row_idx, out,
                                                  G, k, C, nchains, nrows);
  return (int)err;
}

// mu and sig are both null (no EP) or both (n, m, T) beside y.
int fmf_col_block_ll(int cell, const float* cands, const float* w,
                     const float* y, const float* mu, const float* sig,
                     const int* pair_chain, const int* pair_col,
                     const int* pair_t0, float* out, int P, int G, int Tb,
                     int k, int n, int m, int T, int nchains, void* stream) {
  if (P == 0 || G == 0) return 0;
  if (k < 1 || k > 32 || Tb < 1 || (mu == nullptr) != (sig == nullptr))
    return (int)cudaErrorInvalidValue;
  if (cell != kCellPoisson) return (int)cudaErrorInvalidValue;
  const dim3 grid(P, (G + kGT - 1) / kGT);
  const size_t smem = (size_t)kGT * Tb * k * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ep = mu != nullptr;
  cudaError_t err;
  if (k <= 8)
    err = ep ? launch_col<PoissonCell, 8, true>(
                   grid, smem, s, cands, w, y, mu, sig, pair_chain, pair_col,
                   pair_t0, out, G, Tb, k, n, m, T, nchains)
             : launch_col<PoissonCell, 8, false>(
                   grid, smem, s, cands, w, y, mu, sig, pair_chain, pair_col,
                   pair_t0, out, G, Tb, k, n, m, T, nchains);
  else
    err = ep ? launch_col<PoissonCell, 32, true>(
                   grid, smem, s, cands, w, y, mu, sig, pair_chain, pair_col,
                   pair_t0, out, G, Tb, k, n, m, T, nchains)
             : launch_col<PoissonCell, 32, false>(
                   grid, smem, s, cands, w, y, mu, sig, pair_chain, pair_col,
                   pair_t0, out, G, Tb, k, n, m, T, nchains);
  return (int)err;
}

}  // extern "C"
