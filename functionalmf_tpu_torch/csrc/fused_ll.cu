// Fused GASS candidate log-likelihood kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of functionalmf_tpu/ops/fused_ll.py,
// each with and without its EP extras (mu_ep, sigma_ep):
//   * fmf_row_ll        <- fused_row_ll        (_row_kernel)
//   * fmf_col_block_ll  <- fused_col_block_ll  (_col_kernel)
// Both compute, for every candidate g of a batch item,
//     ll[g] = sum over cells c of cell(y[c], tau[g, c])
//             [ - 1{mu[c] not NaN} log N(tau[g, c]; mu[c], sig[c]) ]
// with tau = <candidate, cell vector>, without writing the (candidates x
// cells) tau tensor to device memory. They are one reduction with two
// index maps: a row item (a W row of one chain) has one candidate matrix
// (G, k) and C cells with vectors bt[chain, c]; a column item (a V block
// of one chain and column) has Tb time slots, a candidate matrix (G, k)
// per slot, and n cells per slot with vectors W[chain, i]. The EP term is
// compiled in only for the EP instantiations, chosen at launch by whether
// the caller passed mu/sig.
//
// What bounds them on this card. Per (candidate, cell) pair the work is a
// k-term dot, one log and a few FMAs (a few more with EP); each cell's
// bytes (y, mu, sig, its k-vector) serve ~100 candidates. At the paths'
// shapes (k = 5, 101 candidates; 19 rows of 4332 cells, or column blocks
// of 4, 8 or 228 slots of 19 cells) the row kernel's bound is the log (one
// special-function op a pair), the column kernel's the candidates' bytes
// (k floats a slot and candidate, read once). What holds them back is
// latency: 19 items give 132 SMs little to overlap, and a small launch
// (a seq round is 152 cells an item) is a chain of dependent steps. The
// design:
//   * Fill the card with one launch. An item of 1024 cells or more is
//     split across a thread-block cluster of up to 8 blocks, about
//     1.5 x 132 blocks in all (the host's plan, from the item count). The
//     blocks' partial sums for all candidates are reduced through
//     distributed shared memory in a fixed rank order, and rank 0 writes
//     the output: no atomics, no second pass, bit-identical run to run. A
//     smaller item stays in one block, without cluster barriers.
//   * All candidates per block, each cell loaded once. Lane l of a warp
//     holds candidates l, l+32, l+64, l+96 in registers (a pass of 128;
//     G > 128 runs several passes); the warps split the cells, two at a
//     time, so a thread keeps 4 x 2 independent accumulators. A cell's
//     constants (y ln 2, mu, sqrt(1/2)/sig, log sig + log(2 pi)/2) are
//     computed once per block into shared memory and read by every lane
//     as a broadcast.
//   * Stage the bytes asynchronously. A block walks its range in chunks
//     through a two-stage ring in shared memory filled with cp.async
//     (16-byte copies where the rows start on 16 bytes: block ranges and
//     chunks start on multiples of 4 units): the row kernel's cell vectors,
//     the column kernel's candidates (G rows of chunk x k floats), and the
//     cells' data. The next chunk lands while the current one is computed,
//     and the column block width Tb has no shared-memory limit. A block of
//     one chunk reads its cells' data straight from device memory while
//     its candidates or vectors land, which saves a barrier.
// A cell contributes nothing only when y is NaN (the cell contract
// returns 0 there) and, with EP, mu is NaN too; with EP a cell with NaN y
// and finite mu still subtracts the EP log-density, as the model's
// cellfn_ep does (constrained.py:466-468). Each part is added under a
// per-cell predicate. Ragged edges are masked, never padded: the Pallas
// kernels' padded cells (y NaN, mu = sig = 1, tau = 0) each add the
// constant -log N(0; 1, 1), which these kernels do not reproduce.
//
// Numerics: float32 throughout, on the CUDA cores. Tensor cores are not
// used: the contraction depth is k = 5, and TF32 would move tau by about
// 1e-3 relative, outside the kernels' tolerance (the port turns TF32 off,
// _runtime.require_full_f32, for the same reason). The Poisson cell's log
// is one MUFU lg2 (lg2.approx, absolute error about 2^-22 near 1) times
// the y ln 2 the cell keeps: the accurate log2f, a software sequence,
// measured twice the device time of the whole row kernel on an H100,
// and every kernel-vs-plain check stays within rtol
// 1e-5 / atol 1e-3 with lg2.approx (chip_smoke.py prints each error as a
// share of its bound). The EP constants use logf, once per cell.
//
// The cell log-likelihood is chosen when the kernel is compiled: a functor
// per supported cell function, selected at launch by an integer id that
// the Python side maps from the CellFn name. The launch plan (cluster
// size, chunk, shared-memory bytes) comes from _launch_plan in
// ops/fused_ll.py; the entry points check its bytes against the layout.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCells = 2;                   // cells a warp takes at once
constexpr int kPerLane = 4;                 // candidates a lane holds
constexpr int kPass = 32 * kPerLane;        // candidates a pass holds
constexpr int kMaxCluster = 8;
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kHalfLog2Pi = 0.91893853320467274f;
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kSqrtHalf = 0.70710678118654752f;

// y * log(max(tau, 1e-8)) - max(tau, 1e-8): the Poisson cell without its
// y-only term. A cell keeps y ln 2 (prep), so the log is one MUFU lg2.
// The clamp propagates a NaN tau, as torch.clamp does (max.NaN).
struct PoissonCell {
  __device__ __forceinline__ static float prep(float y) { return y * kLn2; }
  __device__ __forceinline__ static float apply(float yp, float tau) {
    float rate;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(rate) : "f"(tau), "f"(1e-8f));
    float l2;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l2) : "f"(rate));
    return fmaf(yp, l2, -rate);
  }
};

// ---------------------------------------------------------------------
// shared-memory layout, in floats; every region starts on 16 bytes
// ---------------------------------------------------------------------
__host__ __device__ constexpr int r4(int x) { return (x + 3) & ~3; }

struct Layout {
  int cells;   // float4 cell constants: chunk (row) or chunk * n (column)
  int fixed;   // W (column kernel)
  int cand;    // one stage: candidate rows (column kernel)
  int cand_row;
  int vec;     // one stage: cell vectors (row kernel)
  int data;    // one stage: each of y, mu, sig
  int data_row;
  int stage;
  int total;
  __host__ __device__ Layout(bool row, int chunk, int G, int k, int n,
                             bool ep) {
    const int gp = G < kPass ? G : kPass;
    const int narr = ep ? 3 : 1;
    if (row) {
      cells = 4 * chunk;
      fixed = 0;
      cand_row = 0;
      cand = 0;
      vec = r4(chunk * k);
      data_row = r4(chunk);
      data = data_row;
    } else {
      cells = 4 * chunk * n;
      fixed = r4(n * k);
      cand_row = r4(chunk * k);
      cand = gp * cand_row;
      vec = 0;
      data_row = r4(chunk);
      data = n * data_row;
    }
    stage = cand + vec + narr * data;
    total = cells + kWarps * kPass + kPass + fixed + 2 * stage;
  }
};

// ---------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy nrows rows of n floats, row r from src + r * sstride to
// dst + r * dstride, with every thread of the block starting cp.async:
// 16-byte copies where every row starts on 16 bytes on both sides, then
// the rows' last n % 4 floats; 4-byte copies otherwise.
__device__ __forceinline__ void copy_rows(float* dst, int dstride,
                                          const float* src, long long sstride,
                                          int nrows, int n) {
  if (n <= 0) return;
  int nv = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0 &&
      (sstride & 3) == 0 && (dstride & 3) == 0) {
    nv = n >> 2;
    for (int u = threadIdx.x; u < nrows * nv; u += kThreads) {
      const int r = u / nv, e = (u - r * nv) << 2;
      cp_async16(dst + r * dstride + e, src + r * sstride + e);
    }
  }
  const int rest = n - 4 * nv;
  for (int u = threadIdx.x; u < nrows * rest; u += kThreads) {
    const int r = u / rest, e = 4 * nv + (u - r * rest);
    cp_async4(dst + r * dstride + e, src + r * sstride + e);
  }
}

// The block of rank `rank` in a cluster of cl takes units [lo, hi): the
// units in groups of 4 (of 1 where there are fewer than 4 a block), the
// groups split as evenly as the ranks allow, so that a block's first unit
// keeps the rows' 16-byte alignment.
__device__ __forceinline__ int2 block_range(int units, int rank, int cl) {
  const int g = (units >= 4 * cl) ? 4 : 1;
  const int groups = (units + g - 1) / g;
  const int lo = g * (int)((long long)rank * groups / cl);
  const int hi = g * (int)((long long)(rank + 1) * groups / cl);
  return make_int2(lo < units ? lo : units, hi < units ? hi : units);
}

// A cell's constants, computed once per block: (the cell's prepared y,
// NaN where y is; mu; sqrt(1/2) / sig; log sig + log(2 pi) / 2), the EP
// part 0 where mu is NaN or without EP, so that
// -log N(tau; mu, sig) = ((tau - mu) sqrt(1/2) / sig)^2 + log sig
// + log(2 pi) / 2.
template <class Cell, bool EP>
__device__ __forceinline__ float4 cell_constants(float y, float mu,
                                                 float sig) {
  float4 c = make_float4(isnan(y) ? y : Cell::prep(y), 0.f, 0.f, 0.f);
  if (EP && !isnan(mu)) {
    c.y = mu;
    c.z = kSqrtHalf / sig;   // exact: one sigma for many cells would
                             // turn an approximate quotient into a bias
    c.w = logf(sig) + kHalfLog2Pi;
  }
  return c;
}

// One cell against the thread's candidates: acc[j] += cell(y, tau_j)
// [- log N(tau_j; mu, sig)], each part skipped where y (mu) is NaN. The
// EP constant is added per pair: summed apart, it would leave the
// accumulators to cancel a large sum at the end.
template <class Cell, int K, bool PAD, bool EP>
__device__ __forceinline__ void cell_terms(float4 cc, const float* v, int k,
                                           const float (&cv)[kPerLane][K],
                                           float (&acc)[kPerLane]) {
  float b[K];
#pragma unroll
  for (int a = 0; a < K; ++a) b[a] = (!PAD || a < k) ? v[a] : 0.f;
  const bool has_y = !isnan(cc.x);
  const bool has_ep = EP && cc.z != 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    float tau = 0.f;
#pragma unroll
    for (int a = 0; a < K; ++a) tau = fmaf(cv[j][a], b[a], tau);
    const float t = Cell::apply(cc.x, tau);
    if (has_y) acc[j] += t;
    if constexpr (EP) {
      const float z = (tau - cc.y) * cc.z;
      if (has_ep) acc[j] += fmaf(z, z, cc.w);
    }
  }
}

// ---------------------------------------------------------------------
// the two index maps
// ---------------------------------------------------------------------
struct RowArgs {
  const float *cands, *bt, *y, *mu, *sig;
  const int *row_chain, *row_idx;
  float* out;
  int G, k, C, nchains, nrows, chunk;
};

// Row item r: candidates cands[r] (G, k); one slot of cells [lo, hi) of
// this block, cell c with vector bt[chain, c] and data y[row, c] (mu, sig).
template <class Cell, int K, bool PAD, bool EP>
struct RowMap {
  const RowArgs& a;
  int item, chain, row, lo, hi;
  float cv[kPerLane][K];

  __device__ RowMap(const RowArgs& args, int it, int rank, int cl)
      : a(args), item(it) {
    chain = a.row_chain[it];
    row = a.row_idx[it];
    const int2 r = block_range(a.C, rank, cl);
    lo = r.x;
    hi = r.y;
  }
  __device__ bool valid() const {
    return chain >= 0 && chain < a.nchains && row >= 0 && row < a.nrows;
  }
  __device__ int G() const { return a.G; }
  __device__ float* out() const { return a.out + (size_t)item * a.G; }
  __device__ int nchunks() const { return (hi - lo + a.chunk - 1) / a.chunk; }
  __device__ void fetch_fixed(float*) const {}

  __device__ void begin_pass(int g0, int gp, int lane) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int g = lane + 32 * j;
      const float* p = a.cands + ((size_t)item * a.G + g0 + g) * a.k;
#pragma unroll
      for (int q = 0; q < K; ++q)
        cv[j][q] = (g < gp && (!PAD || q < a.k)) ? p[q] : 0.f;
    }
  }

  __device__ int c0(int q) const { return lo + q * a.chunk; }
  __device__ int ncells(int q) const {
    const int c = c0(q);
    return (hi - c < a.chunk) ? hi - c : a.chunk;
  }

  __device__ void fetch(int q, float* st, const Layout& L, bool data) const {
    const int nc = ncells(q);
    copy_rows(st, 0, a.bt + ((size_t)chain * a.C + c0(q)) * a.k, 0, 1,
              nc * a.k);
    if (!data) return;
    const size_t d = (size_t)row * a.C + c0(q);
    copy_rows(st + L.vec, 0, a.y + d, 0, 1, nc);
    if constexpr (EP) {
      copy_rows(st + L.vec + L.data, 0, a.mu + d, 0, 1, nc);
      copy_rows(st + L.vec + 2 * L.data, 0, a.sig + d, 0, 1, nc);
    }
  }

  // The chunk's cell constants from its staged data, or (DIRECT) from
  // device memory.
  template <bool DIRECT>
  __device__ void prep(int q, const float* st, float4* cells,
                       const Layout& L) const {
    const float* sd = st + L.vec;
    const size_t d = (size_t)row * a.C + c0(q);
    for (int c = threadIdx.x; c < ncells(q); c += kThreads) {
      if constexpr (DIRECT)
        cells[c] = cell_constants<Cell, EP>(
            a.y[d + c], EP ? a.mu[d + c] : 0.f, EP ? a.sig[d + c] : 1.f);
      else
        cells[c] = cell_constants<Cell, EP>(
            sd[c], EP ? sd[L.data + c] : 0.f, EP ? sd[2 * L.data + c] : 1.f);
    }
  }

  __device__ int slots(int) const { return 1; }
  __device__ int per_slot(int q) const { return ncells(q); }
  __device__ void load_slot(int, int, const float*, const Layout&) {}
  __device__ const float* vectors(const float* st, const float*) const {
    return st;
  }
};

struct ColArgs {
  const float *cands, *w, *y, *mu, *sig;
  const int *pair_chain, *pair_col, *pair_t0;
  float* out;
  int G, Tb, k, n, m, T, nchains, chunk;
};

// Column item p: slots t in [lo, hi) of this block, candidates
// cands[p, :, t] (G, k); cell (t, i) with vector W[chain, i] and data
// y[i, j, t0 + t] (mu, sig), absent where t0 + t is outside [0, T).
template <class Cell, int K, bool PAD, bool EP>
struct ColMap {
  const ColArgs& a;
  int item, chain, j, t0, lo, hi;
  int g0, gp;
  float cv[kPerLane][K];

  __device__ ColMap(const ColArgs& args, int it, int rank, int cl)
      : a(args), item(it) {
    chain = a.pair_chain[it];
    j = a.pair_col[it];
    t0 = a.pair_t0[it];
    const int2 r = block_range(a.Tb, rank, cl);
    lo = r.x;
    hi = r.y;
  }
  __device__ bool valid() const {
    return chain >= 0 && chain < a.nchains && j >= 0 && j < a.m;
  }
  __device__ int G() const { return a.G; }
  __device__ float* out() const { return a.out + (size_t)item * a.G; }
  __device__ int nchunks() const { return (hi - lo + a.chunk - 1) / a.chunk; }

  __device__ void fetch_fixed(float* fixed) const {
    copy_rows(fixed, 0, a.w + (size_t)chain * a.n * a.k, 0, 1, a.n * a.k);
  }

  __device__ void begin_pass(int g0_, int gp_, int) {
    g0 = g0_;
    gp = gp_;
  }

  __device__ int s0(int q) const { return lo + q * a.chunk; }
  __device__ int nslots(int q) const {
    const int s = s0(q);
    return (hi - s < a.chunk) ? hi - s : a.chunk;
  }

  __device__ void fetch(int q, float* st, const Layout& L, bool data) const {
    const int ns = nslots(q);
    copy_rows(st, L.cand_row,
              a.cands + (((size_t)item * a.G + g0) * a.Tb + s0(q)) * a.k,
              (long long)a.Tb * a.k, gp, ns * a.k);
    if (!data) return;
    // the slots inside [0, T), row i of y at (i, j, t)
    const int ts = t0 + s0(q);
    const int tlo = ts < 0 ? 0 : ts;
    const int thi = (ts + ns > a.T) ? a.T : ts + ns;
    if (thi <= tlo) return;
    const size_t d = (size_t)j * a.T + tlo;
    const long long rs = (long long)a.m * a.T;
    float* sd = st + L.cand + (tlo - ts);
    copy_rows(sd, L.data_row, a.y + d, rs, a.n, thi - tlo);
    if constexpr (EP) {
      copy_rows(sd + L.data, L.data_row, a.mu + d, rs, a.n, thi - tlo);
      copy_rows(sd + 2 * L.data, L.data_row, a.sig + d, rs, a.n, thi - tlo);
    }
  }

  template <bool DIRECT>
  __device__ void prep(int q, const float* st, float4* cells,
                       const Layout& L) const {
    const int ns = nslots(q), n = a.n;
    const int ts = t0 + s0(q);
    const float* sd = st + L.cand;
    for (int idx = threadIdx.x; idx < ns * n; idx += kThreads) {
      const int s = idx / n, i = idx - s * n;
      const size_t r = DIRECT ? ((size_t)i * a.m + j) * a.T + ts + s
                              : (size_t)i * L.data_row + s;
      const float* y = DIRECT ? a.y : sd;
      const float* mu = DIRECT ? a.mu : sd + L.data;
      const float* sig = DIRECT ? a.sig : sd + 2 * L.data;
      const bool inside = ts + s >= 0 && ts + s < a.T;
      cells[idx] = cell_constants<Cell, EP>(
          inside ? y[r] : nanf(""), (EP && inside) ? mu[r] : nanf(""),
          (EP && inside) ? sig[r] : 1.f);
    }
  }

  __device__ int slots(int q) const { return nslots(q); }
  __device__ int per_slot(int) const { return a.n; }

  __device__ void load_slot(int s, int lane, const float* st,
                            const Layout& L) {
#pragma unroll
    for (int jj = 0; jj < kPerLane; ++jj) {
      const int gl = lane + 32 * jj;
      const float* p = st + gl * L.cand_row + s * a.k;
#pragma unroll
      for (int q = 0; q < K; ++q)
        cv[jj][q] = (gl < gp && (!PAD || q < a.k)) ? p[q] : 0.f;
    }
  }
  __device__ const float* vectors(const float*, const float* fixed) const {
    return fixed;
  }
};

// ---------------------------------------------------------------------
// the reduction both kernels run
// ---------------------------------------------------------------------
template <class Cell, int K, bool PAD, bool EP, class Map>
__device__ __forceinline__ void reduce_item(Map& map, const Layout& L,
                                            int k) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  float4* cells = reinterpret_cast<float4*>(smem);
  float* red = smem + L.cells;
  float* part = red + kWarps * kPass;
  float* fixed = part + kPass;
  float* const stage0 = fixed + L.fixed;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = map.G();
  const int nq = map.nchunks();

  if (!map.valid()) {   // uniform over the cluster: every block returns
    if (cluster.block_rank() == 0)
      for (int g = threadIdx.x; g < G; g += kThreads) map.out()[g] = nanf("");
    return;
  }
  map.fetch_fixed(fixed);
  for (int g0 = 0; g0 < G; g0 += kPass) {
    const int gp = (G - g0 < kPass) ? G - g0 : kPass;
    map.begin_pass(g0, gp, lane);
    float acc[kCells][kPerLane];
#pragma unroll
    for (int u = 0; u < kCells; ++u)
#pragma unroll
      for (int jj = 0; jj < kPerLane; ++jj) acc[u][jj] = 0.f;

    // A block of one chunk reads its cells' data straight from device
    // memory while its candidates (vectors) land: one barrier fewer.
    const bool direct = nq == 1;
    if (nq > 0) map.fetch(0, stage0, L, !direct);
    cp_async_commit();
    if (direct) map.template prep<true>(0, stage0, cells, L);
    for (int q = 0; q < nq; ++q) {
      float* st = stage0 + (q & 1) * L.stage;
      if (q + 1 < nq)
        map.fetch(q + 1, stage0 + ((q + 1) & 1) * L.stage, L, true);
      cp_async_commit();
      cp_async_wait_1();   // chunk q (and W) landed, chunk q+1 in flight
      __syncthreads();
      if (!direct) {
        map.template prep<false>(q, st, cells, L);
        __syncthreads();
      }
      // this warp's share: whole slots, or a part of one slot's cells
      const int S = map.slots(q), n = map.per_slot(q);
      const int wps = (S >= kWarps) ? 1 : kWarps / S;
      const int part_i = warp % wps;
      const int cb = (int)((long long)part_i * n / wps);
      const int ce = (int)((long long)(part_i + 1) * n / wps);
      const float* vb = map.vectors(st, fixed);
      for (int s = warp / wps; s < S; s += kWarps / wps) {
        map.load_slot(s, lane, st, L);
        const float4* cs = cells + (size_t)s * n;
        int c = cb;
#pragma unroll 2
        for (; c + kCells <= ce; c += kCells) {
#pragma unroll
          for (int u = 0; u < kCells; ++u)
            cell_terms<Cell, K, PAD, EP>(cs[c + u], vb + (c + u) * k, k,
                                         map.cv, acc[u]);
        }
        for (; c < ce; ++c)
          cell_terms<Cell, K, PAD, EP>(cs[c], vb + c * k, k, map.cv,
                                       acc[0]);
      }
      if (q + 2 < nq) __syncthreads();   // stage q is free for chunk q+2
    }

    // the block's partial sums, warps in order, then the cluster's, ranks
    // in order, through distributed shared memory
#pragma unroll
    for (int jj = 0; jj < kPerLane; ++jj) {
      float v = 0.f;
#pragma unroll
      for (int u = 0; u < kCells; ++u) v += acc[u][jj];
      red[warp * kPass + lane + 32 * jj] = v;
    }
    __syncthreads();
    const int nb = (int)cluster.num_blocks();
    if (threadIdx.x < gp) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kPass + threadIdx.x];
      if (nb == 1) map.out()[g0 + threadIdx.x] = s;
      part[threadIdx.x] = s;
    }
    if (nb == 1) {   // no cluster: the next pass reuses red after this
      __syncthreads();
      continue;
    }
    cluster.sync();
    if (cluster.block_rank() == 0 && threadIdx.x < gp) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < nb) s += cluster.map_shared_rank(part, r)[threadIdx.x];
      map.out()[g0 + threadIdx.x] = s;
    }
    cluster.sync();   // part is read before any block reuses or leaves it
  }
}

template <class Cell, int K, bool PAD, bool EP>
__global__ void __launch_bounds__(kThreads)
    row_ll_kernel(const __grid_constant__ RowArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const Layout L(true, a.chunk, a.G, a.k, 0, EP);
  RowMap<Cell, K, PAD, EP> map(a, blockIdx.x / cl, (int)cluster.block_rank(), cl);
  reduce_item<Cell, K, PAD, EP>(map, L, a.k);
}

template <class Cell, int K, bool PAD, bool EP>
__global__ void __launch_bounds__(kThreads)
    col_block_ll_kernel(const __grid_constant__ ColArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const Layout L(false, a.chunk, a.G, a.k, a.n, EP);
  ColMap<Cell, K, PAD, EP> map(a, blockIdx.x / cl, (int)cluster.block_rank(), cl);
  reduce_item<Cell, K, PAD, EP>(map, L, a.k);
}

// ---------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------
template <class Args>
cudaError_t launch(void (*kernel)(const Args), const Args& args, int items,
                   int cluster, int smem, cudaStream_t s) {
  if (smem > kDefaultSmem) {
    // above 48 KB of dynamic shared memory a kernel must opt in (per
    // device; the call is cheap, so it is not cached)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)items * (unsigned)cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

struct RowLaunch {
  const RowArgs& a;
  int items, cluster, smem;
  cudaStream_t s;
  template <int K, bool PAD, bool EP>
  cudaError_t go() const {
    return launch(row_ll_kernel<PoissonCell, K, PAD, EP>, a, items, cluster,
                  smem, s);
  }
};

struct ColLaunch {
  const ColArgs& a;
  int items, cluster, smem;
  cudaStream_t s;
  template <int K, bool PAD, bool EP>
  cudaError_t go() const {
    return launch(col_block_ll_kernel<PoissonCell, K, PAD, EP>, a, items,
                  cluster, smem, s);
  }
};

// k = 1..8 exactly; 9..16 and 17..32 in zero-padded registers
template <class L>
cudaError_t dispatch(const L& l, int k, bool ep) {
#define FMF_K(KV, PAD)                                        \
  return ep ? l.template go<KV, PAD, true>()                  \
            : l.template go<KV, PAD, false>()
  switch (k) {
    case 1: FMF_K(1, false);
    case 2: FMF_K(2, false);
    case 3: FMF_K(3, false);
    case 4: FMF_K(4, false);
    case 5: FMF_K(5, false);
    case 6: FMF_K(6, false);
    case 7: FMF_K(7, false);
    case 8: FMF_K(8, false);
    default: break;
  }
  if (k <= 16) FMF_K(16, true);
  FMF_K(32, true);
#undef FMF_K
}

bool plan_ok(int cluster, int chunk, int smem, const Layout& L) {
  return cluster >= 1 && cluster <= kMaxCluster && chunk >= 1 &&
         (long long)smem == 4ll * L.total;
}

constexpr int kCellPoisson = 0;

}  // namespace

extern "C" {

const char* fmf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// mu and sig are both null (no EP) or both (nrows, C) beside y. The plan
// (cluster blocks an item, cells a chunk, dynamic shared-memory bytes)
// comes from ops/fused_ll.py:_launch_plan.
int fmf_row_ll(int cell, const float* cands, const float* bt, const float* y,
               const float* mu, const float* sig, const int* row_chain,
               const int* row_idx, float* out, int R, int G, int k, int C,
               int nchains, int nrows, void* stream, int cluster, int chunk,
               int smem) {
  if (R == 0 || G == 0) return 0;
  const bool ep = mu != nullptr;
  if (k < 1 || k > 32 || ep != (sig != nullptr) || cell != kCellPoisson ||
      C < cluster ||
      !plan_ok(cluster, chunk, smem, Layout(true, chunk, G, k, 0, ep)))
    return (int)cudaErrorInvalidValue;
  const RowArgs a{cands, bt, y, mu, sig, row_chain, row_idx, out,
                  G, k, C, nchains, nrows, chunk};
  return (int)dispatch(
      RowLaunch{a, R, cluster, smem, static_cast<cudaStream_t>(stream)}, k,
      ep);
}

// mu and sig are both null (no EP) or both (n, m, T) beside y.
int fmf_col_block_ll(int cell, const float* cands, const float* w,
                     const float* y, const float* mu, const float* sig,
                     const int* pair_chain, const int* pair_col,
                     const int* pair_t0, float* out, int P, int G, int Tb,
                     int k, int n, int m, int T, int nchains, void* stream,
                     int cluster, int chunk, int smem) {
  if (P == 0 || G == 0) return 0;
  const bool ep = mu != nullptr;
  if (k < 1 || k > 32 || Tb < cluster || ep != (sig != nullptr) ||
      cell != kCellPoisson ||
      !plan_ok(cluster, chunk, smem, Layout(false, chunk, G, k, n, ep)))
    return (int)cudaErrorInvalidValue;
  const ColArgs a{cands, w,   y,  mu, sig, pair_chain, pair_col, pair_t0,
                  out,   G,   Tb, k,  n,   m,          T,        nchains,
                  chunk};
  return (int)dispatch(
      ColLaunch{a, P, cluster, smem, static_cast<cudaStream_t>(stream)}, k,
      ep);
}

}  // extern "C"
