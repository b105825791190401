// The Polya-Gamma draw of omega ~ PG(b, c) in one kernel, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws PG(b, c) with XLA's
// elementwise ops (functionalmf_tpu/ops/polyagamma.py:38-132), and so does
// the port's plain version (ops/polyagamma.py, ops/gamma.py:gamma_mt). It
// was added because that plain version is the largest phase of a
// negative-binomial sweep: six Marsaglia-Tsang rounds of about twenty
// elementwise passes each over a (terms, cells) float32 tensor, and the
// moved axis and the sum after them, write and read some 150-200 GB a sweep
// at 128 chains of the GDELT shape for a 42 MB answer.
//
// The function is ops/polyagamma.py:polya_gamma's, on the noise that
// ops/gamma.py:draw_gamma_mt_noise drew and clamped: x, u (rounds, terms,
// cells) and ub (terms, cells), laid out so. For a cell with 0 < b < the
// normal cut-off (b_safe = b; 1 elsewhere, as the plain version runs it),
//     omega = sum_k g_k / ((k + 1/2)^2 + (c / 2 pi)^2) / (2 pi^2)
//             + max(E PG(b, c) - b sum_k 1 / denom_k / (2 pi^2), 0),
// g_k ~ Gamma(b, 1) by fixed-round Marsaglia-Tsang (a_eff = b + 1 boosted
// by ub^(1/b) below 1; the first accepted round's d v, a_eff where none
// accepts); at b >= the cut-off the moment-matched normal E + z sd,
// clamped at 1e-12; 0 at b <= 0. The same terms, rounds, tail mean and
// normal branch as the plain version. The acceptance tests run in float32,
// as the plain version takes them; the accepted d v, the boost, the terms'
// sums, the tail mean and the normal branch in float64, rounded once to
// float32 at the end, where the plain version rounds at every step.
//
// What bounds it on this card: bytes. A cell needs the first round's x and
// u of each of its terms (128 bytes at 16 terms), its b, c and z; later
// rounds are read only by the lanes the first one rejected (a round
// accepts with probability at least 0.95) and ub only by cells with b < 1.
// The arithmetic, two float32 logs a round and a float64 cube, division
// and two sums a term, is a small fraction of the card's rate at that byte
// count, float64 included. The design:
//   * One thread a cell, the terms in order k = 0..K-1 with both sums in
//     registers: a cell's sum has a fixed order whatever the batch's shape
//     (a mesh rank's chain slice sums bit for bit as the whole batch).
//   * A lane stops at its first accepted round, so it reads nothing more.
//     Cells with b <= 0 or b >= the cut-off run no gamma rounds at all.
//   * Neighbouring threads take neighbouring cells, so every load is
//     coalesced; the next term's first-round x and u are loaded before the
//     current term is computed, to keep two loads in flight a thread.
// A variant reads caller-given g_k (terms, cells) in place of the rounds
// (polya_gamma's injected ``g``, and its ``use_mt=False`` draws).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr double kTwoPiSq = 19.739208802178716;   // 2 pi^2
constexpr double kTwoPi = 6.283185307179586;

struct PgArgs {
  const float* b;
  const float* c;
  const float* z;
  const float* x;    // (rounds, terms, cells), or null with g
  const float* u;    // (rounds, terms, cells), or null with g
  const float* ub;   // (terms, cells), or null with g
  const float* g;    // (terms, cells), or null
  float* out;
  long long cells;
  int terms;
  int rounds;
  float normal_above;
};

// tanh(c / 2) / c with its c -> 0 series (ops/polyagamma.py:_tanh_half_over)
__device__ __forceinline__ double tanh_half_over(double c) {
  const double x = 0.5 * c;
  const double x2 = x * x;
  const double ratio = fabs(x) < 0.05 ? 1.0 - x2 / 3.0 + 2.0 * x2 * x2 / 15.0
                                      : tanh(x) / x;
  return 0.5 * ratio;
}

// Var PG(b, c) with its series below |c| = 0.5, clamped at 0 (pg_var)
__device__ __forceinline__ double pg_var(double b, double c) {
  const double c2 = c * c;
  const double v = fabs(c) < 0.5
                       ? (1.0 + c2 / 20.0 + c2 * c2 / 840.0) / 24.0
                       : (sinh(c) - c) / (4.0 * (c * c * c));
  const double ch = cosh(c / 2.0);
  const double bv = b * (v / (ch * ch));
  return bv < 0.0 ? 0.0 : bv;         // a NaN stays NaN, as torch.clamp
}

template <bool FROM_G>
__global__ void __launch_bounds__(kThreads)
    polya_gamma_kernel(const PgArgs a) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= a.cells) return;
  const float bf = a.b[s];
  if (!(bf > 0.0f)) {
    a.out[s] = 0.0f;
    return;
  }
  const double b = bf, c = a.c[s];
  const double mean_full = 0.5 * b * tanh_half_over(c);
  if (bf >= a.normal_above) {
    const float w = (float)(mean_full + a.z[s] * sqrt(pg_var(b, c)));
    a.out[s] = w < 1e-12f ? 1e-12f : w;
    return;
  }
  const long long S = a.cells;
  const int K = a.terms;
  const double cc = c / kTwoPi;
  const double cc2 = cc * cc;
  // the lane's Marsaglia-Tsang constants (ops/gamma.py:gamma_mt); the
  // acceptance test in float32, as the plain version takes it
  const bool small = bf < 1.0f;
  const double a_eff = small ? b + 1.0 : b;
  const double d = a_eff - 1.0 / 3.0;
  const double cm = 1.0 / sqrt(9.0 * d);
  const float df = (float)d, cmf = (float)cm;
  const double a_clamp = fmax(b, 1e-12);

  double sum_g = 0.0, sum_inv = 0.0;
  float xn = 0.0f, un = 0.0f;
  if (!FROM_G) {
    xn = a.x[s];
    un = a.u[s];
  }
  for (int k = 0; k < K; ++k) {
    const long long ks = (long long)k * S + s;
    double g;
    if (FROM_G) {
      g = a.g[ks];
    } else {
      const float x0 = xn, u0 = un;
      if (k + 1 < K) {             // the next term's first round, in flight
        xn = a.x[ks + S];
        un = a.u[ks + S];
      }
      g = a_eff;                   // no round accepted: the mean
      for (int r = 0; r < a.rounds; ++r) {
        float x, u;
        if (r == 0) {
          x = x0;
          u = u0;
        } else {
          const long long i = ((long long)r * K) * S + ks;
          x = a.x[i];
          u = a.u[i];
        }
        const float t = 1.0f + cmf * x;
        const float v = t * t * t;
        if (v > 0.0f &&
            logf(u) < 0.5f * x * x + df - df * v + df * logf(v)) {
          const double td = 1.0 + cm * x;
          g = d * (td * td * td);
          break;
        }
      }
      if (small) g *= exp(log((double)a.ub[ks]) / a_clamp);
    }
    const double kh = k + 0.5;
    const double inv = 1.0 / (kh * kh + cc2);
    sum_g += g * inv;
    sum_inv += inv;
  }
  const double tail = mean_full - b * sum_inv / kTwoPiSq;
  a.out[s] = (float)(sum_g / kTwoPiSq + (tail < 0.0 ? 0.0 : tail));
}

}  // namespace

extern "C" {

// b, c, z, out: (cells,); x, u: (rounds, terms, cells) and ub: (terms,
// cells) with g null, or g: (terms, cells) with x, u and ub null. All
// float32 and contiguous. Launches on ``stream`` and returns
// cudaGetLastError() (the launch's own error; 0 when all went well).
int fmf_polya_gamma(const float* b, const float* c, const float* z,
                    const float* x, const float* u, const float* ub,
                    const float* g, float* out, long long cells, int terms,
                    int rounds, float normal_above, void* stream) {
  if (cells == 0) return 0;
  const bool from_g = g != nullptr;
  if (cells < 0 || terms < 1 || b == nullptr || c == nullptr ||
      z == nullptr || out == nullptr ||
      (!from_g && (x == nullptr || u == nullptr || ub == nullptr ||
                   rounds < 1)))
    return (int)cudaErrorInvalidValue;
  const PgArgs a{b, c, z, x, u, ub, g, out, cells, terms, rounds,
                 normal_above};
  const unsigned blocks = (unsigned)((cells + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (from_g)
    polya_gamma_kernel<true><<<blocks, kThreads, 0, s>>>(a);
  else
    polya_gamma_kernel<false><<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
