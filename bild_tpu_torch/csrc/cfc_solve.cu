// The CFC proposal's fixed-point solve: per-slot weights that reproduce a
// slot's marginal given the previous slot's, each (lane, slot) row with
// its own loop of up to `maxiter` iterations.
//
// Replaces the body of the device `lax.while_loop` of
// bild_tpu/amis/cfc.py::_solve_marginals (l.146-170), which is not a Pallas
// kernel: XLA ran it as one loop over every slot of every lane, stopping
// when all had converged. A slot freezes at its first iterate whose
// largest change is below `precision`, so a slot's result does not depend
// on the others' (bild_tpu's docstring, l.131-134): here each row stops on
// its own, with no reduction across rows and no host round trip. The plain
// version is amis/cfc.py::_solve_marginals, which the CPU runs.
//
// Per iteration, with allowed(i, j) the transition matrix, f the slot's
// log-marginal, g the previous slot's and p the current weights:
//   norm[i] = lse_j{allowed(i, j)} p[j]       (0 where g[i] = -inf)
//   S[j]    = lse_i{allowed(i, j)} (g[i] - norm[i])   (0 where f[j] = -inf)
//   p'[j]   = f[j] - S[j] - lse_j (f - S)
// and the row converges when max_j |p' - p| (0 where f[j] = -inf) is
// below `precision`. A row whose f or g holds a 0 (a Kronecker delta)
// returns f and counts as converged, as does a row the caller freezes.
//
// Bits. Every log-sum-exp is lanes.py::lane_logsumexp(exact=True): m =
// max (NaN if any entry is NaN; then, as an infinite one, replaced by 0),
// exp(x - m) zero-padded to a power of two and summed by the pairwise tree
// x[j] + x[j + h], h halving, then log + m. No product appears, so no FMA
// contraction can move a bit, and the comparison with `precision` is made
// in the row's type, as PyTorch compares a tensor with a Python float. So
// the kernel computes what the plain version computes, bit for bit where
// exp and log round as PyTorch's elementwise kernels do.
//
// What bounds it on the H100: latency. The work is a few hundred
// operations per iteration per row on a few hundred kB of data, far below
// a microsecond at the card's peaks; a launch lasts as long as its slowest
// row's chain of dependent iterations (config 3's rows converge in one,
// config 4's three-state rows take tens to hundreds). What the design does
// about it, for n <= 8 states (every model of the repository):
//  - n is a compile-time constant (one instantiation per n), so every
//    array lives in registers: no local memory. The launch bounds ask for
//    one block per SM at least, which leaves ptxas the registers to keep
//    it so (without the 1, float64 at n = 3 spilled 72 bytes at 64
//    registers).
//  - A group of p2 threads (p2 the power of two >= n) serves a row,
//    several rows per warp. Thread i computes norm[i], thread j computes
//    S[j]; the norms and the terms f - S reach the group's threads by
//    warp shuffles, and each thread then holds the whole new p: an
//    iteration's chain is three log-sum-exps, not 2n + 1. The last
//    log-sum-exp and the largest change are taken in every thread of the
//    group over the gathered terms, in the plain tree's order (one
//    shuffle's latency where a butterfly of shuffles would take log2 p2).
//  - The grid is rows x p2 threads in blocks of 64, so a few thousand
//    rows spread over most of the SMs.
// Rows of 9 to 64 states take the general path: one thread per row with
// its arrays sized to the next power of two.
#include <math.h>

#include "kalman_common.cuh"

namespace {

// the largest state count with a group kernel of its own
// (amis/cfc.py::SOLVE_GROUP_STATES); the threads of a block
// (amis/cfc.py::SOLVE_THREADS)
constexpr int kGroupStates = 8;
constexpr int kThreads = 64;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// lane_logsumexp(exact=True) of x[0..N-1], every index a constant
template <typename T, int N>
__device__ __forceinline__ T lse_fixed(const T (&x)[N]) {
  constexpr int P = pow2_at_least(N);
  T m = x[0];
#pragma unroll
  for (int j = 1; j < N; ++j)
    if (x[j] > m || isnan(x[j])) m = x[j];
  if (isnan(m) || isinf(m)) m = T(0);
  T s[P];
#pragma unroll
  for (int j = 0; j < P; ++j) s[j] = j < N ? dexp(x[j] - m) : T(0);
#pragma unroll
  for (int h = P >> 1; h >= 1; h >>= 1)
#pragma unroll
    for (int j = 0; j < h; ++j) s[j] = s[j] + s[j + h];
  return bild::dlog(s[0]) + m;
}

// A group of P = pow2_at_least(N) threads per row: thread `me` of the
// group (its lane in the warp modulo P) owns state `me` where me < N.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
cfc_solve_kernel(const T* __restrict__ logf, const T* __restrict__ logg,
                 const unsigned char* __restrict__ transitions,
                 const unsigned char* __restrict__ frozen, T* __restrict__ logp,
                 unsigned char* __restrict__ converged, long long M, int maxiter,
                 T precision) {
  constexpr int P = pow2_at_least(N);
  static_assert(P <= 32 && kThreads % P == 0, "a group lies in one warp");
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long r = t / P;
  if (r >= M) return;                 // the whole group: rows are P-aligned
  const int me = threadIdx.x % P;
  const unsigned mask =
      P == 32 ? 0xffffffffu : ((1u << P) - 1) << ((threadIdx.x % 32) & ~(P - 1));
  const bool mine = me < N;
  const T ninf = -INFINITY;

  T f[N], g[N], p[N];
  bool is_delta = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    f[j] = logf[r * N + j];
    g[j] = logg[r * N + j];
    p[j] = f[j];
    is_delta = is_delta || f[j] == T(0) || g[j] == T(0);
  }
  // this thread's state: its f and g, its row and column of the matrix
  T f_me = ninf, g_me = ninf;
  unsigned row = 0, col = 0;
  if (mine) {
    f_me = logf[r * N + me];
    g_me = logg[r * N + me];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      row |= static_cast<unsigned>(transitions[me * N + j] != 0) << j;
      col |= static_cast<unsigned>(transitions[j * N + me] != 0) << j;
    }
  }
  bool done = is_delta || (frozen != nullptr && frozen[r]);
  for (int it = 0; it < maxiter && !done; ++it) {
    T x[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = (row >> j) & 1 ? p[j] : ninf;
    const T norm_me = g_me == ninf ? T(0) : lse_fixed<T, N>(x);
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[i] = g[i] - __shfl_sync(mask, norm_me, i, P);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = (col >> i) & 1 ? x[i] : ninf;
    const T s = lse_fixed<T, N>(x);
    const T q_me = f_me - (f_me == ninf ? T(0) : s);
    T q[N];
#pragma unroll
    for (int j = 0; j < N; ++j) q[j] = __shfl_sync(mask, q_me, j, P);
    const T z = lse_fixed<T, N>(q);
    T most = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      q[j] = q[j] - z;
      const T dj = f[j] == ninf ? T(0) : fabs(q[j] - p[j]);
      if (j == 0 || dj > most || isnan(dj)) most = isnan(most) ? most : dj;
      p[j] = q[j];
    }
    done = most < precision;
  }
  if (mine) {
    T out = f_me;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j == me && !is_delta) out = p[j];
    logp[r * N + me] = out;
  }
  if (me == 0) converged[r] = done;
}

// The general path (9 to 64 states): one thread per row, arrays of NP
// entries, n and its power of two p2 at run time.
template <typename T, int NP>
__device__ T exact_lse(const T* x, int n, int p2) {
  T m = x[0];
  for (int j = 1; j < n; ++j)
    if (x[j] > m || isnan(x[j])) m = x[j];
  if (isnan(m) || isinf(m)) m = T(0);
  T s[NP];
  for (int j = 0; j < p2; ++j) s[j] = j < n ? dexp(x[j] - m) : T(0);
  for (int h = p2 >> 1; h >= 1; h >>= 1)
    for (int j = 0; j < h; ++j) s[j] = s[j] + s[j + h];
  return bild::dlog(s[0]) + m;
}

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
cfc_solve_kernel_wide(const T* __restrict__ logf, const T* __restrict__ logg,
                 const unsigned char* __restrict__ transitions,
                 const unsigned char* __restrict__ frozen, T* __restrict__ logp,
                 unsigned char* __restrict__ converged, long long M, int n,
                 int maxiter, T precision) {
  __shared__ unsigned char allowed[NP * NP];
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    allowed[(e / n) * NP + e % n] = transitions[e];
  __syncthreads();
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= M) return;
  int p2 = 1;
  while (p2 < n) p2 <<= 1;

  const T ninf = -INFINITY;
  T f[NP], g[NP], p[NP], norm[NP], x[NP];
  bool is_delta = false;
  for (int j = 0; j < n; ++j) {
    f[j] = logf[r * n + j];
    g[j] = logg[r * n + j];
    p[j] = f[j];
    is_delta = is_delta || f[j] == T(0) || g[j] == T(0);
  }
  bool done = is_delta || (frozen != nullptr && frozen[r]);
  for (int it = 0; it < maxiter && !done; ++it) {
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) x[j] = allowed[i * NP + j] ? p[j] : ninf;
      const T v = exact_lse<T, NP>(x, n, p2);
      norm[i] = g[i] == ninf ? T(0) : v;
    }
    T q[NP];
    for (int j = 0; j < n; ++j) {
      for (int i = 0; i < n; ++i) x[i] = allowed[i * NP + j] ? g[i] - norm[i] : ninf;
      const T v = exact_lse<T, NP>(x, n, p2);
      q[j] = f[j] - (f[j] == ninf ? T(0) : v);
    }
    const T z = exact_lse<T, NP>(q, n, p2);
    T most = T(0);
    for (int j = 0; j < n; ++j) {
      q[j] = q[j] - z;
      const T dj = f[j] == ninf ? T(0) : fabs(q[j] - p[j]);
      if (j == 0 || dj > most || isnan(dj)) most = isnan(most) ? most : dj;
      p[j] = q[j];
    }
    done = most < precision;
  }
  for (int j = 0; j < n; ++j) logp[r * n + j] = is_delta ? f[j] : p[j];
  converged[r] = done;
}

struct Args {
  const void *logf, *logg, *transitions, *frozen;
  void *logp, *converged;
  long long M;
  int n, maxiter;
  double precision;
  int device;
  void* stream;
};

template <typename T, int N>
int launch_group(const Args& a) {
  constexpr int P = pow2_at_least(N);
  return bild::launch(cfc_solve_kernel<T, N>, (a.M * P + kThreads - 1) / kThreads,
                      kThreads, 0, a.device, a.stream,
                      static_cast<const T*>(a.logf), static_cast<const T*>(a.logg),
                      static_cast<const unsigned char*>(a.transitions),
                      static_cast<const unsigned char*>(a.frozen),
                      static_cast<T*>(a.logp),
                      static_cast<unsigned char*>(a.converged), a.M, a.maxiter,
                      static_cast<T>(a.precision));
}

template <typename T, int NP>
int launch_general(const Args& a) {
  return bild::launch(cfc_solve_kernel_wide<T, NP>, (a.M + kThreads - 1) / kThreads,
                      kThreads, 0, a.device, a.stream,
                      static_cast<const T*>(a.logf), static_cast<const T*>(a.logg),
                      static_cast<const unsigned char*>(a.transitions),
                      static_cast<const unsigned char*>(a.frozen),
                      static_cast<T*>(a.logp),
                      static_cast<unsigned char*>(a.converged), a.M, a.n,
                      a.maxiter, static_cast<T>(a.precision));
}

// `group` and `threads` are amis/cfc.py::solve_plan's: refused unless
// they are the kernel's own
template <typename T>
int solve(const Args& a, int group, int threads) {
  if (a.n < 1 || a.n > 64 || a.M < 0 || a.maxiter < 0 || threads != kThreads ||
      group != (a.n <= kGroupStates ? pow2_at_least(a.n) : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a.n) {
    case 1: return launch_group<T, 1>(a);
    case 2: return launch_group<T, 2>(a);
    case 3: return launch_group<T, 3>(a);
    case 4: return launch_group<T, 4>(a);
    case 5: return launch_group<T, 5>(a);
    case 6: return launch_group<T, 6>(a);
    case 7: return launch_group<T, 7>(a);
    case 8: return launch_group<T, 8>(a);
  }
  if (a.n <= 16) return launch_general<T, 16>(a);
  if (a.n <= 32) return launch_general<T, 32>(a);
  return launch_general<T, 64>(a);
}

}  // namespace

// logf, logg, logp (M, n) and converged (M,) contiguous; transitions (n,
// n) and frozen (M,) one byte per entry (frozen may be null: nothing
// pre-frozen); group and threads from solve_plan
#define BILD_CFC_ENTRY(NAME, TYPE)                                              \
  extern "C" int NAME(const void* logf, const void* logg,                       \
                      const void* transitions, const void* frozen, void* logp,  \
                      void* converged, int M, int n, int maxiter, int group,    \
                      int threads, int device, double precision,                \
                      void* stream) {                                           \
    return solve<TYPE>(Args{logf, logg, transitions, frozen, logp, converged,   \
                            M, n, maxiter, precision, device, stream},          \
                       group, threads);                                         \
  }

BILD_CFC_ENTRY(bild_cfc_solve_f32, float)
BILD_CFC_ENTRY(bild_cfc_solve_f64, double)
