// The CFC proposal's fixed-point solve: per-slot weights that reproduce a
// slot's marginal given the previous slot's, one thread per (lane, slot)
// row, each with its own loop of up to `maxiter` iterations.
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
// What bounds it on the H100: latency. At config 3's lockstep step (640
// lanes x 4 slots, n = 2) the work is a few kFLOP per iteration per row
// on a few hundred kB of data, far below a microsecond at the card's
// peaks; the rows' dependent chains (exp, log, a few tens of iterations)
// and the launch set the time. One thread per row keeps every chain in
// registers and local memory and needs no synchronization; the transition
// matrix sits in shared memory.
#include <math.h>

#include "kalman_common.cuh"

namespace {

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }

// lane_logsumexp(exact=True) of x[0..n-1]; p2 is the smallest power of two
// >= n (<= NP)
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
__global__ void __launch_bounds__(128)
cfc_solve_kernel(const T* __restrict__ logf, const T* __restrict__ logg,
                 const unsigned char* __restrict__ transitions,
                 const unsigned char* __restrict__ frozen, T* __restrict__ logp,
                 unsigned char* __restrict__ converged, long long M, int n,
                 int p2, int maxiter, T precision) {
  __shared__ unsigned char allowed[NP * NP];
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    allowed[(e / n) * NP + e % n] = transitions[e];
  __syncthreads();
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= M) return;

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

template <typename T, int NP>
int launch_solve(const void* logf, const void* logg, const void* transitions,
                 const void* frozen, void* logp, void* converged, long long M,
                 int n, int maxiter, double precision, int device,
                 void* stream) {
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  const int threads = 128;
  return bild::launch(cfc_solve_kernel<T, NP>, (M + threads - 1) / threads,
                      threads, 0, device, stream, static_cast<const T*>(logf),
                      static_cast<const T*>(logg),
                      static_cast<const unsigned char*>(transitions),
                      static_cast<const unsigned char*>(frozen),
                      static_cast<T*>(logp),
                      static_cast<unsigned char*>(converged), M, n, p2, maxiter,
                      static_cast<T>(precision));
}

template <typename T>
int solve(const void* logf, const void* logg, const void* transitions,
          const void* frozen, void* logp, void* converged, int M, int n,
          int maxiter, double precision, int device, void* stream) {
  if (n < 1 || n > 64 || M < 0 || maxiter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 4)
    return launch_solve<T, 4>(logf, logg, transitions, frozen, logp, converged,
                              M, n, maxiter, precision, device, stream);
  if (n <= 8)
    return launch_solve<T, 8>(logf, logg, transitions, frozen, logp, converged,
                              M, n, maxiter, precision, device, stream);
  if (n <= 16)
    return launch_solve<T, 16>(logf, logg, transitions, frozen, logp, converged,
                               M, n, maxiter, precision, device, stream);
  if (n <= 32)
    return launch_solve<T, 32>(logf, logg, transitions, frozen, logp, converged,
                               M, n, maxiter, precision, device, stream);
  return launch_solve<T, 64>(logf, logg, transitions, frozen, logp, converged,
                             M, n, maxiter, precision, device, stream);
}

}  // namespace

// logf, logg, logp (M, n) and converged (M,) contiguous; transitions (n,
// n) and frozen (M,) one byte per entry (frozen may be null: nothing
// pre-frozen)
#define BILD_CFC_ENTRY(NAME, TYPE)                                              \
  extern "C" int NAME(const void* logf, const void* logg,                       \
                      const void* transitions, const void* frozen, void* logp,  \
                      void* converged, int M, int n, int maxiter, int device,   \
                      double precision, void* stream) {                         \
    return solve<TYPE>(logf, logg, transitions, frozen, logp, converged, M, n,  \
                       maxiter, precision, device, stream);                     \
  }

BILD_CFC_ENTRY(bild_cfc_solve_f32, float)
BILD_CFC_ENTRY(bild_cfc_solve_f64, double)
