// Packed-symmetric Rouse-Kalman log-likelihood: one block per (lane,
// profile), where a lane is one trajectory and all lanes share the model.
//
// Replaces the Pallas kernel bild_tpu/ops/kalman_sym.py::_kernel. The
// covariance is carried packed: the PP = N(N+1)/2 entries (a, b), a <= b, in
// row-major upper-triangle order, q copies. The host builds, per state s
// (bild_tpu_torch/ops/kalman_sym.py::build_sym_operators):
//   P_s (PP x PP, rows padded to PPp)  c' = P_s c + sig_s  is pack(B C B^T)
//   U1  rows 0..N-1 give Cw = C w, row S_OFF gives w.C.w
//   Ballw_s ((N+1) x N) = [B_s; w.B_s], Gsw_s = [G_s; w.G_s]
// so that per frame, with s = profile[t],
//   c' = P_s c + sig_s                      (one warp per packed row)
//   M' = Ballw_s M + Gsw_s                  (row N of M' is the predicted w.M')
// and at observed frames
//   R = U1 c:  Cw = R[0..N-1],  S = R[N] + s2,  Sinv = 1 / S
//   c[(a,b)] -= (Cw_a Cw_b) Sinv            (the packed rank-1 downdate)
//   M += (Cw Sinv)[Cind] (y - w.M)
//   ll -= 1/2 (xmm^2 Sinv - log Sinv + log 2pi)
// The Pallas kernel propagated every profile through EVERY state and
// selected with one-hot masks, and got its trajectory axis from jax.vmap
// around the call; here a block applies its own state only, and the grid
// holds every (lane, profile) pair of a lockstep step: block b reads lane
// b / P's frames.
//
// What bounds it on the H100: each block streams its state's whole P_s
// (PP^2 scalars, 176 KB at N=20 in float32) from L2 at every frame, for
// one profile's q matrix-vector products; the P_s of all states (373 KB at
// n=2) stays L2-resident, and the wrapper sends shapes whose operators
// exceed a fixed L2 budget to the dense kernel. A warp reads one operator
// row with coalesced loads and applies it to up to kQChunk covariance
// copies at once, so q copies do not multiply the L2 traffic. Reusing
// one P_s read across a tile of profiles (tensor-core GEMM, profiles as
// the N dimension) is the later fast version.
#include "kalman_common.cuh"

namespace {

template <typename scalar_t>
__global__ void __launch_bounds__(bild::kThreads)
kalman_sym_kernel(const scalar_t* __restrict__ Pall,
                  const scalar_t* __restrict__ sig,
                  const scalar_t* __restrict__ c0,
                  const scalar_t* __restrict__ U1,
                  const scalar_t* __restrict__ Ballw,
                  const scalar_t* __restrict__ Gsw,
                  const scalar_t* __restrict__ M0w,
                  const scalar_t* __restrict__ s2,
                  const int* __restrict__ Cind,
                  const int* __restrict__ profiles,
                  const scalar_t* __restrict__ ydata,
                  const unsigned char* __restrict__ valid,
                  scalar_t* __restrict__ out,
                  int n, int N, int d, int q, int P, int T, int PPp,
                  int S_OFF, int N1p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int PP = N * (N + 1) / 2;
  const int N1 = N + 1;
  scalar_t* c = reinterpret_cast<scalar_t*>(smem_raw);  // (q, PP)
  scalar_t* cn = c + q * PP;                            // (q, PP)
  scalar_t* R = cn + q * PP;                            // (q, N+1): Cw, then w.C.w
  scalar_t* M = R + q * N1;                             // (N+1, d): M, then w.M
  scalar_t* Mn = M + N1 * d;                            // (N+1, d)

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  const int* prof = profiles + static_cast<size_t>(blockIdx.x) * T;
  const size_t traj = blockIdx.x / P;  // this block's lane (trajectory)
  const scalar_t* y_traj = ydata + traj * T * d;
  const unsigned char* valid_traj = valid + traj * T;
  scalar_t ll = 0;  // accumulated by thread 0

  // out[(qi, row)] = A[row, :PP] . c[qi, :] (+ bias[row]) for rows 0..nrows-1;
  // `row_of` maps an output row to its operator row
  auto rows_dot_c = [&](const scalar_t* A, const scalar_t* bias, int nrows,
                        int out_stride, scalar_t* dst, auto row_of) {
    for (int q0 = 0; q0 < q; q0 += bild::kQChunk) {
      const int nq = min(bild::kQChunk, q - q0);
      for (int r = warp; r < nrows; r += nwarps) {
        const scalar_t* row = A + static_cast<size_t>(row_of(r)) * PPp;
        scalar_t acc[bild::kQChunk] = {};
        for (int j = lane; j < PP; j += 32) {
          const scalar_t a = row[j];
#pragma unroll
          for (int u = 0; u < bild::kQChunk; ++u)
            if (u < nq) acc[u] += a * c[(q0 + u) * PP + j];
        }
#pragma unroll
        for (int u = 0; u < bild::kQChunk; ++u) {
          if (u < nq) {
            const scalar_t v = bild::warp_sum(acc[u]);
            if (lane == 0) dst[(q0 + u) * out_stride + r] = bias ? v + bias[r] : v;
          }
        }
      }
    }
  };

  const int s0 = bild::clamp_state(prof[0], n);
  for (int i = tid; i < q * PP; i += nth) c[i] = c0[static_cast<size_t>(s0) * PPp + i % PP];
  for (int i = tid; i < N1 * d; i += nth) M[i] = M0w[static_cast<size_t>(s0) * N1p * d + i];
  __syncthreads();

  auto update = [&](int t) {
    const scalar_t* y = y_traj + static_cast<size_t>(t) * d;
    rows_dot_c(U1, nullptr, N1, N1, R,
               [&](int r) { return r < N ? r : S_OFF; });
    __syncthreads();
    for (int idx = tid; idx < q * N * N; idx += nth) {
      const int qi = idx / (N * N), a = (idx / N) % N, b = idx % N;
      if (b < a) continue;
      const scalar_t* Rq = R + qi * N1;
      const scalar_t Sinv = scalar_t(1) / (Rq[N] + s2[qi]);
      c[qi * PP + a * N - a * (a - 1) / 2 + (b - a)] -= (Rq[a] * Rq[b]) * Sinv;
    }
    for (int idx = tid; idx < N * d; idx += nth) {
      const int i = idx / d, dd = idx % d;
      const scalar_t* Rq = R + Cind[dd] * N1;
      const scalar_t Sinv = scalar_t(1) / (Rq[N] + s2[Cind[dd]]);
      M[idx] += (Rq[i] * Sinv) * (y[dd] - M[N * d + dd]);
    }
    if (tid == 0) {
      for (int dd = 0; dd < d; ++dd) {
        const scalar_t* Rq = R + Cind[dd] * N1;
        const scalar_t Sinv = scalar_t(1) / (Rq[N] + s2[Cind[dd]]);
        const scalar_t xmm = y[dd] - M[N * d + dd];
        ll -= scalar_t(0.5) *
              (xmm * xmm * Sinv - bild::dlog(Sinv) + scalar_t(bild::kLog2Pi));
      }
    }
    __syncthreads();
  };

  if (valid_traj[0]) update(0);

  for (int t = 1; t < T; ++t) {
    const int s = bild::clamp_state(prof[t], n);
    rows_dot_c(Pall + static_cast<size_t>(s) * PPp * PPp,
               sig + static_cast<size_t>(s) * PPp, PP, PP, cn,
               [](int r) { return r; });
    const scalar_t* Bw = Ballw + static_cast<size_t>(s) * N1p * N;
    const scalar_t* Gw = Gsw + static_cast<size_t>(s) * N1p * d;
    for (int idx = tid; idx < N1 * d; idx += nth) {
      const int i = idx / d, dd = idx % d;
      scalar_t acc = 0;
      for (int k = 0; k < N; ++k) acc += Bw[i * N + k] * M[k * d + dd];
      Mn[idx] = acc + Gw[idx];
    }
    __syncthreads();
    scalar_t* tmp = c; c = cn; cn = tmp;
    tmp = M; M = Mn; Mn = tmp;

    if (valid_traj[t]) update(t);
  }

  if (tid == 0) out[blockIdx.x] = ll;
}

size_t sym_smem_elems(int N, int d, int q) {
  const size_t PP = static_cast<size_t>(N) * (N + 1) / 2;
  return 2 * q * PP + static_cast<size_t>(q) * (N + 1) + 2 * static_cast<size_t>(N + 1) * d;
}

template <typename scalar_t>
int launch_sym(const void* Pall, const void* sig, const void* c0,
               const void* U1, const void* Ballw, const void* Gsw,
               const void* M0w, const void* s2, const void* Cind,
               const void* profiles, const void* ydata, const void* valid,
               void* out, int n, int N, int d, int q, int L, int P, int T,
               int PPp, int S_OFF, int N1p, int device, void* stream) {
  const size_t smem = sym_smem_elems(N, d, q) * sizeof(scalar_t);
  return bild::launch_per_profile(
      kalman_sym_kernel<scalar_t>, L, P, smem, device, stream,
      static_cast<const scalar_t*>(Pall), static_cast<const scalar_t*>(sig),
      static_cast<const scalar_t*>(c0), static_cast<const scalar_t*>(U1),
      static_cast<const scalar_t*>(Ballw), static_cast<const scalar_t*>(Gsw),
      static_cast<const scalar_t*>(M0w), static_cast<const scalar_t*>(s2),
      static_cast<const int*>(Cind), static_cast<const int*>(profiles),
      static_cast<const scalar_t*>(ydata),
      static_cast<const unsigned char*>(valid), static_cast<scalar_t*>(out),
      n, N, d, q, P, T, PPp, S_OFF, N1p);
}

}  // namespace

#define BILD_SYM_ENTRY(NAME, TYPE)                                            \
  extern "C" int NAME(const void* Pall, const void* sig, const void* c0,      \
                      const void* U1, const void* Ballw, const void* Gsw,     \
                      const void* M0w, const void* s2, const void* Cind,      \
                      const void* profiles, const void* ydata,                \
                      const void* valid, void* out, int n, int N, int d,      \
                      int q, int L, int P, int T, int PPp, int S_OFF,         \
                      int N1p, int device, void* stream) {                    \
    return launch_sym<TYPE>(Pall, sig, c0, U1, Ballw, Gsw, M0w, s2, Cind,     \
                            profiles, ydata, valid, out, n, N, d, q, L, P, T, \
                            PPp, S_OFF, N1p, device, stream);                 \
  }

BILD_SYM_ENTRY(bild_kalman_sym_f32, float)
BILD_SYM_ENTRY(bild_kalman_sym_f64, double)
