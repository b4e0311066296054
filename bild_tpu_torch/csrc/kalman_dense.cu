// Dense-covariance Rouse-Kalman log-likelihood: one block per (lane,
// profile), where a lane is one trajectory and all lanes share the model.
//
// Replaces the Pallas kernel bild_tpu/ops/kalman_pallas.py::_kernel. That
// kernel propagated a tile of 128 profiles through EVERY state and picked
// each profile's state with one-hot masks, and got its trajectory axis
// from jax.vmap around the call; here a block reads its own profile[t] and
// applies that state's operators only, and the grid holds every (lane,
// profile) pair of a lockstep step: block b reads lane b / P's frames.
//
// Per frame t, with s = profile[t]:
//   M' = B_s M + G_s
//   X  = B_s C,   C' = X B_s + Sig_s           (for each of the q copies)
// and at observed frames the Kalman update
//   Cw = C w,  S = w.Cw + s2,  C -= (Cw / S) Cw^T,
//   M += (Cw / S)[Cind] (y - w.M),  ll += -1/2 (xmm^2 / S + log S + log 2pi).
//
// Shared memory holds C (q copies), the scratch X, the means and the
// update vectors: (q + 1) N^2 + 2 N d + q N + q + d + N scalars, 3.9 KB at
// N=20, d=3, q=1 in float32. B_s, Sig_s, G_s are read from global memory
// and stay in L1/L2 (n N^2 scalars per operator). What bounds the kernel
// is the latency of the frame loop: four to six __syncthreads() per frame,
// 20-term dot products per thread in between, nothing to overlap across
// frames. Many resident blocks per SM (small shared memory) hide part of
// it; tiles of profiles per block come in a later revision.
#include "kalman_common.cuh"

namespace {

template <typename scalar_t>
__global__ void __launch_bounds__(bild::kThreads)
kalman_dense_kernel(const scalar_t* __restrict__ Bs,
                    const scalar_t* __restrict__ Gs,
                    const scalar_t* __restrict__ Sigs,
                    const scalar_t* __restrict__ M0s,
                    const scalar_t* __restrict__ C0s,
                    const scalar_t* __restrict__ w_g,
                    const scalar_t* __restrict__ s2,
                    const int* __restrict__ Cind,
                    const int* __restrict__ profiles,
                    const scalar_t* __restrict__ ydata,
                    const unsigned char* __restrict__ valid,
                    scalar_t* __restrict__ out,
                    int n, int N, int d, int q, int P, int T) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NN = N * N;
  scalar_t* C = reinterpret_cast<scalar_t*>(smem_raw);  // (q, N, N)
  scalar_t* X = C + q * NN;                             // (N, N)
  scalar_t* M = X + NN;                                 // (N, d)
  scalar_t* Mn = M + N * d;                             // (N, d)
  scalar_t* Cw = Mn + N * d;                            // (q, N)
  scalar_t* S = Cw + q * N;                             // (q)
  scalar_t* m = S + q;                                  // (d)
  scalar_t* w = m + d;                                  // (N)

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int* prof = profiles + static_cast<size_t>(blockIdx.x) * T;
  const size_t traj = blockIdx.x / P;  // this block's lane (trajectory)
  const scalar_t* y_traj = ydata + traj * T * d;
  const unsigned char* valid_traj = valid + traj * T;
  scalar_t ll = 0;  // accumulated by thread 0

  const int s0 = bild::clamp_state(prof[0], n);
  for (int i = tid; i < q * NN; i += nth) C[i] = C0s[static_cast<size_t>(s0) * NN + i % NN];
  for (int i = tid; i < N * d; i += nth) M[i] = M0s[static_cast<size_t>(s0) * N * d + i];
  for (int i = tid; i < N; i += nth) w[i] = w_g[i];
  __syncthreads();

  auto update = [&](int t) {
    const scalar_t* y = y_traj + static_cast<size_t>(t) * d;
    for (int idx = tid; idx < q * N; idx += nth) {
      const scalar_t* row = C + (idx / N) * NN + (idx % N) * N;
      scalar_t acc = 0;
      for (int j = 0; j < N; ++j) acc += row[j] * w[j];
      Cw[idx] = acc;
    }
    for (int dd = tid; dd < d; dd += nth) {
      scalar_t acc = 0;
      for (int i = 0; i < N; ++i) acc += M[i * d + dd] * w[i];
      m[dd] = acc;
    }
    __syncthreads();
    for (int qi = tid; qi < q; qi += nth) {
      scalar_t acc = 0;
      for (int i = 0; i < N; ++i) acc += Cw[qi * N + i] * w[i];
      S[qi] = acc + s2[qi];
    }
    __syncthreads();
    for (int idx = tid; idx < q * NN; idx += nth) {
      const int qi = idx / NN, i = (idx / N) % N, j = idx % N;
      C[idx] -= (Cw[qi * N + i] / S[qi]) * Cw[qi * N + j];
    }
    for (int idx = tid; idx < N * d; idx += nth) {
      const int i = idx / d, dd = idx % d, c = Cind[dd];
      M[idx] += (Cw[c * N + i] / S[c]) * (y[dd] - m[dd]);
    }
    if (tid == 0) {
      for (int dd = 0; dd < d; ++dd) {
        const scalar_t Sd = S[Cind[dd]];
        const scalar_t xmm = y[dd] - m[dd];
        ll += scalar_t(-0.5) *
              (xmm * xmm / Sd + bild::dlog(Sd) + scalar_t(bild::kLog2Pi));
      }
    }
    __syncthreads();
  };

  if (valid_traj[0]) update(0);

  for (int t = 1; t < T; ++t) {
    const int s = bild::clamp_state(prof[t], n);
    const scalar_t* B = Bs + static_cast<size_t>(s) * NN;
    const scalar_t* Sig = Sigs + static_cast<size_t>(s) * NN;
    const scalar_t* G = Gs + static_cast<size_t>(s) * N * d;

    for (int idx = tid; idx < N * d; idx += nth) {
      const int i = idx / d, dd = idx % d;
      scalar_t acc = 0;
      for (int k = 0; k < N; ++k) acc += B[i * N + k] * M[k * d + dd];
      Mn[idx] = acc + G[idx];
    }
    for (int qi = 0; qi < q; ++qi) {
      scalar_t* Cq = C + qi * NN;
      for (int idx = tid; idx < NN; idx += nth) {
        const int i = idx / N, j = idx % N;
        scalar_t acc = 0;
        for (int k = 0; k < N; ++k) acc += B[i * N + k] * Cq[k * N + j];
        X[idx] = acc;
      }
      __syncthreads();
      for (int idx = tid; idx < NN; idx += nth) {
        const int i = idx / N, j = idx % N;
        scalar_t acc = 0;
        for (int k = 0; k < N; ++k) acc += X[i * N + k] * B[k * N + j];
        Cq[idx] = acc + Sig[idx];
      }
      __syncthreads();
    }
    for (int idx = tid; idx < N * d; idx += nth) M[idx] = Mn[idx];
    __syncthreads();

    if (valid_traj[t]) update(t);
  }

  if (tid == 0) out[blockIdx.x] = ll;
}

size_t dense_smem_elems(int N, int d, int q) {
  return static_cast<size_t>(q + 1) * N * N + 2 * N * d + q * N + q + d + N;
}

template <typename scalar_t>
int launch_dense(const void* Bs, const void* Gs, const void* Sigs,
                 const void* M0s, const void* C0s, const void* w,
                 const void* s2, const void* Cind, const void* profiles,
                 const void* ydata, const void* valid, void* out,
                 int n, int N, int d, int q, int L, int P, int T, int device,
                 void* stream) {
  const size_t smem = dense_smem_elems(N, d, q) * sizeof(scalar_t);
  return bild::launch_per_profile(
      kalman_dense_kernel<scalar_t>, L, P, smem, device, stream,
      static_cast<const scalar_t*>(Bs), static_cast<const scalar_t*>(Gs),
      static_cast<const scalar_t*>(Sigs), static_cast<const scalar_t*>(M0s),
      static_cast<const scalar_t*>(C0s), static_cast<const scalar_t*>(w),
      static_cast<const scalar_t*>(s2), static_cast<const int*>(Cind),
      static_cast<const int*>(profiles), static_cast<const scalar_t*>(ydata),
      static_cast<const unsigned char*>(valid), static_cast<scalar_t*>(out),
      n, N, d, q, P, T);
}

}  // namespace

#define BILD_DENSE_ENTRY(NAME, TYPE)                                          \
  extern "C" int NAME(const void* Bs, const void* Gs, const void* Sigs,       \
                      const void* M0s, const void* C0s, const void* w,        \
                      const void* s2, const void* Cind, const void* profiles, \
                      const void* ydata, const void* valid, void* out, int n, \
                      int N, int d, int q, int L, int P, int T, int device,   \
                      void* stream) {                                         \
    return launch_dense<TYPE>(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles,  \
                              ydata, valid, out, n, N, d, q, L, P, T, device, \
                              stream);                                        \
  }

BILD_DENSE_ENTRY(bild_kalman_dense_f32, float)
BILD_DENSE_ENTRY(bild_kalman_dense_f64, double)
