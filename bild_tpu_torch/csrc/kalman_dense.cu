// Dense-covariance Rouse-Kalman log-likelihood: one warp per (lane,
// profile), W warps per block, where a lane is one trajectory and all
// lanes share the model.
//
// Replaces the Pallas kernel bild_tpu/ops/kalman_pallas.py::_kernel. That
// kernel propagated a tile of 128 profiles through EVERY state and picked
// each profile's state with one-hot masks, and got its trajectory axis
// from jax.vmap around the call; here a warp reads its own profile[t] and
// applies that state's operators only, and the grid holds every (lane,
// profile) pair of a lockstep step: warp g = block W + warp evaluates
// profile g % P of lane g / P.
//
// Per frame t, with s = profile[t]:
//   M' = B_s M + G_s
//   X  = B_s C,   C' = X B_s + Sig_s           (for each of the q copies)
// and at observed frames the Kalman update
//   Cw = C w,  Sinv = 1 / (w.Cw + s2),  C -= (Cw Sinv) Cw^T,
//   M += (Cw Sinv)[Cind] (y - w.M),
//   ll -= 1/2 (xmm^2 Sinv - log Sinv + log 2pi).
// B_s is symmetric (as the reference assumes, kalman_pallas.py:12), so B_s
// serves as the k-major operand of both products and no B_s^T is kept.
//
// What bounds it on the H100. The least work of this likelihood at N=20,
// d=3, q=1, T=100 is about 27 kFLOP per profile-frame (X = B C in full,
// C' on its upper triangle, the means) and 1.6 kFLOP per observed frame:
// about 232 GFLOP for a lockstep call of 640 lanes x 128 profiles
// (chip_smoke.py::kernel_work), 3.5 ms at the 67 TFLOP/s float32 peak.
// This kernel does the full products, 4 N^3 per frame. The first version
// gave each profile a block of 256 threads: 4-6 block barriers per frame,
// two loads (B from L1, C from shared memory) per FMA, latency-bound at
// 3.4 TFLOP/s.
//
// The design. Each warp owns one profile's C (q, NP, NP), its means M (NP,
// d) and a scratch area in shared memory (N padded to NP, a multiple of
// 4; the scratch holds X^T during the products and Cw, 1/S and w.M in the
// update; the propagated means get a buffer of their own when the
// operators are in shared memory, else the scratch), and runs the frame loop
// alone, with __syncwarp() and no block barrier. Each lane computes a 4x4
// tile of a product: k-major operands (B and C rows for X = B C, X^T and B
// rows for C' = X B) give two 16-byte loads per 16 FMAs, 25 of 32 lanes
// busy at N=20; every k loop runs four k per step, so a single warp's
// frame (the one-trajectory launch) is not a chain of shared-memory
// latencies. When they fit beside W warps, the n states' B_s, Sig_s, G_s
// are loaded into shared memory once per block (6.4 KB at N=20, n=2,
// float32); larger chains read them from global memory through L1, so one
// warp's working set alone bounds N (float32: 168 at q=1, 120 at q=3).
// The wrapper (ops/kalman_dense.py::dense_plan) picks where the operators
// live and W (8, 4, 2 or 1), so that small launches (one trajectory, P=100)
// still spread over the SMs. dense_layout() below and
// ops/kalman_dense.py::dense_smem_bytes compute the same bytes; the launch
// refuses a mismatch. A profile's arithmetic does not depend on its warp
// or block partners, nor on where the operators live. It reaches about 15 %
// of the likelihood's bound (PERF.md, an H100 SXM at 700 W). What holds it
// there: the full products (4 N^3 where the symmetric C' needs 3 N^3), the
// products' shared-memory wavefronts (two 16-byte loads per 16 FMAs, 7 of
// 32 lanes idle at N=20) and the update, a third of the frame, which one
// warp runs as short dependent chains.
#include <type_traits>

#include "kalman_common.cuh"

namespace {

constexpr int kMaxWarps = 8;

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

struct DenseLayout {
  int NP;          // N padded to a multiple of 4
  int scratch;     // scalars of a warp's scratch area
  size_t B, Sig, G, w, s2, Cind, warp0, per_warp, bytes;
};

// Byte offsets of the block's shared memory; mirrored by
// ops/kalman_dense.py::dense_smem_bytes. With ops_shared the n states'
// B, Sig (NP, NP) and G (N, d) come first.
template <typename scalar_t>
__host__ __device__ DenseLayout dense_layout(int n, int N, int d, int q, int W,
                                             bool ops_shared) {
  DenseLayout s;
  const size_t sz = sizeof(scalar_t);
  s.NP = (N + 3) / 4 * 4;
  const int NN = s.NP * s.NP;
  size_t o = 0;
  s.B = s.Sig = s.G = 0;
  if (ops_shared) {
    s.B = o;   o += align16(sz * n * NN);
    s.Sig = o; o += align16(sz * n * NN);
    s.G = o;   o += align16(sz * n * N * d);
  }
  s.w = o;    o += align16(sz * s.NP);
  s.s2 = o;   o += align16(sz * q);
  s.Cind = o; o += align16(4 * d);
  s.warp0 = o;
  // per warp: C (q, NP, NP), the scratch, M (NP, d), and with ops_shared
  // a second mean buffer Mn (NP, d)
  int scratch = NN;
  if (q * s.NP + q + d > scratch) scratch = q * s.NP + q + d;
  if (s.NP * d > scratch) scratch = s.NP * d;
  s.scratch = scratch;
  s.per_warp = align16(sz * (static_cast<size_t>(q) * NN + scratch +
                             (ops_shared ? 2 : 1) * s.NP * d));
  s.bytes = o + W * s.per_warp;
  return s;
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
  constexpr int VW = bild::Vec16<T>::width;
#pragma unroll
  for (int h = 0; h < 4 / VW; ++h) {
    const auto x = bild::load16(p + h * VW);
    const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int u = 0; u < VW; ++u) v[h * VW + u] = xs[u];
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T (&v)[4]) {
  constexpr int VW = bild::Vec16<T>::width;
#pragma unroll
  for (int h = 0; h < 4 / VW; ++h) {
    T part[VW];
#pragma unroll
    for (int u = 0; u < VW; ++u) part[u] = v[h * VW + u];
    bild::store16(p + h * VW, part);
  }
}

// One state's N x N operator, read as k-major rows of 4 scalars: in shared
// memory padded with zeros to (NP, NP) ...
template <typename T>
struct SharedOp {
  const T* p;
  int NP;
  __device__ __forceinline__ T at(int r, int k) const { return p[r * NP + k]; }
  __device__ __forceinline__ void row4(int k, int j0, T (&v)[4]) const {
    load4(p + k * NP + j0, v);
  }
};

// ... or in global memory as the caller gave it, (N, N), through L1, with
// zeros past N: the same values, so the same bits
template <typename T>
struct GlobalOp {
  const T* p;
  int N;
  __device__ __forceinline__ T at(int r, int k) const {
    return r < N && k < N ? __ldg(p + r * N + k) : T(0);
  }
  __device__ __forceinline__ void row4(int k, int j0, T (&v)[4]) const {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = at(k, j0 + u);
  }
};

// out[i][j] (4x4 tile at i0, j0) = sum_k A[k][i0 + i] B[k][j0 + j]: both
// operands k-major (SharedOp, GlobalOp), k = 0..NP-1 in order, four k per
// step so that the loads of a step issue together.
template <typename T, typename OpA, typename OpB>
__device__ __forceinline__ void tile_product(const OpA& A, const OpB& B, int NP,
                                             int i0, int j0, T (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < NP; k0 += 4) {
    T a[4][4], b[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      A.row4(k0 + u, i0, a[u]);
      B.row4(k0 + u, j0, b[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[u][i], b[u][j], acc[i][j]);
  }
}

// sum_k x[k * xs] y[k] over k = 0..NP-1 in order (entries past N are zero)
template <typename T>
__device__ __forceinline__ T dot_np(const T* x, int xs, const T* y, int NP) {
  T acc = 0;
  for (int k0 = 0; k0 < NP; k0 += 4) {
    T xv[4], yv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xv[u] = x[(k0 + u) * xs];
      yv[u] = y[k0 + u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = fma(xv[u], yv[u], acc);
  }
  return acc;
}

template <typename scalar_t, bool kOpsShared>
__global__ void __launch_bounds__(kMaxWarps * 32)
kalman_dense_kernel(const scalar_t* __restrict__ Bs,
                    const scalar_t* __restrict__ Gs,
                    const scalar_t* __restrict__ Sigs,
                    const scalar_t* __restrict__ M0s,
                    const scalar_t* __restrict__ C0s,
                    const scalar_t* __restrict__ w_g,
                    const scalar_t* __restrict__ s2_g,
                    const int* __restrict__ Cind_g,
                    const int* __restrict__ profiles,
                    const scalar_t* __restrict__ ydata,
                    const unsigned char* __restrict__ valid,
                    scalar_t* __restrict__ out,
                    int n, int N, int d, int q, int L, int P, int T, int W) {
  using Op = std::conditional_t<kOpsShared, SharedOp<scalar_t>, GlobalOp<scalar_t>>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DenseLayout lay = dense_layout<scalar_t>(n, N, d, q, W, kOpsShared);
  const int NP = lay.NP;
  const int NN = NP * NP;
  scalar_t* w = reinterpret_cast<scalar_t*>(smem_raw + lay.w);      // (NP)
  scalar_t* s2 = reinterpret_cast<scalar_t*>(smem_raw + lay.s2);    // (q)
  int* Cind = reinterpret_cast<int*>(smem_raw + lay.Cind);          // (d)
  // the operators of state s, and G_s (N, d) row-major in either place
  const scalar_t* G = Gs;
  auto op = [&](const scalar_t* global, size_t shared_at, int s) -> Op {
    if constexpr (kOpsShared)
      return Op{reinterpret_cast<const scalar_t*>(smem_raw + shared_at) + s * NN, NP};
    else
      return Op{global + static_cast<size_t>(s) * N * N, N};
  };

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  if constexpr (kOpsShared) {
    scalar_t* B = reinterpret_cast<scalar_t*>(smem_raw + lay.B);      // (n, NP, NP)
    scalar_t* Sig = reinterpret_cast<scalar_t*>(smem_raw + lay.Sig);  // (n, NP, NP)
    scalar_t* Gsh = reinterpret_cast<scalar_t*>(smem_raw + lay.G);    // (n, N, d)
    for (int i = tid; i < n * NN; i += nth) {
      const int s = i / NN, r = (i / NP) % NP, k = i % NP;
      const bool in = r < N && k < N;
      const size_t at = (static_cast<size_t>(s) * N + r) * N + k;
      B[i] = in ? Bs[at] : scalar_t(0);
      Sig[i] = in ? Sigs[at] : scalar_t(0);
    }
    for (int i = tid; i < n * N * d; i += nth) Gsh[i] = Gs[i];
    G = Gsh;
  }
  for (int i = tid; i < NP; i += nth) w[i] = i < N ? w_g[i] : scalar_t(0);
  for (int i = tid; i < q; i += nth) s2[i] = s2_g[i];
  for (int i = tid; i < d; i += nth) Cind[i] = Cind_g[i];
  __syncthreads();  // the block's only barrier: from here each warp runs alone

  const int warp = tid >> 5, lane = tid & 31;
  const long long g = static_cast<long long>(blockIdx.x) * W + warp;
  if (g >= static_cast<long long>(L) * P) return;
  const size_t traj = static_cast<size_t>(g / P);
  scalar_t* C = reinterpret_cast<scalar_t*>(smem_raw + lay.warp0 + warp * lay.per_warp);
  scalar_t* XT = C + q * NN;        // scratch, (NP, NP): X transposed
  scalar_t* Cw = XT;                // scratch in the update, (q, NP)
  scalar_t* Sinv = Cw + q * NP;     // (q): 1 / S
  scalar_t* m = Sinv + q;           // (d): w.M
  scalar_t* M = XT + lay.scratch;   // (NP, d)
  // the propagated means (NP, d): their own buffer, swapped with M, when
  // the operators leave room; else the scratch, copied back to M
  scalar_t* Mn = kOpsShared ? M + NP * d : XT;
  const int* prof = profiles + static_cast<size_t>(g) * T;
  const scalar_t* y_traj = ydata + traj * T * d;
  const unsigned char* valid_traj = valid + traj * T;
  const int NT = NP / 4;            // 4x4 tiles per dimension
  scalar_t ll = 0;                  // accumulated by lane 0

  const int s0 = bild::clamp_state(prof[0], n);
  for (int i = lane; i < q * NN; i += 32) {
    const int r = (i / NP) % NP, k = i % NP;
    C[i] = r < N && k < N ? C0s[(static_cast<size_t>(s0) * N + r) * N + k] : scalar_t(0);
  }
  for (int i = lane; i < NP * d; i += 32) {
    const int r = i / d, dd = i % d;
    M[i] = r < N ? M0s[(static_cast<size_t>(s0) * N + r) * d + dd] : scalar_t(0);
    if (kOpsShared) Mn[i] = 0;
  }
  __syncwarp();

  auto update = [&](int t) {
    const scalar_t* y = y_traj + static_cast<size_t>(t) * d;
    for (int idx = lane; idx < q * NP + d; idx += 32) {
      if (idx < q * NP)  // Cw = C w (zero past N)
        Cw[idx] = dot_np(C + (idx / NP) * NN + (idx % NP) * NP, 1, w, NP);
      else               // m = w.M
        m[idx - q * NP] = dot_np(M + idx - q * NP, d, w, NP);
    }
    __syncwarp();
    for (int qi = lane; qi < q; qi += 32)
      Sinv[qi] = scalar_t(1) / (dot_np(Cw + qi * NP, 1, w, NP) + s2[qi]);
    __syncwarp();
    for (int item = lane; item < q * NT * NT; item += 32) {  // C -= (Cw / S) Cw^T
      const int qi = item / (NT * NT), i0 = item / NT % NT * 4, j0 = item % NT * 4;
      const scalar_t* cw = Cw + qi * NP;
      scalar_t cj[4];
      load4(cw + j0, cj);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        scalar_t* row = C + qi * NN + (i0 + i) * NP + j0;
        scalar_t r[4];
        load4(row, r);
        const scalar_t k = cw[i0 + i] * Sinv[qi];
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] -= k * cj[j];
        store4(row, r);
      }
    }
    for (int idx = lane; idx < N * d; idx += 32) {
      const int i = idx / d, dd = idx % d, c = Cind[dd];
      M[idx] += (Cw[c * NP + i] * Sinv[c]) * (y[dd] - m[dd]);
    }
    if (lane == 0) {
      for (int dd = 0; dd < d; ++dd) {
        const scalar_t Sv = Sinv[Cind[dd]];
        const scalar_t xmm = y[dd] - m[dd];
        ll += scalar_t(-0.5) *
              (xmm * xmm * Sv - bild::dlog(Sv) + scalar_t(bild::kLog2Pi));
      }
    }
    __syncwarp();
  };

  // M' = B_s M + G_s into Mn; then C' = (B_s C) B_s + Sig_s for each
  // copy, X = B_s C in the scratch as X^T
  auto propagate = [&](int t) {
    const int s = bild::clamp_state(prof[t], n);
    const Op B = op(Bs, lay.B, s);
    const Op Sig = op(Sigs, lay.Sig, s);
    const scalar_t* Gp = G + static_cast<size_t>(s) * N * d;

    for (int idx = lane; idx < N * d; idx += 32) {
      const int r = idx / d, dd = idx % d;
      scalar_t acc = 0;
      for (int k0 = 0; k0 < NP; k0 += 4) {
        scalar_t xv[4], yv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          xv[u] = M[(k0 + u) * d + dd];
          yv[u] = B.at(r, k0 + u);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) acc = fma(xv[u], yv[u], acc);
      }
      Mn[idx] = acc + Gp[idx];
    }
    if constexpr (!kOpsShared) {
      __syncwarp();
      for (int idx = lane; idx < N * d; idx += 32) M[idx] = Mn[idx];
      __syncwarp();
    }
    for (int qi = 0; qi < q; ++qi) {
      scalar_t* Cq = C + qi * NN;
      const SharedOp<scalar_t> Cop{Cq, NP}, XTop{XT, NP};
      for (int tile = lane; tile < NT * NT; tile += 32) {  // X = B C, stored as X^T
        const int i0 = tile / NT * 4, j0 = tile % NT * 4;
        scalar_t acc[4][4];
        tile_product(B, Cop, NP, i0, j0, acc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          scalar_t col[4] = {acc[0][j], acc[1][j], acc[2][j], acc[3][j]};
          store4(XT + (j0 + j) * NP + i0, col);
        }
      }
      __syncwarp();
      for (int tile = lane; tile < NT * NT; tile += 32) {  // C' = X B + Sig
        const int i0 = tile / NT * 4, j0 = tile % NT * 4;
        scalar_t acc[4][4];
        tile_product(XTop, B, NP, i0, j0, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          scalar_t sg[4], row[4];
          Sig.row4(i0 + i, j0, sg);
#pragma unroll
          for (int j = 0; j < 4; ++j) row[j] = acc[i][j] + sg[j];
          store4(Cq + (i0 + i) * NP + j0, row);
        }
      }
      __syncwarp();
    }
    if constexpr (kOpsShared) {
      scalar_t* tmp = M; M = Mn; Mn = tmp;
    }
  };

  for (int t = 0; t < T; ++t) {
    if (t > 0) propagate(t);
    if (valid_traj[t]) update(t);
  }

  if (lane == 0) out[g] = ll;
}


template <typename scalar_t>
int launch_dense(const void* Bs, const void* Gs, const void* Sigs,
                 const void* M0s, const void* C0s, const void* w,
                 const void* s2, const void* Cind, const void* profiles,
                 const void* ydata, const void* valid, void* out,
                 int n, int N, int d, int q, int L, int P, int T, int W,
                 int ops_shared, int smem, int device, void* stream) {
  const DenseLayout lay = dense_layout<scalar_t>(n, N, d, q, W, ops_shared != 0);
  if (W < 1 || W > kMaxWarps || lay.bytes != static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(L) * P;
  auto kernel = ops_shared ? kalman_dense_kernel<scalar_t, true>
                           : kalman_dense_kernel<scalar_t, false>;
  return bild::launch(
      kernel, (items + W - 1) / W, 32 * W, lay.bytes, device, stream,
      static_cast<const scalar_t*>(Bs), static_cast<const scalar_t*>(Gs),
      static_cast<const scalar_t*>(Sigs), static_cast<const scalar_t*>(M0s),
      static_cast<const scalar_t*>(C0s), static_cast<const scalar_t*>(w),
      static_cast<const scalar_t*>(s2), static_cast<const int*>(Cind),
      static_cast<const int*>(profiles), static_cast<const scalar_t*>(ydata),
      static_cast<const unsigned char*>(valid), static_cast<scalar_t*>(out),
      n, N, d, q, L, P, T, W);
}

}  // namespace

#define BILD_DENSE_ENTRY(NAME, TYPE)                                          \
  extern "C" int NAME(const void* Bs, const void* Gs, const void* Sigs,       \
                      const void* M0s, const void* C0s, const void* w,        \
                      const void* s2, const void* Cind, const void* profiles, \
                      const void* ydata, const void* valid, void* out, int n, \
                      int N, int d, int q, int L, int P, int T, int W,        \
                      int ops_shared, int smem, int device, void* stream) {   \
    return launch_dense<TYPE>(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles,  \
                              ydata, valid, out, n, N, d, q, L, P, T, W,      \
                              ops_shared, smem, device, stream);              \
  }

BILD_DENSE_ENTRY(bild_kalman_dense_f32, float)
BILD_DENSE_ENTRY(bild_kalman_dense_f64, double)
