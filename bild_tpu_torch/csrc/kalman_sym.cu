// Packed-symmetric Rouse-Kalman log-likelihood: one block per tile of TP
// profiles of one lane (the tile plan), or one cluster of C blocks per
// group of profiles of one lane (the cluster plan), where a lane is one
// trajectory and all lanes share the model.
//
// Replaces the Pallas kernel bild_tpu/ops/kalman_sym.py::_kernel. The
// covariance is carried packed: the PP = N(N+1)/2 entries (a, b), a <= b, in
// row-major upper-triangle order, q copies. The host builds, per state s
// (bild_tpu_torch/ops/kalman_sym.py::build_sym_operators):
//   P_s (PP x PP, rows padded to PPp)  c' = P_s c + sig_s  is pack(B C B^T)
//   Ballw_s ((N+1) x N) = [B_s; w.B_s], Gsw_s = [G_s; w.G_s]
// so that per frame, with s = profile[t],
//   c' = P_s c + sig_s
//   M' = Ballw_s M + Gsw_s                  (row N of M' is the predicted w.M')
// and at observed frames
//   Cw = C w (read from the packed c),  S = w.Cw + s2,  Sinv = 1 / S
//   c[(a,b)] -= (Cw_a Cw_b) Sinv            (the packed rank-1 downdate)
//   M += (Cw Sinv)[Cind] (y - w.M)
//   ll -= 1/2 (xmm^2 Sinv - log Sinv + log 2pi)
//
// What bounds it on the H100. The likelihood's least work at N=20, d=3,
// q=1, T=100 is about 27 kFLOP per profile-frame (the dense recursion with
// C' and the downdate symmetric) and 1.6 kFLOP per observed frame: 232
// GFLOP for a lockstep call of 640 lanes x 128 profiles
// (chip_smoke.py::kernel_work), 3.5 ms at the 67 TFLOP/s float32 (no
// tensor core) peak; its HBM bytes (profiles, data, results, operators
// once) are 34 MB, 10 us. The packed algorithm spends more: 2 PP^2 + PP =
// 88.4 kFLOP per profile-frame to propagate (PP = 210; it grows as N^4,
// the dense recursion as N^3), 752 GFLOP per lockstep call. The first
// version gave every profile a block of its own, which streamed its
// state's whole 187 KB P_s from L2 for one matrix-vector product per
// frame: 1.5 TB of L2 reads per lockstep call, L2-bound at 590 ms.
//
// The design. A block owns TP profiles of one lane; they share the frames,
// the mask and the operators. Their packed covariances (q copies each,
// TP q columns of PPp scalars) stay in shared memory for the whole frame
// loop. Per frame the block sorts its columns by profile[t] into groups
// padded to 4 columns (one ballot per state), and one SIMT GEMM computes
//   cn[:, col] = P_{s(col)} c[:, col] + sig_{s(col)}
// for every column. P_s arrives in slabs of 8 operator columns for up to
// 256 rows, double-buffered: the host stores each slab contiguously and
// bank-swizzled (ops/kalman_sym.py::slab_operators), so one Hopper bulk
// copy (TMA, completion on an mbarrier) per state moves it, issued by one
// thread, with one block barrier per slab. Each thread keeps a register
// tile of 4 columns and up to 8 rows (32 FMAs per 16-byte operand load
// pair; fewer rows, so more threads, when the tile holds few columns).
// One L2 read of P_s serves every profile of the tile in that state: it
// is read at most n times per tile-frame, not once per profile-frame
// (TP=32: 16x fewer L2 bytes, about 92 GB per lockstep call, computed).
// The update reads Cw = C w from the packed columns (N^2 FMAs per column;
// the reference's U1 product, (N+1) PPp, would stream a 28 KB operator
// through an L1 that the two blocks' shared memory leaves at about 28
// KB), and the means' operators Ballw, Gsw sit in shared memory too.
// It reaches about 6 % of the likelihood's bound and runs its own 752
// GFLOP at about a fifth of the peak (PERF.md, an H100 SXM at 700 W). What
// holds it there: the issue slots of 32 FMAs against 12 shared-memory
// loads per 4 k, one barrier per 8 k, and the update and means, a fifth of
// the frame.
//
// Precision: the covariance type cov_t. A packed covariance stored in
// float32 between frames drifts over a long trajectory (0.32-0.34 nats per
// profile family at T=1000 against the float64 build on the H100), so the
// float32 entry carries c, cn, Cw, 1/S, the product's register tile and
// the downdate in float64 (cov_t = double); the P_s slabs, sig, Ballw,
// Gsw, w, s2, the means, the data, the log-density and the result stay
// float32. A slab scalar is widened in registers before its FMAs; K and
// 1/S are rounded once to float32 for the means and the log-density. The
// float64 FMAs run at half the float32 rate, c and cn double their bytes,
// and the register tile doubles its registers: the float32 build takes 224
// registers a thread, so one block per SM. (Held to two blocks, 128
// registers, it spilled, and 16-profile tiles read P_s twice as often:
// 165.6 against 112.5 ms at the lockstep launch on an H100.)
//
// Shared memory at N=20, d=3, q=1, n=2, TP=32, float32 with the float64
// covariance (the lockstep launch): c and cn 2 x 32 x 218 x 8 = 111.6 KB,
// the P_s slabs 2 buffers x n x 216 rows x 8 x 4 = 27.6 KB, the means M
// and Mn 2 x 32 x 21 x 3 x 4 = 16.1 KB, Cw and 1/S 32 x 21 x 8 = 5.4 KB,
// Ballw and Gsw 3.9 KB, the log-likelihoods, index tables, column lists
// and barriers 1.0 KB: 166 KB, one block per SM. sym_layout() below and
// ops/kalman_sym.py::sym_smem_bytes compute the same bytes; the launch
// refuses a mismatch.
//
// The cluster plan (ops/kalman_sym.py::sym_plan), for launches where even
// one profile per block leaves SMs idle: sample()'s single-trajectory step
// (L=1, P=100) gave 100 one-profile blocks, each streaming its state's
// whole P_s from L2 in 27 slabs, one at a time, per frame (2.1 ms, 0.2 %
// of the bound). Here a cluster of C = 8 blocks (one per SM) takes TP
// profiles of one lane, as few as let every cluster run at once (the
// card's cudaOccupancyMaxActiveClusters: 15 clusters of 8 on an H100).
// Block `rank` owns operator rows PP/C (+1) of every state: they are
// bulk-copied into its shared memory once (ops/kalman_sym.py::
// row_operators) and stay there for all T frames.
// Every block keeps a replica of the cluster's covariances. Per frame it
// computes its rows of cn[:, col] = P_s c[:, col] + sig_s for every column
// (one thread per (row, column), the tile kernel's FMA chain), stores each
// into every block's replica with st.async, whose bytes count on the
// receiving block's mbarrier of that buffer (no cluster barrier per
// frame: a block waits for the bytes of its replica, and a peer can only
// overwrite a buffer after every block has sent the rows it read from it),
// then runs the means and the update on its replica, the same work in
// every block. Rank 0 writes the results. Measured on an H100 (PERF.md,
// tools/profile_kernels.py): about 0.62 ms at sample()'s step, a third of
// the tile plan's time; of a frame the product takes about 39 %, bound by
// shared-memory wavefronts (each thread reads its own operator row), the
// update about 38 % (latency: a 20-long FMA chain per entry and four block
// barriers), the means 13 %, the exchange 6 %. No state sort: a thread's
// columns share no operator load (one column per thread keeps six warps
// in the product; groups of 4 columns of one state measured slower).
// Clusters of 16 measure slower too (chip_smoke.py's cluster phase times
// both): each block then updates twice the columns.
//
// A profile's result does not depend on its partners: every output of the
// products is one thread's dot product over k = 0..PPp-1 in order, the
// downdate's products are rounded explicitly (never contracted), and
// every other step is per profile, in code both plans share. So a lane
// launch equals single-lane launches, a permutation of the profiles
// permutes the results and a subset gives the same bits, whatever the
// tile width or plan.
//
// The split-bf16 tiers ('split_cov', 'split') have a kernel of their own,
// kalman_sym_split.cu.
#include "kalman_common.cuh"

// Phase marks of the frame loop: empty here; tools/profile_kernels.py
// builds a copy that defines them to sum thread 0's clock64() cycles per
// phase (mark k ends phase k).
#ifndef BILD_PHASE
#define BILD_PHASE_START()
#define BILD_PHASE(k)
#define BILD_PHASE_END()
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 8;        // operator columns (k) per slab
constexpr int kTM = 8;        // operator rows per thread in the propagation
constexpr int kTN = 4;        // covariance columns per thread (one group tile)
constexpr int kRowsMax = 256; // operator rows per slab
constexpr int kMaxTile = 32;  // profiles per block: one ballot per state
constexpr int kMaxD = 4;      // spatial dimensions (means kept in registers)

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// A slab row holds CH 16-byte chunks (kBK scalars). Chunk ch of operator
// row r is stored at chunk ch ^ ((r / (8 / CH)) % CH): the 8 consecutive
// rows that a quarter-warp reads at one chunk then fall in 8 distinct
// 16-byte bank groups. The host stores the operators so
// (ops/kalman_sym.py::slab_operators), and a bulk copy keeps the order.
template <int CH>
__device__ __forceinline__ int swizzle(int r, int ch) {
  return ch ^ ((r / (8 / CH)) & (CH - 1));
}

struct SymLayout {
  int ld;         // covariance column stride (scalars)
  int nct_max;    // column tiles of 4, at most
  int rows_slab;  // operator rows per slab
  size_t c, cn, slab, M, Mn, R, Sinv, ll, Bw, Gw, w, s2, y, ab, Cind, list, tstate,
      pstate, misc, bar, bytes;
};

// Byte offsets of the block's shared memory; mirrored by
// ops/kalman_sym.py::sym_smem_bytes. The covariances, Cw and 1/S are
// cov_t, the rest scalar_t.
template <typename scalar_t, typename cov_t>
__host__ __device__ SymLayout sym_layout(int n, int N, int d, int q, int PPp,
                                         int TP) {
  SymLayout s;
  const size_t sz = sizeof(scalar_t), cz = sizeof(cov_t);
  const int ncol = TP * q;
  s.ld = PPp + bild::Vec16<cov_t>::width;
  s.nct_max = (ncol + kTN - 1) / kTN + n;
  s.rows_slab = PPp < kRowsMax ? PPp : kRowsMax;
  size_t o = 0;
  s.c = o;      o += align16(cz * ncol * s.ld);
  s.cn = o;     o += align16(cz * ncol * s.ld);
  s.slab = o;   o += align16(sz * 2 * n * s.rows_slab * kBK);
  s.M = o;      o += align16(sz * TP * (N + 1) * d);
  s.Mn = o;     o += align16(sz * TP * (N + 1) * d);
  s.R = o;      o += align16(cz * ncol * N);
  s.Sinv = o;   o += align16(cz * ncol);
  s.ll = o;     o += align16(sz * TP);
  s.Bw = o;     o += align16(sz * n * (N + 1) * N);
  s.Gw = o;     o += align16(sz * n * (N + 1) * d);
  s.w = o;      o += align16(sz * N);
  s.s2 = o;     o += align16(sz * q);
  s.y = o;      o += align16(sz * d);
  s.ab = o;     o += align16(2 * (N * (N + 1) / 2));
  s.Cind = o;   o += align16(4 * d);
  s.list = o;   o += align16(4 * s.nct_max * kTN);
  s.tstate = o; o += align16(4 * s.nct_max);
  s.pstate = o; o += align16(4 * TP);
  s.misc = o;   o += 16;
  s.bar = o;    o += 16;  // two mbarriers, one per slab buffer
  s.bytes = o;
  return s;
}

// What the shared steps of a frame read and write: a block's tp profiles
// (column p q + qi of profile p) and the model's small operands, all in
// shared memory. Both kernels run these steps with the same code, so a
// profile's bits do not depend on which kernel evaluated it.
template <typename scalar_t, typename cov_t>
struct Frame {
  cov_t* c;                  // (ncol, ld) packed covariances
  scalar_t* M;               // (tp, N+1, d) means
  scalar_t* Mn;              // (tp, N+1, d) propagated means
  cov_t* R;                  // (ncol, N): Cw
  cov_t* Sinv;               // (ncol)
  scalar_t* llv;             // (tp) log-likelihoods
  const scalar_t* Bw;        // (n, N+1, N)
  const scalar_t* Gw;        // (n, N+1, d)
  const scalar_t* w;         // (N)
  const scalar_t* s2;        // (q)
  const scalar_t* yt;        // (d): this frame's data
  const unsigned short* ab;  // (a, b) of packed entry k, a in the low byte
  const int* Cind;           // (d)
  const int* pstate;         // (tp): this frame's state of each profile
  int tp, ncol, ld, N, d, q;
};

// sum_k x[k] y[k] over k = 0..K-1 in order, in cov_t, four loads at a
// time (x covariance entries, y the scalar_t w)
template <typename scalar_t, typename cov_t>
__device__ __forceinline__ cov_t dot(const cov_t* x, const scalar_t* y, int K) {
  cov_t acc = 0;
  int k = 0;
#pragma unroll 1
  for (; k + 4 <= K; k += 4) {
    cov_t xv[4], yv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xv[u] = x[k + u];
      yv[u] = cov_t(y[k + u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = fma(xv[u], yv[u], acc);
  }
#pragma unroll 1
  for (; k < K; ++k) acc = fma(x[k], cov_t(y[k]), acc);
  return acc;
}

// The measurement update of the frame whose data f.yt holds; ends with a
// block barrier. mark(k) ends its step k (0: Cw, 1: 1/S, 2: the rest) for
// the phase marks of tools/profile_kernels.py.
template <typename scalar_t, typename cov_t, typename Mark>
__device__ __forceinline__ void measurement_update(const Frame<scalar_t, cov_t>& f, Mark mark) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int N = f.N, d = f.d, q = f.q, ncol = f.ncol, tp = f.tp, ld = f.ld;
  const int N1 = N + 1, PP = N * (N + 1) / 2;
  cov_t* c = f.c;
  cov_t* R = f.R;
  cov_t* Sinv = f.Sinv;
  scalar_t* M = f.M;
  scalar_t* llv = f.llv;
  const scalar_t* w = f.w;
  const scalar_t* s2 = f.s2;
  const scalar_t* yt = f.yt;
  const unsigned short* ab = f.ab;
  const int* Cind = f.Cind;
  // Cw[col, a] = sum_b C_ab w_b, read from the packed column: row a of
  // the upper triangle (b >= a) is contiguous, column a (b < a) strided.
  // One loop over b = 0..N-1 that every lane of a warp runs alike sums
  // the strided part and the row's part apart, each in order from 0 (the
  // bits of two loops, which a warp would run one after the other), and
  // adds them
#pragma unroll 1
  for (int item = tid; item < ncol * N; item += nth) {
    const int col = item / N, a = item % N;
    const cov_t* cc = c + static_cast<size_t>(col) * ld;
    cov_t lo = 0, hi = 0;
    int k = a;  // packed index of (min(a, b), max(a, b))
#pragma unroll 4
    for (int b = 0; b < N; ++b) {
      const cov_t x = cc[k], y = cov_t(w[b]);
      if (b < a) {
        lo = fma(x, y, lo);
        k += N - 1 - b;
      } else {
        hi = fma(x, y, hi);
        k += 1;
      }
    }
    R[col * N + a] = lo + hi;
  }
  __syncthreads();
  mark(0);
#pragma unroll 1
  for (int col = tid; col < ncol; col += nth)  // S = w.Cw + s2
    Sinv[col] = cov_t(1) / (dot(R + col * N, w, N) + cov_t(s2[col % q]));
  __syncthreads();
  mark(1);
#pragma unroll 1
  for (int k = tid; k < PP; k += nth) {  // c[(a,b)] -= (Cw_a Cw_b) Sinv
    const int a = ab[k] & 0xff, b = ab[k] >> 8;
    auto down = [&](int col) {
      return bild::mul_rn(bild::mul_rn(R[col * N + a], R[col * N + b]), Sinv[col]);
    };
    int col = 0;
    for (; col + 4 <= ncol; col += 4) {  // four columns' loads before their stores
      cov_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = down(col + u);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cov_t* cc = c + static_cast<size_t>(col + u) * ld + k;
        *cc = bild::sub_rn(*cc, v[u]);
      }
    }
    for (; col < ncol; ++col) {
      cov_t* cc = c + static_cast<size_t>(col) * ld + k;
      *cc = bild::sub_rn(*cc, down(col));
    }
  }
  // M += K[Cind] (y - w.M), K rounded once to scalar_t
#pragma unroll 1
  for (int item = tid; item < tp * N; item += nth) {
    const int p = item / N, i = item % N;
    scalar_t* Mp = M + p * N1 * d;
#pragma unroll
    for (int dd = 0; dd < kMaxD; ++dd) {
      if (dd < d) {
        const int col = p * q + Cind[dd];
        Mp[i * d + dd] += scalar_t(R[col * N + i] * Sinv[col]) * (yt[dd] - Mp[N * d + dd]);
      }
    }
  }
#pragma unroll 1
  for (int p = tid; p < tp; p += nth) {
    scalar_t ll = llv[p];
    for (int dd = 0; dd < d; ++dd) {
      const scalar_t Sv = scalar_t(Sinv[p * q + Cind[dd]]);
      const scalar_t xmm = yt[dd] - M[p * N1 * d + N * d + dd];
      ll -= scalar_t(0.5) *
            (xmm * xmm * Sv - bild::dlog(Sv) + scalar_t(bild::kLog2Pi));
    }
    llv[p] = ll;
  }
  __syncthreads();
  mark(2);
}

// Mn[p] = Ballw_s M[p] + Gsw_s, s the profile's state: one row of one
// profile per item, its d columns at once (no barrier)
template <typename scalar_t, typename cov_t>
__device__ __forceinline__ void propagate_means(const Frame<scalar_t, cov_t>& f) {
  const int N = f.N, d = f.d, N1 = N + 1;
#pragma unroll 1
  for (int item = threadIdx.x; item < f.tp * N1; item += blockDim.x) {
    const int p = item / N1, row = item % N1, s = f.pstate[p];
    const scalar_t* Bwr = f.Bw + (s * N1 + row) * N;
    const scalar_t* Mp = f.M + p * N1 * d;
    scalar_t acc[kMaxD] = {};
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      const scalar_t b = Bwr[k];
#pragma unroll
      for (int dd = 0; dd < kMaxD; ++dd)
        if (dd < d) acc[dd] = fma(b, Mp[k * d + dd], acc[dd]);
    }
#pragma unroll
    for (int dd = 0; dd < kMaxD; ++dd)
      if (dd < d) f.Mn[(p * N1 + row) * d + dd] = acc[dd] + f.Gw[(s * N1 + row) * d + dd];
  }
}

// one block per SM: the float64 covariance's register tile leaves no
// room for a second (see the header)
template <typename scalar_t, typename cov_t>
__global__ void __launch_bounds__(kThreads, 1)
kalman_sym_kernel(const scalar_t* __restrict__ Pslab,
                  const scalar_t* __restrict__ sig,
                  const scalar_t* __restrict__ c0,
                  const scalar_t* __restrict__ w_g,
                  const scalar_t* __restrict__ Ballw,
                  const scalar_t* __restrict__ Gsw,
                  const scalar_t* __restrict__ M0w,
                  const scalar_t* __restrict__ s2_g,
                  const int* __restrict__ Cind_g,
                  const int* __restrict__ profiles,
                  const scalar_t* __restrict__ ydata,
                  const unsigned char* __restrict__ valid,
                  scalar_t* __restrict__ out,
                  int n, int N, int d, int q, int P, int T, int PPp, int N1p,
                  int TP) {
  constexpr int VW = bild::Vec16<scalar_t>::width;  // slab scalars per 16-byte load
  constexpr int CVW = bild::Vec16<cov_t>::width;    // covariance scalars per load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SymLayout lay = sym_layout<scalar_t, cov_t>(n, N, d, q, PPp, TP);
  cov_t* c = reinterpret_cast<cov_t*>(smem_raw + lay.c);          // (ncol, ld)
  cov_t* cn = reinterpret_cast<cov_t*>(smem_raw + lay.cn);        // (ncol, ld)
  scalar_t* slab = reinterpret_cast<scalar_t*>(smem_raw + lay.slab);
  scalar_t* M = reinterpret_cast<scalar_t*>(smem_raw + lay.M);    // (TP, N+1, d)
  scalar_t* Mn = reinterpret_cast<scalar_t*>(smem_raw + lay.Mn);
  cov_t* R = reinterpret_cast<cov_t*>(smem_raw + lay.R);          // (ncol, N): Cw
  cov_t* Sinv = reinterpret_cast<cov_t*>(smem_raw + lay.Sinv);    // (ncol)
  scalar_t* llv = reinterpret_cast<scalar_t*>(smem_raw + lay.ll); // (TP)
  // the small operands, read in latency-bound loops, live here and not in
  // L1 (which the two blocks' shared memory leaves at about 28 KB)
  scalar_t* Bw = reinterpret_cast<scalar_t*>(smem_raw + lay.Bw);  // (n, N+1, N)
  scalar_t* Gw = reinterpret_cast<scalar_t*>(smem_raw + lay.Gw);  // (n, N+1, d)
  scalar_t* w = reinterpret_cast<scalar_t*>(smem_raw + lay.w);    // (N)
  scalar_t* s2 = reinterpret_cast<scalar_t*>(smem_raw + lay.s2);  // (q)
  scalar_t* yt = reinterpret_cast<scalar_t*>(smem_raw + lay.y);   // (d): this frame's data
  // (a, b) of packed entry k, a in the low byte (N < 256)
  unsigned short* ab = reinterpret_cast<unsigned short*>(smem_raw + lay.ab);
  int* Cind = reinterpret_cast<int*>(smem_raw + lay.Cind);
  int* list = reinterpret_cast<int*>(smem_raw + lay.list);      // column of each group slot
  int* tstate = reinterpret_cast<int*>(smem_raw + lay.tstate);  // state of each column tile
  int* pstate = reinterpret_cast<int*>(smem_raw + lay.pstate);  // state of each profile
  int* misc = reinterpret_cast<int*>(smem_raw + lay.misc);      // tile count, present states
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw + lay.bar);

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int PP = N * (N + 1) / 2;
  const int N1 = N + 1;
  const int ld = lay.ld;
  const int tiles_per_lane = (P + TP - 1) / TP;
  const size_t traj = blockIdx.x / tiles_per_lane;  // this block's lane
  const int p0 = static_cast<int>(blockIdx.x % tiles_per_lane) * TP;
  const int tp = min(TP, P - p0);                   // profiles in this tile
  const int ncol = tp * q;                          // column p*q + qi
  const int* prof = profiles + (traj * P + p0) * static_cast<size_t>(T);
  const scalar_t* y_traj = ydata + traj * T * d;
  const unsigned char* valid_traj = valid + traj * T;

  for (int i = tid; i < ncol * ld; i += nth) {
    const int col = i / ld, k = i % ld;
    const int s0 = bild::clamp_state(prof[static_cast<size_t>(col / q) * T], n);
    c[i] = k < PPp ? cov_t(c0[static_cast<size_t>(s0) * PPp + k]) : cov_t(0);
    cn[i] = 0;
  }
  for (int i = tid; i < tp * N1 * d; i += nth) {
    const int p = i / (N1 * d);
    const int s0 = bild::clamp_state(prof[static_cast<size_t>(p) * T], n);
    M[i] = M0w[static_cast<size_t>(s0) * N1p * d + i % (N1 * d)];
  }
  for (int p = tid; p < tp; p += nth) llv[p] = 0;
  for (int a = tid; a < N; a += nth)
    for (int b = a; b < N; ++b)
      ab[a * N - a * (a - 1) / 2 + (b - a)] = static_cast<unsigned short>(a | (b << 8));
  for (int i = tid; i < n * N1 * N; i += nth)
    Bw[i] = Ballw[(static_cast<size_t>(i / (N1 * N)) * N1p) * N + i % (N1 * N)];
  for (int i = tid; i < n * N1 * d; i += nth)
    Gw[i] = Gsw[(static_cast<size_t>(i / (N1 * d)) * N1p) * d + i % (N1 * d)];
  for (int i = tid; i < N; i += nth) w[i] = w_g[i];
  for (int i = tid; i < q; i += nth) s2[i] = s2_g[i];
  for (int i = tid; i < d; i += nth) Cind[i] = Cind_g[i];
  if (tid == 0) {
    bild::mbar_init(&bar[0]);
    bild::mbar_init(&bar[1]);
  }
  unsigned parity = 0;  // bit b: the phase of bar[b] to wait for next
  __syncthreads();
  BILD_PHASE_START();

  // this frame's view of the block's profiles, for the shared steps
  auto frame = [&]() {
    return Frame<scalar_t, cov_t>{c, M, Mn, R, Sinv, llv, Bw, Gw, w, s2, yt, ab,
                                  Cind, pstate, tp, ncol, ld, N, d, q};
  };

  // Sort this frame's columns by state: the columns of state s fill group
  // slots list[4 tiles_before_s ...], padded with -1 to whole tiles of 4.
  // Warp 0 does it, with this frame's states and data loaded one frame
  // ahead (st_next, y_next), so the global loads' latency hides behind a
  // frame of work.
  int st_next = -1;
  scalar_t y_next = 0;
  auto prefetch = [&](int t) {
    if (tid < 32 && t < T) {
      if (tid < tp) st_next = bild::clamp_state(prof[static_cast<size_t>(tid) * T + t], n);
      if (tid < d) y_next = y_traj[static_cast<size_t>(t) * d + tid];
    }
  };
  auto partition = [&](int t) {
    if (tid < 32) {
      const int lane = tid;
      const int st = lane < tp ? st_next : -1;
      if (lane < d) yt[lane] = y_next;
      prefetch(t + 1);
      if (lane < tp) pstate[lane] = st;
      int nct = 0;
      unsigned present = 0;
      for (int s = 0; s < n; ++s) {
        const unsigned m = __ballot_sync(0xffffffffu, st == s);
        const int cnt = __popc(m);
        if (cnt == 0) continue;
        const int base = nct * kTN;
        if (st == s) {
          const int rank = __popc(m & ((1u << lane) - 1u));
          for (int qi = 0; qi < q; ++qi) list[base + rank * q + qi] = lane * q + qi;
        }
        const int cols = cnt * q, tiles = (cols + kTN - 1) / kTN;
        for (int j = cols + lane; j < tiles * kTN; j += 32) list[base + j] = -1;
        for (int j = lane; j < tiles; j += 32) tstate[nct + j] = s;
        nct += tiles;
        present |= 1u << s;
      }
      if (lane == 0) {
        misc[0] = nct;
        misc[1] = static_cast<int>(present);
      }
    }
    __syncthreads();
  };

  // cn[:, col] = P_s c[:, col] + sig_s for every column, s its state, and
  // the means (while the first slabs load). Each active thread owns tm
  // rows (1, 2, 4 or 8: the fewest that spread the rows of one pass over
  // the block's threads) of one column tile. The slabs of P_s alternate
  // between two buffers, one slab ahead of the product, with one block
  // barrier per slab. (Deeper rings measured slower: at TP=32 a third
  // buffer leaves room for one block per SM instead of two.)
  auto propagate = [&]() {
    const int nct = misc[0];
    const unsigned present = static_cast<unsigned>(misc[1]);
    int tm = 1;
    while (tm < kTM && nct * ((PP + tm - 1) / tm) > nth) tm *= 2;
    const int RT = min(min(nth / nct, (PP + tm - 1) / tm), lay.rows_slab / tm);
    const int rows_per_pass = RT * tm;
    // consecutive threads take consecutive rows of one column tile: their
    // operand loads of c broadcast, their slab rows fall in distinct bank
    // groups (swizzle)
    const int rt = tid % RT, ct = tid / RT;
    const bool active = ct < nct;
    const int my_s = active ? tstate[ct] : 0;
    int cols[kTN];
    const cov_t* bcol[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      cols[j] = active ? list[ct * kTN + j] : -1;
      bcol[j] = c + static_cast<size_t>(cols[j] < 0 ? 0 : cols[j]) * ld;
    }
    const int nkb = PPp / kBK;
    constexpr int CH = kBK * static_cast<int>(sizeof(scalar_t)) / 16;  // 16-B chunks per slab row

    for (int row0 = 0; row0 < PP; row0 += rows_per_pass) {
      const int rows = min(rows_per_pass, PP - row0);
      // slab kb of every present state into buffer kb & 1: one bulk copy
      // of rows x kBK contiguous scalars per state, issued by the block's
      // last thread, which computes nothing when the tile's columns leave
      // threads idle (243 of 256 compute at TP=32, N=20)
      auto issue = [&](int kb) {
        if (tid != nth - 1) return;
        const unsigned bytes = rows * kBK * sizeof(scalar_t);
        unsigned long long* b = &bar[kb & 1];
        bild::mbar_arrive_expect(b, bytes * __popc(present));
        for (int s = 0; s < n; ++s) {
          if (!((present >> s) & 1u)) continue;
          bild::bulk_copy(slab + static_cast<size_t>((kb & 1) * n + s) * lay.rows_slab * kBK,
                          Pslab + ((static_cast<size_t>(s) * nkb + kb) * PPp + row0) * kBK,
                          bytes, b);
        }
      };

      cov_t acc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

      if (row0 > 0) __syncthreads();  // the last pass's slabs are consumed
      issue(0);
      if (row0 == 0) propagate_means(frame());
      BILD_PHASE(1);
      for (int kb = 0; kb < nkb; ++kb) {
        bild::mbar_wait(&bar[kb & 1], (parity >> (kb & 1)) & 1u);  // slab kb landed
        parity ^= 1u << (kb & 1);
        __syncthreads();  // every thread is done with slab kb-1
        BILD_PHASE(2);
        if (kb + 1 < nkb) issue(kb + 1);  // into kb-1's buffer
        BILD_PHASE(3);
        if (active) {
          const scalar_t* A = slab + static_cast<size_t>((kb & 1) * n + my_s) * lay.rows_slab * kBK;
          const int k0 = kb * kBK;
#pragma unroll
          for (int kk = 0; kk < kBK; kk += VW) {
            cov_t b[kTN][VW];  // VW entries of each column, CVW per load
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
#pragma unroll
              for (int h = 0; h < VW / CVW; ++h) {
                const auto v = bild::load16(bcol[j] + k0 + kk + h * CVW);
                const cov_t* vs = reinterpret_cast<const cov_t*>(&v);
#pragma unroll
                for (int u = 0; u < CVW; ++u) b[j][h * CVW + u] = vs[u];
              }
            }
#pragma unroll
            for (int i = 0; i < kTM; ++i) {
              if (i < tm) {
                const int r = rt + i * RT;
                const auto av = bild::load16(A + r * kBK + swizzle<CH>(row0 + r, kk / VW) * VW);
                const scalar_t* a = reinterpret_cast<const scalar_t*>(&av);
#pragma unroll
                for (int u = 0; u < VW; ++u) {
                  const cov_t au = cov_t(a[u]);
#pragma unroll
                  for (int j = 0; j < kTN; ++j) acc[i][j] = fma(au, b[j][u], acc[i][j]);
                }
              }
            }
          }
        }
        BILD_PHASE(4);
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          if (i >= tm || rt + i * RT >= rows) continue;
          const int r = row0 + rt + i * RT;
          const cov_t sg = cov_t(sig[static_cast<size_t>(my_s) * PPp + r]);
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            if (cols[j] >= 0) cn[static_cast<size_t>(cols[j]) * ld + r] = acc[i][j] + sg;
        }
      }
      BILD_PHASE(5);
    }
    __syncthreads();
    BILD_PHASE(5);
  };

  prefetch(0);
  for (int t = 0; t < T; ++t) {
    if (t == 0) {
      if (tid < d) yt[tid] = y_next;
      prefetch(1);
      __syncthreads();
      BILD_PHASE(1);
    } else {
      partition(t);
      BILD_PHASE(0);
      propagate();  // ends with a block barrier: cn and Mn are complete
      cov_t* tmp = c; c = cn; cn = tmp;
      scalar_t* tmpM = M; M = Mn; Mn = tmpM;
    }
    if (valid_traj[t]) measurement_update(frame(), [&](int) { BILD_PHASE(6); });
    BILD_PHASE(6);
  }
  BILD_PHASE_END();

  for (int p = tid; p < tp; p += nth) out[traj * P + p0 + p] = llv[p];
}

// The operator rows [first, first + count) that block `rank` of a cluster
// of C owns: PP / C each, one more for the first PP % C blocks. Mirrored
// by ops/kalman_sym.py::cluster_rows.
__host__ __device__ inline int cluster_first_row(int PP, int C, int rank) {
  return rank * (PP / C) + (rank < PP % C ? rank : PP % C);
}
__host__ __device__ inline int cluster_row_count(int PP, int C, int rank) {
  return PP / C + (rank < PP % C ? 1 : 0);
}

// A cluster launch asks for at least this much shared memory per block,
// more than half of an SM's (two resident blocks would need 2 x (116 KB +
// 1 KB) of its 228 KB), so that its blocks spread one per SM.
constexpr size_t kClusterSmem = 116 * 1024;

struct ClusterLayout {
  int ld;    // covariance column stride (scalars)
  int ldp;   // operator row stride (scalars): PPp plus one 16-byte vector
  int rows;  // operator rows per block, at most
  size_t c, cn, P, sig, M, Mn, R, Sinv, ll, Bw, Gw, w, s2, y, ab, Cind, pstate, bar, bytes;
};

// Byte offsets of one cluster block's shared memory; mirrored by
// ops/kalman_sym.py::sym_smem_bytes(..., cluster=C). The replicas of the
// cluster's covariances, Cw and 1/S are cov_t, the rest scalar_t.
template <typename scalar_t, typename cov_t>
__host__ __device__ ClusterLayout cluster_layout(int n, int N, int d, int q, int PPp,
                                                 int TP, int C) {
  ClusterLayout s;
  const size_t sz = sizeof(scalar_t), cz = sizeof(cov_t);
  const int ncol = TP * q, PP = N * (N + 1) / 2;
  s.ld = PPp + bild::Vec16<cov_t>::width;
  s.ldp = PPp + bild::Vec16<scalar_t>::width;
  s.rows = (PP + C - 1) / C;
  size_t o = 0;
  s.c = o;      o += align16(cz * ncol * s.ld);
  s.cn = o;     o += align16(cz * ncol * s.ld);
  s.P = o;      o += align16(sz * n * s.rows * s.ldp);
  s.sig = o;    o += align16(sz * n * s.rows);
  s.M = o;      o += align16(sz * TP * (N + 1) * d);
  s.Mn = o;     o += align16(sz * TP * (N + 1) * d);
  s.R = o;      o += align16(cz * ncol * N);
  s.Sinv = o;   o += align16(cz * ncol);
  s.ll = o;     o += align16(sz * TP);
  s.Bw = o;     o += align16(sz * n * (N + 1) * N);
  s.Gw = o;     o += align16(sz * n * (N + 1) * d);
  s.w = o;      o += align16(sz * N);
  s.s2 = o;     o += align16(sz * q);
  s.y = o;      o += align16(sz * d);
  s.ab = o;     o += align16(2 * PP);
  s.Cind = o;   o += align16(4 * d);
  s.pstate = o; o += align16(4 * TP);
  s.bar = o;    o += 32;  // the operator rows' barrier; one per covariance buffer
  s.bytes = o;
  return s;
}

// The cluster plan: a cluster of C blocks evaluates TP profiles of one
// lane. Block `rank` keeps its operator rows of every state resident in
// shared memory for the whole launch, and a replica of the cluster's
// covariances; per frame it computes its rows of every column's
// propagation, stores them into every block's replica (distributed shared
// memory, counted on that block's barrier of the buffer), and once its own
// replica is whole runs the means and the update on it, the same work in
// every block. Rank 0 writes the results. Cluster barriers only after the
// set-up and before leaving. One block per SM (kClusterSmem), so its own
// launch bounds.
template <typename scalar_t, typename cov_t>
__global__ void __launch_bounds__(kThreads, 1)
kalman_sym_cluster_kernel(const scalar_t* __restrict__ Prow,
                          const scalar_t* __restrict__ sig,
                          const scalar_t* __restrict__ c0,
                          const scalar_t* __restrict__ w_g,
                          const scalar_t* __restrict__ Ballw,
                          const scalar_t* __restrict__ Gsw,
                          const scalar_t* __restrict__ M0w,
                          const scalar_t* __restrict__ s2_g,
                          const int* __restrict__ Cind_g,
                          const int* __restrict__ profiles,
                          const scalar_t* __restrict__ ydata,
                          const unsigned char* __restrict__ valid,
                          scalar_t* __restrict__ out,
                          int n, int N, int d, int q, int P, int T, int PPp, int N1p,
                          int TP, int C) {
  constexpr int VW = bild::Vec16<scalar_t>::width;  // operator scalars per 16-byte load
  constexpr int CVW = bild::Vec16<cov_t>::width;    // covariance scalars per load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ClusterLayout lay = cluster_layout<scalar_t, cov_t>(n, N, d, q, PPp, TP, C);
  cov_t* c = reinterpret_cast<cov_t*>(smem_raw + lay.c);           // (ncol, ld): replica
  cov_t* cn = reinterpret_cast<cov_t*>(smem_raw + lay.cn);         // (ncol, ld): replica
  scalar_t* Pl = reinterpret_cast<scalar_t*>(smem_raw + lay.P);    // (n, rows, ldp): own rows
  scalar_t* sigl = reinterpret_cast<scalar_t*>(smem_raw + lay.sig);  // (n, rows)
  scalar_t* M = reinterpret_cast<scalar_t*>(smem_raw + lay.M);     // (TP, N+1, d)
  scalar_t* Mn = reinterpret_cast<scalar_t*>(smem_raw + lay.Mn);
  cov_t* R = reinterpret_cast<cov_t*>(smem_raw + lay.R);           // (ncol, N): Cw
  cov_t* Sinv = reinterpret_cast<cov_t*>(smem_raw + lay.Sinv);     // (ncol)
  scalar_t* llv = reinterpret_cast<scalar_t*>(smem_raw + lay.ll);  // (TP)
  scalar_t* Bw = reinterpret_cast<scalar_t*>(smem_raw + lay.Bw);   // (n, N+1, N)
  scalar_t* Gw = reinterpret_cast<scalar_t*>(smem_raw + lay.Gw);   // (n, N+1, d)
  scalar_t* w = reinterpret_cast<scalar_t*>(smem_raw + lay.w);     // (N)
  scalar_t* s2 = reinterpret_cast<scalar_t*>(smem_raw + lay.s2);   // (q)
  scalar_t* yt = reinterpret_cast<scalar_t*>(smem_raw + lay.y);    // (d): this frame's data
  unsigned short* ab = reinterpret_cast<unsigned short*>(smem_raw + lay.ab);
  int* Cind = reinterpret_cast<int*>(smem_raw + lay.Cind);
  int* pstate = reinterpret_cast<int*>(smem_raw + lay.pstate);     // state of each profile
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw + lay.bar);

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int PP = N * (N + 1) / 2;
  const int N1 = N + 1;
  const int ld = lay.ld, ldp = lay.ldp;
  const int rank = static_cast<int>(bild::cluster_rank());
  const int groups = (P + TP - 1) / TP;              // clusters per lane
  const int cl = blockIdx.x / C;                     // this block's cluster
  const size_t traj = cl / groups;                   // its lane
  const int p0 = (cl % groups) * TP;
  const int tp = min(TP, P - p0);                    // profiles in this cluster
  const int ncol = tp * q;                           // column p*q + qi
  const int r0 = cluster_first_row(PP, C, rank);     // this block's operator rows
  const int nrows = cluster_row_count(PP, C, rank);
  const int* prof = profiles + (traj * P + p0) * static_cast<size_t>(T);
  const scalar_t* y_traj = ydata + traj * T * d;
  const unsigned char* valid_traj = valid + traj * T;

  // this block's rows of every state's P_s, once: the host stores each
  // row padded to ldp scalars (ops/kalman_sym.py::row_operators), so the
  // rows of one state are one bulk copy
  if (tid == 0) {
    for (int b = 0; b < 3; ++b) bild::mbar_init(&bar[b]);
    if (nrows > 0) {
      const unsigned bytes = nrows * ldp * sizeof(scalar_t);
      bild::mbar_arrive_expect(bar, bytes * n);
      for (int s = 0; s < n; ++s)
        bild::bulk_copy(Pl + static_cast<size_t>(s) * lay.rows * ldp,
                        Prow + (static_cast<size_t>(s) * PPp + r0) * ldp, bytes, bar);
    }
  }
  for (int i = tid; i < ncol * ld; i += nth) {
    const int col = i / ld, k = i % ld;
    const int s0 = bild::clamp_state(prof[static_cast<size_t>(col / q) * T], n);
    c[i] = k < PPp ? cov_t(c0[static_cast<size_t>(s0) * PPp + k]) : cov_t(0);
    cn[i] = 0;
  }
  for (int i = tid; i < tp * N1 * d; i += nth) {
    const int p = i / (N1 * d);
    const int s0 = bild::clamp_state(prof[static_cast<size_t>(p) * T], n);
    M[i] = M0w[static_cast<size_t>(s0) * N1p * d + i % (N1 * d)];
  }
  for (int p = tid; p < tp; p += nth) llv[p] = 0;
  for (int a = tid; a < N; a += nth)
    for (int b = a; b < N; ++b)
      ab[a * N - a * (a - 1) / 2 + (b - a)] = static_cast<unsigned short>(a | (b << 8));
  for (int i = tid; i < n * N1 * N; i += nth)
    Bw[i] = Ballw[(static_cast<size_t>(i / (N1 * N)) * N1p) * N + i % (N1 * N)];
  for (int i = tid; i < n * N1 * d; i += nth)
    Gw[i] = Gsw[(static_cast<size_t>(i / (N1 * d)) * N1p) * d + i % (N1 * d)];
  for (int i = tid; i < n * nrows; i += nth)
    sigl[(i / nrows) * lay.rows + i % nrows] =
        sig[static_cast<size_t>(i / nrows) * PPp + r0 + i % nrows];
  for (int i = tid; i < N; i += nth) w[i] = w_g[i];
  for (int i = tid; i < q; i += nth) s2[i] = s2_g[i];
  for (int i = tid; i < d; i += nth) Cind[i] = Cind_g[i];
  __syncthreads();                       // the barrier is initialized
  if (nrows > 0) bild::mbar_wait(bar, 0);  // the operator rows landed
  bild::cluster_sync();  // every replica is set before any block stores into a peer's

  auto frame = [&]() {
    return Frame<scalar_t, cov_t>{c, M, Mn, R, Sinv, llv, Bw, Gw, w, s2, yt, ab,
                                  Cind, pstate, tp, ncol, ld, N, d, q};
  };
  // this frame's states and data, loaded by warp 0 one frame ahead
  int st_next = -1;
  scalar_t y_next = 0;
  auto prefetch = [&](int t) {
    if (tid < 32 && t < T) {
      if (tid < tp) st_next = bild::clamp_state(prof[static_cast<size_t>(tid) * T + t], n);
      if (tid < d) y_next = y_traj[static_cast<size_t>(t) * d + tid];
    }
  };

  prefetch(0);
  BILD_PHASE_START();
  for (int t = 0; t < T; ++t) {
    if (tid < 32) {  // this frame's data and states
      if (tid < d) yt[tid] = y_next;
      if (tid < tp) pstate[tid] = st_next;
      prefetch(t + 1);
    }
    __syncthreads();
    BILD_PHASE(0);
    if (t > 0) {
      propagate_means(frame());
      BILD_PHASE(1);
      // cn[r, col] = P_s[r, :] c[:, col] + sig_s[r] for this block's rows
      // r and every column, s the column's state: one thread per (row,
      // column), one float64 FMA chain over k = 0..PPp-1 in order (as the
      // tile kernel's), stored into every block's replica by an
      // asynchronous store that counts its bytes on that block's barrier
      // of this buffer
      const unsigned cn_addr = bild::smem_addr(cn);
      const unsigned bar_addr = bild::smem_addr(&bar[1 + (t & 1)]);
#pragma unroll 1
      for (int item = tid; item < ncol * nrows; item += nth) {
        const int col = item / nrows, r = item % nrows;
        const int s = pstate[col / q];
        const scalar_t* A = Pl + (static_cast<size_t>(s) * lay.rows + r) * ldp;
        const cov_t* bcol = c + static_cast<size_t>(col) * ld;
        cov_t acc = 0;
#pragma unroll 4
        for (int k = 0; k < PPp; k += VW) {
          const auto av = bild::load16(A + k);
          const scalar_t* a = reinterpret_cast<const scalar_t*>(&av);
          cov_t b[VW];
#pragma unroll
          for (int h = 0; h < VW / CVW; ++h) {
            const auto v = bild::load16(bcol + k + h * CVW);
            const cov_t* vs = reinterpret_cast<const cov_t*>(&v);
#pragma unroll
            for (int u = 0; u < CVW; ++u) b[h * CVW + u] = vs[u];
          }
#pragma unroll
          for (int u = 0; u < VW; ++u) acc = fma(cov_t(a[u]), b[u], acc);
        }
        const cov_t v = acc + cov_t(sigl[s * lay.rows + r]);
        BILD_PHASE(2);
        const unsigned addr = cn_addr + static_cast<unsigned>(
            (static_cast<size_t>(col) * ld + r0 + r) * sizeof(cov_t));
        for (int j = 0; j < C; ++j)
          bild::st_async(bild::map_rank(addr, j), v, bild::map_rank(bar_addr, j));
        BILD_PHASE(3);
      }
      // every block's rows of this frame have landed in this replica
      if (tid == 0)
        bild::mbar_arrive_expect(&bar[1 + (t & 1)],
                                 static_cast<unsigned>(ncol * PP * sizeof(cov_t)));
      bild::mbar_wait(&bar[1 + (t & 1)], ((t - 1) >> 1) & 1u);
      BILD_PHASE(3);
      cov_t* tmp = c; c = cn; cn = tmp;
      scalar_t* tmpM = M; M = Mn; Mn = tmpM;
    }
    if (valid_traj[t])
      measurement_update(frame(), [&](int k) {
        if (k == 0) BILD_PHASE(4);
        if (k == 1) BILD_PHASE(5);
        if (k == 2) BILD_PHASE(6);
      });
    BILD_PHASE(6);
  }
  BILD_PHASE_END();

  if (rank == 0)
    for (int p = tid; p < tp; p += nth) out[traj * P + p0 + p] = llv[p];
  bild::cluster_sync();  // no block leaves while a peer may still store into it
}

template <typename scalar_t, typename cov_t>
int launch_sym(const void* Pslab, const void* sig, const void* c0,
               const void* w, const void* Ballw, const void* Gsw,
               const void* M0w, const void* s2, const void* Cind,
               const void* profiles, const void* ydata, const void* valid,
               void* out, int n, int N, int d, int q, int L, int P, int T,
               int PPp, int N1p, int TP, int smem, int device, void* stream) {
  const SymLayout lay = sym_layout<scalar_t, cov_t>(n, N, d, q, PPp, TP);
  if (TP < 1 || TP > kMaxTile || n < 1 || n > 32 || N < 1 || N > 255 || d > kMaxD ||
      PPp % kBK != 0 || lay.nct_max > kThreads || lay.bytes != static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(L) * ((P + TP - 1) / TP);
  return bild::launch(
      kalman_sym_kernel<scalar_t, cov_t>, blocks, kThreads, lay.bytes, device, stream,
      static_cast<const scalar_t*>(Pslab), static_cast<const scalar_t*>(sig),
      static_cast<const scalar_t*>(c0), static_cast<const scalar_t*>(w),
      static_cast<const scalar_t*>(Ballw), static_cast<const scalar_t*>(Gsw),
      static_cast<const scalar_t*>(M0w), static_cast<const scalar_t*>(s2),
      static_cast<const int*>(Cind), static_cast<const int*>(profiles),
      static_cast<const scalar_t*>(ydata),
      static_cast<const unsigned char*>(valid), static_cast<scalar_t*>(out),
      n, N, d, q, P, T, PPp, N1p, TP);
}


template <typename scalar_t, typename cov_t>
int launch_sym_cluster(const void* Prow, const void* sig, const void* c0,
                       const void* w, const void* Ballw, const void* Gsw,
                       const void* M0w, const void* s2, const void* Cind,
                       const void* profiles, const void* ydata, const void* valid,
                       void* out, int n, int N, int d, int q, int L, int P, int T,
                       int PPp, int N1p, int TP, int C, int smem, int device,
                       void* stream) {
  const ClusterLayout lay = cluster_layout<scalar_t, cov_t>(n, N, d, q, PPp, TP, C);
  if (TP < 1 || TP > kMaxTile || C < 1 || C > 16 || n < 1 || n > 32 || N < 1 ||
      N > 255 || d > kMaxD || PPp % kBK != 0 || lay.bytes != static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(L) * ((P + TP - 1) / TP) * C;
  return bild::launch_cluster(
      kalman_sym_cluster_kernel<scalar_t, cov_t>, blocks, C, kThreads,
      lay.bytes > kClusterSmem ? lay.bytes : kClusterSmem, device, stream,
      Prow, sig, c0, w, Ballw, Gsw, M0w, s2, Cind, profiles, ydata, valid, out,
      n, N, d, q, P, T, PPp, N1p, TP, C);
}

}  // namespace

#define BILD_SYM_ARGS                                                         \
  const void *sig, const void *c0, const void *w, const void *Ballw,          \
      const void *Gsw, const void *M0w, const void *s2, const void *Cind,     \
      const void *profiles, const void *ydata, const void *valid, void *out,  \
      int n, int N, int d, int q, int L, int P, int T, int PPp, int N1p,      \
      int TP, int smem, int device, void *stream
#define BILD_SYM_PASS                                                         \
  sig, c0, w, Ballw, Gsw, M0w, s2, Cind, profiles, ydata, valid, out, n, N, d, \
      q, L, P, T, PPp, N1p, TP, smem, device, stream

// exact tier: the propagators in slab order (ops/kalman_sym.py::slab_operators);
// float32 in and out with the covariance recursion in float64, and float64
// throughout
extern "C" int bild_kalman_sym_f32(const void* Pslab, BILD_SYM_ARGS) {
  return launch_sym<float, double>(Pslab, BILD_SYM_PASS);
}
extern "C" int bild_kalman_sym_f64(const void* Pslab, BILD_SYM_ARGS) {
  return launch_sym<double, double>(Pslab, BILD_SYM_PASS);
}

// the cluster plan (ops/kalman_sym.py::sym_plan): the propagators row by
// row, each row padded to a whole 16-byte vector
// (ops/kalman_sym.py::row_operators); C blocks per cluster
#define BILD_SYM_CLUSTER_ARGS                                                 \
  const void *Prow, const void *sig, const void *c0, const void *w,          \
      const void *Ballw, const void *Gsw, const void *M0w, const void *s2,    \
      const void *Cind, const void *profiles, const void *ydata,              \
      const void *valid, void *out, int n, int N, int d, int q, int L, int P, \
      int T, int PPp, int N1p, int TP, int C, int smem, int device,           \
      void *stream
#define BILD_SYM_CLUSTER_PASS                                                 \
  Prow, sig, c0, w, Ballw, Gsw, M0w, s2, Cind, profiles, ydata, valid, out,   \
      n, N, d, q, L, P, T, PPp, N1p, TP, C, smem, device, stream
extern "C" int bild_kalman_sym_cluster_f32(BILD_SYM_CLUSTER_ARGS) {
  return launch_sym_cluster<float, double>(BILD_SYM_CLUSTER_PASS);
}
extern "C" int bild_kalman_sym_cluster_f64(BILD_SYM_CLUSTER_ARGS) {
  return launch_sym_cluster<double, double>(BILD_SYM_CLUSTER_PASS);
}
// clusters of C blocks that the device holds at once, or minus the error
extern "C" int bild_kalman_sym_cluster_slots_f32(int C, int device) {
  return bild::max_active_clusters(kalman_sym_cluster_kernel<float, double>, C, kThreads,
                                   kClusterSmem, device);
}
extern "C" int bild_kalman_sym_cluster_slots_f64(int C, int device) {
  return bild::max_active_clusters(kalman_sym_cluster_kernel<double, double>, C, kThreads,
                                   kClusterSmem, device);
}
