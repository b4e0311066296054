// Packed-symmetric Rouse-Kalman log-likelihood: one block per tile of TP
// profiles of one lane, where a lane is one trajectory and all lanes share
// the model.
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
// Shared memory at N=20, d=3, q=1, n=2, TP=32, float32 (the lockstep
// launch): c and cn 2 x 32 x 220 x 4 = 56.3 KB, the P_s slabs 2 buffers x
// n x 216 rows x 8 x 4 = 27.6 KB, the means M and Mn 2 x 32 x 21 x 3 x 4
// = 16.1 KB, Cw and 1/S 32 x 21 x 4 = 2.7 KB, Ballw and Gsw 3.9 KB, the
// index tables, column lists and barriers 0.9 KB: 108 KB, two blocks per
// SM. sym_layout() below and ops/kalman_sym.py::sym_smem_bytes compute the
// same bytes; the launch refuses a mismatch.
//
// A profile's result does not depend on its partners: every output of the
// products is one thread's dot product over k = 0..PPp-1 in order, the
// downdate's products are rounded explicitly (never contracted), and
// every other step is per profile. So a lane launch equals single-lane
// launches, a permutation of the profiles permutes the results and a
// subset gives the same bits, whatever the tile width.
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
// ops/kalman_sym.py::sym_smem_bytes.
template <typename scalar_t>
__host__ __device__ SymLayout sym_layout(int n, int N, int d, int q, int PPp,
                                         int TP) {
  SymLayout s;
  const size_t sz = sizeof(scalar_t);
  const int ncol = TP * q;
  s.ld = PPp + bild::Vec16<scalar_t>::width;
  s.nct_max = (ncol + kTN - 1) / kTN + n;
  s.rows_slab = PPp < kRowsMax ? PPp : kRowsMax;
  size_t o = 0;
  s.c = o;      o += align16(sz * ncol * s.ld);
  s.cn = o;     o += align16(sz * ncol * s.ld);
  s.slab = o;   o += align16(sz * 2 * n * s.rows_slab * kBK);
  s.M = o;      o += align16(sz * TP * (N + 1) * d);
  s.Mn = o;     o += align16(sz * TP * (N + 1) * d);
  s.R = o;      o += align16(sz * ncol * N);
  s.Sinv = o;   o += align16(sz * ncol);
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

// float32: two blocks per SM (at most 128 registers a thread), so that
// one block's arithmetic covers the other's barrier waits; a float64
// block's shared memory leaves room for one
template <typename scalar_t>
__global__ void __launch_bounds__(kThreads, sizeof(scalar_t) == 4 ? 2 : 1)
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
  constexpr int VW = bild::Vec16<scalar_t>::width;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SymLayout lay = sym_layout<scalar_t>(n, N, d, q, PPp, TP);
  scalar_t* c = reinterpret_cast<scalar_t*>(smem_raw + lay.c);    // (ncol, ld)
  scalar_t* cn = reinterpret_cast<scalar_t*>(smem_raw + lay.cn);  // (ncol, ld)
  scalar_t* slab = reinterpret_cast<scalar_t*>(smem_raw + lay.slab);
  scalar_t* M = reinterpret_cast<scalar_t*>(smem_raw + lay.M);    // (TP, N+1, d)
  scalar_t* Mn = reinterpret_cast<scalar_t*>(smem_raw + lay.Mn);
  scalar_t* R = reinterpret_cast<scalar_t*>(smem_raw + lay.R);    // (ncol, N): Cw
  scalar_t* Sinv = reinterpret_cast<scalar_t*>(smem_raw + lay.Sinv);  // (ncol)
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
    c[i] = k < PPp ? c0[static_cast<size_t>(s0) * PPp + k] : scalar_t(0);
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

  // sum_k x[k] y[k] over k = 0..K-1 in order, four loads at a time
  auto dot = [](const scalar_t* x, const scalar_t* y, int K) {
    scalar_t acc = 0;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      scalar_t xv[4], yv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xv[u] = x[k + u];
        yv[u] = y[k + u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc = fma(xv[u], yv[u], acc);
    }
    for (; k < K; ++k) acc = fma(x[k], y[k], acc);
    return acc;
  };

  // the measurement update of frame t (whose data yt holds)
  auto update = [&]() {
    // Cw[col, a] = sum_b C_ab w_b, read from the packed column: row a of
    // the upper triangle (b >= a) is contiguous, column a (b < a) strided
    for (int item = tid; item < ncol * N; item += nth) {
      const int col = item / N, a = item % N;
      const scalar_t* cc = c + static_cast<size_t>(col) * ld;
      scalar_t acc = 0;
      int k = a;  // packed index of (b, a), b = 0..a-1
#pragma unroll 4
      for (int b = 0; b < a; ++b) {
        acc = fma(cc[k], w[b], acc);
        k += N - 1 - b;
      }
      const scalar_t* row = cc + a * N - a * (a - 1) / 2;  // entries (a, a..N-1)
      R[col * N + a] = acc + dot(row, w + a, N - a);
    }
    __syncthreads();
    for (int col = tid; col < ncol; col += nth)  // S = w.Cw + s2
      Sinv[col] = scalar_t(1) / (dot(R + col * N, w, N) + s2[col % q]);
    __syncthreads();
    for (int k = tid; k < PP; k += nth) {  // c[(a,b)] -= (Cw_a Cw_b) Sinv
      const int a = ab[k] & 0xff, b = ab[k] >> 8;
      auto down = [&](int col) {
        return bild::mul_rn(bild::mul_rn(R[col * N + a], R[col * N + b]), Sinv[col]);
      };
      int col = 0;
      for (; col + 4 <= ncol; col += 4) {  // four columns' loads before their stores
        scalar_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = down(col + u);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          scalar_t* cc = c + static_cast<size_t>(col + u) * ld + k;
          *cc = bild::sub_rn(*cc, v[u]);
        }
      }
      for (; col < ncol; ++col) {
        scalar_t* cc = c + static_cast<size_t>(col) * ld + k;
        *cc = bild::sub_rn(*cc, down(col));
      }
    }
    for (int item = tid; item < tp * N; item += nth) {  // M += K[Cind] (y - w.M)
      const int p = item / N, i = item % N;
      scalar_t* Mp = M + p * N1 * d;
#pragma unroll
      for (int dd = 0; dd < kMaxD; ++dd) {
        if (dd < d) {
          const int col = p * q + Cind[dd];
          Mp[i * d + dd] += (R[col * N + i] * Sinv[col]) * (yt[dd] - Mp[N * d + dd]);
        }
      }
    }
    for (int p = tid; p < tp; p += nth) {
      scalar_t ll = llv[p];
      for (int dd = 0; dd < d; ++dd) {
        const scalar_t Sv = Sinv[p * q + Cind[dd]];
        const scalar_t xmm = yt[dd] - M[p * N1 * d + N * d + dd];
        ll -= scalar_t(0.5) *
              (xmm * xmm * Sv - bild::dlog(Sv) + scalar_t(bild::kLog2Pi));
      }
      llv[p] = ll;
    }
    __syncthreads();
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

  // Mn[p] = Ballw_s M[p] + Gsw_s, s the profile's state: one row of one
  // profile per item, its d columns at once
  auto propagate_means = [&]() {
    for (int item = tid; item < tp * N1; item += nth) {
      const int p = item / N1, row = item % N1, s = pstate[p];
      const scalar_t* Bwr = Bw + (s * N1 + row) * N;
      const scalar_t* Mp = M + p * N1 * d;
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
        if (dd < d) Mn[(p * N1 + row) * d + dd] = acc[dd] + Gw[(s * N1 + row) * d + dd];
    }
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
    const scalar_t* bcol[kTN];
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

      scalar_t acc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

      if (row0 > 0) __syncthreads();  // the last pass's slabs are consumed
      issue(0);
      if (row0 == 0) propagate_means();
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
            scalar_t b[kTN][VW];
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
              const auto v = bild::load16(bcol[j] + k0 + kk);
              const scalar_t* vs = reinterpret_cast<const scalar_t*>(&v);
#pragma unroll
              for (int u = 0; u < VW; ++u) b[j][u] = vs[u];
            }
#pragma unroll
            for (int i = 0; i < kTM; ++i) {
              if (i < tm) {
                const int r = rt + i * RT;
                const auto av = bild::load16(A + r * kBK + swizzle<CH>(row0 + r, kk / VW) * VW);
                const scalar_t* a = reinterpret_cast<const scalar_t*>(&av);
#pragma unroll
                for (int u = 0; u < VW; ++u)
#pragma unroll
                  for (int j = 0; j < kTN; ++j) acc[i][j] = fma(a[u], b[j][u], acc[i][j]);
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
          const scalar_t sg = sig[static_cast<size_t>(my_s) * PPp + r];
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
      scalar_t* tmp = c; c = cn; cn = tmp;
      tmp = M; M = Mn; Mn = tmp;
    }
    if (valid_traj[t]) update();
    BILD_PHASE(6);
  }
  BILD_PHASE_END();

  for (int p = tid; p < tp; p += nth) out[traj * P + p0 + p] = llv[p];
}

template <typename scalar_t>
int launch_sym(const void* Pslab, const void* sig, const void* c0,
               const void* w, const void* Ballw, const void* Gsw,
               const void* M0w, const void* s2, const void* Cind,
               const void* profiles, const void* ydata, const void* valid,
               void* out, int n, int N, int d, int q, int L, int P, int T,
               int PPp, int N1p, int TP, int smem, int device, void* stream) {
  const SymLayout lay = sym_layout<scalar_t>(n, N, d, q, PPp, TP);
  if (TP < 1 || TP > kMaxTile || n < 1 || n > 32 || N < 1 || N > 255 || d > kMaxD ||
      PPp % kBK != 0 ||
      lay.nct_max > kThreads || lay.bytes != static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(L) * ((P + TP - 1) / TP);
  return bild::launch(
      kalman_sym_kernel<scalar_t>, blocks, kThreads, lay.bytes, device, stream,
      static_cast<const scalar_t*>(Pslab), static_cast<const scalar_t*>(sig),
      static_cast<const scalar_t*>(c0), static_cast<const scalar_t*>(w),
      static_cast<const scalar_t*>(Ballw), static_cast<const scalar_t*>(Gsw),
      static_cast<const scalar_t*>(M0w), static_cast<const scalar_t*>(s2),
      static_cast<const int*>(Cind), static_cast<const int*>(profiles),
      static_cast<const scalar_t*>(ydata),
      static_cast<const unsigned char*>(valid), static_cast<scalar_t*>(out),
      n, N, d, q, P, T, PPp, N1p, TP);
}

}  // namespace

#define BILD_SYM_ENTRY(NAME, TYPE)                                            \
  extern "C" int NAME(const void* Pslab, const void* sig, const void* c0,     \
                      const void* w, const void* Ballw, const void* Gsw,      \
                      const void* M0w, const void* s2, const void* Cind,      \
                      const void* profiles, const void* ydata,                \
                      const void* valid, void* out, int n, int N, int d,      \
                      int q, int L, int P, int T, int PPp, int N1p, int TP,   \
                      int smem, int device, void* stream) {                   \
    return launch_sym<TYPE>(Pslab, sig, c0, w, Ballw, Gsw, M0w, s2, Cind,     \
                            profiles, ydata, valid, out, n, N, d, q, L, P, T, \
                            PPp, N1p, TP, smem, device, stream);              \
  }

BILD_SYM_ENTRY(bild_kalman_sym_f32, float)
BILD_SYM_ENTRY(bild_kalman_sym_f64, double)
