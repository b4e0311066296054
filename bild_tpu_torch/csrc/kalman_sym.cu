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
//
// The split tiers (float32 only; bild_tpu's split_bf16 / split_update
// flags, kalman_sym.py:222-242). Each operand of a product becomes a
// bfloat16 pair, hi = bf16(x), lo = bf16(x - hi) (round to nearest even),
// and A B ~ Ahi Bhi + Ahi Blo + Alo Bhi: three products of exactly
// representable operands with float32 sums. TIER 1 ('split_cov') splits
// the conjugation, TIER 2 ('split') also the update contraction (Cw and
// S = u.c, u the S row of the reference's U1) and the mean propagation.
// The conjugation then runs on the tensor cores: per 16 x 8 tile of cn
// (16 operator rows, 8 columns of one state) and 16-deep k-step, three
// mma.sync.m16n8k16 bf16 products accumulate in float32 registers. A is
// P_s hi and lo, stored by the host in the mma's A-fragment order
// (ops/kalman_sym.py::split_fragments: 1 KB per 16 x 16 tile, one 16-byte
// load per lane and operand, no bank conflict), streamed in slabs of up
// to 7 m-tiles per state by the same bulk copies (a hi and a lo slab take
// the bytes of one float32 slab). B is the tile's covariance columns: at
// the start of each frame's product every column is split in place into
// its pairs (per 16-scalar block, 8 words of hi pairs, then 8 of lo), so
// a lane loads its B fragment as four words; the column stride is 4
// modulo 32 (ops/kalman_sym.py::split_ld), so those loads meet 32 banks.
// Columns are sorted by state into groups padded to 8 (the mma's n). Each
// warp owns up to 8 (m-tile, column-tile) products of a pass and keeps
// their accumulators over the whole k loop; the passes split the m-tiles
// so that no warp holds more. The update and the means stay SIMT, with
// the pairs made as the operands are read (exact products, three float32
// sums combined as (hi.hi + hi.lo) + lo.hi). Rows and depth padded to 16
// are exact zeros: the host pads P_s with zeros, and the write-back
// stores zeros in the covariance slots past PP (the in-place split puts
// lo words there when PP is not a multiple of 16, PP = 210 at N=20, and
// the buffer is the next frame's cn). Per-profile independence holds here
// too: every tile output accumulates the same k-steps in the same order
// whatever its place in a tile, and an mma's outputs depend only on their
// own row and column. What bounds it: the conjugation's three bf16
// products at the tensor cores' 989 TFLOP/s and the rest at the float32
// peak, 1.09 ms for a lockstep call of 640 x 128 profiles
// (chip_smoke.py::split_bound_ms); 'split_cov' ran it in 57 ms, about
// the exact tier's time (PERF.md, an H100 SXM at 700 W): the slab
// pipeline, one bulk copy and one block barrier per 16-deep k-step and
// pass with a few mma per warp between them, holds the frame, not the
// tensor cores. This is the simple kernel; wgmma, deeper slabs and a
// producer warp are what would move it.
#include <cuda_bf16.h>

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
// the split tiers
constexpr int kTN8 = 8;          // covariance columns per mma tile (n = 8)
constexpr int kFragBytes = 1024; // one 16 x 16 operator tile: hi and lo fragments
constexpr int kMtSlab = 7;       // operator m-tiles per slab, at most
constexpr int kItems = 8;        // (m-tile, column-tile) products per warp and pass

// bfloat16 pairs: hi = bf16(x), lo = bf16(x - hi), both rounded to nearest
// even (x - hi is exact)
__device__ __forceinline__ void split1(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(x - hi));
}
// two consecutive scalars as packed bf16 words (the first in the low half)
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  const __nv_bfloat16 l0 = __float2bfloat16_rn(x0 - __bfloat162float(h0));
  const __nv_bfloat16 l1 = __float2bfloat16_rn(x1 - __bfloat162float(h1));
  hi = static_cast<unsigned>(__bfloat16_as_ushort(h0)) |
       (static_cast<unsigned>(__bfloat16_as_ushort(h1)) << 16);
  lo = static_cast<unsigned>(__bfloat16_as_ushort(l0)) |
       (static_cast<unsigned>(__bfloat16_as_ushort(l1)) << 16);
}
// acc += the split product of a and x, its three parts summed apart
__device__ __forceinline__ void split_fma(float a, float x, float& hh, float& hl, float& lh) {
  float ah, al, xh, xl;
  split1(a, ah, al);
  split1(x, xh, xl);
  hh = fmaf(ah, xh, hh);
  hl = fmaf(ah, xl, hl);
  lh = fmaf(al, xh, lh);
}
// d += A B for one 16 x 8 tile: A (16 x 16, row) four words of bf16 pairs,
// B (16 x 8, col) two words, d four floats (rows g, g+8 x columns 2t, 2t+1
// of lane 4g + t)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

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
  int nct_max;    // column tiles of 4 (split tiers: 8), at most
  int rows_slab;  // operator rows per slab
  int mt_slab;    // split tiers: operator m-tiles per slab
  size_t c, cn, slab, M, Mn, R, Sinv, ll, Bw, Gw, w, s2, y, ab, u, Cind, list, tstate,
      pstate, misc, bar, bytes;
};

// Byte offsets of the block's shared memory; mirrored by
// ops/kalman_sym.py::sym_smem_bytes.
template <typename scalar_t>
__host__ __device__ SymLayout sym_layout(int n, int N, int d, int q, int PPp,
                                         int TP, bool split) {
  SymLayout s;
  const size_t sz = sizeof(scalar_t);
  const int ncol = TP * q;
  const int K16 = (PPp + 15) / 16 * 16;
  const int tn = split ? kTN8 : kTN;
  s.ld = split ? K16 + (36 - K16 % 32) % 32 : PPp + bild::Vec16<scalar_t>::width;
  s.nct_max = (ncol + tn - 1) / tn + n;
  s.rows_slab = PPp < kRowsMax ? PPp : kRowsMax;
  s.mt_slab = K16 / 16 < kMtSlab ? K16 / 16 : kMtSlab;
  size_t o = 0;
  s.c = o;      o += align16(sz * ncol * s.ld);
  s.cn = o;     o += align16(sz * ncol * s.ld);
  s.slab = o;   o += align16(split ? static_cast<size_t>(2) * n * s.mt_slab * kFragBytes
                                   : sz * 2 * n * s.rows_slab * kBK);
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
  s.u = o;      o += split ? align16(sz * PPp) : 0;
  s.Cind = o;   o += align16(4 * d);
  s.list = o;   o += align16(4 * s.nct_max * tn);
  s.tstate = o; o += align16(4 * s.nct_max);
  s.pstate = o; o += align16(4 * TP);
  s.misc = o;   o += 16;
  s.bar = o;    o += 16;  // two mbarriers, one per slab buffer
  s.bytes = o;
  return s;
}

// float32: two blocks per SM (at most 128 registers a thread), so that
// one block's arithmetic covers the other's barrier waits; a float64
// block's shared memory leaves room for one. TIER: 0 exact, 1 split_cov,
// 2 split (float32 only); Pops is Pslab (exact) or the A fragments
// (split tiers), Srow the S row of U1 (TIER 2).
template <typename scalar_t, int TIER>
__global__ void __launch_bounds__(kThreads, sizeof(scalar_t) == 4 ? 2 : 1)
kalman_sym_kernel(const void* __restrict__ Pops,
                  const float* __restrict__ Srow,
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
  constexpr bool kSplit = TIER != 0;
  constexpr bool kSplitUpd = TIER == 2;
  constexpr int TNW = kSplit ? kTN8 : kTN;  // columns per column tile
  static_assert(!kSplit || sizeof(scalar_t) == 4, "the split tiers are float32 only");
  const scalar_t* __restrict__ Pslab = static_cast<const scalar_t*>(Pops);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SymLayout lay = sym_layout<scalar_t>(n, N, d, q, PPp, TP, kSplit);
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
  scalar_t* srow = reinterpret_cast<scalar_t*>(smem_raw + lay.u); // (PPp): TIER 2's S row
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
  if (kSplitUpd)
    for (int i = tid; i < PPp; i += nth) srow[i] = Srow[i];
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

  // TIER 2's update contraction: Cw[col, a] = sum_b w_b C_ab and S =
  // u.c, each product split, as the reference's split U1 c (U1's Cw rows
  // hold the float32 w_b; its S row is u)
  auto contract_split = [&]() {
    for (int item = tid; item < ncol * N; item += nth) {
      const int col = item / N, a = item % N;
      const scalar_t* cc = c + static_cast<size_t>(col) * ld;
      float hh = 0, hl = 0, lh = 0;
      int k = a;  // packed index of (b, a), b = 0..a-1
      for (int b = 0; b < a; ++b) {
        split_fma(w[b], cc[k], hh, hl, lh);
        k += N - 1 - b;
      }
      const scalar_t* row = cc + a * N - a * (a - 1) / 2;  // entries (a, a..N-1)
      for (int b = a; b < N; ++b) split_fma(w[b], row[b - a], hh, hl, lh);
      R[col * N + a] = (hh + hl) + lh;
    }
    for (int col = tid; col < ncol; col += nth) {
      const scalar_t* cc = c + static_cast<size_t>(col) * ld;
      float hh = 0, hl = 0, lh = 0;
      for (int k = 0; k < PP; ++k) split_fma(srow[k], cc[k], hh, hl, lh);
      Sinv[col] = scalar_t(1) / (((hh + hl) + lh) + s2[col % q]);
    }
    __syncthreads();
  };

  // the measurement update of frame t (whose data yt holds)
  auto update = [&]() {
    if constexpr (kSplitUpd) {
      contract_split();
    } else {
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
    }
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
  // slots list[TNW tiles_before_s ...], padded with -1 to whole tiles of
  // TNW (4; 8 in the split tiers).
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
        const int base = nct * TNW;
        if (st == s) {
          const int rank = __popc(m & ((1u << lane) - 1u));
          for (int qi = 0; qi < q; ++qi) list[base + rank * q + qi] = lane * q + qi;
        }
        const int cols = cnt * q, tiles = (cols + TNW - 1) / TNW;
        for (int j = cols + lane; j < tiles * TNW; j += 32) list[base + j] = -1;
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
      if constexpr (kSplitUpd) {  // each product split, as the reference's Ballw M
        float hh[kMaxD] = {}, hl[kMaxD] = {}, lh[kMaxD] = {};
        for (int k = 0; k < N; ++k) {
          float bh, bl;
          split1(Bwr[k], bh, bl);
#pragma unroll
          for (int dd = 0; dd < kMaxD; ++dd) {
            if (dd < d) {
              float mh, ml;
              split1(Mp[k * d + dd], mh, ml);
              hh[dd] = fmaf(bh, mh, hh[dd]);
              hl[dd] = fmaf(bh, ml, hl[dd]);
              lh[dd] = fmaf(bl, mh, lh[dd]);
            }
          }
        }
#pragma unroll
        for (int dd = 0; dd < kMaxD; ++dd)
          if (dd < d)
            Mn[(p * N1 + row) * d + dd] = ((hh[dd] + hl[dd]) + lh[dd]) + Gw[(s * N1 + row) * d + dd];
        continue;
      }
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

  // The split tiers' conjugation on the tensor cores: cn[:, col] = P_s
  // c[:, col] + sig_s, per 16 x 8 tile three mma products per 16-deep
  // k-step (see the top of the file), and the means while the first slabs
  // load.
  auto propagate_split = [&]() {
    const int nct = misc[0];
    const unsigned present = static_cast<unsigned>(misc[1]);
    const int KS = (PPp + 15) / 16;  // k-steps, and m-tiles
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int nwarps = nth / 32;
    // every column's covariance as bf16 pairs, in place: the f32 values
    // are not read again (cn is the next frame's c)
    for (int i = tid; i < ncol * KS; i += nth) {
      scalar_t* blk = c + static_cast<size_t>(i / KS) * ld + (i % KS) * 16;
      unsigned hw[8], lw[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) split2(blk[2 * j], blk[2 * j + 1], hw[j], lw[j]);
      unsigned* words = reinterpret_cast<unsigned*>(blk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        words[j] = hw[j];
        words[8 + j] = lw[j];
      }
    }
    // m-tiles per pass: at most a slab's, and at most kItems products a warp
    const int cap = max(1, min(lay.mt_slab, nwarps * kItems / nct));
    const int passes = (KS + cap - 1) / cap;
    const int mtp = (KS + passes - 1) / passes;
    const unsigned char* frags = static_cast<const unsigned char*>(Pops);
    unsigned char* slab_b = smem_raw + lay.slab;
    const size_t buf_bytes = static_cast<size_t>(lay.mt_slab) * kFragBytes;

    for (int mt0 = 0; mt0 < KS; mt0 += mtp) {
      const int mts = min(mtp, KS - mt0);
      const int items = mts * nct;
      // k-step ks of m-tiles mt0.. of every present state into buffer ks & 1
      auto issue = [&](int ks) {
        if (tid != nth - 1) return;
        const unsigned bytes = mts * kFragBytes;
        unsigned long long* b = &bar[ks & 1];
        bild::mbar_arrive_expect(b, bytes * __popc(present));
        for (int s = 0; s < n; ++s) {
          if (!((present >> s) & 1u)) continue;
          bild::bulk_copy(slab_b + ((ks & 1) * n + s) * buf_bytes,
                          frags + ((static_cast<size_t>(s) * KS + ks) * KS + mt0) * kFragBytes,
                          bytes, b);
        }
      };

      float acc[kItems][4];
#pragma unroll
      for (int j = 0; j < kItems; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;

      if (mt0 > 0) __syncthreads();  // the last pass's slabs are consumed
      issue(0);
      if (mt0 == 0) propagate_means();
      for (int ks = 0; ks < KS; ++ks) {
        bild::mbar_wait(&bar[ks & 1], (parity >> (ks & 1)) & 1u);  // slab ks landed
        parity ^= 1u << (ks & 1);
        __syncthreads();  // every warp is done with slab ks-1 (and c is split)
        if (ks + 1 < KS) issue(ks + 1);
        const unsigned char* buf = slab_b + (ks & 1) * n * buf_bytes;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int item = warp + j * nwarps;  // warp-uniform: the mma needs the whole warp
          if (item < items) {
            const int ct = item / mts, mt = item % mts;
            const int col = list[ct * kTN8 + g];
            const unsigned* cb = reinterpret_cast<const unsigned*>(
                c + static_cast<size_t>(col < 0 ? 0 : col) * ld + ks * 16);
            const unsigned bh0 = cb[t4], bh1 = cb[t4 + 4];
            const unsigned bl0 = cb[8 + t4], bl1 = cb[12 + t4];
            const uint4* a = reinterpret_cast<const uint4*>(
                buf + tstate[ct] * buf_bytes + mt * kFragBytes);
            const uint4 ah = a[lane], al = a[32 + lane];
            mma_bf16(acc[j], ah, bh0, bh1);
            mma_bf16(acc[j], ah, bl0, bl1);
            mma_bf16(acc[j], al, bh0, bh1);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int item = warp + j * nwarps;
        if (item >= items) continue;
        const int ct = item / mts, mt = item % mts, s = tstate[ct];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (mt0 + mt) * 16 + g + 8 * h;  // < K16 <= ld
          const bool live = r < PP;
          const scalar_t sg = live ? sig[static_cast<size_t>(s) * PPp + r] : scalar_t(0);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = list[ct * kTN8 + 2 * t4 + e];
            if (col >= 0)
              cn[static_cast<size_t>(col) * ld + r] = live ? acc[j][2 * h + e] + sg : scalar_t(0);
          }
        }
      }
    }
    __syncthreads();
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
      // each ends with a block barrier: cn and Mn are complete
      if constexpr (kSplit) propagate_split(); else propagate();
      scalar_t* tmp = c; c = cn; cn = tmp;
      tmp = M; M = Mn; Mn = tmp;
    }
    if (valid_traj[t]) update();
    BILD_PHASE(6);
  }
  BILD_PHASE_END();

  for (int p = tid; p < tp; p += nth) out[traj * P + p0 + p] = llv[p];
}

template <typename scalar_t, int TIER>
int launch_sym(const void* Pops, const void* Srow, const void* sig, const void* c0,
               const void* w, const void* Ballw, const void* Gsw,
               const void* M0w, const void* s2, const void* Cind,
               const void* profiles, const void* ydata, const void* valid,
               void* out, int n, int N, int d, int q, int L, int P, int T,
               int PPp, int N1p, int TP, int smem, int device, void* stream) {
  const SymLayout lay = sym_layout<scalar_t>(n, N, d, q, PPp, TP, TIER != 0);
  // the split tiers: every (m-tile, column-tile) product of a pass has a
  // warp slot (at least one m-tile a pass)
  const int max_cols = TIER != 0 ? kThreads / 32 * kItems : kThreads;
  if (TP < 1 || TP > kMaxTile || n < 1 || n > 32 || N < 1 || N > 255 || d > kMaxD ||
      PPp % kBK != 0 || (TIER == 2 && Srow == nullptr) ||
      lay.nct_max > max_cols || lay.bytes != static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(L) * ((P + TP - 1) / TP);
  return bild::launch(
      kalman_sym_kernel<scalar_t, TIER>, blocks, kThreads, lay.bytes, device, stream,
      Pops, static_cast<const float*>(Srow), static_cast<const scalar_t*>(sig),
      static_cast<const scalar_t*>(c0), static_cast<const scalar_t*>(w),
      static_cast<const scalar_t*>(Ballw), static_cast<const scalar_t*>(Gsw),
      static_cast<const scalar_t*>(M0w), static_cast<const scalar_t*>(s2),
      static_cast<const int*>(Cind), static_cast<const int*>(profiles),
      static_cast<const scalar_t*>(ydata),
      static_cast<const unsigned char*>(valid), static_cast<scalar_t*>(out),
      n, N, d, q, P, T, PPp, N1p, TP);
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

// exact tier: the propagators in slab order (ops/kalman_sym.py::slab_operators)
extern "C" int bild_kalman_sym_f32(const void* Pslab, BILD_SYM_ARGS) {
  return launch_sym<float, 0>(Pslab, nullptr, BILD_SYM_PASS);
}
extern "C" int bild_kalman_sym_f64(const void* Pslab, BILD_SYM_ARGS) {
  return launch_sym<double, 0>(Pslab, nullptr, BILD_SYM_PASS);
}
// split tiers, float32: the propagators' A fragments
// (ops/kalman_sym.py::split_fragments) and U1's S row
extern "C" int bild_kalman_sym_splitcov_f32(const void* Psplit, const void* Srow,
                                            BILD_SYM_ARGS) {
  return launch_sym<float, 1>(Psplit, Srow, BILD_SYM_PASS);
}
extern "C" int bild_kalman_sym_split_f32(const void* Psplit, const void* Srow,
                                         BILD_SYM_ARGS) {
  return launch_sym<float, 2>(Psplit, Srow, BILD_SYM_PASS);
}
