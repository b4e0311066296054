// The split-bf16 tiers of the packed-symmetric Rouse-Kalman log-likelihood
// ('split_cov' and 'split', float32 only): one block per tile of up to 32
// profiles of one lane, as the exact tier (kalman_sym.cu, whose header
// gives the recursion and the packed operators).
//
// Replaces the Pallas kernel bild_tpu/ops/kalman_sym.py::_kernel under its
// static flags split_bf16 and split_update (kalman_sym.py:222-242). Each
// operand of a split product becomes a bfloat16 pair, hi = bf16(x), lo =
// bf16(x - hi) (round to nearest even), and A B ~ Ahi Bhi + Ahi Blo + Alo
// Bhi with float32 sums. TIER 1 ('split_cov') splits the conjugation c' =
// P_s c + sig_s; TIER 2 ('split') also the update contraction (Cw and S =
// u.c, u the S row of the reference's U1) and the mean propagation Ballw M.
//
// What bounds it on the H100, at the lockstep launch (L=640 lanes x 128
// profiles, T=100, N=20 so PP=210 padded to 224, n=2, tiles of 32), all
// computed:
// - tensor-core work: per block-frame and present state, three bf16
//   products of the 256 x 224 operator (4 m-blocks of 64 rows) by the
//   state's columns (n = 8 per column tile); 2.8 TFLOP per call at 32
//   columns a tile, 2.8 ms at 989 TFLOP/s. The likelihood's least work
//   in this tier takes 1.09 ms (chip_smoke.py::split_bound_ms).
// - L2 -> SM bytes: every block streams every present state's hi and lo
//   operator once per frame, 224 x 224 x 4 = 200,704 B: 102 GB per call
//   (2,560 blocks x 99 frames x 2 states). All blocks read the same 401 KB,
//   so these are L2 hits; at the 3-4 TB/s that the ring reaches they take
//   25-35 ms, the floor of this design.
// - shared memory per block: 113,440 B ('split_cov'), 115,168 B ('split')
//   with a 3-stage ring, two blocks per SM, at 96 registers a thread
//   (split_layout below, mirrored by ops/kalman_sym.py::sym_smem_bytes;
//   the launch refuses a mismatch). Blocks of one profile (a single
//   trajectory's step, one block per SM) take a 16-stage ring.
//
// The design. The block is two consumer warpgroups (256 threads: the
// frame's SIMT work, and the conjugation on wgmma) and one producer warp.
// - Operators: the host stores P_s's hi and lo in the order they are
//   streamed (ops/kalman_sym.py::split_stages): per state, per m-block of
//   64 rows, per stage of kDepth operator columns, the hi then the lo tile,
//   each in wgmma's canonical K-major layout without swizzle (8 x 16-byte
//   core matrices, each 128 contiguous bytes: no bank conflict). Rows past
//   the last m-block's are not stored: wgmma reads stale ring bytes there,
//   which only feed output rows that are discarded.
// - The ring: S stages of one (m-block, kDepth-deep) hi and lo tile pair,
//   S the deepest that the block's shared memory allows (at least 3: each
//   warpgroup holds one stage while it waits for the next). The producer
//   warp's lane 0 runs the whole launch's stream ahead, across frames (it
//   finds each frame's present states with its own warp ballot), with two
//   bulk copies per stage completing on the stage's full mbarrier; it
//   waits on the stage's empty mbarrier, where the 128 threads of the
//   consuming warpgroup arrive once their wgmma has read it. No block
//   barrier inside the conjugation: one mbarrier wait per stage.
// - Per frame the consumers sort their columns by state into tiles of 8
//   (a warp ballot per state), split every column's covariance into bf16
//   pairs written straight into the canonical K-major layout of wgmma's B
//   (one 16-byte store per 8 slots, columns in tile order), and issue per
//   stage three m64nNk16 products (N = 8 x the state's tiles, a template
//   constant, so no product lies on a divergent path) into one float32
//   accumulator; warpgroup w owns m-blocks w and w + 2 and keeps one wgmma
//   group in flight. The epilogue adds sig_s and writes the float32
//   covariance back in place (the split copy is what the products read).
// - The update contraction runs over the nonzero entries of w and of
//   U1's S row only (2 of 20 and 3 of 210 for the Rouse model's
//   end-to-end distance; the skipped terms are exact zeros). 'split'
//   splits w, the S row and Ballw once at the start (packed pairs in
//   shared memory) and its mean propagation Ballw M runs on the tensor
//   cores, three mma.m16n8k16 products per tile, M split as it is loaded.
// - Not kept (PERF.md, section 6): a cluster of two blocks sharing each stage
//   through a multicast copy halves the L2 bytes, but with three stages
//   each slot then waits for the slower block and a remote arrival
//   (slower by 1.8x); 112 registers a thread leave one block per SM.
//
// A profile's result does not depend on its partners: every output of a
// product is its own row and column's dot product over the same k-steps in
// the same order whatever the tile's other columns, the downdate's products
// are rounded explicitly, and every other step is per profile. Rows and
// depth padded to whole stages are exact zeros (the host pads P_s, and the
// covariance slots past PP are zero and never written).
#include <cuda_bf16.h>
#include <stdint.h>

#include "kalman_common.cuh"

// Phase marks of the frame loop: empty here; tools/profile_kernels.py
// builds a copy that defines them to sum thread 0's clock64() cycles per
// phase (mark k ends phase k).
#ifndef BILD_PHASE
#define BILD_PHASE_START()
#define BILD_PHASE(k)
#define BILD_PHASE_END()
#endif

// chip_smoke.py builds a copy with BILD_SPLIT_PROBE defined: block 0 then
// writes what frame 1's update contraction and mean propagation read and
// wrote, to the buffer given here: the predicted covariance c (ncol x PP),
// Cw (ncol x N), 1/S (ncol), the means before and after the propagation
// (tp x (N+1) x d each).
#ifdef BILD_SPLIT_PROBE
__device__ float* g_split_probe;
extern "C" int bild_split_probe_set(float* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_split_probe, &buf, sizeof(buf)));
}
#endif

namespace {

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMinStages = 3;  // ring stages at least: each warpgroup holds one while it waits
constexpr int kDepth = 32;                 // operator columns (k) per stage
constexpr int kMB = 64;                    // operator rows per m-block (wgmma's m)
constexpr int kStageBytes = kMB * kDepth * 2 * 2;  // a hi and a lo tile
constexpr int kMaxTile = 32;  // profiles per block: one ballot per state
constexpr int kMaxCols = 32;  // columns per block, so per state (wgmma n <= 32)
constexpr int kMaxD = 4;      // spatial dimensions

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
// d += A B for one 16 x 8 tile: A (16 x 16, row) four words of bf16 pairs,
// B (16 x 8, col) two words, d four floats (rows g, g+8 x columns 2t, 2t+1
// of lane 4g + t)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}
// a constant's pair in one word: hi's bits in the high half, lo's in the low
__device__ __forceinline__ unsigned pack_pair(float x) {
  float hi, lo;
  split1(x, hi, lo);
  return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);
}
__device__ __forceinline__ void unpack_pair(unsigned u, float& hi, float& lo) {
  hi = __uint_as_float(u & 0xffff0000u);
  lo = __uint_as_float(u << 16);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
__device__ __forceinline__ void mbar_init_count(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bild::smem_addr(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bild::smem_addr(bar))
               : "memory");
}
// generic-proxy writes of shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor, no swizzle: lbo the byte
// offset between core matrices adjacent in k, sbo between 8-row groups
__device__ __forceinline__ uint64_t gmma_desc(const void* p, unsigned lbo, unsigned sbo) {
  const uint64_t a = bild::smem_addr(p);
  return ((a & 0x3FFFFu) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}
// keeps the compiler from moving accumulator reads above the wait that
// completes their products (never used while a product is in flight: the
// compiler would then serialize the products)
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 8 NT, float32) += A (64 x 16, bf16, K-major) B (16 x 8 NT, bf16,
// K-major), or d = A B where acc is 0. Thread 32 v + 4 g + t of the
// warpgroup holds rows 16 v + g and 16 v + g + 8 at columns 8 j + 2 t,
// 8 j + 2 t + 1 in d[4 j .. 4 j + 3].
__device__ __forceinline__ void gmma_n8(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void gmma_n16(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void gmma_n24(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void gmma_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}
// n = 8 NT columns
template <int NT>
__device__ __forceinline__ void gmma(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  if constexpr (NT == 1) gmma_n8(d, a, b, acc);
  else if constexpr (NT == 2) gmma_n16(d, a, b, acc);
  else if constexpr (NT == 3) gmma_n24(d, a, b, acc);
  else gmma_n32(d, a, b, acc);
}
template <int V>
struct IntC {
  static constexpr int value = V;
};

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

struct SplitLayout {
  int ld;       // float32 covariance column stride (scalars)
  int nct_max;  // column tiles of 8, at most
  size_t ring, c, B, M, Mn, R, Sinv, ll, Bw, Gw, w, s2, y, ab, u, nz, Cind, list, tstate,
      pstate, misc, bar, bytes;
};

// Byte offsets of the block's shared memory; mirrored by
// ops/kalman_sym.py::sym_smem_bytes.
__host__ __device__ inline SplitLayout split_layout(int n, int N, int d, int q, int PPp,
                                                    int TP, int tier, int S) {
  SplitLayout s;
  const int ncol = TP * q;
  const int KP = (PPp + kDepth - 1) / kDepth * kDepth;
  s.ld = KP + (36 - KP % 32) % 32;  // 4 modulo 32: the split's loads meet 32 banks
  s.nct_max = (ncol + 7 * n) / 8;     // sum over states of ceil(columns / 8)
  size_t o = 0;
  s.ring = o;   o += static_cast<size_t>(S) * kStageBytes;
  s.c = o;      o += align16(4 * static_cast<size_t>(ncol) * s.ld);
  s.B = o;      o += align16(static_cast<size_t>(8 * s.nct_max) * KP * 2 * 2);
  s.M = o;      o += align16(4 * static_cast<size_t>(TP) * (N + 1) * d);
  s.Mn = o;     o += align16(4 * static_cast<size_t>(TP) * (N + 1) * d);
  s.R = o;      o += align16(4 * static_cast<size_t>(ncol) * N);
  s.Sinv = o;   o += align16(4 * ncol);
  s.ll = o;     o += align16(4 * TP);
  s.Bw = o;     o += align16(4 * static_cast<size_t>(n) * (N + 1) * N);
  s.Gw = o;     o += align16(4 * static_cast<size_t>(n) * (N + 1) * d);
  s.w = o;      o += align16(4 * N);
  s.s2 = o;     o += align16(4 * q);
  s.y = o;      o += align16(4 * d);
  s.ab = o;     o += align16(2 * (N * (N + 1) / 2));
  s.u = o;      o += tier == 2 ? align16(4 * PPp) : 0;
  s.nz = o;     o += align16(4 * (N + (tier == 2 ? PPp : 0)));
  s.Cind = o;   o += align16(4 * d);
  s.list = o;   o += align16(4 * 8 * s.nct_max);
  s.tstate = o; o += align16(4 * s.nct_max);
  s.pstate = o; o += align16(4 * TP);
  s.misc = o;   o += 16;
  s.bar = o;    o += align16(8 * 2 * S);  // full, then empty, per stage
  s.bytes = o;
  return s;
}

// TIER: 1 split_cov, 2 split. Pops: the operators' hi and lo in stream
// order (ops/kalman_sym.py::split_stages); Srow: U1's S row (TIER 2).
template <int TIER>
__global__ void __launch_bounds__(kThreads, 2)
kalman_sym_split_kernel(const unsigned char* __restrict__ Pops,
                        const float* __restrict__ Srow,
                        const float* __restrict__ sig,
                        const float* __restrict__ c0,
                        const float* __restrict__ w_g,
                        const float* __restrict__ Ballw,
                        const float* __restrict__ Gsw,
                        const float* __restrict__ M0w,
                        const float* __restrict__ s2_g,
                        const int* __restrict__ Cind_g,
                        const int* __restrict__ profiles,
                        const float* __restrict__ ydata,
                        const unsigned char* __restrict__ valid,
                        float* __restrict__ out,
                        int n, int N, int d, int q, int P, int T, int PPp, int N1p,
                        int TP, int S) {
  constexpr bool kSplitUpd = TIER == 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const SplitLayout lay = split_layout(n, N, d, q, PPp, TP, TIER, S);
  unsigned char* ring = smem_raw + lay.ring;
  float* c = reinterpret_cast<float*>(smem_raw + lay.c);     // (ncol, ld), float32
  unsigned char* Bhi = smem_raw + lay.B;                      // the columns' pairs
  float* M = reinterpret_cast<float*>(smem_raw + lay.M);     // (TP, N+1, d)
  float* Mn = reinterpret_cast<float*>(smem_raw + lay.Mn);
  float* R = reinterpret_cast<float*>(smem_raw + lay.R);     // (ncol, N): Cw
  float* Sinv = reinterpret_cast<float*>(smem_raw + lay.Sinv);
  float* llv = reinterpret_cast<float*>(smem_raw + lay.ll);
  // TIER 1: Ballw and w as floats; TIER 2: as packed pairs (pack_pair)
  float* Bw = reinterpret_cast<float*>(smem_raw + lay.Bw);   // (n, N+1, N)
  unsigned* Bwp = reinterpret_cast<unsigned*>(smem_raw + lay.Bw);
  float* Gw = reinterpret_cast<float*>(smem_raw + lay.Gw);   // (n, N+1, d)
  float* w = reinterpret_cast<float*>(smem_raw + lay.w);
  unsigned* wp = reinterpret_cast<unsigned*>(smem_raw + lay.w);
  float* s2 = reinterpret_cast<float*>(smem_raw + lay.s2);
  float* yt = reinterpret_cast<float*>(smem_raw + lay.y);
  // TIER 2: the pairs of the S row's nonzero entries, in order
  unsigned* up = reinterpret_cast<unsigned*>(smem_raw + lay.u);
  int* wnz = reinterpret_cast<int*>(smem_raw + lay.nz);  // nonzero entries of w
  int* unz = wnz + N;                                     // and of the S row (TIER 2)
  unsigned short* ab = reinterpret_cast<unsigned short*>(smem_raw + lay.ab);
  int* Cind = reinterpret_cast<int*>(smem_raw + lay.Cind);
  int* list = reinterpret_cast<int*>(smem_raw + lay.list);      // column of each slot
  int* tstate = reinterpret_cast<int*>(smem_raw + lay.tstate);  // state of each tile
  int* pstate = reinterpret_cast<int*>(smem_raw + lay.pstate);
  // tiles and present states of the frame; nonzero entries of w and u
  int* misc = reinterpret_cast<int*>(smem_raw + lay.misc);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_raw + lay.bar);
  unsigned long long* empty = full + S;

  const int tid = threadIdx.x;
  const int PP = N * (N + 1) / 2;
  const int N1 = N + 1;
  const int ld = lay.ld;
  const int KP = (PPp + kDepth - 1) / kDepth * kDepth;  // rows and depth, padded
  const int KGB = KP / 8;                // core matrices of 8 k per column group
  const int MB = (KP + kMB - 1) / kMB;   // m-blocks
  const int KC = KP / kDepth;            // stages per m-block
  const int tiles_per_lane = (P + TP - 1) / TP;
  const size_t traj = blockIdx.x / tiles_per_lane;
  const int p0 = static_cast<int>(blockIdx.x % tiles_per_lane) * TP;
  const int tp = min(TP, P - p0);
  const int ncol = tp * q;
  const int* prof = profiles + (traj * P + p0) * static_cast<size_t>(T);
  const float* y_traj = ydata + traj * T * d;
  const unsigned char* valid_traj = valid + traj * T;
  unsigned char* Blo = Bhi + static_cast<size_t>(8 * lay.nct_max) * KP * 2;

  for (int i = tid; i < ncol * ld; i += kThreads) {
    const int col = i / ld, k = i % ld;
    const int s0 = bild::clamp_state(prof[static_cast<size_t>(col / q) * T], n);
    c[i] = k < PPp ? c0[static_cast<size_t>(s0) * PPp + k] : 0.f;
  }
  for (int i = tid; i < tp * N1 * d; i += kThreads) {
    const int p = i / (N1 * d);
    const int s0 = bild::clamp_state(prof[static_cast<size_t>(p) * T], n);
    M[i] = M0w[static_cast<size_t>(s0) * N1p * d + i % (N1 * d)];
  }
  for (int p = tid; p < tp; p += kThreads) llv[p] = 0;
  for (int a = tid; a < N; a += kThreads)
    for (int b = a; b < N; ++b)
      ab[a * N - a * (a - 1) / 2 + (b - a)] = static_cast<unsigned short>(a | (b << 8));
  for (int i = tid; i < n * N1 * N; i += kThreads) {
    const float v = Ballw[(static_cast<size_t>(i / (N1 * N)) * N1p) * N + i % (N1 * N)];
    if (kSplitUpd) Bwp[i] = pack_pair(v); else Bw[i] = v;
  }
  for (int i = tid; i < n * N1 * d; i += kThreads)
    Gw[i] = Gsw[(static_cast<size_t>(i / (N1 * d)) * N1p) * d + i % (N1 * d)];
  for (int i = tid; i < N; i += kThreads) {
    if (kSplitUpd) wp[i] = pack_pair(w_g[i]); else w[i] = w_g[i];
  }
  for (int i = tid; i < q; i += kThreads) s2[i] = s2_g[i];
  for (int i = tid; i < d; i += kThreads) Cind[i] = Cind_g[i];
  if (tid < 64) {  // warp 0: w's nonzero entries; warp 1: the S row's (TIER 2)
    const bool wrow = tid < 32;
    const int lane = tid & 31, len = wrow ? N : (kSplitUpd ? PPp : 0);
    int cnt = 0;
    for (int base = 0; base < len; base += 32) {
      const int k = base + lane;
      const float v = k < len ? (wrow ? w_g[k] : Srow[k]) : 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, v != 0.f);
      if (v != 0.f) {
        const int j = cnt + __popc(m & ((1u << lane) - 1u));
        if (wrow) {
          wnz[j] = k;
        } else {
          unz[j] = k;
          up[j] = pack_pair(v);
        }
      }
      cnt += __popc(m);
    }
    if (lane == 0) misc[wrow ? 2 : 3] = cnt;
  }
  if (tid == 0) {
    for (int j = 0; j < S; ++j) {
      mbar_init_count(&full[j], 1);
      mbar_init_count(&empty[j], 128);  // the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  if (tid >= kConsumers) {
    // The producer warp: the launch's whole operator stream, stage after
    // stage, each into the ring slot its consumer released. The order is
    // the consumers': per frame, per present state, per pair of m-blocks
    // (warpgroup w takes m-block 2 p + w), per stage depth, per warpgroup.
    const int lane = tid & 31;
    unsigned seq = 0;
    for (int t = 1; t < T; ++t) {
      const int st = lane < tp ? bild::clamp_state(prof[static_cast<size_t>(lane) * T + t], n)
                               : -1;
      unsigned present = 0;
      for (int s = 0; s < n; ++s)
        if (__ballot_sync(0xffffffffu, st == s)) present |= 1u << s;
      if (lane == 0) {
        for (int s = 0; s < n; ++s) {
          if (!((present >> s) & 1u)) continue;
          for (int pr = 0; pr < (MB + 1) / 2; ++pr)
            for (int kc = 0; kc < KC; ++kc)
              for (int wg = 0; wg < 2; ++wg) {
                const int mb = 2 * pr + wg;
                if (mb >= MB) continue;
                const int slot = seq % S;
                bild::mbar_wait(&empty[slot], ((seq / S) & 1u) ^ 1u);
                ++seq;
                const int rows = min(kMB, KP - kMB * mb);
                const unsigned bytes = rows * kDepth * 2;
                const unsigned char* src =
                    Pops + (static_cast<size_t>(s) * KP * KP + static_cast<size_t>(kMB) * mb * KP +
                            static_cast<size_t>(rows) * kDepth * kc) * 4;
                unsigned char* dst = ring + static_cast<size_t>(slot) * kStageBytes;
                bild::mbar_arrive_expect(&full[slot], 2 * bytes);
                bild::bulk_copy(dst, src, bytes, &full[slot]);
                bild::bulk_copy(dst + kStageBytes / 2, src + bytes, bytes, &full[slot]);
              }
        }
      }
      __syncwarp();
    }
    return;
  }

  BILD_PHASE_START();
  const int wg = tid / 128, wv = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  unsigned cseq = 0;  // the ring's stage count, as the producer's
  // Cw and S of frame t's update (c holds the predicted covariance). The
  // sums run over the nonzero entries of w and of U1's S row only (wnz,
  // unz; for the Rouse model's end-to-end distance 2 of N and 3 of PP):
  // the terms skipped are exact zeros, so every sum keeps its bits.
  auto packed = [N](int a, int b) {  // index of entry (a, b) of the packed triangle
    const int i = min(a, b), j = max(a, b);
    return i * N - i * (i - 1) / 2 + (j - i);
  };
  auto contract = [&]() {
    const int nw = misc[2];
    if constexpr (kSplitUpd) {
      // Cw[col, a] = sum_b w_b C_ab and S = u.c, each product split (U1's
      // Cw rows hold the float32 w_b, its S row u), the three parts summed
      // apart
      for (int item = tid; item < ncol * N; item += kConsumers) {
        const int col = item / N, a = item % N;
        const float* cc = c + static_cast<size_t>(col) * ld;
        float hh = 0, hl = 0, lh = 0;
        for (int j = 0; j < nw; ++j) {
          const int b = wnz[j];
          float wh, wl, xh, xl;
          unpack_pair(wp[b], wh, wl);
          split1(cc[packed(a, b)], xh, xl);
          hh = fmaf(wh, xh, hh);
          hl = fmaf(wh, xl, hl);
          lh = fmaf(wl, xh, lh);
        }
        R[col * N + a] = (hh + hl) + lh;
      }
      const int nu = misc[3];
      for (int col = tid; col < ncol; col += kConsumers) {
        const float* cc = c + static_cast<size_t>(col) * ld;
        float hh = 0, hl = 0, lh = 0;
        for (int j = 0; j < nu; ++j) {
          float uh, ul, xh, xl;
          unpack_pair(up[j], uh, ul);
          split1(cc[unz[j]], xh, xl);
          hh = fmaf(uh, xh, hh);
          hl = fmaf(uh, xl, hl);
          lh = fmaf(ul, xh, lh);
        }
        Sinv[col] = 1.f / (((hh + hl) + lh) + s2[col % q]);
      }
      consumer_sync();
    } else {
      // Cw[col, a] = sum_b C_ab w_b: the entries (b, a), b < a, then (a, b),
      // b >= a, each part one chain in b's order
      for (int item = tid; item < ncol * N; item += kConsumers) {
        const int col = item / N, a = item % N;
        const float* cc = c + static_cast<size_t>(col) * ld;
        float lower = 0, upper = 0;
        for (int j = 0; j < nw; ++j) {
          const int b = wnz[j];
          if (b < a) lower = fmaf(cc[packed(a, b)], w[b], lower);
          else upper = fmaf(cc[packed(a, b)], w[b], upper);
        }
        R[col * N + a] = lower + upper;
      }
      consumer_sync();
      for (int col = tid; col < ncol; col += kConsumers) {  // S = w.Cw + s2
        float acc = 0;
        for (int j = 0; j < nw; ++j) acc = fmaf(R[col * N + wnz[j]], w[wnz[j]], acc);
        Sinv[col] = 1.f / (acc + s2[col % q]);
      }
      consumer_sync();
    }
  };

  // the measurement update of frame t (whose data yt holds)
  auto update = [&](int t) {
#ifdef BILD_SPLIT_PROBE
    if (t == 1 && blockIdx.x == 0)
      for (int i = tid; i < ncol * PP; i += kConsumers)
        g_split_probe[i] = c[static_cast<size_t>(i / PP) * ld + i % PP];
#endif
    contract();
    BILD_PHASE(5);
#ifdef BILD_SPLIT_PROBE
    if (t == 1 && blockIdx.x == 0) {
      float* pr = g_split_probe + ncol * PP;
      for (int i = tid; i < ncol * N; i += kConsumers) pr[i] = R[i];
      for (int i = tid; i < ncol; i += kConsumers) pr[ncol * N + i] = Sinv[i];
    }
#endif
    for (int k = tid; k < PP; k += kConsumers) {  // c[(a,b)] -= (Cw_a Cw_b) Sinv
      const int a = ab[k] & 0xff, b = ab[k] >> 8;
      auto down = [&](int col) {
        return bild::mul_rn(bild::mul_rn(R[col * N + a], R[col * N + b]), Sinv[col]);
      };
      int col = 0;
      for (; col + 4 <= ncol; col += 4) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = down(col + u);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float* cc = c + static_cast<size_t>(col + u) * ld + k;
          *cc = bild::sub_rn(*cc, v[u]);
        }
      }
      for (; col < ncol; ++col) {
        float* cc = c + static_cast<size_t>(col) * ld + k;
        *cc = bild::sub_rn(*cc, down(col));
      }
    }
    for (int item = tid; item < tp * N; item += kConsumers) {  // M += K[Cind] (y - w.M)
      const int p = item / N, i = item % N;
      float* Mp = M + p * N1 * d;
#pragma unroll
      for (int dd = 0; dd < kMaxD; ++dd) {
        if (dd < d) {
          const int col = p * q + Cind[dd];
          Mp[i * d + dd] += (R[col * N + i] * Sinv[col]) * (yt[dd] - Mp[N * d + dd]);
        }
      }
    }
    for (int p = tid; p < tp; p += kConsumers) {
      float ll = llv[p];
      for (int dd = 0; dd < d; ++dd) {
        const float Sv = Sinv[p * q + Cind[dd]];
        const float xmm = yt[dd] - M[p * N1 * d + N * d + dd];
        ll -= 0.5f * (xmm * xmm * Sv - bild::dlog(Sv) + static_cast<float>(bild::kLog2Pi));
      }
      llv[p] = ll;
    }
    consumer_sync();
  };

  // Sort this frame's columns by state into slots list[8 tiles_before_s
  // ...], padded with -1 to whole tiles of 8. Warp 0 does it, with the
  // frame's states and data loaded one frame ahead.
  int st_next = -1;
  float y_next = 0;
  auto prefetch = [&](int t) {
    if (tid < 32 && t < T) {
      if (tid < tp) st_next = bild::clamp_state(prof[static_cast<size_t>(tid) * T + t], n);
      if (tid < d) y_next = y_traj[static_cast<size_t>(t) * d + tid];
    }
  };
  auto partition = [&](int t) {
    if (tid < 32) {
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
        const int base = nct * 8;
        if (st == s) {
          const int rank = __popc(m & ((1u << lane) - 1u));
          for (int qi = 0; qi < q; ++qi) list[base + rank * q + qi] = lane * q + qi;
        }
        const int cols = cnt * q, tiles = (cols + 7) / 8;
        for (int j = cols + lane; j < tiles * 8; j += 32) list[base + j] = -1;
        for (int j = lane; j < tiles; j += 32) tstate[nct + j] = s;
        nct += tiles;
        present |= 1u << s;
      }
      if (lane == 0) {
        misc[0] = nct;
        misc[1] = static_cast<int>(present);
      }
    }
    consumer_sync();
  };

  // Every slot's covariance as bf16 pairs in wgmma's K-major core matrices
  // (8 slots x 8 k, 128 contiguous bytes): slot 8 cg + i, k-group kg at byte
  // (cg KGB + kg) 128 + 16 i, hi and lo apart; padding slots are zeros.
  auto split_columns = [&]() {
    const int nct = misc[0];
    for (int it = tid; it < nct * 8 * KGB; it += kConsumers) {
      const int i = it % 8, kg = (it / 8) % KGB, cg = it / (8 * KGB);
      const int col = list[cg * 8 + i];
      uint4 hv = make_uint4(0, 0, 0, 0), lv = make_uint4(0, 0, 0, 0);
      if (col >= 0) {
        const float* src = c + static_cast<size_t>(col) * ld + kg * 8;
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        split2(a.x, a.y, hv.x, lv.x);
        split2(a.z, a.w, hv.y, lv.y);
        split2(b.x, b.y, hv.z, lv.z);
        split2(b.z, b.w, hv.w, lv.w);
      }
      const size_t off = (static_cast<size_t>(cg) * KGB + kg) * 128 + i * 16;
      *reinterpret_cast<uint4*>(Bhi + off) = hv;
      *reinterpret_cast<uint4*>(Blo + off) = lv;
    }
    fence_proxy_async();
  };

  // Mn[p] = Ballw_s M[p] + Gsw_s, s the profile's state
  auto propagate_means = [&]() {
    if constexpr (kSplitUpd) {
      // each product split, as the reference's Ballw M, on the tensor
      // cores: per 16 x 8 tile of (Ballw rows, (profile, dimension)
      // columns) and 16-deep step three mma.m16n8k16 products, each kind
      // in its own float32 accumulator, summed as (hh + hl) + lh. A warp
      // takes a tile of one state for every column, and keeps the columns
      // whose profile is in that state. A (Ballw_s) comes from the packed
      // pairs, B (M) is split as it is loaded.
      const unsigned present = static_cast<unsigned>(misc[1]);
      const int MT = (N1 + 15) / 16, KS = (N + 15) / 16, NT = (tp * d + 7) / 8;
      for (int item = tid / 32; item < n * MT * NT; item += kConsumers / 32) {
        const int s = item / (MT * NT), mt = (item / NT) % MT, nt = item % NT;
        if (!((present >> s) & 1u)) continue;
        const int pB = (nt * 8 + g) / d, dB = (nt * 8 + g) % d;  // this lane's B column
        float hh[4] = {}, hl[4] = {}, lh[4] = {};
        for (int ks = 0; ks < KS; ++ks) {
          uint4 ah, al;  // rows g, g + 8 at depths 2 t4, 2 t4 + 1 (+ 8)
          unsigned* hw = &ah.x;
          unsigned* lw = &al.x;
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int r = 16 * mt + g + 8 * (h & 1), k = 16 * ks + 2 * t4 + 8 * (h >> 1);
            const unsigned* row = Bwp + (s * N1 + r) * N;
            const unsigned u0 = r < N1 && k < N ? row[k] : 0u;
            const unsigned u1 = r < N1 && k + 1 < N ? row[k + 1] : 0u;
            hw[h] = __byte_perm(u0, u1, 0x7632);
            lw[h] = __byte_perm(u0, u1, 0x5410);
          }
          unsigned bh[2], bl[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 16 * ks + 2 * t4 + 8 * h;
            const float* Mp = M + (pB * N1 + k) * d + dB;
            const float x0 = pB < tp && k < N ? Mp[0] : 0.f;
            const float x1 = pB < tp && k + 1 < N ? Mp[d] : 0.f;
            split2(x0, x1, bh[h], bl[h]);
          }
          mma_bf16(hh, ah, bh[0], bh[1]);
          mma_bf16(hl, ah, bl[0], bl[1]);
          mma_bf16(lh, al, bh[0], bh[1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * mt + g + 8 * (e >> 1), col = nt * 8 + 2 * t4 + (e & 1);
          const int p = col / d, dd = col % d;
          if (r < N1 && p < tp && pstate[p] == s)
            Mn[(p * N1 + r) * d + dd] = ((hh[e] + hl[e]) + lh[e]) + Gw[(s * N1 + r) * d + dd];
        }
      }
    } else {
      for (int item = tid; item < tp * N1; item += kConsumers) {
        const int p = item / N1, row = item % N1, s = pstate[p];
        const float* Bwr = Bw + (s * N1 + row) * N;
        const float* Mp = M + p * N1 * d;
        float acc[kMaxD] = {};
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          const float b = Bwr[k];
#pragma unroll
          for (int dd = 0; dd < kMaxD; ++dd)
            if (dd < d) acc[dd] = fmaf(b, Mp[k * d + dd], acc[dd]);
        }
#pragma unroll
        for (int dd = 0; dd < kMaxD; ++dd)
          if (dd < d) Mn[(p * N1 + row) * d + dd] = acc[dd] + Gw[(s * N1 + row) * d + dd];
      }
    }
  };

  // c[:, col] = P_s c[:, col] + sig_s for the columns of state s (tiles
  // tile0 .. tile0 + NT - 1): per m-block of the warpgroup, the ring's
  // stages into one accumulator (three products per 16-deep step), then
  // the epilogue. NT is a template constant and the warpgroup index is
  // warp-uniform (a shuffle), so no product lies on a divergent path,
  // where the compiler would serialize them.
  const int wgu = __shfl_sync(0xffffffffu, wg, 0);
  auto conj_state = [&](auto ntc, int s, int tile0) {
    constexpr int NT = decltype(ntc)::value;
    const unsigned char* bh0 = Bhi + static_cast<size_t>(tile0) * KGB * 128;
    const unsigned char* bl0 = Blo + static_cast<size_t>(tile0) * KGB * 128;
    float acc[16];  // written by the products only: the first one of an m-block starts it
    for (int pr = 0; pr < (MB + 1) / 2; ++pr) {
      const int mb = 2 * pr + wgu;
      int pend = -1;  // the slot of the stage whose products are in flight
      for (int kc = 0; kc < KC; ++kc) {
        for (int w2 = 0; w2 < 2; ++w2) {
          if (2 * pr + w2 >= MB) continue;
          const unsigned i = cseq++;
          if (w2 != wgu) continue;
          const int slot = i % S;
          bild::mbar_wait(&full[slot], (i / S) & 1u);
          const unsigned char* A = ring + static_cast<size_t>(slot) * kStageBytes;
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < kDepth / 16; ++j) {
            const int kg = (kDepth * kc + 16 * j) / 8;
            const uint64_t ah = gmma_desc(A + 256 * j, 128, kDepth / 8 * 128);
            const uint64_t al = gmma_desc(A + kStageBytes / 2 + 256 * j, 128, kDepth / 8 * 128);
            const uint64_t bh = gmma_desc(bh0 + kg * 128, 128, KGB * 128);
            const uint64_t bl = gmma_desc(bl0 + kg * 128, 128, KGB * 128);
            gmma<NT>(acc, ah, bh, kc + j > 0);
            gmma<NT>(acc, ah, bl, 1);
            gmma<NT>(acc, al, bh, 1);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products have read it
          if (pend >= 0) mbar_arrive(&empty[pend]);
          pend = slot;
        }
      }
      wgmma_wait<0>();
      if (mb >= MB) continue;
      fence_acc(acc);
      mbar_arrive(&empty[pend]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = kMB * mb + 16 * wv + g + 8 * h;
          if (r >= PP) continue;
          const float sg = sig[static_cast<size_t>(s) * PPp + r];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = list[(tile0 + j) * 8 + 2 * t4 + e];
            if (col >= 0) c[static_cast<size_t>(col) * ld + r] = acc[4 * j + 2 * h + e] + sg;
          }
        }
      }
    }
  };
  auto conjugate = [&]() {
    const int nct = misc[0];
    const unsigned present = static_cast<unsigned>(misc[1]);
    int tile0 = 0;
    for (int s = 0; s < n; ++s) {
      if (!((present >> s) & 1u)) continue;
      int nt = 0;
      while (tile0 + nt < nct && tstate[tile0 + nt] == s) ++nt;
      switch (__shfl_sync(0xffffffffu, nt, 0)) {
        case 1: conj_state(IntC<1>{}, s, tile0); break;
        case 2: conj_state(IntC<2>{}, s, tile0); break;
        case 3: conj_state(IntC<3>{}, s, tile0); break;
        default: conj_state(IntC<4>{}, s, tile0); break;
      }
      tile0 += nt;
    }
  };

  prefetch(0);
  for (int t = 0; t < T; ++t) {
    if (t == 0) {
      if (tid < d) yt[tid] = y_next;
      prefetch(1);
      consumer_sync();
      BILD_PHASE(1);
    } else {
#ifdef BILD_SPLIT_PROBE
      if (t == 1 && blockIdx.x == 0)
        for (int i = tid; i < tp * N1 * d; i += kConsumers)
          g_split_probe[ncol * (PP + N + 1) + i] = M[i];
#endif
      partition(t);
      BILD_PHASE(0);
      split_columns();
      BILD_PHASE(1);
      propagate_means();
      BILD_PHASE(2);
      consumer_sync();  // the split columns are complete
      conjugate();
      BILD_PHASE(3);
      consumer_sync();  // c and Mn are complete
      BILD_PHASE(4);
      float* tmp = M; M = Mn; Mn = tmp;
#ifdef BILD_SPLIT_PROBE
      if (t == 1 && blockIdx.x == 0)
        for (int i = tid; i < tp * N1 * d; i += kConsumers)
          g_split_probe[ncol * (PP + N + 1) + tp * N1 * d + i] = M[i];
#endif
    }
    if (valid_traj[t]) update(t);
    BILD_PHASE(6);
  }
  BILD_PHASE_END();

  for (int p = tid; p < tp; p += kConsumers) out[traj * P + p0 + p] = llv[p];
}

template <int TIER>
int launch_split(const void* Pops, const void* Srow, const void* sig, const void* c0,
                 const void* w, const void* Ballw, const void* Gsw, const void* M0w,
                 const void* s2, const void* Cind, const void* profiles, const void* ydata,
                 const void* valid, void* out, int n, int N, int d, int q, int L, int P,
                 int T, int PPp, int N1p, int TP, int S, int smem, int device, void* stream) {
  const SplitLayout lay = split_layout(n, N, d, q, PPp, TP, TIER, S);
  if (TP < 1 || TP > kMaxTile || TP * q > kMaxCols || S < kMinStages || n < 1 || n > 32 ||
      N < 1 || N > 255 || d > kMaxD || PPp % 8 != 0 || (TIER == 2 && Srow == nullptr) ||
      lay.bytes != static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(L) * ((P + TP - 1) / TP);
  return bild::launch(
      kalman_sym_split_kernel<TIER>, blocks, kThreads, lay.bytes, device, stream,
      static_cast<const unsigned char*>(Pops), static_cast<const float*>(Srow),
      static_cast<const float*>(sig), static_cast<const float*>(c0),
      static_cast<const float*>(w), static_cast<const float*>(Ballw),
      static_cast<const float*>(Gsw), static_cast<const float*>(M0w),
      static_cast<const float*>(s2), static_cast<const int*>(Cind),
      static_cast<const int*>(profiles), static_cast<const float*>(ydata),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out), n, N, d, q, P, T,
      PPp, N1p, TP, S);
}

}  // namespace

#define BILD_SPLIT_ARGS                                                       \
  const void *Psplit, const void *Srow, const void *sig, const void *c0,      \
      const void *w, const void *Ballw, const void *Gsw, const void *M0w,     \
      const void *s2, const void *Cind, const void *profiles,                 \
      const void *ydata, const void *valid, void *out, int n, int N, int d,   \
      int q, int L, int P, int T, int PPp, int N1p, int TP, int stages,       \
      int smem, int device, void *stream
#define BILD_SPLIT_PASS                                                       \
  Psplit, Srow, sig, c0, w, Ballw, Gsw, M0w, s2, Cind, profiles, ydata,       \
      valid, out, n, N, d, q, L, P, T, PPp, N1p, TP, stages, smem, device,    \
      stream

// float32: the propagators' pairs in stream order
// (ops/kalman_sym.py::split_stages), U1's S row, and the ring's stages
// (ops/kalman_sym.py::sym_plan)
extern "C" int bild_kalman_sym_splitcov_f32(BILD_SPLIT_ARGS) {
  return launch_split<1>(BILD_SPLIT_PASS);
}
extern "C" int bild_kalman_sym_split_f32(BILD_SPLIT_ARGS) {
  return launch_split<2>(BILD_SPLIT_PASS);
}
