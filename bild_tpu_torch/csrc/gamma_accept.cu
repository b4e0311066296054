// The rejection loop of the Gamma sampler on per-lane counter-based
// streams: every entry draws round after round from its own stream until
// its first acceptance.
//
// Replaces the rounds of amis/dirichlet.py::_gamma_accept (the plain
// version, which the CPU runs): there every round draws for all entries
// and the host asks the device after each round whether any entry is left.
// bild_tpu draws with jax.random.gamma, whose rejection loop is a device
// `while_loop` inside XLA (bild_tpu/amis/dirichlet.py:27). A round cannot
// be cut to a fixed count: in float32 the test below cancels for large
// shapes (d >= 1e8, as a degenerate proposal's concentration gives) and
// accepts about half the draws per round, so an entry may need tens of
// rounds where most need one. Here each entry stops on its own; an entry
// still unaccepted after `max_rounds` (never, short of a NaN shape) sets
// the exhaustion flag, which the caller reads once after its steps.
//
// Marsaglia & Tsang (2000), with d = a - 1/3 and c = 1/sqrt(9d) from the
// caller. Round r of entry i of lane l:
//   x = sqrt(-2 log u1) cos(2 pi u2),   u1, u2 from the streams folded by
//       (2r, 0) and (2r, 1); u from the stream folded by 2r + 1;
//   v = (1 + c x)^3, accept d v when v > 0 and
//       log u < 0.5 x x + d - d v + d log v.
// A stream folded by tag t has key mix64(key ^ mix64(t + FOLD)), and its
// element i the bits mix64(key' + (i + 1) GOLDEN); a uniform keeps the top
// 24 (float32) or 53 (float64) bits, (b + 0.5) 2^-bits (lanes.py).
//
// Bits. Every operation is the one PyTorch's elementwise kernels apply to
// the whole tensor in the plain version, in the same order and type, with
// products and sums rounded one by one (never contracted into an FMA), so
// an entry gets the plain version's value: the first round that accepts
// it, the same draw. Which thread draws an entry changes nothing.
//
// What bounds it on the H100: instruction issue, and a launch's fixed
// latency of a few microseconds. A round of an entry costs three uniforms'
// hashes (a mix64 each: two 64-bit products, three shifts and three xors,
// some 18 32-bit integer instructions) and three logs, a cos and a sqrt,
// each a routine of tens of instructions that the bits require as they are
// (PyTorch's); the bytes (d, c, the result) are a few MB at the lockstep
// step (640 lanes x 128 proposals x 5 slots). What the design does about
// it:
//  - The stream words of a round, fold(fold(key, 2r), 0), fold(fold(key,
//    2r), 1) and fold(key, 2r + 1), are the lane's alone: eight of a
//    round's eleven mix64. A block serves one contiguous range of one
//    lane's entries (amis/dirichlet.py::gamma_plan), computes those words
//    of rounds 0 .. kHoisted - 1 once, into shared memory, and an entry's
//    round then hashes only its three elements. An entry past kHoisted
//    rounds folds its own words, as every round did before.
//  - Rounds are the loop, not entries: a thread whose entry accepts takes
//    the block's next entry from a counter in shared memory, so a warp no
//    longer waits for its slowest entry before its threads draw again (in
//    float32 at d >= 1e8 an entry needs tens of rounds where its
//    neighbours need one or two). The counter lives in shared memory: the
//    kernel is replayed inside CUDA graphs that have no node to reset one
//    in global memory.
//  - No 64-bit division: the lane is the block's, the entry's offset in
//    it comes from the counter. A float32 uniform converts its 24 bits
//    from a 32-bit integer.
#include <math.h>

#include <cooperative_groups.h>

#include "kalman_common.cuh"

namespace {

namespace cg = cooperative_groups;

typedef unsigned long long u64;

constexpr u64 kGolden = 0x9E3779B97F4A7C15ull;
constexpr u64 kFold = 0x632BE59BD9B4E019ull;
// rounds whose stream words a block computes once for its lane
// (amis/dirichlet.py::GAMMA_HOISTED_ROUNDS)
constexpr int kHoisted = 8;

__device__ __forceinline__ u64 mix64(u64 x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// LaneRNG.fold(tag) of one lane's key
__device__ __forceinline__ u64 fold(u64 key, long long tag) {
  return mix64(key ^ mix64(static_cast<u64>(tag) + kFold));
}

// the three stream words of a round: the normal's two, the test's
struct Words {
  u64 u1, u2, u;
};

// the stream words of round r of the lane keyed `key`
__device__ __forceinline__ Words round_words(u64 key, int r) {
  const u64 knorm = fold(key, 2LL * r);
  return Words{fold(knorm, 0), fold(knorm, 1), fold(key, 2LL * r + 1)};
}

template <typename T> struct Draw;
template <> struct Draw<float> {
  static constexpr int bits = 24;
  __device__ static float uniform(u64 b) {
    // the top 24 bits through a 32-bit integer: the same float, exactly
    return __fmul_rn(__fadd_rn(static_cast<float>(static_cast<unsigned>(
                                   b >> (64 - bits))), 0.5f),
                     5.9604644775390625e-08f);                  // 2^-24
  }
  __device__ static float normal(float u1, float u2) {
    return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                     cosf(__fmul_rn(6.2831855f, u2)));          // (float) 2 pi
  }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float log(float a) { return logf(a); }
};
template <> struct Draw<double> {
  static constexpr int bits = 53;
  __device__ static double uniform(u64 b) {
    return __dmul_rn(__dadd_rn(static_cast<double>(b >> (64 - bits)), 0.5),
                     1.1102230246251565e-16);                   // 2^-53
  }
  __device__ static double normal(double u1, double u2) {
    return __dmul_rn(sqrt(__dmul_rn(-2.0, ::log(u1))),
                     cos(__dmul_rn(6.283185307179586, u2)));
  }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double log(double a) { return ::log(a); }
};

// Block b serves entries [k span, min((k + 1) span, per_lane)) of lane
// b / blocks_per_lane, k = b % blocks_per_lane.
template <typename T>
__global__ void __launch_bounds__(256)
gamma_accept_kernel(const T* __restrict__ d, const T* __restrict__ c,
                    const long long* __restrict__ keys, T* __restrict__ out,
                    unsigned char* __restrict__ exhausted, int per_lane,
                    int blocks_per_lane, int span, int max_rounds) {
  using D = Draw<T>;
  __shared__ Words words[kHoisted];
  __shared__ unsigned next;
  const int lane = blockIdx.x / blocks_per_lane;
  const int lo = (blockIdx.x - lane * blocks_per_lane) * span;
  const int hi = min(lo + span, per_lane);
  const u64 key = static_cast<u64>(keys[lane]);
  if (threadIdx.x < kHoisted) words[threadIdx.x] = round_words(key, threadIdx.x);
  if (threadIdx.x == 0) next = lo + blockDim.x;
  __syncthreads();

  const long long base = static_cast<long long>(lane) * per_lane;
  int i = lo + threadIdx.x;          // the thread's entry, in its lane
  int r = 0;                         // its round
  T de = T(0), ce = T(0);
  u64 step = 0;
  if (i < hi) {
    de = d[base + i];
    ce = c[base + i];
    step = static_cast<u64>(i + 1) * kGolden;
  }
  while (i < hi) {
    const Words w = r < kHoisted ? words[r] : round_words(key, r);
    const T u1 = D::uniform(mix64(w.u1 + step));
    const T u2 = D::uniform(mix64(w.u2 + step));
    const T u = D::uniform(mix64(w.u + step));
    const T x = D::normal(u1, u2);
    const T b = D::add(T(1), D::mul(ce, x));
    const T v = D::mul(D::mul(b, b), b);
    const bool pos = v > T(0);
    const T logv = D::log(pos ? v : T(1));
    const T rhs = D::add(D::sub(D::add(D::mul(D::mul(T(0.5), x), x), de),
                                D::mul(de, v)),
                         D::mul(de, logv));
    const bool accept = pos && D::log(u) < rhs;
    if (accept || r + 1 == max_rounds) {
      out[base + i] = accept ? D::mul(de, v) : T(0);
      if (!accept) *exhausted = 1;
      // the threads finishing together take the next entries at once
      const cg::coalesced_group g = cg::coalesced_threads();
      unsigned first = 0;
      if (g.thread_rank() == 0) first = atomicAdd(&next, g.size());
      i = static_cast<int>(g.shfl(first, 0) + g.thread_rank());
      r = 0;
      if (i < hi) {
        de = d[base + i];
        ce = c[base + i];
        step = static_cast<u64>(i + 1) * kGolden;
      }
    } else {
      ++r;
    }
  }
}

// The plan must be amis/dirichlet.py::gamma_plan's: every block's range
// non-empty, the ranges covering the lane.
template <typename T>
int launch_gamma(const void* d, const void* c, const void* keys, void* out,
                 void* exhausted, int L, int per_lane, int blocks_per_lane,
                 int span, int threads, int max_rounds, int device,
                 void* stream) {
  if (L < 0 || per_lane < 1 || blocks_per_lane < 1 || span < 1 ||
      max_rounds < 1 || threads < kHoisted || threads > 256 || threads % 32 ||
      static_cast<long long>(blocks_per_lane) * span < per_lane ||
      static_cast<long long>(blocks_per_lane - 1) * span >= per_lane ||
      static_cast<long long>(per_lane) + threads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  return bild::launch(gamma_accept_kernel<T>,
                      static_cast<long long>(L) * blocks_per_lane, threads, 0,
                      device, stream, static_cast<const T*>(d),
                      static_cast<const T*>(c),
                      static_cast<const long long*>(keys), static_cast<T*>(out),
                      static_cast<unsigned char*>(exhausted), per_lane,
                      blocks_per_lane, span, max_rounds);
}

}  // namespace

// d, c, out (L, per_lane) contiguous; keys (L,) int64; exhausted one byte
// (set to 1 where an entry is left, never cleared); blocks_per_lane, span
// and threads from gamma_plan
#define BILD_GAMMA_ENTRY(NAME, TYPE)                                            \
  extern "C" int NAME(const void* d, const void* c, const void* keys,           \
                      void* out, void* exhausted, int L, int per_lane,          \
                      int blocks_per_lane, int span, int threads,               \
                      int max_rounds, int device, void* stream) {               \
    return launch_gamma<TYPE>(d, c, keys, out, exhausted, L, per_lane,          \
                              blocks_per_lane, span, threads, max_rounds,       \
                              device, stream);                                  \
  }

BILD_GAMMA_ENTRY(bild_gamma_accept_f32, float)
BILD_GAMMA_ENTRY(bild_gamma_accept_f64, double)
