// The rejection loop of the Gamma sampler on per-lane counter-based
// streams: one thread per entry, each drawing round after round from its
// own stream until its first acceptance.
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
// it, the same draw.
//
// What bounds it on the H100: the entries' transcendental chains (two
// logs, a cos and a sqrt per draw, a log per test) and the launch; at the
// lockstep step (640 lanes x 128 proposals x 5 slots) most entries accept
// in their first round, and the memory traffic (d, c, the result) is a few
// MB.
#include <math.h>

#include "kalman_common.cuh"

namespace {

typedef unsigned long long u64;

constexpr u64 kGolden = 0x9E3779B97F4A7C15ull;
constexpr u64 kFold = 0x632BE59BD9B4E019ull;

__device__ __forceinline__ u64 mix64(u64 x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// LaneRNG.fold(tag) of one lane's key
__device__ __forceinline__ u64 fold(u64 key, long long tag) {
  return mix64(key ^ mix64(static_cast<u64>(tag) + kFold));
}

template <typename T> struct Draw;
template <> struct Draw<float> {
  static constexpr int bits = 24;
  __device__ static float uniform(u64 b) {
    return __fmul_rn(__fadd_rn(static_cast<float>(b >> (64 - bits)), 0.5f),
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

template <typename T>
__global__ void __launch_bounds__(256)
gamma_accept_kernel(const T* __restrict__ d, const T* __restrict__ c,
                    const long long* __restrict__ keys, T* __restrict__ out,
                    unsigned char* __restrict__ exhausted, long long per_lane,
                    long long total, int max_rounds) {
  using D = Draw<T>;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long lane = e / per_lane;
  const u64 step = static_cast<u64>(e - lane * per_lane + 1) * kGolden;
  const u64 key = static_cast<u64>(keys[lane]);
  const T de = d[e], ce = c[e];
  T value = T(0);
  bool done = false;
  for (int r = 0; r < max_rounds && !done; ++r) {
    const u64 knorm = fold(key, 2LL * r);
    const T u1 = D::uniform(mix64(fold(knorm, 0) + step));
    const T u2 = D::uniform(mix64(fold(knorm, 1) + step));
    const T u = D::uniform(mix64(fold(key, 2LL * r + 1) + step));
    const T x = D::normal(u1, u2);
    const T b = D::add(T(1), D::mul(ce, x));
    const T v = D::mul(D::mul(b, b), b);
    const bool pos = v > T(0);
    const T logv = D::log(pos ? v : T(1));
    const T rhs = D::add(D::sub(D::add(D::mul(D::mul(T(0.5), x), x), de),
                                D::mul(de, v)),
                         D::mul(de, logv));
    if (pos && D::log(u) < rhs) {
      value = D::mul(de, v);
      done = true;
    }
  }
  out[e] = value;
  if (!done) *exhausted = 1;
}

template <typename T>
int launch_gamma(const void* d, const void* c, const void* keys, void* out,
                 void* exhausted, long long per_lane,
                 long long total, int max_rounds, int device, void* stream) {
  if (per_lane < 1 || total < 0 || max_rounds < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  return bild::launch(gamma_accept_kernel<T>, (total + threads - 1) / threads,
                      threads, 0, device, stream, static_cast<const T*>(d),
                      static_cast<const T*>(c),
                      static_cast<const long long*>(keys), static_cast<T*>(out),
                      static_cast<unsigned char*>(exhausted), per_lane, total,
                      max_rounds);
}

}  // namespace

// d, c, out (L, per_lane) contiguous; keys (L,) int64; exhausted one byte
// (set to 1 where an entry is left, never cleared)
#define BILD_GAMMA_ENTRY(NAME, TYPE)                                            \
  extern "C" int NAME(const void* d, const void* c, const void* keys,           \
                      void* out, void* exhausted, int L, int per_lane,          \
                      int max_rounds, int device, void* stream) {               \
    return launch_gamma<TYPE>(d, c, keys, out, exhausted, per_lane,             \
                              static_cast<long long>(L) * per_lane, max_rounds, \
                              device, stream);                                  \
  }

BILD_GAMMA_ENTRY(bild_gamma_accept_f32, float)
BILD_GAMMA_ENTRY(bild_gamma_accept_f64, double)
