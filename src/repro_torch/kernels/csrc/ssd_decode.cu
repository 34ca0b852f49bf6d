// Mamba-2 SSD decode step for Hopper, sm_90a: one token of the recurrence,
// the state updated in place.
//
// Per sequence b and head h, with a = exp(dt[b, h] A[h]):
//   S[p, n] <- S[p, n] a + dt[b, h] x[b, h, p] B[b, n]
//   y[b, h, p] = sum_n S[p, n] C[b, n] + D[h] x[b, h, p]
// all in f32, the (P, N) state f32: the arithmetic of
// models/ssm.py::ssm_decode, whose plain version is
// kernels/ref.py::ssd_decode_step_ref.
//
// What bounds it on the card: bytes.  Each (b, h) reads its state once and
// writes it once, 8 P N bytes, for 6 P N flops (the input's two products,
// the decay's product and add, C's product and add).  At granite-4.0-h-
// micro's serving shape (384 sequences x 64 heads x P 64 x N 128) that is
// 1.61 GB a layer, 0.48 ms at 3.35 TB/s, against 0.2 GFLOP; x, B, C, dt
// and y add under 0.1%.
//
// Design: one block of 128 threads per (b, h).  The state's P x N/4
// float4s are taken in flat order, thread t owning those at t + 128 k.
// N/4 divides 32, so the N/4 float4s of one row lie in as many
// consecutive lanes of one warp, and a thread's quad of n is the same for
// every k: it reads its four B and four C once.  A thread starts the loads
// of kUnroll float4s before it uses any.  A row's sum over n is a shuffle
// reduction over its N/4 lanes, whose first lane writes y.  Every lane of
// a warp runs the same iterations (a float4 past the end is zeros, read
// and stored nowhere), so the full-mask shuffles are convergent.

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;
constexpr int kMaxN = 128;

struct StepArgs {
  float* state;
  const void* x;
  const float* dt;
  const float* A;
  const float* D;
  const void* Bm;
  const void* Cm;
  void* y;
  int H, P, N;
  long long x_sb, x_sh, x_sp, b_sb, b_sn, c_sb, c_sn;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_decode_step_kernel(StepArgs a) {
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int W = a.N / 4;
  const int total = a.P * W;
  const int t = threadIdx.x;
  const int quad = t % W;
  const T* xb = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const T* Bb =
      static_cast<const T*>(a.Bm) + b * a.b_sb + 4 * quad * a.b_sn;
  const T* Cb =
      static_cast<const T*>(a.Cm) + b * a.c_sb + 4 * quad * a.c_sn;
  float bq[4], cq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bq[i] = to_f32(Bb[i * a.b_sn]);
    cq[i] = to_f32(Cb[i * a.c_sn]);
  }
  const float dt = a.dt[bh];
  const float decay = expf(dt * a.A[h]);
  const float d = a.D[h];
  float4* s = reinterpret_cast<float4*>(a.state) +
              static_cast<long long>(bh) * total;
  T* yb = static_cast<T*>(a.y) + static_cast<long long>(bh) * a.P;
  const int rounds = (total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  for (int r = 0; r < rounds; ++r) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = (r * kUnroll + u) * kThreads + t;
      v[u] = f < total ? s[f] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = (r * kUnroll + u) * kThreads + t;
      const bool live = f < total;
      const int p = f / W;
      const float xp = live ? to_f32(xb[p * a.x_sp]) : 0.f;
      const float dx = dt * xp;
      float4 n = v[u];
      n.x = n.x * decay + dx * bq[0];
      n.y = n.y * decay + dx * bq[1];
      n.z = n.z * decay + dx * bq[2];
      n.w = n.w * decay + dx * bq[3];
      float part = n.x * cq[0] + n.y * cq[1] + n.z * cq[2] + n.w * cq[3];
      for (int o = W / 2; o > 0; o >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      if (live) {
        s[f] = n;
        if (quad == 0) {
          yb[p] = from_f32<T>(part + d * xp);
        }
      }
    }
  }
}

}  // namespace
}  // namespace repro

// state: (B, H, P, N) f32, contiguous, 16-byte aligned, updated in place;
// x: (B, H, P) in `dtype` with strides x_sb, x_sh, x_sp; dt: (B, H) f32
// contiguous (after softplus); A, D: (H,) f32; Bm, Cm: (B, N) in `dtype`
// with strides (b_sb, b_sn) and (c_sb, c_sn); y: (B, H, P) in `dtype`,
// contiguous.  N / 4 must be a power of two <= 32.  (The decode step's
// x, B and C are slices of one conv output that may lie batch-minor.)
extern "C" int repro_ssd_decode_step(
    void* state, const void* x, const void* dt, const void* A,
    const void* D, const void* Bm, const void* Cm, void* y, int dtype, int B,
    int H, int P, int N, long long x_sb, long long x_sh, long long x_sp,
    long long b_sb, long long b_sn, long long c_sb, long long c_sn,
    void* stream) {
  using namespace repro;
  const int W = N / 4;
  if (B < 1 || H < 1 || P < 1 || N < 4 || N > kMaxN || N % 4 != 0 ||
      (W & (W - 1)) != 0 ||
      static_cast<long long>(B) * H > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StepArgs a = {};
  a.state = static_cast<float*>(state);
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.Bm = Bm;
  a.Cm = Cm;
  a.y = y;
  a.H = H;
  a.P = P;
  a.N = N;
  a.x_sb = x_sb;
  a.x_sh = x_sh;
  a.x_sp = x_sp;
  a.b_sb = b_sb;
  a.b_sn = b_sn;
  a.c_sb = c_sb;
  a.c_sn = c_sn;
  const dim3 grid(B * H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    ssd_decode_step_kernel<float><<<grid, kThreads, 0, st>>>(a);
  } else if (dtype == kBFloat16) {
    ssd_decode_step_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
