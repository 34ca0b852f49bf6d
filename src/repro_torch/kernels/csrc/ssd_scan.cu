// Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// Replaces the TPU kernel `ssd_scan_bhsp` (src/repro/kernels/ssd_scan.py,
// body `_ssd_kernel`).  Per chunk of Q tokens, with cs = cumsum(dt * A)
// inside the chunk and xdt = x * dt:
//   y[q, p]   = sum_{k <= q} (C[q] . B[k]) exp(cs[q] - cs[k]) xdt[k, p]
//             + exp(cs[q]) sum_n C[q, n] state[p, n]
//   state     = state * exp(cs[Q-1])
//             + sum_k xdt[k, p] exp(cs[Q-1] - cs[k]) B[k, n]
// with the (P, N) state carried in f32 from one chunk to the next.
//
// What bounds it on the card: at the training shape (x (2, 2048, 48, 64),
// N 128, Q 256, bf16) the function moves ~53 MB (x, dt, A, B, C read once,
// y written once), 0.016 ms at 3.35 TB/s, and needs ~9.8 GFLOP over the
// causal pairs k <= q (C . B^T once per chunk, shared by the heads), 0.010
// ms at the bf16 tensor-core rate, so bytes bound it.  This first version
// is far from either: it does its products with plain f32 FMAs from shared
// memory, recomputes C . B^T in every block, and at that shape launches 96
// blocks, fewer than the card's 132 SMs, each walking its 8 chunks in
// turn.  Moving the products onto `wgmma` and splitting the work over more
// blocks is later work.
//
// Design: the TPU grid carried the state across a sequential chunk axis
// in VMEM.  Blocks on the card run in parallel with nothing carried, so
// one block owns one (batch, head, 64-column P tile) and loops over the
// chunks itself, the state in registers (each thread owns a 4 x 8 patch of
// it) and mirrored into shared memory for the y term that reads it.  Output
// column p depends only on x[:, p] and state row p, so P tiles need no
// combine pass; each recomputes the Q x Q part (C . B^T and the decays).
// A chunk's B and C (Q x N) and the Q x Q scores do not fit a block's 227 KB
// at Q = 256, N = 128 in f32, so the chunk is cut into 64-row q tiles and
// 64-row k tiles, and only the k tiles at or below the q tile are computed
// (causal).  The decay exp(cs[q] - cs[k]) is taken only where k <= q: above
// the diagonal the exponent is positive and could overflow, so no inf * 0
// can appear.  The state update rides on the last q tile, which visits
// every k tile.  The cumsum of dt * A and every sum are f32; y is written
// in x's dtype.  The model layouts (B, S, H, P), (B, S, H) and (B, S, N) are
// read through strides, so no transpose is materialised.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarpsSsd = kThreads / 32;
constexpr int kT = 64;          // rows of a q tile and of a k tile
constexpr int kPT = 64;         // P columns per block
constexpr int kLd = kT + 4;     // padded row of the transposed B/C tiles and
                                // of the score tile; a multiple of 4 keeps
                                // float4 reads aligned
constexpr int kMaxN = 128;      // the state patch is 8 rows of 16 per thread
constexpr int kNPerThread = kMaxN / 16;
constexpr int kMaxQ = 4096;

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* Bm;
  const void* Cm;
  void* y;
  int S, P, N, Q;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long a_sb, a_ss, a_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
};

__host__ __device__ inline int padded_q(int Q) {
  return (Q + kT - 1) / kT * kT;
}

size_t ssd_smem_bytes(int N, int Q) {
  const size_t floats = 2 * static_cast<size_t>(N) * kLd   // Ct, Bt
                        + static_cast<size_t>(N) * kPT     // state
                        + kT * kPT                         // xdt tile
                        + kT * kLd                         // score tile
                        + 2 * static_cast<size_t>(padded_q(Q))  // cs, dt
                        + kWarpsSsd;                       // scan totals
  return floats * sizeof(float);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N;
  const int Q = a.Q;
  const int Qp = padded_q(Q);
  float* Ct = smem;                     // [N][kLd]  C tile, transposed
  float* Bt = Ct + N * kLd;             // [N][kLd]  B tile, transposed
  float* St = Bt + N * kLd;             // [N][kPT]  state, transposed
  float* Xs = St + N * kPT;             // [kT][kPT] xdt tile
  float* Ss = Xs + kT * kPT;            // [kT][kLd] decayed scores (q, k)
  float* cs = Ss + kT * kLd;            // [Qp] cumsum of dt * A
  float* dts = cs + Qp;                 // [Qp] dt
  float* red = dts + Qp;                // [kWarpsSsd]

  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int pn = min(kPT, a.P - p0);    // live columns of this tile
  const int tid = threadIdx.x;
  const int tx = tid & 15;              // 4 columns (k or p) each
  const int ty = tid >> 4;              // 4 q rows each
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + p0;
  const float* dt = a.dt + b * a.dt_sb + h * a.dt_sh;
  const float* da = a.a + b * a.a_sb + h * a.a_sh;
  const T* Bm = static_cast<const T*>(a.Bm) + b * a.b_sb;
  const T* Cm = static_cast<const T*>(a.Cm) + b * a.c_sb;
  T* y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + p0;

  // this thread's patch of the state: p = tx*4 + j, n = ty + 16*i
  float st[kNPerThread][4];
#pragma unroll
  for (int i = 0; i < kNPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st[i][j] = 0.f;
    }
  }
  for (int e = tid; e < N * kPT; e += kThreads) {
    St[e] = 0.f;
  }

  const int nqt = Qp / kT;
  for (int c0 = 0; c0 < a.S; c0 += Q) {
    __syncthreads();                    // last chunk done with cs, dts, St

    // ---- cs = cumsum(dt * A) over the chunk: block scan, 256 at a time
    float carry = 0.f;
    for (int base = 0; base < Qp; base += kThreads) {
      const int i = base + tid;
      const bool in = i < Q;
      float v = in ? da[(c0 + i) * a.a_ss] : 0.f;
      const float d = in ? dt[(c0 + i) * a.dt_ss] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) {
          v += t;
        }
      }
      if (lane == 31) {
        red[warp] = v;
      }
      __syncthreads();
      float off = carry;
      float total = carry;
      for (int w = 0; w < kWarpsSsd; ++w) {
        const float r = red[w];
        off += w < warp ? r : 0.f;
        total += r;
      }
      if (i < Qp) {
        cs[i] = v + off;                // rows past Q hold cs[Q-1]
        dts[i] = d;
      }
      carry = total;
      __syncthreads();                  // red is rewritten next round
    }
    const float cs_last = cs[Q - 1];
    const float chunk_decay = expf(cs_last);
#pragma unroll
    for (int i = 0; i < kNPerThread; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st[i][j] *= chunk_decay;
      }
    }

    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();                  // Ct, Bt, Xs, Ss free
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N;
        const int n = e - r * N;
        const int q = q0 + r;
        Ct[n * kLd + r] = q < Q ? to_f32(Cm[(c0 + q) * a.c_ss + n]) : 0.f;
      }
      __syncthreads();

      // ---- the carried state's term: exp(cs[q]) * C[q] . state[p]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = 0.f;
        }
      }
      for (int n = 0; n < N; ++n) {
        const float4 cv = ld4(Ct + n * kLd + ty * 4);
        const float4 sv = ld4(St + n * kPT + tx * 4);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(c4[i], s4[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(cs[q0 + ty * 4 + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] *= e;
        }
      }

      // ---- the chunk's own term over the k tiles at or below this one
      const bool last = qt == nqt - 1;
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kT;
        __syncthreads();                // Bt, Xs, Ss free
        for (int e = tid; e < kT * N; e += kThreads) {
          const int r = e / N;
          const int n = e - r * N;
          const int k = k0 + r;
          Bt[n * kLd + r] = k < Q ? to_f32(Bm[(c0 + k) * a.b_ss + n]) : 0.f;
        }
        for (int e = tid; e < kT * kPT; e += kThreads) {
          const int r = e / kPT;
          const int pp = e - r * kPT;
          const int k = k0 + r;
          Xs[e] = (k < Q && pp < pn)
                      ? to_f32(x[(c0 + k) * a.x_ss + pp]) * dts[k]
                      : 0.f;
        }
        __syncthreads();

        // scores C[q] . B[k] for q = ty*4 + i, k = tx*4 + j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = 0.f;
          }
        }
        for (int n = 0; n < N; ++n) {
          const float4 cv = ld4(Ct + n * kLd + ty * 4);
          const float4 bv = ld4(Bt + n * kLd + tx * 4);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(c4[i], b4[j], s[i][j]);
            }
          }
        }
        // decay, only where k <= q (the exponent is <= 0 there)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty * 4 + i;
          const float cq = cs[q];
          float r4[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx * 4 + j;
            r4[j] = (k <= q && q < Q) ? s[i][j] * expf(cq - cs[k]) : 0.f;
          }
          *reinterpret_cast<float4*>(Ss + (ty * 4 + i) * kLd + tx * 4) =
              make_float4(r4[0], r4[1], r4[2], r4[3]);
        }
        __syncthreads();

        for (int k = 0; k < kT; ++k) {
          const float4 xv = ld4(Xs + k * kPT + tx * 4);
          const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float sv = Ss[(ty * 4 + i) * kLd + k];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(sv, x4[j], acc[i][j]);
            }
          }
        }

        // the last q tile visits every k tile: fold them into the state
        if (last) {
          for (int k = 0; k < kT; ++k) {
            const float w = expf(cs_last - cs[k0 + k]);
            const float4 xv = ld4(Xs + k * kPT + tx * 4);
            const float x4[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
            for (int i = 0; i < kNPerThread; ++i) {
              const int n = ty + 16 * i;
              if (n < N) {
                const float bv = Bt[n * kLd + k];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  st[i][j] = fmaf(x4[j], bv, st[i][j]);
                }
              }
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty * 4 + i;
        if (q < Q) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int pp = tx * 4 + j;
            if (pp < pn) {
              y[(c0 + q) * a.y_ss + pp] = from_f32<T>(acc[i][j]);
            }
          }
        }
      }
    }

    // publish the updated state for the next chunk's y term
    __syncthreads();                    // every q tile done reading St
#pragma unroll
    for (int i = 0; i < kNPerThread; ++i) {
      const int n = ty + 16 * i;
      if (n < N) {
        *reinterpret_cast<float4*>(St + n * kPT + tx * 4) =
            make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const SsdArgs& a, int B, int H, cudaStream_t stream) {
  const size_t smem = ssd_smem_bytes(a.N, a.Q);
  cudaError_t err = allow_smem(ssd_scan_kernel<T>, smem);
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid((a.P + kPT - 1) / kPT, H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x: (B, S, H, P) and Bm/Cm: (B, S, N) of `dtype` (0 = float32,
// 1 = bfloat16), unit stride on P and N; dt, a = dt * A: (B, S, H) float32;
// y: (B, S, H, P) of `dtype`, unit stride on P.  Q is the chunk, S % Q == 0.
// Strides in elements.  Returns the CUDA error of the launch (0 = success).
extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* a, const void* Bm,
    const void* Cm, void* y, int dtype, int B, int S, int H, int P, int N,
    int Q, long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
    long long dt_ss, long long dt_sh, long long a_sb, long long a_ss,
    long long a_sh, long long b_sb, long long b_ss, long long c_sb,
    long long c_ss, long long y_sb, long long y_ss, long long y_sh,
    void* stream) {
  using namespace repro;
  if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || S % Q != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SsdArgs args;
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.Bm = Bm;
  args.Cm = Cm;
  args.y = y;
  args.S = S;
  args.P = P;
  args.N = N;
  args.Q = Q;
  args.x_sb = x_sb;
  args.x_ss = x_ss;
  args.x_sh = x_sh;
  args.dt_sb = dt_sb;
  args.dt_ss = dt_ss;
  args.dt_sh = dt_sh;
  args.a_sb = a_sb;
  args.a_ss = a_ss;
  args.a_sh = a_sh;
  args.b_sb = b_sb;
  args.b_ss = b_ss;
  args.c_sb = c_sb;
  args.c_ss = c_ss;
  args.y_sb = y_sb;
  args.y_ss = y_ss;
  args.y_sh = y_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = launch<float>(args, B, H, st);
  } else if (dtype == kBFloat16) {
    err = launch<__nv_bfloat16>(args, B, H, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
