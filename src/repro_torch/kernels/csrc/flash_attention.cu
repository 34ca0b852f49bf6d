// Causal flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel `flash_attention_bhsd` (src/repro/kernels/
// flash_attention.py, body `_attn_kernel`): causal attention with an
// optional sliding window and GQA through `h // G`, an f32 online softmax
// carried across kv blocks, fully masked kv blocks skipped.
//
// What bounds it on the card: at serving prefill sizes (one sequence,
// L <= a few thousand, Dh 80/128) the work is ~4*L^2*H*Dh/2 flops against
// 2*L*(H+2K)*Dh bytes, so for L >= ~300 it is bound by operations — by the
// tensor-core rate once a later version uses them.  This first version
// does its products with plain f32 FMAs, so the f32 FMA rate bounds it.
//
// Design: the TPU grid carried the softmax state across a sequential kv
// grid axis; blocks on the card run in parallel with nothing carried, so
// one block owns one (batch, q head, 64-row q tile) and loops over the kv
// tiles itself, only up to its causal / window limit (fully masked tiles
// are never loaded).  The q tile and one 32-line kv tile sit in shared
// memory in f32; each of the 8 warps owns 8 q rows, keeps their running
// max, sum and accumulator in registers, and scores one kv line per lane.
// The model layout (B, S, H, Dh) is read through strides, so no transpose
// is materialised; ragged S is masked, Dh is any width up to 128 (80 and
// 128 are the main-path widths), and the kv head is `h / G`.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;                 // q rows per block
constexpr int kBK = 32;                 // kv lines per tile: one per lane
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBQ / kWarps;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, G, Dh, window;                 // window <= 0: full causal
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
};

size_t attn_smem_bytes(int Dh) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * Dh + kBK * (Dh + 1) + kBK * Dh +
          kBQ * kBK);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  const int Dh = a.Dh;
  const int ldk = Dh + 1;               // padded: lane-strided reads hit
                                        // distinct banks
  float* Qs = smem;                     // [kBQ][Dh]
  float* Ks = Qs + kBQ * Dh;            // [kBK][Dh + 1]
  float* Vs = Ks + kBK * ldk;           // [kBK][Dh]
  float* Ps = Vs + kBK * Dh;            // [kBQ][kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / a.G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBQ * Dh; i += blockDim.x) {
    const int r = i / Dh;
    const int d = i - r * Dh;
    const int s = q0 + r;
    Qs[i] = s < a.S ? to_f32(q[s * a.q_ss + d]) : 0.f;
  }

  const int row0 = warp * kRowsPerWarp;
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kDhPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDhPerLane; ++j) {
      acc[r][j] = 0.f;
    }
  }

  // kv range this q tile can see: causal end, window start
  int lo = 0;
  if (a.window > 0) {
    lo = max(0, q0 - a.window + 1);
  }
  const int kv_begin = (lo / kBK) * kBK;
  const int kv_end = min(a.S, q0 + kBQ);

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();                    // Qs written / last tile consumed
    for (int i = tid; i < kBK * Dh; i += blockDim.x) {
      const int r = i / Dh;
      const int d = i - r * Dh;
      const int s = kv0 + r;
      const bool in = s < a.S;
      Ks[r * ldk + d] = in ? to_f32(k[s * a.k_ss + d]) : 0.f;
      Vs[i] = in ? to_f32(v[s * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    const int kv_pos = kv0 + lane;
    float* prow = Ps + row0 * kBK;
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int q_pos = q0 + row0 + r;
      const float* qr = Qs + (row0 + r) * Dh;
      const float* kr = Ks + lane * ldk;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) {
        s = fmaf(qr[d], kr[d], s);
      }
      s *= a.scale;
      bool valid = kv_pos <= q_pos && kv_pos < a.S;
      if (a.window > 0) {
        valid = valid && (q_pos - kv_pos) < a.window;
      }
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      alpha[r] = expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + warp_sum(p);
      m[r] = m_new;
      prow[r * kBK + lane] = p;
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float* pr = prow + r * kBK;
#pragma unroll
      for (int j = 0; j < kDhPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < Dh) {
          float x = acc[r][j] * alpha[r];
#pragma unroll 8
          for (int c = 0; c < kBK; ++c) {
            x = fmaf(pr[c], Vs[c * Dh + d], x);
          }
          acc[r][j] = x;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int s = q0 + row0 + r;
    if (s < a.S) {
      const float den = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int j = 0; j < kDhPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < Dh) {
          o[s * a.o_ss + d] = from_f32<T>(acc[r][j] / den);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const AttnArgs& a, int B, int H, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes(a.Dh);
  cudaError_t err = allow_smem(flash_attention_kernel<T>, smem);
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid((a.S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q: (B, S, H, Dh), k/v: (B, S, K, Dh), o: (B, S, H, Dh), all of `dtype`
// (0 = float32, 1 = bfloat16), unit stride on Dh; strides in elements.
// Returns the CUDA error of the launch (0 = success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int H, int K, int Dh, int window, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, void* stream) {
  using namespace repro;
  if (Dh < 1 || Dh > kMaxDh || K < 1 || H % K != 0 || S < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.S = S;
  a.G = H / K;
  a.Dh = Dh;
  a.window = window;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.o_sb = o_sb;
  a.o_ss = o_ss;
  a.o_sh = o_sh;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = launch<float>(a, B, H, st);
  } else if (dtype == kBFloat16) {
    err = launch<__nv_bfloat16>(a, B, H, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
