// Causal flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel `flash_attention_bhsd` (src/repro/kernels/
// flash_attention.py, body `_attn_kernel`): causal attention with an
// optional sliding window and GQA through `h // G`, an f32 online softmax
// carried across kv blocks, fully masked kv blocks skipped.
//
// What bounds it on the card: at serving prefill sizes (one sequence,
// L <= a few thousand, Dh 80/128) the work is ~4*L^2*H*Dh/2 flops against
// 2*L*(H+2K)*Dh bytes, so for L >= ~300 it is bound by operations, by the
// tensor-core rate in bf16.
//
// The TPU grid carried the softmax state across a sequential kv grid
// axis; blocks on the card run in parallel with nothing carried, so one
// block owns one (batch, q head, q tile) and loops over the kv tiles
// itself, only up to its causal / window limit (fully masked tiles are
// never loaded).  The model layout (B, S, H, Dh) is read through strides,
// so no transpose is materialised; ragged S is masked, Dh is any width up
// to 128 (80 and 128 are the main-path widths), and the kv head is
// `h / G`.
//
// bfloat16 (`flash_attention_mma_kernel`): both products on tensor cores,
// `mma.sync.m16n8k16` bf16 with f32 accumulators.  A block owns 16 q rows
// of one (batch, head); its 4 warps take the 16-line kv tiles of that
// range in turn (warp w: tiles w, w + 4, ...), each an independent
// stream with its own online softmax, so a 128-token prefill of 32 heads
// runs 256 blocks of 4 warps and its longest causal row is walked by 4
// warps at once.  The q rows' A fragments are read once with `ldmatrix`
// and stay in registers.  Each warp copies its K and V tiles as bf16 with
// 16-byte `cp.async` into its own two stages, the next tile in flight
// while this one is used, with no block barrier in the loop; a row is Dh
// rounded up to 16 (zeros past Dh: 80 takes 5 k-steps, 128 takes 8) plus
// 16 bytes, an odd number of 16-byte pieces, so `ldmatrix` reads are free
// of bank conflicts.  Masking, the running max and sum (quad shuffles)
// and the rescale work on the score fragments in registers,
// FlashAttention-2 style; P becomes the A operand of P.V in registers as
// two bf16 terms (hi and the remainder lo): P.V then keeps 16 bits of P,
// so the output stays an f32 rounding away from the plain version's, for
// twice the P.V tensor work.  At the end the warps merge their streams
// through shared memory and write o with coalesced stores.  `mma.sync`
// rather than `wgmma`: its 16-row tiles suit these short prompts, where
// `wgmma`'s 64-row warpgroup tiles and the swizzle of 160-byte rows would
// add risk for little.  Past ~256 tokens the 16-row tiles cost: every q
// tile reads its kv range again (from L2), and a 512-token prefill of 32
// heads of 80 takes 0.053 ms against SDPA's 0.018 ms (H100 80GB HBM3 at
// 700 W, chip_smoke.py); taller q tiles sharing their kv tiles are next.
//
// float32 (`flash_attention_kernel`, the first design): plain f32 FMAs,
// so f32 stays exact to ~1e-6 (TF32 tensor cores would not).  The q tile
// and one 32-line kv tile sit in shared memory in f32; each of the 8
// warps owns 8 q rows, keeps their running max, sum and accumulator in
// registers, and scores one kv line per lane.

#include "common.cuh"

namespace repro {
namespace {

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

// ------------------------------------------------ bfloat16, tensor cores ----

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMmaWarps = 4;            // a block: 16 q rows, 4 kv streams
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16;            // q rows a block
constexpr int kMmaLines = 16;           // kv lines a warp's tile

// Shared row of a padded head of kNK k-steps: 16 * kNK bf16 and 8 more,
// an odd number of 16-byte pieces, so ldmatrix rows hit distinct banks.
template <int kNK>
__host__ __device__ constexpr int mma_ld() {
  return 16 * kNK + 8;
}

// q rows, then each warp's 2 stages of K and V lines; after the loop the
// warps' accumulators, maxima and sums reuse the stages.
template <int kNK>
__host__ __device__ constexpr int mma_tiles_bytes() {
  return static_cast<int>(sizeof(bf16)) * mma_ld<kNK>() *
         kMmaWarps * 2 * 2 * kMmaLines;
}

template <int kNK>
size_t mma_smem_bytes() {
  return sizeof(bf16) * mma_ld<kNK>() * kMmaRows + mma_tiles_bytes<kNK>();
}

// Rows [s0, s0 + n_rows) of a (S, Dh) bf16 matrix with row stride `ss`
// into shared rows of `ld`, copied by `n_threads` threads from `tid`:
// whole 16-byte pieces by cp.async (zero-filled past S), the piece holding
// Dh's tail by scalar loads (zeros past Dh); the pieces past it hold zeros
// from the start.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          long long ss, int s0, int n_rows,
                                          int S, int Dh, int tid,
                                          int n_threads) {
  const int n_full = Dh / 8;
  for (int i = tid; i < n_rows * n_full; i += n_threads) {
    const int r = i / n_full;
    const int c = (i - r * n_full) * 8;
    const int s = s0 + r;
    const bool in = s < S;
    cp_async_16(dst + r * ld + c, in ? src + s * ss + c : src, in ? 16 : 0);
  }
  if (n_full * 8 < Dh) {
    for (int i = tid; i < n_rows * 8; i += n_threads) {
      const int r = i / 8;
      const int d = n_full * 8 + i % 8;
      const int s = s0 + r;
      dst[r * ld + d] = (s < S && d < Dh) ? src[s * ss + d]
                                          : from_f32<bf16>(0.f);
    }
  }
}

template <int kNK>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_mma_kernel(AttnArgs a) {
  constexpr int kLd = mma_ld<kNK>();
  constexpr int kNO = 2 * kNK;          // output n-tiles (8 dims each)
  constexpr int kStage = 2 * kMmaLines * kLd;   // K then V lines
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);    // [kMmaRows][kLd]
  bf16* tiles = Qs + kMmaRows * kLd;               // [warp][2][K|V]

  const int q0 = blockIdx.x * kMmaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / a.G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int S = a.S;
  const int Dh = a.Dh;

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + kh * a.v_sh;
  bf16* o = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;

  // zeros in the columns past Dh's last 16-byte piece, up to the padded
  // width, in q and every stage: no load writes them (the piece that
  // holds Dh's tail is rewritten, zeros and all, by every load)
  {
    const int c0 = (Dh + 7) / 8 * 8;
    const int width = 16 * kNK - c0;
    const int rows = kMmaRows + kMmaWarps * 2 * 2 * kMmaLines;
    for (int i = tid; i < rows * width; i += kMmaThreads) {
      const int r = i / width;
      Qs[r * kLd + c0 + (i - r * width)] = from_f32<bf16>(0.f);
    }
  }

  // kv range of this q tile (window start, causal end) in 16-line tiles;
  // warp w takes tiles w, w + 4, ... into its own two stages
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kv_begin = lo / kMmaLines * kMmaLines;
  const int kv_end = min(S, q0 + kMmaRows);
  const int n_tiles = (kv_end - kv_begin + kMmaLines - 1) / kMmaLines;
  bf16* mine = tiles + warp * 2 * kStage;
  auto issue = [&](int it, int st) {
    if (it < n_tiles) {
      const int s0 = kv_begin + it * kMmaLines;
      bf16* kd = mine + st * kStage;
      load_rows(kd, kLd, k, a.k_ss, s0, kMmaLines, S, Dh, lane, 32);
      load_rows(kd + kMmaLines * kLd, kLd, v, a.v_ss, s0, kMmaLines, S, Dh,
                lane, 32);
    }
    cp_async_commit();
  };

  load_rows(Qs, kLd, q, a.q_ss, q0, kMmaRows, S, Dh, tid, kMmaThreads);
  cp_async_commit();
  issue(warp, 0);
  cp_async_wait<1>();                   // this thread's q pieces
  __syncthreads();                      // everyone's, and the zeros

  // the 16 q rows' A fragments, in registers for the whole loop
  unsigned qf[kNK][4];
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
    ldmatrix_x4(qf[kk], Qs + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
  }

  const int g = lane >> 2;              // fragment row (and row + 8)
  const int t = lane & 3;               // fragment column pair
  const float scale = a.scale * kLog2e; // softmax in base 2
  float acc[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] = 0.f;
    }
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};              // this lane's part of each row sum

  for (int it = warp, n = 0; it < n_tiles; it += kMmaWarps, ++n) {
    const int kv0 = kv_begin + it * kMmaLines;
    issue(it + kMmaWarps, (n + 1) & 1);
    cp_async_wait<1>();
    __syncwarp();                       // the warp's tile it has landed
    const bf16* kt = mine + (n & 1) * kStage;
    const bf16* vt = kt + kMmaLines * kLd;
    float sc[2][4] = {};
    // S = Q K^T: K rows are the column-major B operand as stored
#pragma unroll
    for (int kk = 0; kk < kNK; ++kk) {
      unsigned kb[4];
      ldmatrix_x4(kb, kt + ((lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_16816(sc[0], qf[kk], kb[0], kb[1]);
      mma_16816(sc[1], qf[kk], kb[2], kb[3]);
    }
    // mask, running max over the quad's columns, rescale
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + g + 8 * (e >> 1);
        const int kp = kv0 + nt * 8 + 2 * t + (e & 1);
        bool valid = kp <= qp && kp < S;
        if (a.window > 0) {
          valid = valid && (qp - kp) < a.window;
        }
        sc[nt][e] = valid ? sc[nt][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sc[nt][e] > 0.5f * kNegInf
                            ? exp2f(sc[nt][e] - m[e >> 1]) : 0.f;
        sc[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nn = 0; nn < kNO; ++nn) {
      acc[nn][0] *= alpha[0];
      acc[nn][1] *= alpha[0];
      acc[nn][2] *= alpha[1];
      acc[nn][3] *= alpha[1];
    }
    // O += P V: the 16 lines' score fragments are the A operand, as hi +
    // lo bf16 terms (P alone in bf16 would move outputs by an ulp against
    // the f32 softmax); V rows (kv line x dim) are transposed on the way
    // into registers
    unsigned hi[4];
    unsigned lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split_bf16x2(sc[i >> 1][2 * (i & 1)], sc[i >> 1][2 * (i & 1) + 1],
                   hi[i], lo[i]);
    }
#pragma unroll
    for (int np = 0; np < kNO / 2; ++np) {
      unsigned vb[4];
      ldmatrix_x4_trans(vb, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                np * 16 + (lane >> 4) * 8);
      mma_16816(acc[2 * np], hi, vb[0], vb[1]);
      mma_16816(acc[2 * np + 1], hi, vb[2], vb[3]);
      mma_16816(acc[2 * np], lo, vb[0], vb[1]);
      mma_16816(acc[2 * np + 1], lo, vb[2], vb[3]);
    }
    __syncwarp();                       // stage n & 1 free for tile it + 8
  }
  cp_async_wait<0>();
  __syncthreads();                      // every warp done with its stages

  // merge the 4 warps' streams: accumulators [warp][row][16 kNK], then
  // row max and sum [warp][row]
  float* macc = reinterpret_cast<float*>(tiles);
  float* mm = macc + kMmaWarps * kMmaRows * 16 * kNK;
  float* ll = mm + kMmaWarps * kMmaRows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = g + 8 * r;
    float* arow = macc + (warp * kMmaRows + row) * 16 * kNK;
#pragma unroll
    for (int nn = 0; nn < kNO; ++nn) {
      arow[nn * 8 + 2 * t] = acc[nn][2 * r];
      arow[nn * 8 + 2 * t + 1] = acc[nn][2 * r + 1];
    }
    if (t == 0) {
      mm[warp * kMmaRows + row] = m[r];
      ll[warp * kMmaRows + row] = l[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < kMmaRows * Dh; i += kMmaThreads) {
    const int row = i / Dh;
    const int d = i - row * Dh;
    const int s = q0 + row;
    if (s < S) {
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w) {
        mx = fmaxf(mx, mm[w * kMmaRows + row]);
      }
      float num = 0.f;
      float den = 0.f;
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w) {
        const float wt = exp2f(mm[w * kMmaRows + row] - mx);
        num = fmaf(macc[(w * kMmaRows + row) * 16 * kNK + d], wt, num);
        den = fmaf(ll[w * kMmaRows + row], wt, den);
      }
      o[s * a.o_ss + d] = from_f32<bf16>(num / (den == 0.f ? 1.f : den));
    }
  }
}

template <int kNK>
cudaError_t launch_mma(const AttnArgs& a, int B, int H,
                       cudaStream_t stream) {
  static_assert(sizeof(float) * kMmaWarps * kMmaRows * (16 * kNK + 2) <=
                    mma_tiles_bytes<kNK>(),
                "the merge fits in the stages");
  const size_t smem = mma_smem_bytes<kNK>();
  cudaError_t err = allow_smem(flash_attention_mma_kernel<kNK>, smem);
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid((a.S + kMmaRows - 1) / kMmaRows, H, B);
  flash_attention_mma_kernel<kNK><<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Dh rounded up to 64, 80 or 128: 4, 5 or 8 k-steps of 16.
cudaError_t launch_bf16(const AttnArgs& a, int B, int H,
                        cudaStream_t stream) {
  if (a.Dh <= 64) {
    return launch_mma<4>(a, B, H, stream);
  }
  if (a.Dh <= 80) {
    return launch_mma<5>(a, B, H, stream);
  }
  return launch_mma<8>(a, B, H, stream);
}

// ------------------------------------------------ float32, first design ----

constexpr int kBQ = 64;                 // q rows per block
constexpr int kBK = 32;                 // kv lines per tile: one per lane
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBQ / kWarps;

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
// In bfloat16, q, k and v are read with 16-byte copies: their base
// pointers and strides must be multiples of 16 bytes.
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
    err = launch_bf16(a, B, H, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
