// Backward of causal attention for Hopper, sm_90a, in bfloat16.
//
// The port's own kernel: the TPU kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention.py) is forward-only, so no TPU
// kernel is replaced.  It is the gradient of `flash_attention.cu`'s
// causal attention (optional sliding window, GQA through `h / G`, the
// logits' `scale`), and takes the place of the plain f32 recompute under
// autograd, whose f32 (B, H, S, S) logits and their gradients cost a
// training step many full passes over device memory.
//
// What bounds it on the card: five products over the causal pairs
// (S = QK^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K), 10 Dh
// flops a pair, against q, k, v, dO read and dq, dk, dv written once: at
// training lengths (S 1024-2048, Dh 80-128) it is bound by operations,
// by the tensor-core rate.
//
// Three launches on one stream, no float atomics, so the gradients are
// the same bits from run to run:
//   1. `attn_bwd_pre_kernel`, one block a (batch, q head, 64-row q tile):
//      walks the kv tiles up to the causal / window limit as the forward
//      does, with an online softmax, and writes per row in f32 the
//      log-sum-exp of the scaled logits and D = dO . O, O accumulated in
//      f32 and never written out: both as exact as the plain f32 path's.
//   2. `attn_bwd_dkdv_kernel`, one block a (batch, kv head, 64-line kv
//      tile): over the G q heads of its kv head and the q tiles from the
//      tile's diagonal to the causal / window limit, recomputes
//      S^T = K Q^T and P^T = exp(S^T - LSE), accumulates dV += P^T dO,
//      forms dP^T = V dO^T and dS^T = P^T (dP^T - D), accumulates
//      dK += dS^T Q; dK and dV stay in f32 registers and are written once.
//   3. `attn_bwd_dq_kernel`, one block a (batch, q head, 64-row q tile):
//      walks the kv tiles, recomputes S, P, dP and dS, accumulates
//      dQ += dS K and writes it once.
//
// Design.  Each block has 4 warps; a warp owns 16 rows of the block's
// tile (q rows in 1 and 3, kv lines in 2) and walks the other side's
// 64-line tiles, which the whole block streams through two stages of
// shared memory with 16-byte `cp.async` (the next tile in flight while
// this one is used), in sub-tiles of 16, skipping those that the causal
// and window masks hide entirely.  Every product is `mma.sync.m16n8k16`
// bf16 with f32 accumulators, as in the forward kernel, with the same
// padded shared rows (Dh rounded up to 16, plus 16 bytes, so `ldmatrix`
// reads are free of bank conflicts) and the same fragment reuse: a
// product's f32 output fragments are the next product's A operand in
// registers.  P and dS enter their products (O, dV, dK, dQ) as two bf16
// terms, hi and the remainder lo, the forward kernel's scheme: those
// products keep 16 bits of P and dS, as the plain f32 path does, for
// twice their tensor work.  Blocks take their tiles longest first (the
// causal walk is longest for the last q tile and the first kv tile).
//
// Layouts: q, dO (B, S, H, Dh), k, v (B, S, K, Dh) read through strides
// (base pointers and strides in multiples of 16 bytes); dq, dk, dv written
// through strides; LSE and D (B, H, S) f32 scratch.  Dh is any width up to
// 128 (80 and 128 are the training widths), ragged S is masked.

#include "common.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;      // a block's rows, a streamed tile

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse;                           // (B, H, S): natural log
  float* delta;                         // (B, H, S)
  int S, H, G, Dh, window;              // window <= 0: full causal
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
};

// Shared row of a padded head of kNK k-steps: 16 * kNK bf16 and 8 more,
// an odd number of 16-byte pieces.
template <int kNK>
__host__ __device__ constexpr int row_ld() {
  return 16 * kNK + 8;
}

// Both kinds of block hold two resident tiles and two stages of two
// streamed tiles, of kTile padded rows each; the dK/dV block also two
// stages of the streamed q rows' LSE and D.
template <int kNK>
size_t smem_bytes() {
  return sizeof(bf16) * 6 * kTile * row_ld<kNK>() +
         sizeof(float) * 2 * 2 * kTile;
}

// Rows [s0, s0 + n_rows) of a (S, Dh) bf16 matrix with row stride `ss`
// into shared rows of `ld`: whole 16-byte pieces by cp.async (zero-filled
// past S), the piece holding Dh's tail by scalar loads (zeros past Dh).
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long ss, int s0, int n_rows,
                                          int S, int Dh, int tid) {
  const int n_full = Dh / 8;
  for (int i = tid; i < n_rows * n_full; i += kThreads) {
    const int r = i / n_full;
    const int c = (i - r * n_full) * 8;
    const int s = s0 + r;
    const bool in = s < S;
    cp_async_16(dst + r * ld + c, in ? src + s * ss + c : src, in ? 16 : 0);
  }
  if (n_full * 8 < Dh) {
    for (int i = tid; i < n_rows * 8; i += kThreads) {
      const int r = i / 8;
      const int d = n_full * 8 + i % 8;
      const int s = s0 + r;
      dst[r * ld + d] = (s < S && d < Dh) ? src[s * ss + d]
                                          : from_f32<bf16>(0.f);
    }
  }
}

// Zeros in the columns past Dh's last 16-byte piece, up to the padded
// width, in every shared row: no load writes them.
template <int kNK>
__device__ __forceinline__ void zero_pad(bf16* rows, int n_rows, int Dh,
                                         int tid) {
  constexpr int kLd = row_ld<kNK>();
  const int c0 = (Dh + 7) / 8 * 8;
  const int width = 16 * kNK - c0;
  for (int i = tid; i < n_rows * width; i += kThreads) {
    const int r = i / width;
    rows[r * kLd + c0 + (i - r * width)] = from_f32<bf16>(0.f);
  }
}

// A fragments of 16 rows x 16 kNK of a shared tile (row-major operand).
template <int kNK>
__device__ __forceinline__ void load_a(unsigned (&f)[kNK][4],
                                       const bf16* rows, int lane) {
  constexpr int kLd = row_ld<kNK>();
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
    ldmatrix_x4(f[kk], rows + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
  }
}

// acc (16 x 16) += A (16 x 16 kNK) . B^T, B 16 shared rows of 16 kNK: the
// rows are the column-major B operand as stored.
template <int kNK>
__device__ __forceinline__ void mma_abt(float (&acc)[2][4],
                                        const unsigned (&a)[kNK][4],
                                        const bf16* rows, int lane) {
  constexpr int kLd = row_ld<kNK>();
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
    unsigned b[4];
    ldmatrix_x4(b, rows + ((lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                       ((lane >> 3) & 1) * 8);
    mma_16816(acc[0], a[kk], b[0], b[1]);
    mma_16816(acc[1], a[kk], b[2], b[3]);
  }
}

// The same with A read from 16 shared rows as well.
template <int kNK>
__device__ __forceinline__ void mma_abt_shared(float (&acc)[2][4],
                                               const bf16* a_rows,
                                               const bf16* rows, int lane) {
  constexpr int kLd = row_ld<kNK>();
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
    unsigned a[4];
    unsigned b[4];
    ldmatrix_x4(a, a_rows + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
    ldmatrix_x4(b, rows + ((lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                       ((lane >> 3) & 1) * 8);
    mma_16816(acc[0], a, b[0], b[1]);
    mma_16816(acc[1], a, b[2], b[3]);
  }
}

// acc (16 x 16 kNK) += X (16 x 16, the f32 fragments of a product, as hi
// + lo bf16 terms) . M, M 16 shared rows of 16 kNK transposed on the way
// into registers.
template <int kNK>
__device__ __forceinline__ void mma_xm(float (&acc)[2 * kNK][4],
                                       const float (&x)[2][4],
                                       const bf16* rows, int lane) {
  constexpr int kLd = row_ld<kNK>();
  unsigned hi[4];
  unsigned lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split_bf16x2(x[i >> 1][2 * (i & 1)], x[i >> 1][2 * (i & 1) + 1], hi[i],
                 lo[i]);
  }
#pragma unroll
  for (int np = 0; np < kNK; ++np) {
    unsigned b[4];
    ldmatrix_x4_trans(b, rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                             np * 16 + (lane >> 4) * 8);
    mma_16816(acc[2 * np], hi, b[0], b[1]);
    mma_16816(acc[2 * np + 1], hi, b[2], b[3]);
    mma_16816(acc[2 * np], lo, b[0], b[1]);
    mma_16816(acc[2 * np + 1], lo, b[2], b[3]);
  }
}

// Is (q position qp, kv position kp) attended?
__device__ __forceinline__ bool attended(int qp, int kp, int S, int window) {
  return kp <= qp && qp < S && (window <= 0 || qp - kp < window);
}

// Could any pair of q rows [q0, q0 + 16) and kv lines [k0, k0 + 16) be
// attended?
__device__ __forceinline__ bool any_attended(int q0, int k0, int S,
                                             int window) {
  return k0 <= q0 + 15 && q0 < S && k0 < S &&
         (window <= 0 || q0 - (k0 + 15) < window);
}

// Write a warp's 16 x 16 kNK f32 fragments, times `mul`, as bf16 rows
// r0 + (0..15) of a (S, Dh) matrix with row stride `ss`.
template <int kNK>
__device__ __forceinline__ void store_rows(bf16* dst, long long ss,
                                           const float (&acc)[2 * kNK][4],
                                           float mul, int r0, int S, int Dh,
                                           int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nn = 0; nn < 2 * kNK; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = r0 + g + 8 * (e >> 1);
      const int d = nn * 8 + 2 * t + (e & 1);
      if (s < S && d < Dh) {
        dst[s * ss + d] = from_f32<bf16>(acc[nn][e] * mul);
      }
    }
  }
}

// ---------------------------------------------- 1 and 3: rows of q --------

// One block: q rows [q0, q0 + 64) of one (batch, head); warp w owns rows
// q0 + 16 w + (0..15).  kDq false: the pre-pass (LSE and D); true: dQ.
template <int kNK, bool kDq>
__device__ __forceinline__ void q_rows(const BwdArgs& a, unsigned char* smem) {
  constexpr int kLd = row_ld<kNK>();
  constexpr int kNO = 2 * kNK;          // output n-tiles (8 dims each)
  constexpr int kStage = 2 * kTile * kLd;   // K then V lines
  bf16* Qs = reinterpret_cast<bf16*>(smem);        // [kTile][kLd]
  bf16* dOs = Qs + kTile * kLd;                    // [kTile][kLd]
  bf16* stages = dOs + kTile * kLd;                // [2][K|V][kTile][kLd]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / a.G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int S = a.S;
  const int Dh = a.Dh;
  const int r0 = q0 + 16 * warp;

  const bf16* q = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* k = a.k + b * a.k_sb + kh * a.k_sh;
  const bf16* v = a.v + b * a.v_sb + kh * a.v_sh;
  const bf16* dout = a.dout + b * a.do_sb + h * a.do_sh;
  const long long row_stat = (static_cast<long long>(b) * a.H + h) * S;

  zero_pad<kNK>(Qs, 6 * kTile, Dh, tid);

  // kv range of this q tile (window start, causal end) in 64-line tiles
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kv_begin = lo / kTile * kTile;
  const int kv_end = min(S, q0 + kTile);
  const int n_tiles = (kv_end - kv_begin + kTile - 1) / kTile;
  auto issue = [&](int it, int st) {
    if (it < n_tiles) {
      const int s0 = kv_begin + it * kTile;
      bf16* kd = stages + st * kStage;
      load_tile(kd, kLd, k, a.k_ss, s0, kTile, S, Dh, tid);
      load_tile(kd + kTile * kLd, kLd, v, a.v_ss, s0, kTile, S, Dh, tid);
    }
    cp_async_commit();
  };

  load_tile(Qs, kLd, q, a.q_ss, q0, kTile, S, Dh, tid);
  load_tile(dOs, kLd, dout, a.do_ss, q0, kTile, S, Dh, tid);
  cp_async_commit();
  issue(0, 0);
  cp_async_wait<1>();                   // this thread's q and dO pieces
  __syncthreads();                      // everyone's, and the zeros

  // the warp's 16 q rows (and dO rows) as A fragments, for the whole walk
  unsigned qf[kNK][4];
  load_a<kNK>(qf, Qs + 16 * warp * kLd, lane);
  unsigned df[kDq ? kNK : 1][4];
  if constexpr (kDq) {
    load_a<kNK>(df, dOs + 16 * warp * kLd, lane);
  }

  const int g = lane >> 2;              // fragment row (and row + 8)
  const int t = lane & 3;               // fragment column pair
  const float c = a.scale * kLog2e;     // softmax in base 2
  float acc[kNO][4];                    // O (pre-pass) or dQ, f32
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] = 0.f;
    }
  }
  float m[2] = {kNegInf, kNegInf};      // pre-pass: running max (base 2)
  float l[2] = {0.f, 0.f};              // pre-pass: this lane's row sums
  float lse2[2] = {0.f, 0.f};           // dQ: LSE in base 2
  float dlt[2] = {0.f, 0.f};            // dQ: D
  if constexpr (kDq) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = r0 + g + 8 * r;
      if (s < S) {
        lse2[r] = a.lse[row_stat + s] * kLog2e;
        dlt[r] = a.delta[row_stat + s];
      }
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    issue(it + 1, (it + 1) & 1);
    cp_async_wait<1>();
    __syncthreads();                    // tile it has landed, for all
    const bf16* kt = stages + (it & 1) * kStage;
    const bf16* vt = kt + kTile * kLd;
    for (int j = 0; j < kTile / 16; ++j) {
      const int k0 = kv_begin + it * kTile + 16 * j;
      if (!any_attended(r0, k0, S, a.window)) {
        continue;
      }
      const bf16* ks = kt + 16 * j * kLd;
      const bf16* vs = vt + 16 * j * kLd;
      float sc[2][4] = {};
      mma_abt<kNK>(sc, qf, ks, lane);   // S = Q K^T
      if constexpr (!kDq) {
        // mask, running max over the quad's columns, rescale
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = r0 + g + 8 * (e >> 1);
            const int kp = k0 + nt * 8 + 2 * t + (e & 1);
            sc[nt][e] = attended(qp, kp, S, a.window) ? sc[nt][e] * c
                                                      : kNegInf;
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
        mma_xm<kNK>(acc, sc, vs, lane);     // O += P V
      } else {
        // P from the pre-pass's LSE; dP = dO V^T; dS = P (dP - D)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = r0 + g + 8 * (e >> 1);
            const int kp = k0 + nt * 8 + 2 * t + (e & 1);
            sc[nt][e] = attended(qp, kp, S, a.window)
                            ? exp2f(sc[nt][e] * c - lse2[e >> 1]) : 0.f;
          }
        }
        float dp[2][4] = {};
        mma_abt<kNK>(dp, df, vs, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[nt][e] *= dp[nt][e] - dlt[e >> 1];
          }
        }
        mma_xm<kNK>(acc, sc, ks, lane);     // dQ += dS K
      }
    }
    __syncthreads();                    // stage it & 1 free for tile it + 2
  }
  cp_async_wait<0>();

  if constexpr (kDq) {
    store_rows<kNK>(a.dq + b * a.dq_sb + h * a.dq_sh, a.dq_ss, acc, a.scale,
                    r0, S, Dh, lane);
  } else {
    // O = acc / l in f32; D = dO . O and the LSE, per row
    const bf16* drows = dOs + 16 * warp * kLd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / l[r];
      float dsum = 0.f;
#pragma unroll
      for (int nn = 0; nn < kNO; ++nn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = nn * 8 + 2 * t + e;
          dsum = fmaf(acc[nn][2 * r + e] * inv,
                      to_f32(drows[(g + 8 * r) * kLd + d]), dsum);
        }
      }
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      const int s = r0 + g + 8 * r;
      if (t == 0 && s < S) {
        a.lse[row_stat + s] = (m[r] + log2f(l[r])) * kLn2;
        a.delta[row_stat + s] = dsum;
      }
    }
  }
}

template <int kNK>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_pre_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char pre_smem[];
  q_rows<kNK, false>(a, pre_smem);
}

template <int kNK>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char dq_smem[];
  q_rows<kNK, true>(a, dq_smem);
}

// ---------------------------------------------- 2: lines of k and v -------

// One block: kv lines [k0, k0 + 64) of one (batch, kv head); warp w owns
// lines k0 + 16 w + (0..15).  The block streams the q rows, dO rows, LSE
// and D of each of the kv head's G q heads, q tiles from the diagonal to
// the causal / window limit.
template <int kNK>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(BwdArgs a) {
  constexpr int kLd = row_ld<kNK>();
  constexpr int kNO = 2 * kNK;
  constexpr int kStage = 2 * kTile * kLd;   // q then dO rows
  extern __shared__ __align__(16) unsigned char dkdv_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(dkdv_smem);   // [kTile][kLd]
  bf16* Vs = Ks + kTile * kLd;                     // [kTile][kLd]
  bf16* stages = Vs + kTile * kLd;                 // [2][Q|dO][kTile][kLd]
  float* stats = reinterpret_cast<float*>(stages + 2 * kStage);
                                                   // [2][LSE2|D][kTile]

  const int k0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int S = a.S;
  const int Dh = a.Dh;
  const int kw0 = k0 + 16 * warp;

  const bf16* k = a.k + b * a.k_sb + kh * a.k_sh;
  const bf16* v = a.v + b * a.v_sb + kh * a.v_sh;

  zero_pad<kNK>(Ks, 6 * kTile, Dh, tid);

  // q range of this kv tile (causal start, window end) in 64-row tiles,
  // for each of the G q heads
  const int q_end = a.window > 0 ? min(S, k0 + kTile - 1 + a.window) : S;
  const int n_qt = (q_end - k0 + kTile - 1) / kTile;
  const int n_it = a.G * n_qt;
  auto issue = [&](int it, int st) {
    if (it < n_it) {
      const int h = kh * a.G + it / n_qt;
      const int s0 = k0 + (it % n_qt) * kTile;
      bf16* qd = stages + st * kStage;
      load_tile(qd, kLd, a.q + b * a.q_sb + h * a.q_sh, a.q_ss, s0, kTile, S,
                Dh, tid);
      load_tile(qd + kTile * kLd, kLd, a.dout + b * a.do_sb + h * a.do_sh,
                a.do_ss, s0, kTile, S, Dh, tid);
      const long long row_stat = (static_cast<long long>(b) * a.H + h) * S;
      float* st_stats = stats + st * 2 * kTile;
      for (int i = tid; i < 2 * kTile; i += kThreads) {
        const int s = s0 + (i & (kTile - 1));
        float x = 0.f;
        if (s < S) {
          x = i < kTile ? a.lse[row_stat + s] * kLog2e
                        : a.delta[row_stat + s];
        }
        st_stats[i] = x;
      }
    }
    cp_async_commit();
  };

  load_tile(Ks, kLd, k, a.k_ss, k0, kTile, S, Dh, tid);
  load_tile(Vs, kLd, v, a.v_ss, k0, kTile, S, Dh, tid);
  cp_async_commit();
  issue(0, 0);

  const int g = lane >> 2;
  const int t = lane & 3;
  const float c = a.scale * kLog2e;
  const bf16* kw = Ks + 16 * warp * kLd;
  const bf16* vw = Vs + 16 * warp * kLd;
  float dk[kNO][4];
  float dv[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }
  }

  for (int it = 0; it < n_it; ++it) {
    issue(it + 1, (it + 1) & 1);
    cp_async_wait<1>();
    __syncthreads();                    // q tile it (and K, V) landed
    const bf16* qt = stages + (it & 1) * kStage;
    const bf16* dot = qt + kTile * kLd;
    const float* lse2 = stats + (it & 1) * 2 * kTile;
    const float* dlt = lse2 + kTile;
    const int qt0 = k0 + (it % n_qt) * kTile;
    for (int j = 0; j < kTile / 16; ++j) {
      const int q0 = qt0 + 16 * j;
      if (!any_attended(q0, kw0, S, a.window)) {
        continue;
      }
      const bf16* qs = qt + 16 * j * kLd;
      const bf16* dos = dot + 16 * j * kLd;
      // S^T = K Q^T; P^T = exp(S^T - LSE), by q column
      float sc[2][4] = {};
      mma_abt_shared<kNK>(sc, kw, qs, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * j + nt * 8 + 2 * t + (e & 1);
          const int kp = kw0 + g + 8 * (e >> 1);
          sc[nt][e] = attended(qt0 + col, kp, S, a.window)
                          ? exp2f(sc[nt][e] * c - lse2[col]) : 0.f;
        }
      }
      mma_xm<kNK>(dv, sc, dos, lane);   // dV += P^T dO
      // dP^T = V dO^T; dS^T = P^T (dP^T - D)
      float dp[2][4] = {};
      mma_abt_shared<kNK>(dp, vw, dos, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * j + nt * 8 + 2 * t + (e & 1);
          sc[nt][e] *= dp[nt][e] - dlt[col];
        }
      }
      mma_xm<kNK>(dk, sc, qs, lane);    // dK += dS^T Q
    }
    __syncthreads();                    // stage it & 1 free for tile it + 2
  }
  cp_async_wait<0>();

  store_rows<kNK>(a.dk + b * a.dk_sb + kh * a.dk_sh, a.dk_ss, dk, a.scale,
                  kw0, S, Dh, lane);
  store_rows<kNK>(a.dv + b * a.dv_sb + kh * a.dv_sh, a.dv_ss, dv, 1.f, kw0,
                  S, Dh, lane);
}

template <int kNK>
cudaError_t launch_all(const BwdArgs& a, int B, int K, cudaStream_t stream) {
  const auto pre = attn_bwd_pre_kernel<kNK>;
  const auto dkdv = attn_bwd_dkdv_kernel<kNK>;
  const auto dq = attn_bwd_dq_kernel<kNK>;
  const size_t smem = smem_bytes<kNK>();
  const int n_tiles = (a.S + kTile - 1) / kTile;
  cudaError_t err = allow_smem(pre, smem);
  if (err == cudaSuccess) {
    err = allow_smem(dkdv, smem);
  }
  if (err == cudaSuccess) {
    err = allow_smem(dq, smem);
  }
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 q_grid(n_tiles, a.H, B);
  const dim3 kv_grid(n_tiles, K, B);
  pre<<<q_grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  dkdv<<<kv_grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return err;
  }
  dq<<<q_grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q, dout: (B, S, H, Dh); k, v: (B, S, K, Dh); dq, dk, dv of the same
// shapes; all bfloat16 with unit stride on Dh, strides in elements.  q, k,
// v and dout are read with 16-byte copies: their base pointers and strides
// must be multiples of 16 bytes.  lse, delta: (B, H, S) float32 scratch,
// written by the pre-pass (lse of the logits times `scale`, D = dO . O)
// and read by the two gradient kernels.  Returns the CUDA error of the
// launches (0 = success).
extern "C" int repro_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, void* lse, void* delta, int B, int S, int H, int K,
    int Dh, int window, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh, long long dv_sb,
    long long dv_ss, long long dv_sh, float scale, void* stream) {
  using namespace repro;
  if (Dh < 1 || Dh > kMaxDh || K < 1 || H % K != 0 || S < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.S = S;
  a.H = H;
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
  a.do_sb = do_sb;
  a.do_ss = do_ss;
  a.do_sh = do_sh;
  a.dq_sb = dq_sb;
  a.dq_ss = dq_ss;
  a.dq_sh = dq_sh;
  a.dk_sb = dk_sb;
  a.dk_ss = dk_ss;
  a.dk_sh = dk_sh;
  a.dv_sb = dv_sb;
  a.dv_ss = dv_ss;
  a.dv_sh = dv_sh;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Dh <= 64) {
    err = launch_all<4>(a, B, K, st);
  } else if (Dh <= 80) {
    err = launch_all<5>(a, B, K, st);
  } else {
    err = launch_all<8>(a, B, K, st);
  }
  return static_cast<int>(err);
}
