// Mamba-2 SSD chunked scan for Hopper, sm_90a: the chunk-parallel form.
//
// Replaces the TPU kernel `ssd_scan_bhsp` (src/repro/kernels/ssd_scan.py,
// body `_ssd_kernel`).  Per chunk of Q tokens, with cs = cumsum(a) inside
// the chunk (a = dt * A):
//   y[q, p] = sum_{k <= q} (C[q] . B[k]) exp(cs[q] - cs[k]) dt[k] x[k, p]
//           + exp(cs[q]) sum_n C[q, n] S_in[p, n]
//   S_in of chunk c+1 = S_in of chunk c * exp(cs[Q-1]) + dS of chunk c,
//   dS[p, n] = sum_k x[k, p] exp(cs[Q-1] - cs[k]) dt[k] B[k, n]
// with the (P, N) state in f32.
//
// What bounds it on the card: at the training shape (x (2, 2048, 48, 64),
// N 128, Q 256, bf16) the function moves ~53 MB (x, dt, A, B, C read once,
// y written once), 0.016 ms at 3.35 TB/s, and needs ~9.8 GFLOP over the
// causal pairs k <= q (C . B^T once per chunk, shared by the heads), 0.010
// ms at the bf16 tensor-core rate, so bytes bound it.
//
// Design: the hardware-efficient decomposition of Dao & Gu, "Transformers
// are SSMs" (arXiv:2405.21060, section 7).  The TPU grid carried the state
// through a sequential chunk axis; here every chunk runs in parallel and
// only a short pass over the chunks is sequential.  One call makes four
// launches, on the caller's stream, into f32 scratch the wrapper allocates:
//   1. `cb_kernel`: C . B^T once per (batch, chunk), shared by the heads, in
//      64 x 64 tiles at or below the diagonal -> cb (B, nc, Q, Q).
//   2. `chunk_state_kernel`, one block of 8 warps per (batch, chunk, head,
//      64-column P tile): cs by a block scan -> cs (B, nc, H, 2, Q) with a
//      compact copy of dt, then the chunk's own final state dS -> ds (B,
//      nc, H, P, N), its x and B tiles double-buffered, B scaled by w and
//      split into hi and lo in shared memory once it has landed.
//   3. `state_pass_kernel`: per (batch, head, 8 state elements) the walk
//      over the chunks, its loads issued 4 chunks at a time, writing the
//      state entering each chunk -> sin (B, nc, H, P, N): for bf16 inputs
//      already split into its hi and lo bf16 terms.
//   4. `chunk_out_kernel`, one block of 4 warps per (batch, chunk, head,
//      64-row q tile, 64-column P tile), each warp 16 q rows: the state's
//      term from C and S_in tiles copied at the block's start, then the k
//      tiles at or below the q tile, double-buffered over the state's
//      tiles; y in x's dtype.
// At the training shape launch 2 runs 768 blocks (3 per SM at a time) and
// launch 4 runs 3,072 (4 per SM at a time).  Exact copies go by 16-byte
// `cp.async` (16-byte aligned rows; element copies otherwise).  Measured
// on an H100 (PERF.md), the launches are bound by their load latency and
// their per-tile barriers, not by the tensor cores: the products of
// launch 4 run at under a tenth of the card's bf16 tensor rate.
//
// Products: bf16 on the tensor cores (`mma.sync` m16n8k16 with f32
// accumulators, operands through `ldmatrix`), each operand that comes from
// the inputs kept exact and every f32 factor put on the other side of the
// product as two bf16 terms, hi + lo (16 bits of mantissa where one bf16
// keeps 8); every hi product of a step is issued before its lo products,
// so no product waits on the one before it:
//   - C . B^T: both exact.
//   - dS: x exact against w[k] B[k, n], w = exp(cs[Q-1] - cs[k]) dt[k].
//   - y's state term: C exact against S_in (hi + lo), then exp(cs[q]) in f32.
//   - y's chunk term: x exact against W = (C . B^T) exp(cs[q] - cs[k]) dt[k]
//     (hi + lo), built in registers in the A-fragment layout.
// Decays are taken only where k <= q, as factors that are all <= 1: below
// the diagonal tile through the rows between k and q (one exp per row and
// per column), on it one exp per pair with the exponent <= 0; so no inf *
// 0 can appear.  The cumsum and every sum are f32.  f32 inputs take the
// same launches with the products as f32 FMAs (no TF32).  The model layouts
// (B, S, H, P), (B, S, H) and (B, S, N) are read through strides.

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;           // 4 warps: cb, chunk_out, pass
constexpr int kThreadsCs = 256;         // 8 warps: chunk_state
constexpr int kT = 64;                  // rows of a q, k or P tile
constexpr int kMaxN = 128;
constexpr int kMaxQ = 4096;
constexpr int kPassBatch = 4;           // chunks whose loads the pass issues
                                        // at once

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* Bm;
  const void* Cm;
  void* y;
  float* cs;                            // (B, nc, H, 2, Q) cumsum of a,
                                        // then dt
  float* cb;                            // (B, nc, Q, Q) C . B^T, k <= q
  float* ds;                            // (B, nc, H, P, N) dS
  void* sin;                            // (B, nc, H, P, N) S_in: f32, or
                                        // bf16 hi then lo (P*N each)
  int H, P, N, Q, nc;
  int Np;                               // N rounded up to 16
  int x_vec, bc_vec, s_vec;             // 16-byte rows of x, B/C, S_in
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long a_sb, a_ss, a_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
};

template <typename T>
constexpr bool kBf16 = sizeof(T) == 2;

// Row length of a shared tile `width` wide: 16-byte rows, and for bf16 an
// odd number of 16-byte units, so the 8 rows of an `ldmatrix` hit 8
// different bank groups.
template <typename T>
__host__ __device__ constexpr int tile_ld(int width) {
  return sizeof(T) == 2 ? width + 8 : width + 4;
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Rows [0, kT) x columns [0, width) of a shared tile (row r at dst + r *
// ld) as an exact copy of rows r < nr of a source (row r at src + r *
// ld_src, columns < n live), zeros elsewhere: 16-byte `cp.async` where
// `vec` (source rows 16-byte aligned) and a piece is whole, element copies
// elsewhere.  The caller commits and waits.
template <int kN, typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src,
                                          long long ld_src, int nr, int n,
                                          int width, bool vec) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const int pieces = width / kPer;
  for (int i = threadIdx.x; i < kT * pieces; i += kN) {
    const int r = i / pieces;
    const int c = (i - r * pieces) * kPer;
    T* d = dst + r * ld + c;
    const T* s = src + r * ld_src + c;
    if (r < nr && vec && c + kPer <= n) {
      cp_async_16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        d[e] = r < nr && c + e < n ? s[e] : from_f32<T>(0.f);
      }
    }
  }
}

// 8 elements at p (16-byte aligned) as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = lo.z;
  v[3] = lo.w;
  v[4] = hi.x;
  v[5] = hi.y;
  v[6] = hi.z;
  v[7] = hi.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* hi, __nv_bfloat16* lo,
                                       const float (&v)[8]) {
  uint4 h;
  uint4 l;
  split_bf16x2(v[0], v[1], h.x, l.x);
  split_bf16x2(v[2], v[3], h.y, l.y);
  split_bf16x2(v[4], v[5], h.z, l.z);
  split_bf16x2(v[6], v[7], h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

__device__ __forceinline__ void store8(float* dst, float*,
                                       const float (&v)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// The A fragment of the 16 x 16 bf16 tile at `base` (rows `ld` elements
// apart): stored [m][k], or [k][m] with kTrans.
template <bool kTrans>
__device__ __forceinline__ void frag_a(unsigned (&r)[4],
                                       const __nv_bfloat16* base, int ld) {
  const int l = threadIdx.x & 31;
  const int i = l >> 3;
  const int j = l & 7;
  if (kTrans) {
    ldmatrix_x4_trans(r, base + (j + 8 * (i >> 1)) * ld + 8 * (i & 1));
  } else {
    ldmatrix_x4(r, base + (j + 8 * (i & 1)) * ld + 8 * (i >> 1));
  }
}

// The B fragments of the two 8-column tiles of the 16 x 16 bf16 tile at
// `base`: stored [n][k], or [k][n] with kTrans; r[0..1] hold columns 0-7,
// r[2..3] columns 8-15.
template <bool kTrans>
__device__ __forceinline__ void frag_b2(unsigned (&r)[4],
                                        const __nv_bfloat16* base, int ld) {
  const int l = threadIdx.x & 31;
  const int i = l >> 3;
  const int j = l & 7;
  if (kTrans) {
    ldmatrix_x4_trans(r, base + (j + 8 * (i & 1)) * ld + 8 * (i >> 1));
  } else {
    ldmatrix_x4(r, base + (j + 8 * (i >> 1)) * ld + 8 * (i & 1));
  }
}

// acc0, acc1 += a * the two column tiles of b (frag_b2's layout)
__device__ __forceinline__ void mma_pair(float (&acc0)[4], float (&acc1)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[4]) {
  mma_16816(acc0, a, b[0], b[1]);
  mma_16816(acc1, a, b[2], b[3]);
}

// -------------------------------------------------- 1. C . B^T per chunk ----

template <typename T>
size_t cb_smem_bytes(int Np) {
  return 2 * static_cast<size_t>(kT) * tile_ld<T>(Np) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cb_kernel(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char cb_smem[];
  int t = blockIdx.x;                   // tile (qt, kt), kt <= qt, row-major
  int qt = 0;
  while (t > qt) {
    t -= qt + 1;
    ++qt;
  }
  const int kt = t;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kT;
  const int k0 = kt * kT;
  const int nq = min(kT, a.Q - q0);
  const int nk = min(kT, a.Q - k0);
  const long long s0 = static_cast<long long>(c) * a.Q;
  const int ld = tile_ld<T>(a.Np);
  T* Cs = reinterpret_cast<T*>(cb_smem);  // [kT][ld] C rows q
  T* Bs = Cs + kT * ld;                   // [kT][ld] B rows k
  copy_tile<kThreads>(Cs, ld,
                      static_cast<const T*>(a.Cm) + b * a.c_sb +
                          (s0 + q0) * a.c_ss,
                      a.c_ss, nq, a.N, a.Np, a.bc_vec);
  copy_tile<kThreads>(Bs, ld,
                      static_cast<const T*>(a.Bm) + b * a.b_sb +
                          (s0 + k0) * a.b_ss,
                      a.b_ss, nk, a.N, a.Np, a.bc_vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* cb = a.cb + (static_cast<long long>(b) * a.nc + c) * a.Q * a.Q +
              static_cast<long long>(q0) * a.Q + k0;
  const int tid = threadIdx.x;
  if constexpr (kBf16<T>) {
    const int w = tid >> 5;
    const int g = (tid & 31) >> 2;
    const int t4 = tid & 3;
    float acc[8][4] = {};
    for (int ks = 0; ks < a.Np; ks += 16) {
      unsigned af[4];
      frag_a<false>(af, Cs + 16 * w * ld + ks, ld);
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        unsigned bf[4];
        frag_b2<false>(bf, Bs + 16 * j2 * ld + ks, ld);
        mma_pair(acc[2 * j2], acc[2 * j2 + 1], af, bf);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 16 * w + g + 8 * (e >> 1);
        const int k = 8 * j + 2 * t4 + (e & 1);
        if (q < nq && k < nk) {
          cb[static_cast<long long>(q) * a.Q + k] = acc[j][e];
        }
      }
    }
  } else {
    const int tx = tid & 15;            // columns k = tx + 16 j
    const int ty = tid >> 4;            // rows q = ty + 8 i
    float acc[8][4] = {};
    for (int n = 0; n < a.N; ++n) {
      float cv[8];
      float bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        cv[i] = Cs[(ty + 8 * i) * ld + n];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bv[j] = Bs[(tx + 16 * j) * ld + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = ty + 8 * i;
        const int k = tx + 16 * j;
        if (q < nq && k < nk) {
          cb[static_cast<long long>(q) * a.Q + k] = acc[i][j];
        }
      }
    }
  }
}

// ------------------------------------- 2. cs and each chunk's own state ----

// css[i] = src[0] + ... + src[i] (src at stride s) for i < n: a block scan,
// kN values at a time; each round also copies other[i * so] to oth[i], its
// load in flight with src's.  red: kN / 32 floats of scratch.
template <int kN>
__device__ void block_cumsum(float* css, const float* src, long long s,
                             int n, float* red, const float* other,
                             long long so, float* oth) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < n; base += kN) {
    const int i = base + tid;
    float v = i < n ? src[i * s] : 0.f;
    const float o = i < n ? other[i * so] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) {
        v += u;
      }
    }
    if (lane == 31) {
      red[warp] = v;
    }
    __syncthreads();
    float off = carry;
    float total = carry;
    for (int w = 0; w < kN / 32; ++w) {
      const float r = red[w];
      off += w < warp ? r : 0.f;
      total += r;
    }
    if (i < n) {
      css[i] = v + off;
      oth[i] = o;
    }
    carry = total;
    __syncthreads();                    // red is rewritten next round
  }
}

template <typename T>
size_t chunk_state_smem_bytes(int Np, int Q) {
  const size_t b_tile = static_cast<size_t>(kT) * tile_ld<T>(Np) * sizeof(T);
  return 2 * static_cast<size_t>(kT) * tile_ld<T>(kT) * sizeof(T)  // x, 2
         + 2 * b_tile                     // B as loaded, then w B (hi), 2
         + (kBf16<T> ? b_tile : 0)        // w B lo
         + sizeof(float) * (2 * round_up(Q, 4) + kThreadsCs / 32);  // ws
}

template <typename T>
__global__ void __launch_bounds__(kThreadsCs, 3)
    chunk_state_kernel(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char cs_smem[];
  const int n_pt = (a.P + kT - 1) / kT;
  const int pt = blockIdx.x % n_pt;
  const int c = blockIdx.x / n_pt;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int p0 = pt * kT;
  const int pn = min(kT, a.P - p0);
  const int Q = a.Q;
  const long long s0 = static_cast<long long>(c) * Q;
  const int ldx = tile_ld<T>(kT);
  const int ldb = tile_ld<T>(a.Np);
  T* Xs = reinterpret_cast<T*>(cs_smem);  // [2][kT][ldx] x rows k, P cols
  T* Bs = Xs + 2 * kT * ldx;              // [2][kT][ldb] B, then w B (hi)
  T* Bl = Bs + 2 * kT * ldb;              // [kT][ldb] w B lo (bf16)
  float* ws = reinterpret_cast<float*>(Bl + (kBf16<T> ? kT * ldb : 0));
  float* dts = ws + round_up(Q, 4);       // [Q] dt (ws: [Q] cs, then w)
  float* red = dts + round_up(Q, 4);

  const long long bch = (static_cast<long long>(b) * a.nc + c) * a.H + h;
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + p0 +
               s0 * a.x_ss;
  const T* Bm = static_cast<const T*>(a.Bm) + b * a.b_sb + s0 * a.b_ss;
  const int n_st = (Q + kT - 1) / kT;
  const auto load = [&](int st) {         // stage st's x and B, as they are
    const int k0 = st * kT;
    const int nk = min(kT, Q - k0);
    copy_tile<kThreadsCs>(Xs + (st & 1) * kT * ldx, ldx, x + k0 * a.x_ss,
                          a.x_ss, nk, pn, kT, a.x_vec);
    copy_tile<kThreadsCs>(Bs + (st & 1) * kT * ldb, ldb, Bm + k0 * a.b_ss,
                          a.b_ss, nk, a.N, a.Np, a.bc_vec);
  };
  load(0);                              // in flight during the scan
  cp_async_commit();

  block_cumsum<kThreadsCs>(ws,
                           a.a + b * a.a_sb + h * a.a_sh + s0 * a.a_ss,
                           a.a_ss, Q, red,
                           a.dt + b * a.dt_sb + h * a.dt_sh + s0 * a.dt_ss,
                           a.dt_ss, dts);
  const float cs_last = ws[Q - 1];
  __syncthreads();                      // every thread has cs_last
  float* csdt = a.cs + 2 * bch * Q;     // cs, then dt, for launches 3, 4
  for (int i = threadIdx.x; i < Q; i += kThreadsCs) {
    const float d = dts[i];
    const float v = ws[i];
    if (pt == 0) {
      csdt[i] = v;
      csdt[Q + i] = d;
    }
    ws[i] = expf(cs_last - v) * d;      // each thread its own i
  }

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
  const int pw = 32 * (w & 1);          // bf16: warp w's 32 P rows ...
  const int nw = 32 * (w >> 1);         // ... and 32 state columns
  const int tx = tid & 15;              // f32: state columns tx + 16 j
  const int ty = tid >> 4;              // f32: P rows ty + 16 i
  // bf16: acc[4 m + i][e], P rows 16 m of the warp's 32 x state column
  // tile i of its 32; f32: acc[i][j], P row ty + 16 i, state column
  // tx + 16 j
  float acc[kBf16<T> ? 8 : 4][kBf16<T> ? 4 : 8] = {};
  const int row_pieces = a.Np / 8;
  for (int st = 0; st < n_st; ++st) {
    const int k0 = st * kT;
    const int nk = min(kT, Q - k0);
    T* xs = Xs + (st & 1) * kT * ldx;
    T* bh = Bs + (st & 1) * kT * ldb;
    if (st + 1 < n_st) {
      load(st + 1);                     // into the buffers stage st-1 used
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                    // stage st landed (and w, at st 0)
    // B -> w B in place (bf16: hi in place, lo beside), each thread its own
    // 8-column pieces
    for (int i = tid; i < kT * row_pieces; i += kThreadsCs) {
      const int r = i / row_pieces;
      const int cn = (i - r * row_pieces) * 8;
      T* piece = bh + r * ldb + cn;
      float v[8];
      load8(piece, v);
      const float s = r < nk ? ws[k0 + r] : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] *= s;
      }
      store8(piece, Bl + r * ldb + cn, v);
    }
    __syncthreads();
    if constexpr (kBf16<T>) {
      if (pw < pn && nw < a.Np) {
        const bool two_m = pw + 16 < pn;     // warp-uniform
        const bool two_n = nw + 16 < a.Np;
        for (int ks = 0; ks < nk; ks += 16) {
          unsigned af[2][4];
          frag_a<true>(af[0], xs + ks * ldx + pw, ldx);
          if (two_m) {
            frag_a<true>(af[1], xs + ks * ldx + pw + 16, ldx);
          }
          unsigned bf[2][2][4];         // [hi, lo][16-column slab]
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int j2 = 0; j2 < 2; ++j2) {
              if (j2 == 0 || two_n) {
                frag_b2<true>(bf[half][j2],
                              (half ? Bl : bh) + ks * ldb + nw + 16 * j2,
                              ldb);
              }
            }
          }
          // every hi product before any lo product: none waits on the one
          // before it
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int j2 = 0; j2 < 2; ++j2) {
              if (j2 == 0 || two_n) {
                mma_pair(acc[2 * j2], acc[2 * j2 + 1], af[0], bf[half][j2]);
                if (two_m) {
                  mma_pair(acc[4 + 2 * j2], acc[4 + 2 * j2 + 1], af[1],
                           bf[half][j2]);
                }
              }
            }
          }
        }
      }
    } else {
      for (int k = 0; k < nk; ++k) {
        float xv[4];
        float bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xv[i] = xs[k * ldx + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bv[j] = tx + 16 * j < a.Np ? bh[k * ldb + tx + 16 * j] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();                    // this stage's tiles consumed
  }

  float* ds = a.ds + bch * a.P * a.N + static_cast<long long>(p0) * a.N;
  if constexpr (kBf16<T>) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pw + 16 * (i >> 2) + g + 8 * (e >> 1);
        const int n = nw + 8 * (i & 3) + 2 * t4 + (e & 1);
        if (p < pn && n < a.N) {
          ds[static_cast<long long>(p) * a.N + n] = acc[i][e];
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = ty + 16 * i;
        const int n = tx + 16 * j;
        if (p < pn && n < a.N) {
          ds[static_cast<long long>(p) * a.N + n] = acc[i][j];
        }
      }
    }
  }
}

// ------------------------------- 3. the states entering the chunks ----

// Thread e: state elements [8e, 8e + 8) of one (batch, head).  The loads
// of kPassBatch chunks are issued before the walk through them, so a
// thread has that many in flight where a plain loop had one.
template <typename T>
__global__ void __launch_bounds__(kThreads, 8) state_pass_kernel(SsdArgs a) {
  const long long PN = static_cast<long long>(a.P) * a.N;
  const long long e0 =
      8 * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
  if (e0 >= PN) {
    return;
  }
  const int live = static_cast<int>(min(8LL, PN - e0));
  const bool vec = PN % 8 == 0;         // whole, 32-byte aligned pieces
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  float s[8] = {};
  for (int c0 = 0; c0 < a.nc; c0 += kPassBatch) {
    float d[kPassBatch][8];
    float decay[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      const int c = c0 + j;
      if (c < a.nc) {
        const long long bch =
            (static_cast<long long>(b) * a.nc + c) * a.H + h;
        const float* src = a.ds + bch * PN + e0;
        if (vec) {
          load8(src, d[j]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            d[j][i] = i < live ? src[i] : 0.f;
          }
        }
        decay[j] = a.cs[2 * bch * a.Q + a.Q - 1];
      }
    }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      const int c = c0 + j;
      if (c < a.nc) {
        const long long bch =
            (static_cast<long long>(b) * a.nc + c) * a.H + h;
        if constexpr (kBf16<T>) {
          // hi and lo terms, P*N elements apart
          __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(a.sin) +
                              2 * bch * PN + e0;
          if (vec) {
            store8(hi, hi + PN, s);
          } else {
            for (int i = 0; i < live; ++i) {
              unsigned hv;
              unsigned lv;
              split_bf16x2(s[i], 0.f, hv, lv);
              hi[i] = reinterpret_cast<const __nv_bfloat162*>(&hv)->x;
              hi[PN + i] = reinterpret_cast<const __nv_bfloat162*>(&lv)->x;
            }
          }
        } else {
          float* dst = static_cast<float*>(a.sin) + bch * PN + e0;
          if (vec) {
            store8(dst, dst, s);
          } else {
            for (int i = 0; i < live; ++i) {
              dst[i] = s[i];
            }
          }
        }
        const float f = expf(decay[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] = fmaf(s[i], f, d[j][i]);
        }
      }
    }
  }
}

// ----------------------------------------------- 4. the chunk outputs ----

// The state's tiles (C rows q, S_in rows p: bf16 hi and lo, or f32) and,
// aliasing them once the state's term is done, two stages of a k tile's x
// and C . B^T tiles.
template <typename T>
__host__ __device__ constexpr int chunk_out_tiles_bytes(int Np) {
  return (kBf16<T> ? 3 : 2) * kT * tile_ld<T>(Np) * static_cast<int>(sizeof(T))
                 > 2 * (kT * tile_ld<T>(kT) * static_cast<int>(sizeof(T)) +
                        kT * tile_ld<float>(kT) * 4)
             ? (kBf16<T> ? 3 : 2) * kT * tile_ld<T>(Np) *
                   static_cast<int>(sizeof(T))
             : 2 * (kT * tile_ld<T>(kT) * static_cast<int>(sizeof(T)) +
                    kT * tile_ld<float>(kT) * 4);
}

template <typename T>
size_t chunk_out_smem_bytes(int Np, int Q) {
  return chunk_out_tiles_bytes<T>(Np) +
         sizeof(float) * (2 * round_up(Q, 4) + kT);
}

// 1-D: n floats from src to dst, 16-byte copies where `vec` (both 16-byte
// aligned).  The caller commits and waits.
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int n, bool vec) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
    if (vec && i + 4 <= n) {
      cp_async_16(dst + i, src + i);
    } else {
      for (int e = i; e < min(i + 4, n); ++e) {
        dst[e] = src[e];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_out_kernel(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char co_smem[];
  const int Q = a.Q;
  const int nq = (Q + kT - 1) / kT;
  const int n_pt = (a.P + kT - 1) / kT;
  int t = blockIdx.x;
  const int qt = nq - 1 - t % nq;       // the longest rows first
  t /= nq;
  const int pt = t % n_pt;
  const int c = t / n_pt;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kT;
  const int nqr = min(kT, Q - q0);
  const int p0 = pt * kT;
  const int pn = min(kT, a.P - p0);
  const long long s0 = static_cast<long long>(c) * Q;
  const long long bch = (static_cast<long long>(b) * a.nc + c) * a.H + h;
  const long long PN = static_cast<long long>(a.P) * a.N;
  const int ldc = tile_ld<T>(a.Np);
  const int ldx = tile_ld<T>(kT);
  const int ldw = tile_ld<float>(kT);
  const int stage_bytes = kT * ldx * static_cast<int>(sizeof(T)) +
                          kT * ldw * 4;

  // cs and dt of rows [0, q0 + nqr), dt below the q tile then replaced by
  // per-column factors; per-row factors of the q tile
  const int Qr = round_up(Q, 4);
  float* csv = reinterpret_cast<float*>(co_smem +
                                        chunk_out_tiles_bytes<T>(a.Np));
  float* dtv = csv + Qr;                // k < q0: exp(cs[end] - cs[k]) dt[k]
  float* rowb = dtv + Qr;               // [kT] exp(cs[q] - cs[q0 - 1])
  const float* csdt = a.cs + 2 * bch * Q;
  copy_floats(csv, csdt, q0 + nqr, Q % 4 == 0);
  copy_floats(dtv, csdt + Q, q0 + nqr, Q % 4 == 0);
  cp_async_commit();
  // the state's tiles, in flight with cs and dt (S_in of the first chunk
  // is 0: no state term)
  T* Cs = reinterpret_cast<T*>(co_smem);  // [kT][ldc] C rows q
  T* Sh = Cs + kT * ldc;                  // [kT][ldc] S_in rows p (hi)
  T* Sl = kBf16<T> ? Sh + kT * ldc : Sh;  // [kT][ldc] S_in lo (bf16)
  if (c > 0) {
    copy_tile<kThreads>(Cs, ldc,
                        static_cast<const T*>(a.Cm) + b * a.c_sb +
                            (s0 + q0) * a.c_ss,
                        a.c_ss, nqr, a.N, a.Np, a.bc_vec);
    const T* sin = static_cast<const T*>(a.sin) +
                   (kBf16<T> ? 2 : 1) * bch * PN +
                   static_cast<long long>(p0) * a.N;
    copy_tile<kThreads>(Sh, ldc, sin, a.N, pn, a.N, a.Np, a.s_vec);
    if constexpr (kBf16<T>) {
      copy_tile<kThreads>(Sl, ldc, sin + PN, a.N, pn, a.N, a.Np, a.s_vec);
    }
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();                      // cs, dt visible
  // A k tile wholly below the q tile (kt < qt, so it is whole) takes its
  // decays factored through the last row q0 - 1 above the q tile and the
  // last row r of the k tile, k <= r <= q0 - 1 < q:
  //   exp(cs[q] - cs[k]) dt[k] = rowb[q] * exp(cs[q0-1] - cs[r]) * dtv[k]
  // with dtv[k] = exp(cs[r] - cs[k]) dt[k]: every factor <= 1, one exp per
  // row and per column; the diagonal tile takes one exp per pair k <= q.
  for (int i = threadIdx.x; i < q0; i += kThreads) {
    dtv[i] *= expf(csv[i / kT * kT + kT - 1] - csv[i]);
  }
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    rowb[r] = qt > 0 && r < nqr ? expf(csv[q0 + r] - csv[q0 - 1]) : 0.f;
  }

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
  const int tx = tid & 15;              // f32: P columns tx + 16 j
  const int ty = tid >> 4;              // f32: q rows ty + 8 i
  float acc[8][4] = {};                 // bf16: 8 P tiles of warp w's rows
  if (c > 0) {
    cp_async_wait<0>();
    __syncthreads();                    // the state's tiles landed
    if constexpr (kBf16<T>) {
      // C exact against S_in's hi terms, then its lo terms: no product
      // waits on the one before it
      for (int ks = 0; ks < a.Np; ks += 16) {
        unsigned af[4];
        unsigned bh[4][4];
        unsigned bl[4][4];
        frag_a<false>(af, Cs + 16 * w * ldc + ks, ldc);
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          if (16 * j2 < pn) {
            frag_b2<false>(bh[j2], Sh + 16 * j2 * ldc + ks, ldc);
            frag_b2<false>(bl[j2], Sl + 16 * j2 * ldc + ks, ldc);
          }
        }
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          if (16 * j2 < pn) {
            mma_pair(acc[2 * j2], acc[2 * j2 + 1], af, bh[j2]);
          }
        }
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          if (16 * j2 < pn) {
            mma_pair(acc[2 * j2], acc[2 * j2 + 1], af, bl[j2]);
          }
        }
      }
    } else {
      for (int n = 0; n < a.N; ++n) {
        float cv[8];
        float sv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          cv[i] = Cs[(ty + 8 * i) * ldc + n];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sv[j] = Sh[(tx + 16 * j) * ldc + n];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
          }
        }
      }
    }
    // the state's term times exp(cs[q])
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = kBf16<T> ? 16 * w + g + 8 * (e >> 1) : ty + 8 * i;
        acc[i][e] *= q < nqr ? expf(csv[q0 + q]) : 0.f;
      }
    }
    __syncthreads();                    // the state's tiles consumed
  }

  // the chunk's own term over the k tiles at or below this q tile, each
  // tile's copies in flight while the one before is multiplied
  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + p0 +
               s0 * a.x_ss;
  const float* cb = a.cb + (static_cast<long long>(b) * a.nc + c) * Q * Q +
                    static_cast<long long>(q0) * Q;
  const auto load_k = [&](int kt) {
    const int k0 = kt * kT;
    const int nk = min(kT, Q - k0);
    T* xs = reinterpret_cast<T*>(co_smem + (kt & 1) * stage_bytes);
    copy_tile<kThreads>(xs, ldx, x + k0 * a.x_ss, a.x_ss, nk, pn, kT,
                        a.x_vec);
    copy_tile<kThreads>(reinterpret_cast<float*>(xs + kT * ldx), ldw,
                        cb + k0, Q, nqr, nk, kT, Q % 4 == 0);
  };
  load_k(0);
  cp_async_commit();
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kT;
    if (kt < qt) {
      load_k(kt + 1);                   // into the stage tile kt-1 used
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                    // tile kt landed
    const T* xs = reinterpret_cast<const T*>(co_smem + (kt & 1) * stage_bytes);
    float* wt = reinterpret_cast<float*>(const_cast<T*>(xs) + kT * ldx);
    const bool diag = kt == qt;
    const float tau = diag ? 0.f : expf(csv[q0 - 1] - csv[k0 + kT - 1]);
    // W[q, k] = (C . B^T)[q, k] exp(cs[q] - cs[k]) dt[k], k <= q, at tile
    // row qi and column kj; 0 past the live rows
    const auto wv = [&](int qi, int kj) {
      const float cbv = wt[qi * ldw + kj];
      if (!diag) {
        return cbv * (rowb[qi] * tau) * dtv[k0 + kj];
      }
      return kj <= qi && qi < nqr
                 ? cbv * expf(csv[q0 + qi] - csv[k0 + kj]) * dtv[k0 + kj]
                 : 0.f;
    };
    if constexpr (kBf16<T>) {
      const int qa = 16 * w + g;
      const int qb = qa + 8;
      for (int ks = 0; ks < kT && k0 + ks <= q0 + 16 * w + 15; ks += 16) {
        unsigned bf[4][4];
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          if (16 * j2 < pn) {
            frag_b2<true>(bf[j2], xs + ks * ldx + 16 * j2, ldx);
          }
        }
        const int kk = ks + 2 * t4;
        unsigned ah[4];
        unsigned al[4];
        split_bf16x2(wv(qa, kk), wv(qa, kk + 1), ah[0], al[0]);
        split_bf16x2(wv(qb, kk), wv(qb, kk + 1), ah[1], al[1]);
        split_bf16x2(wv(qa, kk + 8), wv(qa, kk + 9), ah[2], al[2]);
        split_bf16x2(wv(qb, kk + 8), wv(qb, kk + 9), ah[3], al[3]);
        // x exact against W's hi terms, then its lo terms
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          if (16 * j2 < pn) {
            mma_pair(acc[2 * j2], acc[2 * j2 + 1], ah, bf[j2]);
          }
        }
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          if (16 * j2 < pn) {
            mma_pair(acc[2 * j2], acc[2 * j2 + 1], al, bf[j2]);
          }
        }
      }
    } else {
      const int nk = min(kT, Q - k0);
      for (int i = tid; i < kT * kT; i += kThreads) {
        const int qi = i / kT;
        const int kj = i - qi * kT;
        const float v = wv(qi, kj);
        wt[qi * ldw + kj] = v;        // each element read and written here
      }
      __syncthreads();
      for (int k = 0; k < nk; ++k) {
        float wq[8];
        float xv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          wq[i] = wt[(ty + 8 * i) * ldw + k];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xv[j] = xs[k * ldx + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(wq[i], xv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();                    // tile kt consumed
  }

  T* y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + p0 +
         (s0 + q0) * a.y_ss;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int q;
      int p;
      if constexpr (kBf16<T>) {
        q = 16 * w + g + 8 * (e >> 1);  // acc[i]: P tile i
        p = 8 * i + 2 * t4 + (e & 1);
      } else {
        q = ty + 8 * i;
        p = tx + 16 * e;
      }
      if (q < nqr && p < pn) {
        y[q * a.y_ss + p] = from_f32<T>(acc[i][e]);
      }
    }
  }
}

// ----------------------------------------------------------- launches ----

bool aligned16(const void* p, long long s0, long long s1, int elem_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (s0 * elem_bytes) % 16 == 0 && (s1 * elem_bytes) % 16 == 0;
}

template <typename T>
cudaError_t launch(const SsdArgs& a, int B, cudaStream_t stream) {
  const int nq = (a.Q + kT - 1) / kT;
  const int n_pt = (a.P + kT - 1) / kT;
  cudaError_t err;

  const size_t cb_smem = cb_smem_bytes<T>(a.Np);
  if ((err = allow_smem(cb_kernel<T>, cb_smem)) != cudaSuccess) {
    return err;
  }
  cb_kernel<T><<<dim3(nq * (nq + 1) / 2, a.nc, B), kThreads, cb_smem,
                 stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) {
    return err;
  }

  const size_t cs_smem = chunk_state_smem_bytes<T>(a.Np, a.Q);
  if ((err = allow_smem(chunk_state_kernel<T>, cs_smem)) != cudaSuccess) {
    return err;
  }
  chunk_state_kernel<T><<<dim3(n_pt * a.nc, a.H, B), kThreadsCs, cs_smem,
                          stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) {
    return err;
  }

  const long long pieces = (static_cast<long long>(a.P) * a.N + 7) / 8;
  state_pass_kernel<T><<<dim3(static_cast<unsigned>((pieces + kThreads - 1) /
                                                    kThreads),
                              a.H, B),
                         kThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) {
    return err;
  }

  const size_t co_smem = chunk_out_smem_bytes<T>(a.Np, a.Q);
  if ((err = allow_smem(chunk_out_kernel<T>, co_smem)) != cudaSuccess) {
    return err;
  }
  chunk_out_kernel<T><<<dim3(nq * n_pt * a.nc, a.H, B), kThreads, co_smem,
                        stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x: (B, S, H, P) and Bm/Cm: (B, S, N) of `dtype` (0 = float32,
// 1 = bfloat16), unit stride on P and N; dt, a = dt * A: (B, S, H) float32;
// y: (B, S, H, P) of `dtype`, unit stride on P.  Q is the chunk, S % Q == 0,
// nc = S / Q.  Scratch, f32: cs B*nc*H*2*Q, cb B*nc*Q*Q, ds and sin
// B*nc*H*P*N floats each, 16-byte aligned.  Strides in elements.  Four
// launches on `stream`; returns the CUDA error of the first that failed
// (0 = success).
extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* a, const void* Bm,
    const void* Cm, void* y, void* cs, void* cb, void* ds, void* sin,
    int dtype, int B, int S, int H, int P, int N, int Q, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long a_sb, long long a_ss, long long a_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  using namespace repro;
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535 || P < 1 || N < 1 ||
      N > kMaxN || Q < 1 || Q > kMaxQ || S % Q != 0 || S / Q > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int esz = dtype == kFloat32 ? 4 : 2;
  SsdArgs args;
  args.x = x;
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.Bm = Bm;
  args.Cm = Cm;
  args.y = y;
  args.cs = static_cast<float*>(cs);
  args.cb = static_cast<float*>(cb);
  args.ds = static_cast<float*>(ds);
  args.sin = sin;
  args.H = H;
  args.P = P;
  args.N = N;
  args.Q = Q;
  args.nc = S / Q;
  args.Np = round_up(N, 16);
  args.x_vec = aligned16(x, x_sb, x_ss, esz) && (x_sh * esz) % 16 == 0;
  args.bc_vec = aligned16(Bm, b_sb, b_ss, esz) &&
                aligned16(Cm, c_sb, c_ss, esz);
  args.s_vec = (N * esz) % 16 == 0;
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
    err = launch<float>(args, B, st);
  } else if (dtype == kBFloat16) {
    err = launch<__nv_bfloat16>(args, B, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
