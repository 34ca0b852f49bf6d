// Single-query GQA decode attention for Hopper, sm_90a: a dense KV cache
// (with the sliding-window ring mode) and a paged KV pool, one kernel body
// for both.
//
// Replaces the TPU kernels `flash_decode_bkgd` (body `_decode_kernel`) and
// `flash_decode_paged_bkgd` (body `_paged_decode_kernel`) of
// src/repro/kernels/flash_decode.py: one query per sequence against its
// live KV lines, all G query heads of a kv group served from each K/V line
// loaded, the ring mask `slot_pos = pos - ((pos - i) mod S)` under a
// window, and, for the pool, logical line j resolved through
// `page_table[b, j / page_size]`.
//
// What bounds it on the card: bytes.  Each live K/V line is read once and
// used for 2*G*Dh flops per tensor, far below the ~295 flops per byte the
// H100 needs before its compute is the limit.
//
// Split-KV (`split_decode_kernel<TQ, TKV, kPaged>`), as the TPU kernels
// were.  The grid is (splits, kv heads, sequences); one block of 4 warps
// owns a run of `chunk` lines of one (sequence, kv head).  The split length
// comes from shapes only (kernels/flash_decode.py::split_plan over the
// cache's slots, or the table's n_pages * page_size lines, aiming at ~4
// blocks per SM: a decode step of 4 sequences x 32 kv heads over 512 lines
// runs 512 blocks where one block per (sequence, kv head) ran 128); a
// block whose run lies wholly past min(pos_b + 1, lines) exits without
// reading anything and is left out of the combine.  The two layouts differ
// only in where line j of sequence b lives: the dense cache at (b, j), the
// pool at (page_table[b, j / page_size], j % page_size).  A paged block
// first reads the table entries of its run into shared memory (there is no
// scalar prefetch on the card), so each line's page is resolved from there;
// lines past pos_b, hence the null page (0) that tables hold past it, are
// never read.  A block copies its lines in 32-line tiles with 16-byte
// `cp.async` (8 bf16 or 4 f32 a copy, a scalar tail where Dh does not fill
// 16 bytes) into a double-buffered shared tile, so the next tile is in
// flight while this one is scored.  Four lanes score one line for all G
// heads of the group (each lane a quarter of the 16-byte pieces of the
// line, then two shuffles), a warp per head runs the f32 online softmax
// over the tile, and each thread accumulates P.V for (head, dim) pairs.
// The block then writes its f32 partial (unnormalised o, running max m,
// sum l) to scratch the wrapper allocated; the last block of a (sequence,
// kv head) to finish, told by an atomic counter after a `__threadfence`,
// combines the partials as the JAX wrapper does (rescale to the global
// max, divide by the summed l, 1 where that sum is 0), writes o and resets
// the counter.  One launch a call, nothing allocated by the kernel,
// nothing read back by the host: the counters are zeroed once by the
// wrapper and left at zero by every launch, so the launch can sit inside a
// CUDA graph.  A sequence with a single live split writes o directly.  Two
// other layouts measured no faster on the H100 (PERF.md): lanes that each
// keep their own lines' softmax and P.V in registers, merged once per
// block or once per warp.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kTile = 32;               // kv lines per tile (= warp size)

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* pos;                       // (B,)
  const int* page_table;                // (B, n_pages); paged only
  int G, Dh;
  int slots;                            // dense: cache slots; paged:
                                        // n_pages * page_size
  int window;                           // dense ring window, <= 0: none
  int page_size;                        // paged only
  long long pt_stride;                  // paged only
  long long q_sb, q_sh;                 // q (B, 1, H, Dh)
  long long k_s0, k_s1, k_sh;           // dense (b, slot) / paged (page,
  long long v_s0, v_s1, v_sh;           // offset), then kv head
  long long o_sb, o_sh;                 // o (B, 1, H, Dh)
  float scale;
  int chunk;                            // lines per split
  float* part;                          // f32 partials: o (B, K, splits,
                                        // G, Dh), then m and l (B, K,
                                        // splits, 2, G)
  int* counter;                         // (B, K) finished splits, zero at
                                        // rest
};

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kLanesPerLine = 4;        // lanes scoring one line
static_assert(kSplitThreads / kLanesPerLine == kTile,
              "one 4-lane group per line of a tile");

// Head width rounded up to whole 16-byte pieces of T.
__host__ __device__ inline int padded_dh(int Dh, int elem_bytes) {
  const int per = 16 / elem_bytes;
  return (Dh + per - 1) / per * per;
}

// Table entries a run of `chunk` lines can touch: its first line may sit
// anywhere in a page.
__host__ __device__ inline int run_pages(int chunk, int page_size) {
  return (chunk + page_size - 1) / page_size + 1;
}

size_t split_smem_bytes(int G, int Dh, int kv_bytes, int n_pages) {
  const size_t dpad = padded_dh(Dh, kv_bytes);
  return 2 * 2 * kTile * dpad * kv_bytes          // K, V tiles, 2 stages
         + sizeof(float) * (G * dpad              // Qs
                            + G * kTile           // Ps
                            + static_cast<size_t>(G) * Dh  // Acc
                            + 3 * G)              // Ms, Ls, Alpha
         + 16                                     // the last-block flag
         + sizeof(int) * static_cast<size_t>(n_pages);  // Pg (paged)
}

// 16 bytes of shared memory as f32: 8 bf16 or 4 f32.
__device__ __forceinline__ void load16_f32(const __nv_bfloat16* p,
                                           float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16_f32(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}

template <typename TQ, typename TKV, bool kPaged>
__global__ void __launch_bounds__(kSplitThreads)
    split_decode_kernel(DecodeArgs a) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(TKV));  // per piece
  constexpr int kPiecesPerLane = kMaxDh / kPer / kLanesPerLine;
  extern __shared__ __align__(16) unsigned char split_smem[];
  const int G = a.G;
  const int Dh = a.Dh;
  const int dpad = padded_dh(Dh, sizeof(TKV));
  const int n_pieces = dpad / kPer;     // 16-byte pieces of a line
  const int n_full = Dh / kPer;         // ... copied whole by cp.async
  TKV* Kt = reinterpret_cast<TKV*>(split_smem);  // [2][kTile][dpad]
  TKV* Vt = Kt + 2 * kTile * dpad;               // [2][kTile][dpad]
  float* Qs = reinterpret_cast<float*>(Vt + 2 * kTile * dpad);  // [G][dpad]
  float* Ps = Qs + G * dpad;            // [G][kTile]
  float* Acc = Ps + G * kTile;          // [G][Dh]
  float* Ms = Acc + G * Dh;             // [G]
  float* Ls = Ms + G;                   // [G]
  float* Alpha = Ls + G;                // [G]
  int* last = reinterpret_cast<int*>(Alpha + G);
  int* Pg = last + 4;                   // [run_pages] the run's pages

  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int K = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = a.pos[b];
  const int n_lines = max(0, min(pos + 1, a.slots));
  const int live_splits = max(1, (n_lines + a.chunk - 1) / a.chunk);
  if (split >= live_splits) {
    return;                             // wholly past pos: nothing to read
  }
  const int j_begin = split * a.chunk;
  const int j_end = min(j_begin + a.chunk, n_lines);
  const TKV* kbase = static_cast<const TKV*>(a.k) + kh * a.k_sh;
  const TKV* vbase = static_cast<const TKV*>(a.v) + kh * a.v_sh;
  int pg0 = 0;
  if (kPaged) {
    // the table entries of this run's live lines, once
    pg0 = j_begin / a.page_size;
    const int* pt = a.page_table + b * a.pt_stride;
    const int n_pg =
        j_end > j_begin ? (j_end - 1) / a.page_size - pg0 + 1 : 0;
    for (int i = tid; i < n_pg; i += kSplitThreads) {
      Pg[i] = pt[pg0 + i];
    }
    __syncthreads();
  } else {
    kbase += b * a.k_s0;
    vbase += b * a.v_s0;
  }
  // element offset of line j from kbase (k) and vbase (v)
  auto line = [&](int j, long long& ko, long long& vo) {
    if (kPaged) {
      const int pi = j / a.page_size;
      const long long page = Pg[pi - pg0];
      const int off = j - pi * a.page_size;
      ko = page * a.k_s0 + off * a.k_s1;
      vo = page * a.v_s0 + off * a.v_s1;
    } else {
      ko = j * a.k_s1;
      vo = j * a.v_s1;
    }
  };

  // lines [j0, j0 + nl) into stage `st`: whole pieces by cp.async, the
  // tail of a line that does not fill 16 bytes by scalar loads (zeros up
  // to the piece's end)
  auto load_tile = [&](int j0, int st) {
    const int nl = min(kTile, j_end - j0);
    TKV* kd = Kt + st * kTile * dpad;
    TKV* vd = Vt + st * kTile * dpad;
    for (int i = tid; i < nl * n_full; i += kSplitThreads) {
      const int r = i / n_full;
      const int c = (i - r * n_full) * kPer;
      long long ko, vo;
      line(j0 + r, ko, vo);
      cp_async_16(kd + r * dpad + c, kbase + ko + c);
      cp_async_16(vd + r * dpad + c, vbase + vo + c);
    }
    const int tail = dpad - n_full * kPer;
    for (int i = tid; i < nl * tail; i += kSplitThreads) {
      const int r = i / tail;
      const int d = n_full * kPer + (i - r * tail);
      const bool in = d < Dh;
      const TKV zero = from_f32<TKV>(0.f);
      long long ko, vo;
      line(j0 + r, ko, vo);
      kd[r * dpad + d] = in ? kbase[ko + d] : zero;
      vd[r * dpad + d] = in ? vbase[vo + d] : zero;
    }
  };

  // the first tile's copy is in flight while q is read
  const int n_tiles = (j_end - j_begin + kTile - 1) / kTile;
  load_tile(j_begin, 0);
  cp_async_commit();
  const TQ* q = static_cast<const TQ*>(a.q) + b * a.q_sb +
                static_cast<long long>(kh) * G * a.q_sh;
  for (int i = tid; i < G * dpad; i += kSplitThreads) {
    const int g = i / dpad;
    const int d = i - g * dpad;
    Qs[i] = d < Dh ? to_f32(q[g * a.q_sh + d]) : 0.f;
  }
  for (int i = tid; i < G * Dh; i += kSplitThreads) {
    Acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kSplitThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = j_begin + t * kTile;
    const int st = t & 1;
    const int nl = min(kTile, j_end - j0);
    if (t + 1 < n_tiles) {
      load_tile(j0 + kTile, st ^ 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                    // tile t (and the init) visible

    // scores of line r for every head: its 4 lanes split the pieces, two
    // shuffles sum them; every lane runs the loop, so the shuffles see
    // the whole warp
    {
      const int r = tid / kLanesPerLine;
      const int sub = tid % kLanesPerLine;
      const TKV* kr = Kt + (st * kTile + r) * dpad;
      float kx[kPiecesPerLane][kPer];
#pragma unroll
      for (int pc = 0; pc < kPiecesPerLane; ++pc) {
        const int c = sub + pc * kLanesPerLine;
        if (c < n_pieces && r < nl) {
          load16_f32(kr + c * kPer, kx[pc]);
        } else {
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            kx[pc][e] = 0.f;
          }
        }
      }
      const int j = j0 + r;
      bool valid = r < nl;
      if (!kPaged && a.window > 0) {
        // ring: slot j holds the latest position congruent to it
        const int slot_pos =
            pos - (((pos - j) % a.slots) + a.slots) % a.slots;
        valid = valid && slot_pos >= 0 && (pos - slot_pos) < a.window;
      }
      for (int g = 0; g < G; ++g) {
        const float* qg = Qs + g * dpad;
        float dot = 0.f;
#pragma unroll
        for (int pc = 0; pc < kPiecesPerLane; ++pc) {
          const int c = sub + pc * kLanesPerLine;
          if (c < n_pieces) {
#pragma unroll
            for (int e = 0; e < kPer; e += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qg + c * kPer + e);
              dot = fmaf(qv.x, kx[pc][e], dot);
              dot = fmaf(qv.y, kx[pc][e + 1], dot);
              dot = fmaf(qv.z, kx[pc][e + 2], dot);
              dot = fmaf(qv.w, kx[pc][e + 3], dot);
            }
          }
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (sub == 0 && r < nl) {
          Ps[g * kTile + r] = valid ? dot * a.scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w updates heads w, w + 4, ...; lane = line
    for (int g = warp; g < G; g += kSplitWarps) {
      const float s = lane < nl ? Ps[g * kTile + lane] : kNegInf;
      const bool valid = s > 0.5f * kNegInf;
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_old - m_new);
      const float lsum = warp_sum(p);
      if (lane < nl) {
        Ps[g * kTile + lane] = p;
      }
      if (lane == 0) {
        Ms[g] = m_new;
        Ls[g] = Ls[g] * alpha + lsum;
        Alpha[g] = alpha;
      }
    }
    __syncthreads();

    const TKV* vt = Vt + st * kTile * dpad;
    for (int i = tid; i < G * Dh; i += kSplitThreads) {
      const int g = i / Dh;
      const int d = i - g * Dh;
      const float* pr = Ps + g * kTile;
      float x = Acc[i] * Alpha[g];
      for (int r = 0; r < nl; ++r) {
        x = fmaf(pr[r], to_f32(vt[r * dpad + d]), x);
      }
      Acc[i] = x;
    }
    __syncthreads();                    // stage and Ps free for reuse
  }

  if (n_tiles == 0) {
    __syncthreads();                    // no line: the init is the result
  }
  TQ* o = static_cast<TQ*>(a.o) + b * a.o_sb +
          static_cast<long long>(kh) * G * a.o_sh;
  if (live_splits == 1) {
    for (int i = tid; i < G * Dh; i += kSplitThreads) {
      const int g = i / Dh;
      const int d = i - g * Dh;
      const float den = Ls[g] == 0.f ? 1.f : Ls[g];
      o[g * a.o_sh + d] = from_f32<TQ>(Acc[i] / den);
    }
    return;
  }

  // partial of this split, then the last split of (b, kh) combines
  const long long bk = static_cast<long long>(b) * K + kh;
  const long long n_part = static_cast<long long>(gridDim.z) * K * n_splits;
  float* po = a.part + (bk * n_splits) * G * Dh;
  float* pml = a.part + n_part * G * Dh + (bk * n_splits) * 2 * G;
  for (int i = tid; i < G * Dh; i += kSplitThreads) {
    po[split * G * Dh + i] = Acc[i];
  }
  for (int g = tid; g < G; g += kSplitThreads) {
    pml[split * 2 * G + g] = Ms[g];
    pml[split * 2 * G + G + g] = Ls[g];
  }
  __threadfence();                      // partial visible device-wide ...
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(a.counter + bk, 1);   // ... before the count
    *last = done == live_splits - 1;
    if (*last) {
      atomicExch(a.counter + bk, 0);    // zero again for the next launch
    }
  }
  __syncthreads();
  if (!*last) {
    return;
  }
  __threadfence();
  for (int i = tid; i < G * Dh; i += kSplitThreads) {
    const int g = i / Dh;
    const int d = i - g * Dh;
    float m_star = kNegInf;
    for (int s = 0; s < live_splits; ++s) {
      m_star = fmaxf(m_star, __ldcg(pml + s * 2 * G + g));
    }
    float num = 0.f;
    float den = 0.f;
    for (int s = 0; s < live_splits; ++s) {
      const float w = expf(__ldcg(pml + s * 2 * G + g) - m_star);
      num = fmaf(__ldcg(po + s * G * Dh + i), w, num);
      den = fmaf(__ldcg(pml + s * 2 * G + G + g), w, den);
    }
    o[g * a.o_sh + d] = from_f32<TQ>(num / (den == 0.f ? 1.f : den));
  }
}

template <typename TQ, typename TKV, bool kPaged>
cudaError_t launch_split_typed(const DecodeArgs& a, int B, int K,
                               int n_splits, cudaStream_t stream) {
  const size_t smem = split_smem_bytes(
      a.G, a.Dh, sizeof(TKV), kPaged ? run_pages(a.chunk, a.page_size) : 0);
  cudaError_t err = allow_smem(split_decode_kernel<TQ, TKV, kPaged>, smem);
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid(n_splits, K, B);
  split_decode_kernel<TQ, TKV, kPaged>
      <<<grid, kSplitThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// q of `q_dtype`, K/V of `kv_dtype`; the output takes q's dtype.  The
// float32-query / bfloat16-cache pair is what an f32 model over the
// engine's bf16 cache dispatches.
template <bool kPaged>
cudaError_t launch_split(const DecodeArgs& a, int q_dtype, int kv_dtype,
                         int B, int K, int n_splits, cudaStream_t stream) {
  if (q_dtype == kFloat32 && kv_dtype == kFloat32) {
    return launch_split_typed<float, float, kPaged>(a, B, K, n_splits,
                                                    stream);
  }
  if (q_dtype == kBFloat16 && kv_dtype == kBFloat16) {
    return launch_split_typed<__nv_bfloat16, __nv_bfloat16, kPaged>(
        a, B, K, n_splits, stream);
  }
  if (q_dtype == kFloat32 && kv_dtype == kBFloat16) {
    return launch_split_typed<float, __nv_bfloat16, kPaged>(a, B, K,
                                                            n_splits, stream);
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int H, int K, int Dh) {
  return Dh < 1 || Dh > kMaxDh || B < 1 || K < 1 || H % K != 0;
}

}  // namespace
}  // namespace repro

// Dense cache.  q: (B, 1, H, Dh); k/v: (B, slots, K, Dh) read through
// strides (b, slot, kv head), 16-byte aligned (base and strides); pos:
// (B,) int32, the position of the token just written; window > 0 marks k/v
// as a ring of `slots` lines.  The cache is cut into ceil(slots / chunk)
// splits of `chunk` lines; part: f32 scratch of B*K*splits*G*(Dh + 2)
// floats; counter: B*K int32, zero (and left zero).
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, void* o, const int* pos,
    void* part, void* counter, int q_dtype, int kv_dtype, int B, int H,
    int K, int Dh, int slots, int window, int chunk, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_sh, float scale, void* stream) {
  using namespace repro;
  if (bad_shape(B, H, K, Dh) || slots < 1 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DecodeArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.pos = pos;
  a.page_table = nullptr;
  a.G = H / K;
  a.Dh = Dh;
  a.slots = slots;
  a.window = window;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_s0 = k_sb;
  a.k_s1 = k_ss;
  a.k_sh = k_sh;
  a.v_s0 = v_sb;
  a.v_s1 = v_ss;
  a.v_sh = v_sh;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.scale = scale;
  a.chunk = chunk;
  a.part = static_cast<float*>(part);
  a.counter = static_cast<int*>(counter);
  const int n_splits = (slots + chunk - 1) / chunk;
  return static_cast<int>(launch_split<false>(
      a, q_dtype, kv_dtype, B, K, n_splits,
      static_cast<cudaStream_t>(stream)));
}

// Paged pool.  q: (B, 1, H, Dh); k/v: (num_pages, page_size, K, Dh) read
// through strides (page, offset, kv head), 16-byte aligned (base and
// strides); page_table: (B, n_pages) int32 with row stride pt_stride; pos:
// (B,) int32.  The table's n_pages * page_size logical lines are cut into
// splits of `chunk` lines; part and counter as for the dense cache.
extern "C" int repro_flash_decode_paged(
    const void* q, const void* k, const void* v, void* o, const int* pos,
    const int* page_table, void* part, void* counter, int q_dtype,
    int kv_dtype, int B, int H, int K, int Dh, int n_pages, int page_size,
    int chunk, long long pt_stride, long long q_sb, long long q_sh,
    long long k_sp, long long k_so, long long k_sh, long long v_sp,
    long long v_so, long long v_sh, long long o_sb, long long o_sh,
    float scale, void* stream) {
  using namespace repro;
  if (bad_shape(B, H, K, Dh) || n_pages < 1 || page_size < 1 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DecodeArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.pos = pos;
  a.page_table = page_table;
  a.G = H / K;
  a.Dh = Dh;
  a.slots = n_pages * page_size;
  a.window = 0;
  a.page_size = page_size;
  a.pt_stride = pt_stride;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_s0 = k_sp;
  a.k_s1 = k_so;
  a.k_sh = k_sh;
  a.v_s0 = v_sp;
  a.v_s1 = v_so;
  a.v_sh = v_sh;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.scale = scale;
  a.chunk = chunk;
  a.part = static_cast<float*>(part);
  a.counter = static_cast<int*>(counter);
  const int n_splits = (a.slots + chunk - 1) / chunk;
  return static_cast<int>(launch_split<true>(
      a, q_dtype, kv_dtype, B, K, n_splits,
      static_cast<cudaStream_t>(stream)));
}
