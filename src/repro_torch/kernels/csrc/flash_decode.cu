// Single-query GQA decode attention for Hopper, sm_90a: a dense KV cache
// (with the sliding-window ring mode) and a paged KV pool.
//
// Replaces the TPU kernels `flash_decode_bkgd` (body `_decode_kernel`) and
// `flash_decode_paged_bkgd` (body `_paged_decode_kernel`) of
// src/repro/kernels/flash_decode.py: one query per sequence against its
// live KV lines, all G query heads of a kv group served from each K/V line
// loaded, the ring mask `slot_pos = pos - ((pos - i) mod S)` under a
// window, and, for the pool, logical page `pi` resolved through
// `page_table[b, pi]` with the null page never attended.
//
// What bounds it on the card: bytes.  Each live K/V line is read once and
// used for 2*G*Dh flops per tensor, far below the ~295 flops per byte the
// H100 needs before its compute is the limit.
//
// Design: the TPU kernel split the KV axis over grid cells, wrote f32
// partials and combined them in a second pass.  This first version gives
// one block to each (sequence, kv head) and walks that sequence's live
// lines [0, min(pos_b + 1, S)) in 32-line tiles with an f32 online
// softmax, so no partials and no combine are needed and nothing past
// pos_b is read.  The paged variant reads its own page-table entry per
// line (there is no scalar prefetch on the card).  Splitting the KV axis
// over blocks, for more blocks in flight at small batch, is later work.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
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
};

size_t decode_smem_bytes(int G, int Dh) {
  return sizeof(float) *
         (static_cast<size_t>(G) * Dh     // Qs
          + kTile * (Dh + 1)              // Ks
          + kTile * Dh                    // Vs
          + G * kTile                     // Ps
          + G * Dh                        // Acc
          + 3 * G);                       // Ms, Ls, Alpha
}

template <typename TQ, typename TKV, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(DecodeArgs a) {
  static_assert(kTile == 32, "the softmax step maps one line per lane");
  extern __shared__ float smem[];
  const int G = a.G;
  const int Dh = a.Dh;
  const int ldk = Dh + 1;
  float* Qs = smem;                     // [G][Dh]
  float* Ks = Qs + G * Dh;              // [kTile][Dh + 1]
  float* Vs = Ks + kTile * ldk;         // [kTile][Dh]
  float* Ps = Vs + kTile * Dh;          // [G][kTile]
  float* Acc = Ps + G * kTile;          // [G][Dh]
  float* Ms = Acc + G * Dh;             // [G]
  float* Ls = Ms + G;                   // [G]
  float* Alpha = Ls + G;                // [G]

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pos = a.pos[b];
  const int n_lines = max(0, min(pos + 1, a.slots));

  const TQ* q = static_cast<const TQ*>(a.q) + b * a.q_sb +
                static_cast<long long>(kh) * G * a.q_sh;
  for (int i = tid; i < G * Dh; i += kThreads) {
    const int g = i / Dh;
    const int d = i - g * Dh;
    Qs[i] = to_f32(q[g * a.q_sh + d]);
    Acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  const TKV* kbase = static_cast<const TKV*>(a.k) + kh * a.k_sh;
  const TKV* vbase = static_cast<const TKV*>(a.v) + kh * a.v_sh;
  const int* pt = kPaged ? a.page_table + b * a.pt_stride : nullptr;

  for (int j0 = 0; j0 < n_lines; j0 += kTile) {
    __syncthreads();                    // init done / last tile consumed
    for (int i = tid; i < kTile * Dh; i += kThreads) {
      const int r = i / Dh;
      const int d = i - r * Dh;
      const int j = j0 + r;
      float kx = 0.f;
      float vx = 0.f;
      if (j < n_lines) {
        long long ko;
        long long vo;
        if (kPaged) {
          const int pi = j / a.page_size;
          const long long page = pt[pi];
          const int off = j - pi * a.page_size;
          ko = page * a.k_s0 + off * a.k_s1;
          vo = page * a.v_s0 + off * a.v_s1;
        } else {
          ko = b * a.k_s0 + j * a.k_s1;
          vo = b * a.v_s0 + j * a.v_s1;
        }
        kx = to_f32(kbase[ko + d]);
        vx = to_f32(vbase[vo + d]);
      }
      Ks[r * ldk + d] = kx;
      Vs[i] = vx;
    }
    __syncthreads();

    // scores, masked to kNegInf: one (head, line) pair per thread
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile;
      const int r = i - g * kTile;
      const int j = j0 + r;
      bool valid = j < n_lines;
      if (!kPaged && a.window > 0) {
        // ring: slot j holds the latest position congruent to it
        const int slot_pos = pos - (((pos - j) % a.slots) + a.slots) % a.slots;
        valid = valid && slot_pos >= 0 && (pos - slot_pos) < a.window;
      }
      float s = kNegInf;
      if (valid) {
        const float* qr = Qs + g * Dh;
        const float* kr = Ks + r * ldk;
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d) {
          dot = fmaf(qr[d], kr[d], dot);
        }
        s = dot * a.scale;
      }
      Ps[i] = s;
    }
    __syncthreads();

    // online softmax: warp w updates heads w, w + kWarps, ...
    for (int g = warp; g < G; g += kWarps) {
      const float s = Ps[g * kTile + lane];
      const bool valid = s > 0.5f * kNegInf;
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_old - m_new);
      const float lsum = warp_sum(p);
      Ps[g * kTile + lane] = p;
      if (lane == 0) {
        Ms[g] = m_new;
        Ls[g] = Ls[g] * alpha + lsum;
        Alpha[g] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * Dh; i += kThreads) {
      const int g = i / Dh;
      const int d = i - g * Dh;
      const float* pr = Ps + g * kTile;
      float x = Acc[i] * Alpha[g];
#pragma unroll 8
      for (int r = 0; r < kTile; ++r) {
        x = fmaf(pr[r], Vs[r * Dh + d], x);
      }
      Acc[i] = x;
    }
  }
  __syncthreads();

  TQ* o = static_cast<TQ*>(a.o) + b * a.o_sb +
          static_cast<long long>(kh) * G * a.o_sh;
  for (int i = tid; i < G * Dh; i += kThreads) {
    const int g = i / Dh;
    const int d = i - g * Dh;
    const float den = Ls[g] == 0.f ? 1.f : Ls[g];
    o[g * a.o_sh + d] = from_f32<TQ>(Acc[i] / den);
  }
}

template <typename TQ, typename TKV, bool kPaged>
cudaError_t launch_typed(const DecodeArgs& a, int B, int K,
                         cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(a.G, a.Dh);
  cudaError_t err = allow_smem(flash_decode_kernel<TQ, TKV, kPaged>, smem);
  if (err != cudaSuccess) {
    return err;
  }
  const dim3 grid(K, B);
  flash_decode_kernel<TQ, TKV, kPaged><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// q of `q_dtype`, K/V of `kv_dtype`; the output takes q's dtype.  The
// float32-query / bfloat16-cache pair is what an f32 model over the
// engine's bf16 cache dispatches.
template <bool kPaged>
cudaError_t launch(const DecodeArgs& a, int q_dtype, int kv_dtype, int B,
                   int K, cudaStream_t stream) {
  if (q_dtype == kFloat32 && kv_dtype == kFloat32) {
    return launch_typed<float, float, kPaged>(a, B, K, stream);
  }
  if (q_dtype == kBFloat16 && kv_dtype == kBFloat16) {
    return launch_typed<__nv_bfloat16, __nv_bfloat16, kPaged>(a, B, K,
                                                             stream);
  }
  if (q_dtype == kFloat32 && kv_dtype == kBFloat16) {
    return launch_typed<float, __nv_bfloat16, kPaged>(a, B, K, stream);
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int H, int K, int Dh) {
  return Dh < 1 || Dh > kMaxDh || B < 1 || K < 1 || H % K != 0;
}

}  // namespace
}  // namespace repro

// Dense cache.  q: (B, 1, H, Dh); k/v: (B, slots, K, Dh) read through
// strides (b, slot, kv head); pos: (B,) int32, the position of the token
// just written; window > 0 marks k/v as a ring of `slots` lines.
extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, void* o, const int* pos,
    int q_dtype, int kv_dtype, int B, int H, int K, int Dh, int slots,
    int window, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, float scale,
    void* stream) {
  using namespace repro;
  if (bad_shape(B, H, K, Dh) || slots < 1) {
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
  return static_cast<int>(launch<false>(a, q_dtype, kv_dtype, B, K,
                                        static_cast<cudaStream_t>(stream)));
}

// Paged pool.  q: (B, 1, H, Dh); k/v: (num_pages, page_size, K, Dh) read
// through strides (page, offset, kv head); page_table: (B, n_pages) int32
// with row stride pt_stride; pos: (B,) int32.
extern "C" int repro_flash_decode_paged(
    const void* q, const void* k, const void* v, void* o, const int* pos,
    const int* page_table, int q_dtype, int kv_dtype, int B, int H, int K,
    int Dh, int n_pages, int page_size, long long pt_stride, long long q_sb,
    long long q_sh, long long k_sp, long long k_so, long long k_sh,
    long long v_sp, long long v_so, long long v_sh, long long o_sb,
    long long o_sh, float scale, void* stream) {
  using namespace repro;
  if (bad_shape(B, H, K, Dh) || n_pages < 1 || page_size < 1) {
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
  return static_cast<int>(launch<true>(a, q_dtype, kv_dtype, B, K,
                                       static_cast<cudaStream_t>(stream)));
}
