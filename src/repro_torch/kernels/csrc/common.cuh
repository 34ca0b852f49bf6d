// Shared helpers of the kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace repro {

// The finite mask value of the JAX package (models/attention.py,
// kernels/flash_attention.py): a fully masked row stays NaN-free.
constexpr float kNegInf = -1e30f;
// Widest head the kernels take; each lane of a warp owns kMaxDh / 32
// output dims.
constexpr int kMaxDh = 128;
constexpr int kDhPerLane = kMaxDh / 32;

// dtype codes shared with the Python wrappers (kernels/build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

// Two floats as one register of two bf16, the first in the low half (the
// element order of an mma fragment).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// x0, x1 as two bf16 terms each, hi + lo, packed as `pack_bf16x2` packs:
// hi + lo keeps 16 bits of each mantissa where hi alone keeps 8.
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             unsigned& hi, unsigned& lo) {
  hi = pack_bf16x2(x0, x1);
  const float2 h =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16x2(x0 - h.x, x1 - h.y);
}

// The PTX of the kernels, kept in these few helpers.  A host build of a
// kernel source (g++ against stand-in CUDA headers that define
// REPRO_HOST_EMULATION) supplies C++ versions of the same helpers, built
// from the PTX ISA's fragment layouts, so a kernel's indexing can be held
// against its plain version without a card.
#ifndef REPRO_HOST_EMULATION

// 16-byte asynchronous copy global -> shared; bytes past `src_bytes` (0 or
// 16) are zero-filled.  Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `kPending` committed groups of this thread are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, and lane l receives row l/4, columns 2(l%4) and
// 2(l%4)+1 of matrix i in r[i].
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same, each matrix transposed: lane l receives rows 2(l%4) and
// 2(l%4)+1 of column l/4.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a (16x16 bf16, row major) * b (16x8 bf16, column major), f32
// accumulators; with g = lane/4, t = lane%4: a[0..3] hold (row g, k 2t..),
// (row g+8, k 2t..), (row g, k 2t+8..), (row g+8, k 2t+8..); b[0..1] hold
// (k 2t.., col g), (k 2t+8.., col g); d[0..3] hold (row g, col 2t, 2t+1),
// (row g+8, col 2t, 2t+1).
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

#endif  // REPRO_HOST_EMULATION

// Raise the dynamic shared-memory cap of `kernel` when a launch needs more
// than the 48 KB a block gets without asking.  The cap is set once per
// kernel and device (and again only if a later launch needs more), so a
// steady stream of launches pays no `cudaFuncSetAttribute` call.
inline cudaError_t allow_smem_once(const void* kernel, size_t bytes) {
  struct Granted {
    const void* kernel;
    int device;
    size_t bytes;
  };
  static std::mutex mu;
  static std::vector<Granted> granted;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    return err;
  }
  std::lock_guard<std::mutex> lock(mu);
  Granted* entry = nullptr;
  for (Granted& g : granted) {
    if (g.kernel == kernel && g.device == device) {
      entry = &g;
    }
  }
  if (entry != nullptr && entry->bytes >= bytes) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) {
    return err;
  }
  if (entry == nullptr) {
    granted.push_back({kernel, device, bytes});
  } else {
    entry->bytes = bytes;
  }
  return cudaSuccess;
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) {
    return cudaSuccess;
  }
  return allow_smem_once(reinterpret_cast<const void*>(kernel), bytes);
}

}  // namespace repro
