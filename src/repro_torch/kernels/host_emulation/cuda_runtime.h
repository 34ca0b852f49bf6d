// Stand-in for the CUDA runtime, so that g++ can build a kernel source of
// ../csrc into a host library (see ../host_emulation.py).  Each block runs
// alone, its CUDA threads as std::threads; __syncthreads is a barrier of
// the block; ldmatrix and mma.sync exchange registers through a buffer
// of the warp between two barriers of the warp, a shuffle waits only for
// its partner lane, and the PTX helpers of ../csrc/common.cuh are C++
// built from the PTX ISA's fragment layouts.  cp.async copies at once.
// Dynamic shared memory is filled with 0xff bytes (NaN in f32 and bf16)
// before each block, so a read of a byte no thread wrote shows in the
// result.
#pragma once
#define REPRO_HOST_EMULATION 1

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) alignas(n)

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct uint3 {
  unsigned x, y, z;
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}

inline thread_local uint3 threadIdx;
inline thread_local uint3 blockIdx;
inline dim3 blockDim;
inline dim3 gridDim;

namespace mock {

constexpr size_t kSmemBytes = 232448;
alignas(16) inline unsigned char smem_buf[kSmemBytes];

struct Warp {
  std::unique_ptr<std::barrier<>> bar;  // ldmatrix, mma: the whole warp
  alignas(16) unsigned char data[32][64];
  // shuffles: lane to lane, so that a group of lanes can shuffle while
  // the rest of the warp is elsewhere (as a masked shuffle can); one
  // channel per mask width (2, 4, ..., 32 lanes)
  std::atomic<unsigned long long> gen[6][32] = {};
  unsigned long long val[6][32][64];
};
inline std::unique_ptr<std::barrier<>> block_bar;
inline std::vector<std::unique_ptr<Warp>> warps;
inline thread_local int lane = 0;
inline thread_local Warp* warp = nullptr;

inline thread_local unsigned long long shuffles[6] = {};

// Lane `from`'s value at this lane's next shuffle under `mask`: each lane
// publishes its value under its count of shuffles of that mask width and
// waits only for its partner to reach the same count (the lanes of a
// mask run the same shuffles, whatever the rest of the warp does).  A
// lane keeps its last 64 values: lanes that shuffle with one another
// cannot drift that far apart.
template <typename T>
inline T exchange(T mine, int from, unsigned mask) {
  static_assert(sizeof(T) <= 8, "shuffles move 4 or 8 bytes");
  int ch = 0;
  while ((2u << ch) < static_cast<unsigned>(__builtin_popcount(mask))) {
    ++ch;
  }
  const unsigned long long n = ++shuffles[ch];
  unsigned long long bits = 0;
  std::memcpy(&bits, &mine, sizeof(T));
  warp->val[ch][lane][n % 64] = bits;
  warp->gen[ch][lane].store(n, std::memory_order_release);
  while (warp->gen[ch][from].load(std::memory_order_acquire) < n) {
    std::this_thread::yield();
  }
  bits = warp->val[ch][from][n % 64];
  T got;
  std::memcpy(&got, &bits, sizeof(T));
  return got;
}

template <typename Kernel, typename... Args>
void launch(Kernel kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
            Args... args) {
  gridDim = grid;
  blockDim = block;
  const int n = block.x * block.y * block.z;
  if (smem > kSmemBytes) {
    std::abort();
  }
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::memset(smem_buf, 0xff, smem);
        block_bar = std::make_unique<std::barrier<>>(n);
        warps.clear();
        for (int w = 0; w < (n + 31) / 32; ++w) {
          warps.push_back(std::make_unique<Warp>());
          warps.back()->bar =
              std::make_unique<std::barrier<>>(std::min(32, n - 32 * w));
        }
        std::vector<std::thread> threads;
        for (int t = 0; t < n; ++t) {
          threads.emplace_back([=] {
            threadIdx = {t % block.x, t / block.x % block.y,
                         t / (block.x * block.y)};
            blockIdx = {bx, by, bz};
            lane = t % 32;
            warp = warps[t / 32].get();
            kernel(args...);
            warp->bar->arrive_and_drop();
            block_bar->arrive_and_drop();
          });
        }
        for (auto& th : threads) th.join();
      }
}

}  // namespace mock

inline void __syncthreads() { mock::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  mock::warp->bar->arrive_and_wait();
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
template <typename T>
inline T __shfl_xor_sync(unsigned mask, T v, int o) {
  return mock::exchange(v, mock::lane ^ o, mask);
}
template <typename T>
inline T __shfl_up_sync(unsigned mask, T v, unsigned o) {
  const int from = mock::lane - static_cast<int>(o);
  return mock::exchange(v, from >= 0 ? from : mock::lane, mask);
}
template <typename T>
inline T __ldcg(const T* p) {
  return *p;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicExch(int* p, int v) {
  return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST);
}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute,
                                        int) {
  return cudaSuccess;
}

// ---- the PTX helpers of common.cuh ----

// The device faults on a misaligned 16-byte copy or ldmatrix row: so does
// the stand-in.
inline void require_aligned(const void* p, const char* what) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
    std::fprintf(stderr, "misaligned %s address %p\n", what, p);
    std::abort();
  }
}

inline void cp_async_16(void* dst, const void* src, int src_bytes = 16) {
  require_aligned(dst, "cp.async shared");
  if (src_bytes > 0) {
    require_aligned(src, "cp.async global");
  }
  std::memset(dst, 0, 16);
  std::memcpy(dst, src, src_bytes);
}
inline void cp_async_commit() {}
template <int kPending>
inline void cp_async_wait() {}

inline unsigned halves(const unsigned char* row, int col) {
  unsigned r;
  std::memcpy(&r, row + 2 * col, 4);
  return r;
}

inline void ldmatrix_x4(unsigned (&r)[4], const void* src) {
  require_aligned(src, "ldmatrix row");
  const auto* all = &mock::warp->data[0][0];
  std::memcpy(mock::warp->data[mock::lane], &src, sizeof(src));
  mock::warp->bar->arrive_and_wait();
  const int l = mock::lane;
  for (int i = 0; i < 4; ++i) {
    const unsigned char* row;
    std::memcpy(&row, all + 64 * (8 * i + l / 4), sizeof(row));
    r[i] = halves(row, 2 * (l % 4));
  }
  mock::warp->bar->arrive_and_wait();
}

inline void ldmatrix_x4_trans(unsigned (&r)[4], const void* src) {
  require_aligned(src, "ldmatrix row");
  const auto* all = &mock::warp->data[0][0];
  std::memcpy(mock::warp->data[mock::lane], &src, sizeof(src));
  mock::warp->bar->arrive_and_wait();
  const int l = mock::lane;
  for (int i = 0; i < 4; ++i) {
    const unsigned char* r0;
    const unsigned char* r1;
    std::memcpy(&r0, all + 64 * (8 * i + 2 * (l % 4)), sizeof(r0));
    std::memcpy(&r1, all + 64 * (8 * i + 2 * (l % 4) + 1), sizeof(r1));
    unsigned short lo, hi;
    std::memcpy(&lo, r0 + 2 * (l / 4), 2);
    std::memcpy(&hi, r1 + 2 * (l / 4), 2);
    r[i] = lo | (static_cast<unsigned>(hi) << 16);
  }
  mock::warp->bar->arrive_and_wait();
}

inline float bf16_half(unsigned reg, int hi) {
  const unsigned u = (hi ? reg >> 16 : reg & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline void mma_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                      unsigned b1) {
  const unsigned mine[6] = {a[0], a[1], a[2], a[3], b0, b1};
  std::memcpy(mock::warp->data[mock::lane], mine, sizeof(mine));
  mock::warp->bar->arrive_and_wait();
  auto reg = [](int ln, int i) {
    unsigned r;
    std::memcpy(&r, mock::warp->data[ln] + 4 * i, 4);
    return r;
  };
  // A[row][k]: lane (row % 8) * 4 + (k % 8) / 2, register row / 8 + 2 (k / 8)
  // B[k][col]: lane col * 4 + (k % 8) / 2, register 4 + k / 8
  const int g = mock::lane / 4;
  const int t = mock::lane % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e / 2);
    const int col = 2 * t + e % 2;
    float x = d[e];
    for (int k = 0; k < 16; ++k) {
      const float av = bf16_half(reg((row % 8) * 4 + (k % 8) / 2,
                                     row / 8 + 2 * (k / 8)), k % 2);
      const float bv =
          bf16_half(reg(col * 4 + (k % 8) / 2, 4 + k / 8), k % 2);
      x += av * bv;
    }
    d[e] = x;
  }
  mock::warp->bar->arrive_and_wait();
}
