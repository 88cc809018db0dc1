// Fused mean-field update at any label count on the FFMA pipes (K1w_ffma),
// for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `fused_energy_update` (the JAX package's
// ops/pallas/meanfield.py, `_kernel`) for every L above the largest that
// K1w (meanfield_wide.cu, tensor cores, L <= 256) serves; K1 (meanfield.cu)
// serves L in {8, 16, 32, 64}. It computes the same function:
//
//     E[i]  = E0[i] + (S[i] - C[i])
//     q     = softmax(-E[i])                    (max-subtracted)
//     C'[i] = q . Mu                            (L x L compatibility)
//
// with E, the max, the exps, the sum and the product in f32 and each output
// rounded once to the I/O dtype (f32 or bf16).
//
// Bound: at the repo's largest configuration (fullres128: n = 2,088,960
// rows, L = 128) the five (n, L) passes are 2.67 GB in bf16 (0.80 ms at
// 3.35 TB/s) and 5.35 GB in f32 (1.60 ms); the product is 2 L^2 n = 68.5
// GFLOP, 1.02 ms of f32 FFMA at 67 TFLOP/s. So in bf16 the operations bound
// it and in f32 the bytes. This design is simple and right at every L; the
// product stays on the FFMA pipes (K1w, the tensor-core design, takes every
// L up to 256 and leaves this kernel the larger ones):
//
// - One block of 256 threads per tile of `tile_rows` consecutive rows, so a
//   tile is one contiguous span of each array. Rows of any width, aligned
//   or not (L = 3 in bf16 is 6 bytes), are read value by value: thread t
//   takes values t, t + 256, ... of the span, so every load and E store of a
//   warp is contiguous whatever L is.
// - Phase 1 writes E (rounded once) and keeps the f32 E in shared memory,
//   rows padded to `q_stride` floats. Groups of G = min(32, pow2 >= L) lanes
//   then take one row each: max and sum by __shfl_xor_sync inside the group,
//   exp by expf, q = exp / sum in place, and the row's pad set to zero.
// - Phase 2 (C' = q . Mu): Mu is staged through shared memory in blocks of
//   64 rows by `col_chunk` columns (zero past L), so every L fits; Mu alone is
//   64 KB in f32 at L = 128. Each thread owns 4 columns of 4 rows (rows
//   strided by the thread rows of the block, against bank conflicts) in 16
//   f32 accumulators and reads q and Mu by 16-byte shared loads: 64 FFMA for
//   8 loads. The sum runs over l in order, the Mu blocks in order of l.
// - Dynamic shared memory (q tile + Mu block) is sized by the wrapper
//   (`wide_ffma_geometry`): at most about 100 KB a block where that holds one row,
//   at most 227 KB in any case, opted into with cudaFuncSetAttribute above
//   48 KB. __launch_bounds__(256, 2): at most 128 registers a thread.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;  // RB: rows of C' a thread carries in phase 2
constexpr int kMuRows = 64;        // LK: rows of Mu staged at once
constexpr int kMaxColChunk = 64;   // columns of Mu staged at once
constexpr int kMaxSmem = 232448;   // the H100's opt-in limit a block
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fused_energy_update_wide_ffma_kernel(const T* __restrict__ e0, const T* __restrict__ s,
                                const T* __restrict__ c, const T* __restrict__ mu,
                                T* __restrict__ e_out, T* __restrict__ c_out, long long n, int L,
                                int tile_rows, int q_stride, int col_chunk) {
  extern __shared__ __align__(16) float smem[];
  float* q = smem;                                 // tile_rows x q_stride
  float* mu_s = smem + tile_rows * q_stride;       // kMuRows x col_chunk

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long long row0 = (long long)blockIdx.x * tile_rows;
  const int rows = (int)(n - row0 < tile_rows ? n - row0 : tile_rows);
  const int lp = (L + 3) & ~3;  // L padded to whole float4s

  // phase 1: E, value by value over the tile's contiguous span
  {
    const long long base = row0 * L;
    const int count = rows * L;
#pragma unroll 4
    for (int i = tid; i < count; i += kThreads) {
      const float e = to_float(__ldg(e0 + base + i)) +
                      (to_float(__ldg(s + base + i)) - to_float(__ldg(c + base + i)));
      store(e_out + base + i, e);
      const int r = i / L;
      q[r * q_stride + (i - r * L)] = e;
    }
  }
  __syncthreads();

  // softmax of -E: G lanes a row, 32 / G rows a warp at once
  {
    int g = 1;
    while (g < L && g < 32) g <<= 1;
    const int per_warp = 32 / g;
    const int sub = lane % g;
    for (int rb = warp * per_warp; rb < rows; rb += kWarps * per_warp) {  // warp-uniform
      const int r = rb + lane / g;
      const bool ok = r < rows;
      float* qr = q + (ok ? r : 0) * q_stride;
      float m = -INFINITY;
      if (ok)
        for (int l = sub; l < L; l += g) m = fmaxf(m, -qr[l]);
      for (int o = g / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      if (ok)
        for (int l = sub; l < L; l += g) {
          const float x = expf(-qr[l] - m);
          qr[l] = x;
          sum += x;
        }
      for (int o = g / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (ok)
        for (int l = sub; l < lp; l += g) qr[l] = l < L ? qr[l] / sum : 0.f;
    }
  }

  // phase 2: C' = q . Mu, 4 columns of kRowsPerThread rows a thread
  const int groups = col_chunk / 4;       // column groups of a chunk
  const int thread_rows = kThreads / groups;
  const int cg = tid % groups;
  const int tr = tid / groups;
  const bool vec = (L % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(c_out) & (4 * sizeof(T) - 1)) == 0);
  for (int j0 = 0; j0 < L; j0 += col_chunk) {
    float acc[kRowsPerThread][4];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[k][x] = 0.f;
    int qoff[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = tr + k * thread_rows;
      qoff[k] = (r < tile_rows ? r : 0) * q_stride;  // a spare row reads row 0, unstored
    }
    for (int l0 = 0; l0 < L; l0 += kMuRows) {
      __syncthreads();  // q complete (first pass); the last Mu block read
      for (int i = tid; i < kMuRows * col_chunk; i += kThreads) {
        const int a = i / col_chunk, b = i - a * col_chunk;
        const int l = l0 + a, j = j0 + b;
        mu_s[i] = (l < L && j < L) ? to_float(__ldg(mu + (long long)l * L + j)) : 0.f;
      }
      __syncthreads();
      const int lk = lp - l0 < kMuRows ? lp - l0 : kMuRows;
      for (int a = 0; a < lk; a += 4) {
        float4 m4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          m4[u] = *reinterpret_cast<const float4*>(mu_s + (a + u) * col_chunk + cg * 4);
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          const float4 q4 = *reinterpret_cast<const float4*>(q + qoff[k] + l0 + a);
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[k][0] = fmaf(qv[u], m4[u].x, acc[k][0]);
            acc[k][1] = fmaf(qv[u], m4[u].y, acc[k][1]);
            acc[k][2] = fmaf(qv[u], m4[u].z, acc[k][2]);
            acc[k][3] = fmaf(qv[u], m4[u].w, acc[k][3]);
          }
        }
      }
    }
    const int j = j0 + cg * 4;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = tr + k * thread_rows;
      if (r >= rows || j >= L) continue;
      T* dst = c_out + (row0 + r) * L + j;
      if (vec) {  // j + 3 < L and the 4 values are one aligned vector
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        } else {
          __nv_bfloat162 lo = __floats2bfloat162_rn(acc[k][0], acc[k][1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(acc[k][2], acc[k][3]);
          uint2 w;
          w.x = *reinterpret_cast<uint32_t*>(&lo);
          w.y = *reinterpret_cast<uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(dst) = w;
        }
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (j + x < L) store(dst + x, acc[k][x]);
      }
    }
  }
}

// The geometry the wrapper's `wide_ffma_geometry` computes, re-derived here.
int col_chunk_for(int L) {
  int w = 4;
  while (w < L && w < kMaxColChunk) w <<= 1;
  return w;
}

template <typename T>
cudaError_t launch(const void* e0, const void* s, const void* c, const void* mu, void* e_out,
                   void* c_out, long long n, int L, int tile_rows, int q_stride, int col_chunk,
                   int num_tiles, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(fused_energy_update_wide_ffma_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes);
    if (err != cudaSuccess) return err;
  }
  fused_energy_update_wide_ffma_kernel<T><<<num_tiles, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(e0), static_cast<const T*>(s), static_cast<const T*>(c),
      static_cast<const T*>(mu), static_cast<T*>(e_out), static_cast<T*>(c_out), n, L, tile_rows,
      q_stride, col_chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every array is row-major contiguous,
// aligned to its element; n > 0, L > 0. The geometry comes from the
// wrapper's `wide_ffma_geometry`: one block of 256 threads per tile of
// `tile_rows` rows (num_tiles = ceil(n / tile_rows) blocks), q rows of
// `q_stride` floats, Mu staged in blocks of 64 x `col_chunk`, and
// `smem_bytes` = (tile_rows * q_stride + 64 * col_chunk) * 4 of dynamic
// shared memory. Returns the launch's cudaError_t (0 = ok).
extern "C" int fused_energy_update_wide_ffma_launch(const void* e0, const void* s, const void* c,
                                               const void* mu, void* e_out, void* c_out,
                                               long long n, int L, int dtype, int tile_rows,
                                               int q_stride, int col_chunk, int num_tiles,
                                               int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lp = (L + 3) & ~3;
  if (n <= 0 || L <= 0 || tile_rows <= 0 || col_chunk != col_chunk_for(L) ||
      tile_rows > kThreads / (col_chunk / 4) * kRowsPerThread || q_stride != lp + 4 ||
      num_tiles != (n + tile_rows - 1) / tile_rows ||
      smem_bytes != (tile_rows * q_stride + kMuRows * col_chunk) * (int)sizeof(float) ||
      smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(e0, s, c, mu, e_out, c_out, n, L, tile_rows, q_stride, col_chunk,
                              num_tiles, smem_bytes, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(e0, s, c, mu, e_out, c_out, n, L, tile_rows, q_stride,
                                      col_chunk, num_tiles, smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}
