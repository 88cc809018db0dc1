// Fused mean-field update for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `fused_energy_update`
// (the JAX package's ops/pallas/meanfield.py, `_kernel`). For each row
// i of the (n, L) mean-field state:
//
//     E[i]  = E0[i] + (S[i] - C[i])            (S = lattice-filtered C)
//     q     = softmax(-E[i])                    (max-subtracted)
//     C'[i] = q . Mu                            (L x L compatibility)
//
// and writes E and C'. E, the max, exp, sum and the product are computed
// in f32; each output is rounded once to the I/O dtype.
//
// Bound: memory. The kernel reads E0, S and C and writes E and C': five
// (n, L) passes, 17.7 MB in bf16 at the flagship shape (110592, 16), 35.4 MB
// in f32, so 5.28 us (10.56 us) at the H100 SXM's 3.35 TB/s. The product is
// 2 L^2 flops a row, 0.85 us of f32 FFMA at L = 16 (67 TFLOP/s); even at
// L = 64 in bf16 it stays under the byte time. So the design is about the
// loads and stores:
//
// - Each warp owns one tile of `tile_rows` consecutive rows (the wrapper
//   computes the geometry): one contiguous span of each array. Lane i loads
//   words i, i + 32, ... of the three spans with 16-byte loads, all issued
//   before any is used, so every load instruction is whole-sector and up to
//   kMaxWords x 3 words a lane are in flight at once. The ragged last tile
//   loads and computes only its rows. There is no shared-memory staging and
//   no barrier: the other warps of the SM hide a warp's latency.
// - Phase 1 (E and q): each lane takes its loaded words (4 f32 or 8 bf16
//   values each), so the E stores are whole-sector too. The lanes of a row
//   (L / 4 in f32, L / 8 in bf16) share their max and sum by
//   __shfl_xor_sync; exp is one ex2.approx of the max-subtracted argument
//   times log2(e), and q is the exps times one rcp.approx of their sum. q
//   goes to the warp's scratch in shared memory in f32, rows padded by 4
//   floats against bank conflicts.
// - Phase 2 (C' = q . Mu): each lane owns 64 / L output columns, so the 64
//   Mu entries they need are loaded once into registers (at L = 64 the lane
//   walks the two halves of the columns). It reads q by 16-byte loads and
//   carries two rows at once where it owns fewer than eight columns, so two
//   to eight independent FFMA chains are in flight; each sums over l in
//   order. Neighbouring lanes own neighbouring columns of neighbouring rows,
//   so the C' stores are whole-sector as well.
// - __launch_bounds__(128, 4): at most 128 registers a thread.
//
// Designs measured on the H100 and not kept (PERF.md): a persistent grid
// whose warps walk tiles through a cp.async ring in shared memory (as fast
// in bf16, 2% faster in f32, for a stage ring, its header and a persistent
// geometry); block-wide tiles through a TMA bulk-copy ring; q . Mu on the
// tensor cores with q split exactly into three bf16 terms.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWords = 4;  // 16-byte words of each array a lane loads
constexpr int kMaxSmem = 48 * 1024;  // the q scratch; no opt-in needed

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 2^x and 1/x by the special-function unit: relative errors of about 2^-22
// and 2^-23, far inside the f32 tolerance of 1e-5.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

// One 16-byte word of T values, as f32.
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int kValues = 4;
  static __device__ __forceinline__ void unpack(uint4 w, float* out) {
    out[0] = __uint_as_float(w.x);
    out[1] = __uint_as_float(w.y);
    out[2] = __uint_as_float(w.z);
    out[3] = __uint_as_float(w.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int kValues = 8;
  static __device__ __forceinline__ void unpack(uint4 w, float* out) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(u[i] << 16);             // low half: the first element
      out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);  // high half: the second
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                      pack_bf16x2(v[6], v[7]));
  }
};

// Stores N consecutive values, rounded once to T, in one or two vector stores.
template <typename T, int N>
__device__ __forceinline__ void store_values(T* p, const float* v) {
  constexpr int W = Word<T>::kValues;
  if constexpr (N >= W) {
#pragma unroll
    for (int i = 0; i < N / W; ++i) reinterpret_cast<uint4*>(p)[i] = Word<T>::pack(v + i * W);
  } else if constexpr (std::is_same_v<T, float>) {
    if constexpr (N == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    else p[0] = v[0];
  } else {
    if constexpr (N == 4)
      *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
    else if constexpr (N == 2) *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v[0], v[1]);
    else p[0] = __float2bfloat16_rn(v[0]);
  }
}

template <int L, typename T>
__global__ void __launch_bounds__(kThreads, 4)
fused_energy_update_kernel(const T* __restrict__ e0, const T* __restrict__ s,
                           const T* __restrict__ c, const T* __restrict__ mu,
                           T* __restrict__ e_out, T* __restrict__ c_out, long long n,
                           int tile_rows) {
  constexpr int V = Word<T>::kValues;      // values in a 16-byte word
  constexpr int G = L / V;                 // words in a row: the lanes of a row in phase 1
  constexpr int VC = 64 / L;               // output columns a lane owns in phase 2
  constexpr int CG = L / VC;               // lanes that span a row's columns (64 at L = 64)
  constexpr int LPR = CG > 32 ? 32 : CG;   // lanes of a row in one phase-2 pass
  constexpr int HALVES = CG / LPR;         // column sets a lane walks (2 at L = 64)
  constexpr int RG = 32 / LPR;             // rows a warp's store instruction covers
  constexpr int RB = VC >= 8 ? 1 : 2;      // rows a lane carries at once
  constexpr int QS = L + 4;                // q's row stride in floats
  static_assert(G >= 1 && 32 % G == 0 && L % 4 == 0, "unsupported L");
  constexpr float kLog2e = 1.4426950408889634f;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long row0 = ((long long)blockIdx.x * kWarps + warp) * tile_rows;
  if (row0 >= n) return;  // the last block's spare warps
  const int rows = (int)(n - row0 < tile_rows ? n - row0 : tile_rows);
  const int words = rows * G;  // a row's G lanes are all in or all out

  extern __shared__ __align__(16) float q_all[];
  float* q = q_all + warp * tile_rows * QS;

  // every load of the tile in flight before the first is used
  const uint4* src_e0 = reinterpret_cast<const uint4*>(e0 + row0 * L);
  const uint4* src_s = reinterpret_cast<const uint4*>(s + row0 * L);
  const uint4* src_c = reinterpret_cast<const uint4*>(c + row0 * L);
  uint4 w_e0[kMaxWords], w_s[kMaxWords], w_c[kMaxWords];
#pragma unroll
  for (int i = 0; i < kMaxWords; ++i) {
    const int w = lane + 32 * i;
    if (w < words) {
      w_e0[i] = __ldg(src_e0 + w);
      w_s[i] = __ldg(src_s + w);
      w_c[i] = __ldg(src_c + w);
    }
  }

  // phase 1: E and q, one word of each array a lane at a time
  uint4* dst_e = reinterpret_cast<uint4*>(e_out + row0 * L);
#pragma unroll
  for (int i = 0; i < kMaxWords; ++i) {
    if (32 * i >= words) break;  // the same for every lane
    const int w = lane + 32 * i;
    const bool ok = w < words;
    float e[V], t[V];
    if (ok) {
      float cc[V];
      Word<T>::unpack(w_e0[i], e);
      Word<T>::unpack(w_s[i], t);
      Word<T>::unpack(w_c[i], cc);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = e[j] + (t[j] - cc[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = 0.f;
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < V; ++j) m = fmaxf(m, -e[j]);
#pragma unroll
    for (int o = 1; o < G; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      t[j] = exp2_approx((-e[j] - m) * kLog2e);
      sum += t[j];
    }
#pragma unroll
    for (int o = 1; o < G; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (ok) {
      dst_e[w] = Word<T>::pack(e);
      const float inv = rcp_approx(sum);
      float* qr = q + (w / G) * QS + (w % G) * V;
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(qr + j) =
            make_float4(t[j] * inv, t[j + 1] * inv, t[j + 2] * inv, t[j + 3] * inv);
    }
  }
  __syncwarp();  // q is complete

  // phase 2: C' = q . Mu, VC columns of RB rows a lane; lane's rows are
  // base + lane / LPR + b * RG
  float mu_r[L][VC];
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    const int col0 = (h * LPR + lane % LPR) * VC;
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int j = 0; j < VC; ++j) mu_r[l][j] = to_float(__ldg(mu + l * L + col0 + j));
    for (int base = 0; base < rows; base += RG * RB) {
      const int r0 = base + lane / LPR;
      float acc[RB][VC];
#pragma unroll
      for (int b = 0; b < RB; ++b)
#pragma unroll
        for (int j = 0; j < VC; ++j) acc[b][j] = 0.f;
#pragma unroll
      for (int l = 0; l < L; l += 4) {
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          // a row past the tile reads row 0 and is not stored
          const int r = r0 + b * RG < rows ? r0 + b * RG : 0;
          const float4 q4 = *reinterpret_cast<const float4*>(q + r * QS + l);
#pragma unroll
          for (int j = 0; j < VC; ++j) {
            acc[b][j] = fmaf(q4.x, mu_r[l][j], acc[b][j]);
            acc[b][j] = fmaf(q4.y, mu_r[l + 1][j], acc[b][j]);
            acc[b][j] = fmaf(q4.z, mu_r[l + 2][j], acc[b][j]);
            acc[b][j] = fmaf(q4.w, mu_r[l + 3][j], acc[b][j]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < RB; ++b)
        if (r0 + b * RG < rows)
          store_values<T, VC>(c_out + (row0 + r0 + b * RG) * L + col0, acc[b]);
    }
  }
}

template <int L, typename T>
cudaError_t launch(const void* e0, const void* s, const void* c, const void* mu, void* e_out,
                   void* c_out, long long n, int tile_rows, int grid, int smem_bytes,
                   cudaStream_t stream) {
  constexpr int G = L * sizeof(T) / 16;
  if (tile_rows * G > 32 * kMaxWords ||
      smem_bytes != kWarps * tile_rows * (L + 4) * (int)sizeof(float))
    return cudaErrorInvalidValue;
  fused_energy_update_kernel<L, T><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(e0), static_cast<const T*>(s), static_cast<const T*>(c),
      static_cast<const T*>(mu), static_cast<T*>(e_out), static_cast<T*>(c_out), n, tile_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int L, const void* e0, const void* s, const void* c, const void* mu,
                     void* e_out, void* c_out, long long n, int tile_rows, int grid, int smem,
                     cudaStream_t st) {
  switch (L) {
    case 8: return launch<8, T>(e0, s, c, mu, e_out, c_out, n, tile_rows, grid, smem, st);
    case 16: return launch<16, T>(e0, s, c, mu, e_out, c_out, n, tile_rows, grid, smem, st);
    case 32: return launch<32, T>(e0, s, c, mu, e_out, c_out, n, tile_rows, grid, smem, st);
    case 64: return launch<64, T>(e0, s, c, mu, e_out, c_out, n, tile_rows, grid, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer is 16-byte aligned and
// row-major contiguous; n > 0. The geometry comes from the wrapper's
// `launch_geometry`: warp tiles of `tile_rows` rows (at most 4 16-byte
// words of each array a lane), num_tiles = ceil(n / tile_rows), grid =
// ceil(num_tiles / 4) blocks of 128 threads, and `smem_bytes` of q scratch.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int fused_energy_update_launch(const void* e0, const void* s, const void* c,
                                          const void* mu, void* e_out, void* c_out, long long n,
                                          int L, int dtype, int tile_rows, int num_tiles,
                                          int grid, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || tile_rows <= 0 || num_tiles != (n + tile_rows - 1) / tile_rows ||
      grid != (num_tiles + kWarps - 1) / kWarps || smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(L, e0, s, c, mu, e_out, c_out, n, tile_rows, grid, smem_bytes, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(L, e0, s, c, mu, e_out, c_out, n, tile_rows, grid,
                                        smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}
