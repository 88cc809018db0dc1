// Fused mean-field update at L <= 256 labels for Hopper (K1w), sm_90a,
// plain C interface: bf16 on the tensor cores, f32 with the plain version's
// arithmetic.
//
// Replaces the Pallas kernel `fused_energy_update` (the JAX package's
// ops/pallas/meanfield.py, `_kernel`) for every L up to 256 that K1
// (meanfield.cu, L in {8, 16, 32, 64}) does not serve; larger L go to
// K1w_ffma (meanfield_wide_ffma.cu). It computes the same function:
//
//     E[i]  = E0[i] + (S[i] - C[i])
//     q     = softmax(-E[i])                    (max-subtracted)
//     C'[i] = q . Mu                            (L x L compatibility)
//
// with E, the max, the exps, the sum and the division in f32 and each
// output rounded once to the I/O dtype (f32 or bf16).
//
// Bound: at fullres128 (n = 2,088,960 rows, L = 128) the five (n, L) passes
// are 2.67 GB in bf16 (0.80 ms at 3.35 TB/s) and 5.35 GB in f32 (1.60 ms);
// the product, 2 L^2 n = 68.5 GFLOP, is 0.07 ms of bf16 tensor-core time.
// So bytes bound it, and the design keeps the memory busy.
//
// Numerics.
// - bf16 I/O (fullres128's state): the product keeps q's f32 accuracy on
//   the tensor cores. Mu is exact in bf16; q_hi = bf16(q), q_lo =
//   bf16(q - q_hi); two m16n8k16 bf16 MMAs with an f32 accumulator, per
//   k-step of 16 labels (in order of l) first q_lo.Mu, then q_hi.Mu (a q
//   rounded once to bf16 would move ~8% of C' values by a bf16 ulp). exp is
//   ex2.approx of x log2(e) (__expf), then one division a row and a
//   product a value.
// - f32 I/O: the plain version's arithmetic, bit for bit on the H100: the
//   softmax in PyTorch's warp-softmax order (lane j sums labels j, j + 32,
//   ... in order, the lanes reduced by xor 16, 8, 4, 2, 1; expf; a division
//   a value) and C' summed over l in order from 0 by FFMA, as cuBLAS sums
//   this product. The fused pipeline's f32 run is held within 5e-3 px of
//   the unfused loop, and its 5 iterations amplify any other rounding past
//   that: 3xTF32 (1e-6 off the plain version), a split-k f32 sum and even a
//   correctly rounded f64 product all move some pixels by 0.008-0.016 px.
//   So f32 stays on the FFMA pipes.
// Columns past L get q = 0 (their energy counts as +inf) and Mu rows and
// columns past L are zero, so padding L to LP adds nothing.
//
// Design (LP = L padded to 32, 64, 128 or 256; a template parameter):
// - Persistent blocks (`Cfg`: warps a block, blocks a SM for
//   __launch_bounds__) stage Mu once into shared memory: bf16 transposed
//   (MuT[j][l], rows padded so that the 16-byte fragment loads of a
//   quarter warp hit distinct banks), f32 as it is. f32 at LP = 256 (Mu
//   256 KB) splits the output columns into blocks of NB = 128 over
//   gridDim.y; each such block recomputes the softmax and only gridDim.y =
//   0 writes E.
// - Each warp walks tiles of rows (bf16: 16, one MMA row tile; f32: 8)
//   independently of the others: no block barrier after Mu is staged.
//   Within a quad (lanes 4g..4g+3) lane t holds row g (and g + 8), and of
//   every 64 bytes of a row the 16 bytes at 16t: E0, S, C are read and E
//   written as 16-byte words (a quad reads 64 contiguous bytes of 8 rows).
// - bf16: the next tile's E0, S and C are copied by 16-byte cp.async into
//   the warp's staging buffer while this tile's softmax and product run;
//   each lane copies and later reads only its own words, so its own
//   cp.async.wait_group is the only wait. The bytes in flight, not the
//   registers, then set how far the loads run ahead. f32 needs its shared
//   memory for Mu and the q tiles, and hides the loads' latency with 20
//   warps an SM instead (faster there than 9 warps with staging buffers).
// - bf16: the softmax runs in the registers that hold E (max and sum over
//   the lane's values, then two __shfl_xor_sync across the quad). The MMA's
//   k order is permuted to match the lane's 16-byte words (A and B alike),
//   so those registers are the A fragments (q as packed hi and lo pairs)
//   and one 16-byte shared load gives the B fragments of two k-steps. C'
//   accumulates in registers, 32 output columns (a pass) at a time, the
//   columns permuted inside each group of 4 n-tiles so that a lane ends
//   with 8 contiguous columns of each row, stored as one 16-byte word.
// - f32: E goes to the warp's q tile in shared memory (label-major), the
//   softmax runs a row at a time across the warp, and lane j accumulates
//   columns NB/32 j .. of the tile's 8 rows: per label one 16-byte Mu read
//   and two broadcast q reads for 32 FFMA, 8 labels unrolled.
// - Rows whose pitch L * elt is not a multiple of 16 bytes, or arrays not
//   16-byte aligned, take a value-by-value branch of the same loads and
//   stores straight from and to device memory (`vec` = 0), chosen once per
//   launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxSmem = 232448;  // the H100's opt-in limit a block
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxL = 256;
constexpr int kQStride = 12;  // f32: floats a label's 8 rows take in a warp's q tile

// Per dtype and LP: rows a warp's tile, warps a block, blocks a SM
// (__launch_bounds__), output columns a block (NB), and the dynamic shared
// memory: Mu (bf16: transposed rows of kStride elements; f32: LP rows of
// NB), then a warp's staging buffer (bf16: 3 arrays x kRows rows x LP
// values) or q tile (f32: LP labels x kQStride floats). Must agree with `ops/cuda/meanfield.py`
// (`wide_config`, `wide_geometry`).
template <typename T, int LP>
struct Cfg;

template <int LP>
struct Cfg<__nv_bfloat16, LP> {
  static constexpr int kRows = 16;  // one MMA row tile
  static constexpr int kWarps = LP <= 64 ? 8 : LP == 128 ? 12 : 3;
  static constexpr int kMinBlocks = LP <= 64 ? 2 : 1;
  static constexpr int kNB = LP;
  static constexpr int kNP = 32;                                // output columns a pass
  static constexpr int kVec = 8;                                // values of a 16-byte word
  static constexpr int kStride = LP % 64 == 32 ? LP : LP + 32;  // bf16 elements
  static constexpr int kMuBytes = kNB * kStride * 2;
  static constexpr int kBufBytes = 3 * kRows * LP * 2;
  static constexpr int kQBytes = 0;
  static constexpr bool kStage = true;
  static constexpr int kSmem = kMuBytes + kWarps * (kBufBytes + kQBytes);
};

template <int LP>
struct Cfg<float, LP> {
  static constexpr int kRows = 8;
  static constexpr bool kStage = false;  // many warps load straight into registers
  static constexpr int kWarps = LP <= 32 ? 8 : LP == 64 ? 16 : LP == 128 ? 20 : 8;
  static constexpr int kMinBlocks = LP <= 32 ? 2 : 1;
  static constexpr int kNB = LP <= 128 ? LP : 128;
  static constexpr int kVec = 4;
  static constexpr int kMuBytes = LP * kNB * 4;
  static constexpr int kBufBytes = 0;
  static constexpr int kQBytes = LP * kQStride * 4;
  static constexpr int kSmem = kMuBytes + kWarps * (kBufBytes + kQBytes);
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}

// V values of one row (cols col .. col + V - 1 of a row of L), as f32: the
// 16-byte word at `word` (staged in shared memory, or p itself), or value
// by value from p; the columns past L (and a row past n) read as 0.
template <typename T, int V>
__device__ __forceinline__ void load_row(float (&out)[V], const uint4* word,
                                         const T* __restrict__ p, bool vec, bool row_ok, int col,
                                         int L) {
  if (vec) {
    if (row_ok && col < L) {
      const uint4 w = *word;
      const T* x = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = to_float(x[v]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = 0.f;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = (row_ok && col + v < L) ? to_float(__ldg(p + v)) : 0.f;
  }
}

// V values (rounded once to T) to p, cols col .. col + V - 1 of a row of L:
// by the widest aligned words (`vec`: L is a whole number of 16-byte words,
// so each word is in or out), else value by value.
template <typename T, int V>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float (&x)[V], bool vec,
                                          bool row_ok, int col, int L) {
  if (!row_ok) return;
  if (vec && sizeof(T) == 4 && V % 4 == 0) {
#pragma unroll
    for (int v = 0; v < V; v += 4)
      if (col + v < L)
        *reinterpret_cast<float4*>(p + v) = make_float4(x[v], x[v + 1], x[v + 2], x[v + 3]);
  } else if (vec && sizeof(T) == 4 && V == 2) {
    if (col < L) *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else if (vec && sizeof(T) == 2 && V % 8 == 0) {
#pragma unroll
    for (int v = 0; v < V; v += 8) {
      if (col + v >= L) continue;
      uint4 w;
      w.x = pack_bf16(x[v], x[v + 1]);
      w.y = pack_bf16(x[v + 2], x[v + 3]);
      w.z = pack_bf16(x[v + 4], x[v + 5]);
      w.w = pack_bf16(x[v + 6], x[v + 7]);
      *reinterpret_cast<uint4*>(p + v) = w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (col + v < L) store1(p + v, x[v]);
  }
}

template <typename T, int LP>
__global__ void __launch_bounds__(Cfg<T, LP>::kWarps * 32, Cfg<T, LP>::kMinBlocks)
fused_energy_update_wide_kernel(const T* __restrict__ e0, const T* __restrict__ s,
                                const T* __restrict__ c, const T* __restrict__ mu,
                                T* __restrict__ e_out, T* __restrict__ c_out, long long n, int L,
                                int vec) {
  using C = Cfg<T, LP>;
  constexpr int V = C::kVec;       // values a lane holds of each 64-byte chunk of a row
  constexpr int W = 4 * V;         // columns of a chunk
  constexpr int kChunks = LP / W;  // chunks of a row
  constexpr int kQ = LP / 4;       // values a lane holds of a row
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kRows = C::kRows;  // rows of a warp's tile
  constexpr int kHalves = kRows / 8;
  static_assert(kBf16 ? kHalves == 2 : kHalves == 1, "bf16: one MMA row tile; f32: 8 rows");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's staging buffer: word (a, h, k) of lane at
  // ((a kHalves + h) kChunks + k) 32 + lane
  uint4* buf = reinterpret_cast<uint4*>(smem_raw + C::kMuBytes + warp * C::kBufBytes);
  auto slot = [&](int a, int h, int k) {
    return buf + ((a * kHalves + h) * kChunks + k) * 32 + lane;
  };
  // f32: this warp's q tile, label l's 8 rows at l * kQStride
  float* q_s = reinterpret_cast<float*>(smem_raw + C::kMuBytes + C::kWarps * C::kBufBytes +
                                        warp * C::kQBytes);

  const int n0 = blockIdx.y * C::kNB;  // this block's output columns

  // Mu once per block, zero past L (reads coalesced along j): bf16
  // transposed, MuT[j][l]; f32 as it is, Mu[l][j], this block's columns
  for (int i = threadIdx.x; i < LP * C::kNB; i += C::kWarps * 32) {
    const int l = i / C::kNB, j = i - l * C::kNB;
    const float m = (l < L && n0 + j < L) ? to_float(__ldg(mu + (long long)l * L + n0 + j)) : 0.f;
    if constexpr (kBf16) {
      reinterpret_cast<__nv_bfloat16*>(smem_raw)[j * C::kStride + l] = __float2bfloat16_rn(m);
    } else {
      reinterpret_cast<float*>(smem_raw)[i] = m;
    }
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const long long num_tiles = (n + kRows - 1) / kRows;
  const long long step = (long long)gridDim.x * C::kWarps;
  const bool write_e = blockIdx.y == 0;

  // Stage a tile's E0, S, C words that this lane reads (cp.async, 16 bytes
  // each, no registers held): lane-private slots, so the lane's own
  // wait_group makes them visible and no warp barrier is needed.
  auto stage = [&](long long tile) {
    const long long r = tile * kRows + g;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T* src = a == 0 ? e0 : a == 1 ? s : c;
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          const int col = k * W + t * V;
          if (r + 8 * h < n && col < L) cp_async16(slot(a, h, k), src + (r + 8 * h) * L + col);
        }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  long long tile = (long long)blockIdx.x * C::kWarps + warp;
  const bool staged = vec && C::kStage;
  if (staged && tile < num_tiles) stage(tile);
  for (; tile < num_tiles; tile += step) {
    const long long r0 = tile * kRows + g;  // this lane's rows r0 (and r0 + 8) while loading
    const bool ok[2] = {r0 < n, r0 + 8 < n};
    if (staged) asm volatile("cp.async.wait_group 0;" ::: "memory");

    // E = E0 + (S - C), written once; bf16 keeps it in registers (columns
    // past L as +inf) with each row's max, f32 puts it in the q tile
    float q[2][kBf16 ? kQ : 1];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const long long base = (r0 + 8 * h) * L;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int col = k * W + t * V;
        float a[V], b[V], d[V];
        // the staged word, or (f32) the word in device memory
        auto word = [&](int a, const T* p) {
          return C::kStage ? slot(a, h, k) : reinterpret_cast<const uint4*>(p);
        };
        load_row<T, V>(a, word(0, e0 + base + col), e0 + base + col, vec, ok[h], col, L);
        load_row<T, V>(b, word(1, s + base + col), s + base + col, vec, ok[h], col, L);
        load_row<T, V>(d, word(2, c + base + col), c + base + col, vec, ok[h], col, L);
#pragma unroll
        for (int v = 0; v < V; ++v) a[v] = a[v] + (b[v] - d[v]);
        if (write_e) store_row<T, V>(e_out + base + col, a, vec, ok[h], col, L);
        if constexpr (kBf16) {
          if (col + V > L) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              if (col + v >= L) a[v] = INFINITY;
          }
#pragma unroll
          for (int v = 0; v < V; ++v) {
            mx[h] = fmaxf(mx[h], -a[v]);
            q[h][k * V + v] = a[v];
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) q_s[(col + v) * kQStride + g] = a[v];
        }
      }
    }
    // the next tile's loads run during this tile's softmax and product
    if (staged && tile + step < num_tiles) stage(tile + step);

    if constexpr (kBf16) {
      // q = softmax(-E) per row: exp by ex2.approx of x log2(e) (__expf),
      // one division for the row and a product a value; then q as packed
      // (hi, lo) bf16 pairs
      uint32_t qh[2][kQ / 2], ql[2][kQ / 2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          q[h][i] = __expf(-q[h][i] - mx[h]);
          sum += q[h][i];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.f / sum;
#pragma unroll
        for (int i = 0; i < kQ / 2; ++i) {
          const float x0 = q[h][2 * i] * inv, x1 = q[h][2 * i + 1] * inv;
          qh[h][i] = pack_bf16(x0, x1);
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&qh[h][i]);
          ql[h][i] = pack_bf16(x0 - __low2float(hv), x1 - __high2float(hv));
        }
      }

      // C' = q . Mu on the tensor cores, kNP output columns a pass. This
      // lane's B rows: output column 8 (g / 2) + 2 J + g % 2 of each group
      // of 4 n-tiles is n-tile J's column g (so lane t ends with columns
      // 8t .. 8t + 7 of the group)
      constexpr int kTiles = C::kNP / 8;
      const __nv_bfloat16* mu_t = reinterpret_cast<const __nv_bfloat16*>(smem_raw) +
                                  (8 * (g >> 1) + (g & 1)) * C::kStride + t * V;
#pragma unroll 1
      for (int p = 0; p < C::kNB; p += C::kNP) {
        float acc[kTiles][4];
#pragma unroll
        for (int j = 0; j < kTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
#pragma unroll
          for (int j = 0; j < kTiles; ++j) {
            const int row = p + (j >> 2) * 32 + (j & 3) * 2;
            const uint4 bw = *reinterpret_cast<const uint4*>(mu_t + row * C::kStride + k * W);
            // k-step 0: labels 8t..8t+3 of the chunk, k-step 1: 8t+4..8t+7
            mma_bf16(acc[j], ql[0][4 * k], ql[1][4 * k], ql[0][4 * k + 1], ql[1][4 * k + 1],
                     bw.x, bw.y);
            mma_bf16(acc[j], qh[0][4 * k], qh[1][4 * k], qh[0][4 * k + 1], qh[1][4 * k + 1],
                     bw.x, bw.y);
            mma_bf16(acc[j], ql[0][4 * k + 2], ql[1][4 * k + 2], ql[0][4 * k + 3],
                     ql[1][4 * k + 3], bw.z, bw.w);
            mma_bf16(acc[j], qh[0][4 * k + 2], qh[1][4 * k + 2], qh[0][4 * k + 3],
                     qh[1][4 * k + 3], bw.z, bw.w);
          }
        }
#pragma unroll
        for (int grp = 0; grp < kTiles / 4; ++grp) {
          const int col = n0 + p + grp * 32 + 8 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x[8];
#pragma unroll
            for (int J = 0; J < 4; ++J) {
              x[2 * J] = acc[grp * 4 + J][2 * h];
              x[2 * J + 1] = acc[grp * 4 + J][2 * h + 1];
            }
            store_row<T, 8>(c_out + (r0 + 8 * h) * L + col, x, vec, ok[h], col, L);
          }
        }
      }
    } else {
      // q = softmax(-E) per row with the plain version's arithmetic: lane j
      // takes labels j, j + 32, ... in order, max and sum reduced across
      // the warp by xor 16, 8, 4, 2, 1 (PyTorch's warp softmax), expf and
      // one division a value
      __syncwarp();
      constexpr int kIt = LP / 32;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float x[kIt];
#pragma unroll
        for (int it = 0; it < kIt; ++it) {
          const int l = lane + 32 * it;
          x[it] = l < L ? -q_s[l * kQStride + r] : -INFINITY;
        }
        float m = x[0];
#pragma unroll
        for (int it = 1; it < kIt; ++it) m = m > x[it] ? m : x[it];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float b = __shfl_xor_sync(0xffffffffu, m, o);
          m = m < b ? b : m;
        }
        float sum = 0.f;
#pragma unroll
        for (int it = 0; it < kIt; ++it) {
          x[it] = expf(x[it] - m);
          sum += x[it];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum = sum + __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
        for (int it = 0; it < kIt; ++it) {
          const int l = lane + 32 * it;
          if (l < L) q_s[l * kQStride + r] = x[it] / sum;
        }
      }
      __syncwarp();

      // C' = q . Mu on the FFMA pipes, summed over l in order from 0 as the
      // plain version's product sums. Lane j takes columns kLaneCols j ..
      // of this block's for the tile's 8 rows: per label, two broadcast
      // reads of its q rows and its Mu columns by one 16-byte read
      constexpr int kLaneCols = C::kNB / 32;
      const float* mu_s = reinterpret_cast<const float*>(smem_raw) + lane * kLaneCols;
      float acc[kRows][kLaneCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) acc[r][j] = 0.f;
#pragma unroll 8
      for (int l = 0; l < L; ++l) {
        float m[kLaneCols];
        if constexpr (kLaneCols == 4) {
          const float4 w = *reinterpret_cast<const float4*>(mu_s + l * C::kNB);
          m[0] = w.x, m[1] = w.y, m[2] = w.z, m[3] = w.w;
        } else if constexpr (kLaneCols == 2) {
          const float2 w = *reinterpret_cast<const float2*>(mu_s + l * C::kNB);
          m[0] = w.x, m[1] = w.y;
        } else {
          m[0] = mu_s[l * C::kNB];
        }
#pragma unroll
        for (int r4 = 0; r4 < kRows; r4 += 4) {
          const float4 w = *reinterpret_cast<const float4*>(q_s + l * kQStride + r4);
          const float qr[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < kLaneCols; ++j)
              acc[r4 + u][j] = fmaf(qr[u], m[j], acc[r4 + u][j]);
        }
      }
      const int col = n0 + lane * kLaneCols;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long row = tile * kRows + r;
        store_row<T, kLaneCols>(c_out + row * L + col, acc[r], vec, row < n, col, L);
      }
      __syncwarp();  // the q tile is read before the next tile writes it
    }
  }
}

// The geometry the wrapper's `wide_geometry` computes, re-derived here.
int lp_for(int L) {
  int lp = 32;
  while (lp < L) lp *= 2;
  return lp;
}

template <typename T, int LP>
cudaError_t launch(const void* e0, const void* s, const void* c, const void* mu, void* e_out,
                   void* c_out, long long n, int L, int vec, int grid_x, int grid_y,
                   int smem_bytes, cudaStream_t stream) {
  using C = Cfg<T, LP>;
  static_assert(C::kSmem <= kMaxSmem, "Mu and the warps' buffers do not fit shared memory");
  const long long warps = ((n + C::kRows - 1) / C::kRows + C::kWarps - 1) / C::kWarps;
  if (grid_y != LP / C::kNB || smem_bytes != C::kSmem || grid_x < 1 || grid_x > warps)
    return cudaErrorInvalidValue;
  auto kernel = fused_energy_update_wide_kernel<T, LP>;
  if (smem_bytes > kDefaultSmem) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(grid_x, grid_y), C::kWarps * 32, smem_bytes, stream>>>(
      static_cast<const T*>(e0), static_cast<const T*>(s), static_cast<const T*>(c),
      static_cast<const T*>(mu), static_cast<T*>(e_out), static_cast<T*>(c_out), n, L, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lp(const void* e0, const void* s, const void* c, const void* mu, void* e_out,
                      void* c_out, long long n, int L, int lp, int vec, int grid_x, int grid_y,
                      int smem_bytes, cudaStream_t st) {
  auto go = [&](auto lp_value) {
    return launch<T, decltype(lp_value)::value>(e0, s, c, mu, e_out, c_out, n, L, vec, grid_x,
                                                grid_y, smem_bytes, st);
  };
  switch (lp) {
    case 32: return go(std::integral_constant<int, 32>());
    case 64: return go(std::integral_constant<int, 64>());
    case 128: return go(std::integral_constant<int, 128>());
    case 256: return go(std::integral_constant<int, 256>());
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every array is row-major contiguous,
// aligned to its element; n > 0, 1 <= L <= 256. The geometry comes from the
// wrapper's `wide_geometry`: LP = L padded to 32, 64, 128 or 256; a grid of
// grid_x persistent blocks (at most one a warp's tile of 16 rows) by
// grid_y = LP / NB output-column blocks; `smem_bytes` = the Mu planes. Rows
// are read and written by 16-byte words where every array is 16-byte
// aligned and L * elt is a multiple of 16, else value by value. Returns the
// launch's cudaError_t (0 = ok).
extern "C" int fused_energy_update_wide_launch(const void* e0, const void* s, const void* c,
                                               const void* mu, void* e_out, void* c_out,
                                               long long n, int L, int dtype, int lp, int grid_x,
                                               int grid_y, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || L <= 0 || L > kMaxL || lp != lp_for(L) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int elt = dtype == 0 ? 4 : 2;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(e0) | reinterpret_cast<uintptr_t>(s) |
                          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(e_out) |
                          reinterpret_cast<uintptr_t>(c_out);
  const int vec = (bases % 16 == 0) && ((L * elt) % 16 == 0);
  if (dtype == 0)
    return (int)launch_lp<float>(e0, s, c, mu, e_out, c_out, n, L, lp, vec, grid_x, grid_y,
                                 smem_bytes, st);
  return (int)launch_lp<__nv_bfloat16>(e0, s, c, mu, e_out, c_out, n, L, lp, vec, grid_x, grid_y,
                                       smem_bytes, st);
}
