// Fused mean-field update above 256 labels for Hopper (K1x), sm_90a, plain
// C interface: q staged once in shared memory, Mu streamed through it; bf16
// on the tensor cores (wgmma), f32 with the plain version's arithmetic.
//
// Replaces the Pallas kernel `fused_energy_update` (the JAX package's
// ops/pallas/meanfield.py, `_kernel`) for 257 <= L <= 1024 (XWIDE_MAX_L);
// K1 (meanfield.cu) serves L in {8, 16, 32, 64}, K1w (meanfield_wide.cu)
// every other L up to 256, K1xx (meanfield_xxwide.cu) L above 1024.
// It computes the same function:
//
//     E[i]  = E0[i] + (S[i] - C[i])
//     q     = softmax(-E[i])                    (max-subtracted)
//     C'[i] = q . Mu                            (L x L compatibility)
//
// with E, the max, the exps, the sum and the product in f32 and each output
// rounded once to the I/O dtype (f32 or bf16).
//
// Bound: at a half-size Middlebury frame (n = 1,473,108 rows, L = 320) the
// five (n, L) passes are 4.71 GB in bf16 (1.41 ms at 3.35 TB/s) and 9.43 GB
// in f32 (2.81 ms); q.Mu is 2 L^2 n = 302 GFLOP: 0.31 ms on the tensor cores
// (bf16; 0.92 ms with q's three terms), 4.50 ms on the f32 FFMA pipes. So
// bytes bound bf16 and the FFMA pipes bound f32. What stops K1w's design
// from stretching here is space: Mu (200 KB in bf16 at L = 320, 4 MB in f32
// at 1024) no longer fits beside anything in a block's 227 KB, and q kept
// in registers as MMA fragments already costs 254 registers at 256 labels.
//
// Design: one persistent block a SM, warp-specialised.
// - Producers (8 warps in bf16, 4 in f32) walk a tile of R consecutive rows
//   (R = 64, 32 or 16: the most whose two q buffers fit), R / warps rows
//   each, two rows a step up to 10 values a lane. Lane j holds labels j,
//   j + 32, ... (PyTorch's warp-softmax order); every load is unconditional
//   (the index clamped into the row) and the next step's rows are loaded
//   into registers while this step's are computed. Per row: E written
//   once, max and sum reduced by xor 16, 8, 4, 2, 1, and q into this tile's
//   q buffer in f32, zero past L up to LP (L padded to 64). bf16: __expf and
//   one division a row; f32: expf and a division a value, the plain
//   version's rounding. A named barrier hands the buffer to the consumers;
//   the producers go on with the next tile in the other buffer.
// - Consumers (4 warps, one warpgroup, in bf16; 8 in f32) compute C' = q .
//   Mu for the tile, `kNc` output columns a pass: Mu's (kKt x kNc) tiles,
//   in order of l, come from L2 by one bulk copy each (cp.async.bulk, the
//   TMA engine, completing on an mbarrier) of an image of Mu laid out as
//   the stages (`fused_energy_update_xwide_tile_mu_kernel`, run first),
//   through a ring of shared-memory stages; the ring runs on across passes
//   and tiles. Mu is read from L2 once a tile: (n / R) LP^2 elt bytes, half
//   the HBM bytes at L = 320 and R = 64.
//   bf16: wgmma m64nNk16 (N = 160 where R = 64: LP = 320 in two passes;
//   else 64) with f32 accumulators, A from registers: each warp reads its
//   16 rows of q as f32 pairs and splits them into three bf16 terms (hi,
//   mid, lo; Mu is exact in bf16, so the products keep q's f32 accuracy: two
//   terms moved phase L's disparity by 0.14 px mean off the plain version's,
//   three by 0.019), B from the stage (8 x 8 core matrices, no swizzle).
//   The producers give registers to the consumers (setmaxnreg), so that two
//   k-tiles of A and the accumulators stay live and ptxas keeps the wgmma
//   pipeline asynchronous.
//   f32: each thread owns R / 16 rows by 4 columns and sums over l in order
//   from 0 by FFMA, as cuBLAS sums this product: q label-major (a float4 of
//   4 rows a label), Mu by float4.
// - C' is stored by pairs (bf16) or 16-byte words (f32) where every array is
//   16-byte aligned and L * elt is a multiple of 16, else value by value.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxSmem = 232448;  // the H100's opt-in limit a block
constexpr int kMaxLP = 1024;      // XWIDE_MAX_L: 32 values a lane of a row
constexpr int kBarBytes = 64;     // the Mu ring's mbarriers, at the end of shared memory
// named barriers (0 is __syncthreads'): q buffer b full, q buffer b empty,
// the consumers' ring
constexpr int kFull = 1, kEmpty = 3, kRing = 5;

// Per dtype and R: producer and consumer warps, stages of the Mu ring and
// how many are filled ahead, labels a stage
template <typename T, int R>
struct Cfg;

template <int R>
struct Cfg<__nv_bfloat16, R> {
  static constexpr int kProducers = 8;
  static constexpr int kConsumers = 4;  // one warpgroup
  static constexpr int kStages = 4;
  static constexpr int kLead = 2;  // stages filled ahead: a stage's wgmma may run a stage on
  static constexpr int kKt = 32;   // (64 would need more registers than wgmma's pipeline has)
  static constexpr int kNc = R == 64 ? 160 : 64;  // output columns a pass: LP = 320 in two
  // registers a thread of the producers and of the consumers after
  // setmaxnreg, for up to 16 values a lane and above: 8 x 32 x 128 + 4 x 32
  // x 232 = 62464 and 8 x 32 x 152 + 4 x 32 x 200 = 64512, within the 168 x
  // 384 = 64512 the block holds at launch
  template <int kIt>
  static constexpr int kProducerRegs = kIt <= 16 ? 128 : 152;
  template <int kIt>
  static constexpr int kConsumerRegs = kIt <= 16 ? 232 : 200;
};

template <int R>
struct Cfg<float, R> {
  static constexpr int kProducers = 4;
  static constexpr int kConsumers = 8;
  static constexpr int kStages = 3;
  static constexpr int kLead = 2;
  static constexpr int kKt = R == 64 ? 32 : 16;
  static constexpr int kNc = 64;
};

// The shared memory a block takes: two q buffers (f32; bf16 state: R rows
// of LP + 8 values; f32 state: LP labels of R + 4 values), the Mu ring
// (bf16: 8 x 8 core matrices, 128 bytes each, n-groups 128 bytes apart and
// k-groups 16 kNc bytes; f32: kKt rows of kNc floats) and the ring's
// mbarriers.
template <typename T, int R>
__host__ __device__ constexpr int q_bytes(int lp) {
  return sizeof(T) == 2 ? R * (lp + 8) * 4 : lp * (R + 4) * 4;
}
template <typename T, int R>
__host__ __device__ constexpr int stage_bytes() {
  return Cfg<T, R>::kKt * Cfg<T, R>::kNc * (int)sizeof(T);
}
template <typename T, int R>
__host__ __device__ constexpr int smem_for(int lp) {
  return 2 * q_bytes<T, R>(lp) + Cfg<T, R>::kStages * stage_bytes<T, R>() + kBarBytes;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// q's pair (x, y) as three bf16 pairs hi + mid + lo: each term the
// rounding of what the terms before it leave, so their sum keeps q's f32
// accuracy (24 bits) and, Mu being exact in bf16, so do the products
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = v.x - hf.x, ry = v.y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// mbarriers and the bulk copy (the TMA engine) that fills the Mu ring
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma: shared-memory matrix descriptor of a no-swizzle (8 x 16-byte core
// matrix) layout; `lbo` and `sbo` in bytes
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (64 x 64, f32) += A (64 x 16 bf16, this warp's 16 rows in registers as
// an m16n8k16 A fragment) . B (16 x 64 bf16 in shared memory, N-major)
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_64x160x16(float (&d)[80], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
// d += A . B at N = 64 or 160 columns
template <int N>
__device__ __forceinline__ void wgmma_64xN(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  if constexpr (N == 160)
    wgmma_64x160x16(d, a, desc_b);
  else
    wgmma_64x64x16(d, a, desc_b);
}

template <typename T, int R, int kIt>
__global__ void __launch_bounds__((Cfg<T, R>::kProducers + Cfg<T, R>::kConsumers) * 32, 1)
fused_energy_update_xwide_kernel(const T* __restrict__ e0, const T* __restrict__ s,
                                 const T* __restrict__ c,
                                 const unsigned char* __restrict__ mu_tiled,
                                 T* __restrict__ e_out, T* __restrict__ c_out, long long n, int L,
                                 int lp, int vec) {
  using C = Cfg<T, R>;
  constexpr int kProducers = C::kProducers;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kThreads = (kProducers + C::kConsumers) * 32;
  constexpr int kConsumerThreads = C::kConsumers * 32;
  constexpr int kKt = C::kKt;
  constexpr int kStages = C::kStages;
  static_assert(R == 16 || R == 32 || R == 64, "a tile is 1, 2 or 4 MMA row tiles");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qb = q_bytes<T, R>(lp);
  unsigned char* ring = smem_raw + 2 * qb;
  const long long num_tiles = (n + R - 1) / R;
  const int my_tiles = (int)((num_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);

  if (warp < kProducers) {
    // bf16: the producers give registers to the consumers, whose wgmma
    // pipeline (80 accumulators, two k-tiles of q's three terms) would
    // otherwise be serialised by ptxas for want of them
    if constexpr (kBf16)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::template kProducerRegs<kIt>));
    // ---- producers: E, the softmax and q, kNR rows a step ---------------
    // Lane j holds labels j, j + 32, ... of a row (PyTorch's warp-softmax
    // order). Every load is unconditional (index clamped into the row) and,
    // up to 16 values a lane, the next step's rows are loaded into registers
    // while this step's are computed, so each warp keeps kNR rows of E0, S
    // and C in flight (at 32 values a lane the registers would spill).
    constexpr int kRpw = R / kProducers;  // rows of a tile a warp takes
    constexpr int kNR = kIt <= 10 ? 2 : 1;
    constexpr bool kPrefetch = kIt <= 16;
    const int iters = lp / 32;
    const long long total = (long long)my_tiles * kRpw;
    auto row_of = [&](long long q) {
      const long long tile = blockIdx.x + (q / kRpw) * gridDim.x;
      return tile * R + warp * kRpw + q % kRpw;
    };
    // the offset of sequence row q's first value (a row past the end reads
    // the last row)
    auto row_at = [&](long long q) {
      const long long row = q < total ? row_of(q) : 0;
      return (row < n ? row : n - 1) * L;
    };
    float ra[kPrefetch ? kNR : 1][kIt], rb[kPrefetch ? kNR : 1][kIt], rc[kPrefetch ? kNR : 1][kIt];
    auto load = [&](long long q) {
#pragma unroll
      for (int r = 0; r < (kPrefetch ? kNR : 0); ++r) {
        const long long at = row_at(q + r);
#pragma unroll
        for (int it = 0; it < kIt; ++it) {
          const int l = min(lane + 32 * it, L - 1);
          ra[r][it] = to_float(e0[at + l]);
          rb[r][it] = to_float(s[at + l]);
          rc[r][it] = to_float(c[at + l]);
        }
      }
    };

    load(0);
    for (long long q = 0; q < total; q += kNR) {
      const int tl = (int)(q / kRpw), i0 = (int)(q % kRpw), b = tl & 1;
      // -E (labels past L as -inf) and its max; then the next rows' loads
      float x[kNR][kIt], m[kNR];
      long long row[kNR];
      bool ok[kNR];
#pragma unroll
      for (int r = 0; r < kNR; ++r) {
        row[r] = row_of(q + r);
        ok[r] = row[r] < n;
        const long long at = kPrefetch ? 0 : row_at(q + r);
#pragma unroll
        for (int it = 0; it < kIt; ++it) {
          const int l = min(lane + 32 * it, L - 1);
          const float e =
              kPrefetch ? ra[r][it] + (rb[r][it] - rc[r][it])
                        : to_float(e0[at + l]) + (to_float(s[at + l]) - to_float(c[at + l]));
          const float v = lane + 32 * it < L ? -e : -INFINITY;
          x[r][it] = v;
          m[r] = it == 0 ? v : (m[r] > v ? m[r] : v);
        }
      }
      load(q + kNR);
#pragma unroll
      for (int r = 0; r < kNR; ++r) {
        T* pe = e_out + (ok[r] ? row[r] : 0) * L;
#pragma unroll
        for (int it = 0; it < kIt; ++it)
          if (ok[r] && lane + 32 * it < L) store1(pe + lane + 32 * it, -x[r][it]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < kNR; ++r) {
          const float other = __shfl_xor_sync(0xffffffffu, m[r], o);
          m[r] = m[r] < other ? other : m[r];
        }
      }
      float sum[kNR];
#pragma unroll
      for (int r = 0; r < kNR; ++r) {
        sum[r] = 0.f;
#pragma unroll
        for (int it = 0; it < kIt; ++it) {
          x[r][it] = kBf16 ? __expf(x[r][it] - m[r]) : expf(x[r][it] - m[r]);
          sum[r] += x[r][it];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < kNR; ++r) sum[r] = sum[r] + __shfl_xor_sync(0xffffffffu, sum[r], o);
      }
      if (i0 == 0 && tl >= 2) bar_sync(kEmpty + b, kThreads);  // the consumers are done with b
      unsigned char* qbuf = smem_raw + b * qb;
#pragma unroll
      for (int r = 0; r < kNR; ++r) {
        const int rr = warp * kRpw + i0 + r;  // the row in the tile
        if constexpr (kBf16) {
          float* qr = reinterpret_cast<float*>(qbuf) + rr * (lp + 8);
          const float inv = 1.f / sum[r];
#pragma unroll
          for (int it = 0; it < kIt; ++it)
            if (it < iters) qr[lane + 32 * it] = x[r][it] * inv;
        } else {
          float* qt = reinterpret_cast<float*>(qbuf) + rr;
#pragma unroll
          for (int it = 0; it < kIt; ++it)
            if (it < iters) qt[(lane + 32 * it) * (R + 4)] = x[r][it] / sum[r];
        }
      }
      if (i0 + kNR == kRpw) bar_arrive(kFull + b, kThreads);  // this warp's rows of b are in
    }
    return;
  }

  // ---- consumers: C' = q . Mu, Mu streamed through the ring --------------
  if constexpr (kBf16)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::template kConsumerRegs<kIt>));
  const int cw = warp - kProducers;
  const int ctid = threadIdx.x - kProducers * 32;
  constexpr int kNc = C::kNc;
  const int passes = (lp + kNc - 1) / kNc, ktiles = lp / kKt;
  const long long total_stages = (long long)my_tiles * passes * ktiles;

  // Mu's (kKt x kNc) tile of each stage (cyclic over passes, and over
  // k-tiles in order within a pass) into ring slot stage % kStages by one
  // bulk copy of its image in `mu_tiled`, completing on the slot's mbarrier;
  // `fp`, `fk`: the pass and k-tile of the next stage to fill
  constexpr int kStageBytes = stage_bytes<T, R>();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + smem_for<T, R>(lp) - kBarBytes);
  const int p0 = blockIdx.x % passes;  // blocks start on different columns of Mu
  int fp = p0, fk = 0;
  long long filled = 0;
  auto fill = [&]() {
    if (filled < total_stages) {
      if (ctid == 0) {
        const int slot = (int)(filled % kStages);
        mbar_expect_tx(full + slot, kStageBytes);
        bulk_copy(ring + slot * kStageBytes, mu_tiled + (long long)(fp * ktiles + fk) * kStageBytes,
                  kStageBytes, full + slot);
      }
      if (++fk == ktiles) fk = 0, fp = fp + 1 == passes ? 0 : fp + 1;
      ++filled;
    }
  };

  if (ctid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  bar_sync(kRing, kConsumerThreads);
  // kLead stages ahead: the slot refilled was read kStages - kLead stages
  // ago (bf16: two, since a stage's wgmma may run on after its k-tile)
  for (int q = 0; q < C::kLead; ++q) fill();
  long long stage = 0;
  for (int tl = 0; tl < my_tiles; ++tl) {
    const int b = tl & 1;
    const long long row0 = (blockIdx.x + (long long)tl * gridDim.x) * R;
    bar_sync(kFull + b, kThreads);  // the producers' q of this tile is in buffer b
    const unsigned char* qbuf = smem_raw + b * qb;
    if constexpr (kBf16) {
      // one warpgroup: wgmma m64n64k16, warp cw's 16 rows of A: q read as
      // f32 pairs in the m16n8k16 A layout (row g or g + 8, labels 2t, 2t +
      // 1 and 2t + 8, 2t + 9 of a k-step) and split into three bf16 terms
      // (rows past R repeat rows of the tile and are not stored); B from
      // the stage by descriptor
      const int g = lane >> 2, t = lane & 3;
      const float* q0 = reinterpret_cast<const float*>(qbuf) +
                        ((cw * 16) % R + g) * (lp + 8) + 2 * t;  // row g; row g + 8 below
      uint32_t ah[2][kKt / 16][4], am[2][kKt / 16][4], al[2][kKt / 16][4];
      for (int pi = 0; pi < passes; ++pi) {
        const int p = (p0 + pi) % passes;
        float acc[kNc / 2];
#pragma unroll
        for (int i = 0; i < kNc / 2; ++i) acc[i] = 0.f;
        // two k-tiles an iteration, so that the A registers of a k-tile whose
        // wgmma may still run are not overwritten (ktiles is a whole number:
        // LP is a multiple of 64 = kKt; an odd count ends with a single one)
        auto ktile = [&](auto slot, int k) {
          constexpr int S = decltype(slot)::value;
          bar_sync(kRing, kConsumerThreads);  // stage - 2's wgmma is done in every warp
          fill();
          mbar_wait(full + (int)(stage % kStages), (int)(stage / kStages) & 1);
          const unsigned char* mus = ring + (int)(stage % kStages) * stage_bytes<T, R>();
#pragma unroll
          for (int kk = 0; kk < kKt / 16; ++kk) {
            const float* qk = q0 + k * kKt + kk * 16;
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // a0: row g, a1: g + 8, a2, a3: labels + 8
              const float2 v =
                  *reinterpret_cast<const float2*>(qk + (i & 1) * 8 * (lp + 8) + (i >> 1) * 8);
              split3(v, ah[S][kk][i], am[S][kk][i], al[S][kk][i]);
            }
          }
          wgmma_fence();
          acc_fence(acc);
#pragma unroll
          for (int kk = 0; kk < kKt / 16; ++kk) {
            // k-groups of 8 labels 16 kNc bytes apart, n-groups of 8 columns 128
            const uint64_t desc = smem_desc(mus + kk * 32 * kNc, 16 * kNc, 128);
            wgmma_64xN<kNc>(acc, al[S][kk], desc);
            wgmma_64xN<kNc>(acc, am[S][kk], desc);
            wgmma_64xN<kNc>(acc, ah[S][kk], desc);
          }
          wgmma_commit();
          acc_fence(acc);
          wgmma_wait<1>();
          ++stage;
        };
        int k = 0;
        for (; k + 1 < ktiles; k += 2) {
          ktile(std::integral_constant<int, 0>(), k);
          ktile(std::integral_constant<int, 1>(), k + 1);
        }
        if (k < ktiles) ktile(std::integral_constant<int, 0>(), k);
        wgmma_wait<0>();
        acc_fence(acc);
        if (cw * 16 < R) {
#pragma unroll
          for (int j = 0; j < kNc / 8; ++j) {
            const int col = p * kNc + j * 8 + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const long long row = row0 + cw * 16 + g + 8 * h;
              if (row >= n) continue;
              T* dst = c_out + row * L + col;
              const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
              if (vec) {  // L is a multiple of 8: the pair is in or out
                if (col < L)
                  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
              } else {
                if (col < L) store1(dst, v0);
                if (col + 1 < L) store1(dst + 1, v1);
              }
            }
          }
        }
      }
    } else {
      constexpr int kRT = R / 16;  // rows a thread
      const int cg = ctid % 16, rg = ctid / 16;
      const float* qt = reinterpret_cast<const float*>(qbuf) + rg * kRT;
      for (int pi = 0; pi < passes; ++pi) {
        const int p = (p0 + pi) % passes;
        float acc[kRT][4];
#pragma unroll
        for (int r = 0; r < kRT; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
        for (int k = 0; k < ktiles; ++k, ++stage) {
          bar_sync(kRing, kConsumerThreads);  // every warp is done with the slot refilled next
          fill();
          mbar_wait(full + (int)(stage % kStages), (int)(stage / kStages) & 1);
          const float* mus =
              reinterpret_cast<const float*>(ring + (int)(stage % kStages) * stage_bytes<T, R>()) +
              4 * cg;
          const float* qk = qt + k * kKt * (R + 4);
          // over l in order from 0, one FFMA a (row, column) a label
#pragma unroll
          for (int a = 0; a < kKt; ++a) {
            const float4 mv = *reinterpret_cast<const float4*>(mus + a * kNc);
            float qv[kRT];
            if constexpr (kRT == 4) {
              const float4 w = *reinterpret_cast<const float4*>(qk + a * (R + 4));
              qv[0] = w.x, qv[1] = w.y, qv[2] = w.z, qv[3] = w.w;
            } else if constexpr (kRT == 2) {
              const float2 w = *reinterpret_cast<const float2*>(qk + a * (R + 4));
              qv[0] = w.x, qv[1] = w.y;
            } else {
              qv[0] = qk[a * (R + 4)];
            }
#pragma unroll
            for (int r = 0; r < kRT; ++r) {
              acc[r][0] = fmaf(qv[r], mv.x, acc[r][0]);
              acc[r][1] = fmaf(qv[r], mv.y, acc[r][1]);
              acc[r][2] = fmaf(qv[r], mv.z, acc[r][2]);
              acc[r][3] = fmaf(qv[r], mv.w, acc[r][3]);
            }
          }
        }
        const int col = p * kNc + 4 * cg;
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          const long long row = row0 + rg * kRT + r;
          if (row >= n) continue;
          T* dst = c_out + row * L + col;
          if (vec) {  // L is a multiple of 4: the word is in or out
            if (col < L)
              *reinterpret_cast<float4*>(dst) =
                  make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (col + v < L) store1(dst + v, acc[r][v]);
          }
        }
      }
    }
    if (tl + 2 < my_tiles) bar_arrive(kEmpty + b, kThreads);  // buffer b is free again
  }
}

// Mu's image as the ring's stages, in order (pass, k-tile): bf16 in 8 x 8
// core matrices (k-group at 8 kNc elements, n-group at 64, k row at 8), f32
// row-major; zero past L (the passes may run past LP)
template <typename T, int kKt, int kNc>
__global__ void fused_energy_update_xwide_tile_mu_kernel(const T* __restrict__ mu,
                                                        T* __restrict__ out, int L, int lp) {
  const int ktiles = lp / kKt, cols = (lp + kNc - 1) / kNc * kNc;
  const long long total = (long long)lp * cols;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int l = (int)(i / cols), j = (int)(i % cols);
    const int a = l % kKt, jj = j % kNc;
    const long long stage = (long long)(j / kNc) * ktiles + l / kKt;
    const int off = sizeof(T) == 2 ? (a >> 3) * 8 * kNc + (jj >> 3) * 64 + (a & 7) * 8 + (jj & 7)
                                   : a * kNc + jj;
    out[stage * kKt * kNc + off] = l < L && j < L ? mu[(long long)l * L + j] : from_float<T>(0.f);
  }
}

template <typename T, int R, int kIt>
cudaError_t launch(const void* e0, const void* s, const void* c, const void* mu,
                   void* mu_tiled, void* e_out, void* c_out, long long n, int L, int lp, int vec,
                   int grid, int smem_bytes, cudaStream_t stream) {
  const long long tiles = (n + R - 1) / R;
  if (smem_bytes != smem_for<T, R>(lp) || smem_bytes > kMaxSmem || grid < 1 ||
      grid > tiles || lp > 32 * kIt || (kIt > 10 && lp <= 32 * (kIt == 16 ? 10 : 16)))
    return cudaErrorInvalidValue;
  constexpr int kNc = Cfg<T, R>::kNc;
  const long long blocks = ((long long)lp * ((lp + kNc - 1) / kNc * kNc) + 255) / 256;
  fused_energy_update_xwide_tile_mu_kernel<T, Cfg<T, R>::kKt, kNc>
      <<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, stream>>>(
          static_cast<const T*>(mu), static_cast<T*>(mu_tiled), L, lp);
  auto kernel = fused_energy_update_xwide_kernel<T, R, kIt>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, (Cfg<T, R>::kProducers + Cfg<T, R>::kConsumers) * 32, smem_bytes, stream>>>(
      static_cast<const T*>(e0), static_cast<const T*>(s), static_cast<const T*>(c),
      static_cast<const unsigned char*>(mu_tiled), static_cast<T*>(e_out), static_cast<T*>(c_out),
      n, L, lp, vec);
  return cudaGetLastError();
}

// the instantiations `xwide_geometry` can choose: (R, values a lane)
template <typename T>
cudaError_t launch_rows(const void* e0, const void* s, const void* c, const void* mu,
                        void* mu_tiled, void* e_out, void* c_out, long long n, int L, int lp,
                        int rows, int vec, int grid, int smem_bytes, cudaStream_t st) {
  const int it = lp <= 320 ? 10 : lp <= 512 ? 16 : 32;
  if (rows == 64 && it == 10)
    return launch<T, 64, 10>(e0, s, c, mu, mu_tiled, e_out, c_out, n, L, lp, vec, grid,
                              smem_bytes, st);
  if (rows == 32 && it == 16)
    return launch<T, 32, 16>(e0, s, c, mu, mu_tiled, e_out, c_out, n, L, lp, vec, grid,
                              smem_bytes, st);
  if (rows == 32 && it == 32)
    return launch<T, 32, 32>(e0, s, c, mu, mu_tiled, e_out, c_out, n, L, lp, vec, grid,
                              smem_bytes, st);
  if (rows == 16 && it == 32)
    return launch<T, 16, 32>(e0, s, c, mu, mu_tiled, e_out, c_out, n, L, lp, vec, grid,
                              smem_bytes, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every array is row-major contiguous,
// aligned to its element; n > 0, 1 <= L <= 1024; `mu_tiled` is scratch of
// LP * (LP rounded up to the pass width) elements, 16-byte aligned, for
// Mu's stage images. The geometry
// comes from the wrapper's `xwide_geometry`: LP = L padded to a multiple of
// 64, `rows` = R rows a tile (64, 32 or 16: the most whose two q buffers and
// the Mu ring fit), `grid` persistent blocks (at most one a tile) and
// `smem_bytes`, re-checked here. C' is stored by pairs (bf16) or 16-byte
// words (f32) where every array is 16-byte aligned and L * elt is a multiple
// of 16, else value by value. Returns the launch's cudaError_t (0 = ok).
extern "C" int fused_energy_update_xwide_launch(const void* e0, const void* s, const void* c,
                                                const void* mu, void* mu_tiled, void* e_out,
                                                void* c_out,
                                                long long n, int L, int dtype, int lp, int rows,
                                                int grid, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || L <= 0 || lp != (L + 63) / 64 * 64 || lp > kMaxLP || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int elt = dtype == 0 ? 4 : 2;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(e0) | reinterpret_cast<uintptr_t>(s) |
                          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(e_out) |
                          reinterpret_cast<uintptr_t>(c_out);
  if (reinterpret_cast<uintptr_t>(mu_tiled) % 16) return (int)cudaErrorInvalidValue;
  const int vec = (bases % 16 == 0) && ((L * elt) % 16 == 0);
  if (dtype == 0)
    return (int)launch_rows<float>(e0, s, c, mu, mu_tiled, e_out, c_out, n, L, lp, rows, vec,
                                   grid, smem_bytes, st);
  return (int)launch_rows<__nv_bfloat16>(e0, s, c, mu, mu_tiled, e_out, c_out, n, L, lp, rows,
                                         vec, grid, smem_bytes, st);
}
