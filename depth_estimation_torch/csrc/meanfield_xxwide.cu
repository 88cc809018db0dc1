// Fused mean-field update above 1024 labels for Hopper (K1xx), sm_90a, plain
// C interface: q produced in label chunks, Mu streamed by bulk copies (the
// TMA engine); bf16 on the tensor cores (wgmma), f32 with the plain
// version's arithmetic.
//
// Replaces the Pallas kernel `fused_energy_update` (the JAX package's
// ops/pallas/meanfield.py, `_kernel`) for L > 1024 (XWIDE_MAX_L), with no
// upper limit; K1 (meanfield.cu) serves L in {8, 16, 32, 64}, K1w
// (meanfield_wide.cu) every other L up to 256, K1x (meanfield_xwide.cu) up
// to 1024. It computes the same function:
//
//     E[i]  = E0[i] + (S[i] - C[i])
//     q     = softmax(-E[i])                    (max-subtracted)
//     C'[i] = q . Mu                            (L x L compatibility)
//
// with E, the max, the exps, the sum and the product in f32 and each output
// rounded once to the I/O dtype (f32 or bf16).
//
// Bound: at a 512x768 frame's rows at 1536 labels (n = 393,216) the five
// (n, L) passes are 6.04 GB in bf16 (1.80 ms at 3.35 TB/s) and 12.08 GB in
// f32 (3.61 ms); q.Mu is 2 L^2 n = 1.86 TFLOP: 1.88 ms on the tensor cores
// with q in one bf16 term, 5.63 ms with the three terms that keep q's f32
// accuracy, 27.7 ms on the f32 FFMA pipes. So above L ~ 492 the bf16 update
// is bound by the tensor cores, and f32 by the FFMA pipes. What stops K1x's
// design from stretching here: its producers hold a row in registers (32
// values a lane), a tile's whole q no longer fits in shared memory beside
// anything, and one wgmma covers at most 256 output columns.
//
// Design: one persistent block a SM of 4 producer warps and 8 consumer
// warps (two warpgroups). A ring of stages in shared memory carries, for
// kKc = 32 labels at a time, a tile's q chunk (written by the producers)
// and Mu's (kKc x 512) tile (one bulk copy of a pre-tiled image of Mu,
// `fused_energy_update_xxwide_tile_mu_kernel`, run first, completing on the
// stage's mbarrier). C' is computed 512 output columns a pass; each pass
// walks all of L in chunks, so q is produced again in every pass.
// - bf16: a work item is a (64-row tile, pass) pair, block b taking items
//   b, b + grid, ..., so that the blocks on one tile at a time (one a pass)
//   share its rows in L2: with 128-row tiles walked pass after pass by one
//   block, 132 tiles (155 MB) outgrew the 50 MB L2 and every pass re-read
//   device memory (26.9 ms). An item walks its rows once: FlashAttention's
//   online softmax, with a reference max raised only where a chunk's max
//   exceeds it by 2^8, the sums and accumulators then rescaled, and 1 / sum
//   applied to C' at the end. A lane takes 8 consecutive labels of 2 rows
//   (16-byte loads where rows allow); q's terms 2^(y - m) go out as three
//   bf16 terms, hi + mid + lo exactly (truncations of what the ones before
//   leave; Mu being exact in bf16, the products keep q's f32 accuracy: two
//   terms moved phase L's disparity by 0.14 px mean off the plain
//   version's), written as wgmma's K-major core matrices. Each consumer
//   warpgroup runs wgmma m64n256k16 on its half of the pass's columns, A
//   (a q term) and B (its half of the Mu tile) both from shared memory by
//   descriptor, f32 accumulators in registers; a stage is released once the
//   next stage's wgmma group is issued and the one before has completed.
// - f32: a work item is a 32-row tile, all its passes. The producers
//   repeat PyTorch's warp softmax bit for bit (its own kernel up to 2048
//   labels: lane j sums exp(x - max) over labels j, j + 32, ... in order,
//   then xor 16, 8, 4, 2, 1; expf and a division a value): the next tile's
//   row statistics (E written, the max, the sum) are walked a few steps
//   between this tile's chunks, and q is recomputed from E in each pass.
//   Each consumer thread sums an 8 x 8 block of C' over l in order from 0
//   by FFMA, as cuBLAS's f32 kernel sums this product, q and Mu read as
//   float4.
// - C' is stored by pairs (bf16) or 16-byte words (f32) where the arrays'
//   alignment and L allow, else value by value.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;  // the H100's opt-in limit a block
constexpr int kKc = 32;           // labels a stage: a chunk of q, rows of Mu's tile
constexpr int kConsumers = 8;     // consumer warps: two warpgroups
constexpr int kConsumerThreads = kConsumers * 32;
constexpr float kRescale = 8.f;   // bf16: log2 of the largest q term before the sums rescale

// Per dtype: rows a tile, output columns a pass, stages of the ring, and a
// stage's q chunk, Mu tile and (bf16) row factors in bytes.
// bf16: a work item is a (tile, pass) pair, so that the blocks working on
// one tile at a time share its rows in L2; q's three terms, each R rows x
// kKc labels as 8 x 8 core matrices (8 rows of 16 bytes, 128 bytes; the
// kKc / 8 of a row group side by side); Mu's tile as two halves of 256
// columns, one a warpgroup, each as 8 x 8 core matrices of 8 columns a
// k-row, n-groups 128 bytes apart, k-groups 16 x 256; then each row's
// rescale factor and 1 / sum (f32) and a flag a producer warp.
// f32: a work item is a tile, all its passes; q label-major (a label's R
// rows padded by 4 floats), Mu's tile row-major; then the row statistics of
// two tiles (a float2 a row).
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int kProducers = 4;
  static constexpr int kRows = 64;   // one m64 row block, shared by both warpgroups
  static constexpr int kNc = 512;    // a warpgroup's 256 (wgmma's widest N) each
  static constexpr int kStages = 5;
  static constexpr int kTermBytes = kRows * kKc * 2;
  static constexpr int kQBytes = 3 * kTermBytes;
  static constexpr int kMuBytes = kKc * kNc * 2;
  static constexpr int kAuxBytes = 640;  // 2 kRows floats, kProducers flags, padded to 128
  static constexpr int kStageBytes = kQBytes + kMuBytes + kAuxBytes;
  static constexpr int kStatsBytes = 0;
};
template <>
struct Cfg<float> {
  static constexpr int kProducers = 4;
  static constexpr int kRows = 32;
  static constexpr int kNc = 512;
  static constexpr int kStages = 3;
  static constexpr int kQStride = kRows + 4;
  static constexpr int kQBytes = kKc * kQStride * 4;
  static constexpr int kMuBytes = kKc * kNc * 4;
  static constexpr int kStageBytes = kQBytes + kMuBytes;
  static constexpr int kStatsBytes = 2 * kRows * 8;
};
template <typename T>
constexpr int kThreads = (Cfg<T>::kProducers + kConsumers) * 32;
// the shared memory: the ring's stages, the row statistics (f32), the
// ring's full and empty mbarriers
template <typename T>
__host__ __device__ constexpr int bar_offset() {
  return Cfg<T>::kStages * Cfg<T>::kStageBytes + Cfg<T>::kStatsBytes;
}
template <typename T>
__host__ __device__ constexpr int smem_for() {
  return bar_offset<T>() + 2 * Cfg<T>::kStages * 8;
}
static_assert(smem_for<bf16>() <= kMaxSmem && smem_for<float>() <= kMaxSmem, "ring too large");
static_assert(Cfg<bf16>::kStageBytes % 128 == 0 && Cfg<float>::kStageBytes % 16 == 0 &&
                  Cfg<float>::kQBytes % 16 == 0,
              "stage alignment");
static_assert(Cfg<bf16>::kRows == 16 * Cfg<bf16>::kProducers &&
                  2 * Cfg<bf16>::kRows * 4 + 4 * Cfg<bf16>::kProducers <= Cfg<bf16>::kAuxBytes,
              "bf16: 16 rows a producer warp, the row factors and flags in a stage");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// mbarriers and the bulk copy (the TMA engine) that fills a stage's Mu tile
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
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
// the producers' stores of q, seen by the consumers' wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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
__device__ __forceinline__ void acc_fence(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (64 x 256, f32) += A (64 x 16 bf16, K-major, by descriptor) . B (16 x
// 256 bf16, N-major, by descriptor)
__device__ __forceinline__ void wgmma_64x256x16(float (&d)[128], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ---- bf16 values ----------------------------------------------------------
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ void unpack8(const uint4& w, float (&v)[8]) {
  v[0] = bf_lo(w.x), v[1] = bf_hi(w.x), v[2] = bf_lo(w.y), v[3] = bf_hi(w.y);
  v[4] = bf_lo(w.z), v[5] = bf_hi(w.z), v[6] = bf_lo(w.w), v[7] = bf_hi(w.w);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// 8 values of a row from label l0, indices clamped into the row: one 16-byte
// load (vw = 8: rows of a multiple of 16 bytes, 16-byte aligned), two 8-byte
// loads (vw = 4) or one by one (vw = 1)
__device__ __forceinline__ uint4 ld8(const bf16* __restrict__ row, int l0, int L, int vw) {
  const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
  if (vw == 8) return __ldg(reinterpret_cast<const uint4*>(p + min(l0, L - 8)));
  if (vw == 4) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p + min(l0, L - 4)));
    const uint2 b = __ldg(reinterpret_cast<const uint2*>(p + min(l0 + 4, L - 4)));
    return make_uint4(a.x, a.y, b.x, b.y);
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__ldg(p + min(l0 + 2 * i, L - 1)) |
           ((uint32_t)__ldg(p + min(l0 + 2 * i + 1, L - 1)) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}
// the labels of v below L into a row from label l0, as ld8 reads them
__device__ __forceinline__ void st8(bf16* row, int l0, int L, int vw, const float (&v)[8]) {
  const uint4 w = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                             pack2(v[6], v[7]));
  if (vw == 8) {
    if (l0 < L) *reinterpret_cast<uint4*>(row + l0) = w;
  } else if (vw == 4) {
    if (l0 < L) *reinterpret_cast<uint2*>(row + l0) = make_uint2(w.x, w.y);
    if (l0 + 4 < L) *reinterpret_cast<uint2*>(row + l0 + 4) = make_uint2(w.z, w.w);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (l0 + i < L) row[l0 + i] = __float2bfloat16_rn(v[i]);
  }
}
// 2^x (the MUFU's approximation; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the Mu tile of stage (pass p, k-tile k) into a ring stage by one bulk
// copy of its image, completing on the stage's full mbarrier
template <typename T>
__device__ __forceinline__ void fill_mu(unsigned char* stage, const unsigned char* mu_img, int p,
                                        int k, int nk, uint64_t* bar) {
  mbar_expect_tx(bar, Cfg<T>::kMuBytes);
  bulk_copy(stage + Cfg<T>::kQBytes, mu_img + ((long long)p * nk + k) * Cfg<T>::kMuBytes,
            Cfg<T>::kMuBytes, bar);
}

// 8 values as three bf16 terms, hi + mid + lo = v exactly: hi the top 8
// bits of v's significand, mid the next 8 of what remains, lo the rest
// (each remainder is exact in f32, the last one in bf16); pairs packed low
// value first
__device__ __forceinline__ void split3_8(const float (&v)[8], uint4& hi, uint4& mid, uint4& lo) {
  uint32_t h[8], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = __float_as_uint(v[i]) & 0xffff0000u;
    const float r = v[i] - __uint_as_float(h[i]);
    m[i] = __float_as_uint(r) & 0xffff0000u;
    l[i] = __float_as_uint(r - __uint_as_float(m[i]));
  }
  hi = make_uint4(__byte_perm(h[0], h[1], 0x7632), __byte_perm(h[2], h[3], 0x7632),
                  __byte_perm(h[4], h[5], 0x7632), __byte_perm(h[6], h[7], 0x7632));
  mid = make_uint4(__byte_perm(m[0], m[1], 0x7632), __byte_perm(m[2], m[3], 0x7632),
                   __byte_perm(m[4], m[5], 0x7632), __byte_perm(m[6], m[7], 0x7632));
  lo = make_uint4(__byte_perm(l[0], l[1], 0x7632), __byte_perm(l[2], l[3], 0x7632),
                  __byte_perm(l[4], l[5], 0x7632), __byte_perm(l[6], l[7], 0x7632));
}

// bf16: work items (tile, pass), item i of block b the (b + i grid)-th;
// FlashAttention's online softmax, so that an item walks its rows once; the
// two consumer warpgroups share each q chunk, on their halves of the
// pass's columns
__device__ __forceinline__ void xxwide_bf16(const bf16* __restrict__ e0,
                                            const bf16* __restrict__ s,
                                            const bf16* __restrict__ c,
                                            const unsigned char* __restrict__ mu_img,
                                            bf16* __restrict__ e_out, bf16* __restrict__ c_out,
                                            long long n, int L, int lp, int passes, int vw,
                                            int vec, unsigned char* smem, uint64_t* full,
                                            uint64_t* empty) {
  using C = Cfg<bf16>;
  constexpr int R = C::kRows, kS = C::kStages, kRpw = R / C::kProducers;
  constexpr float kLog2e = 1.4426950408889634f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nk = lp / kKc;  // stages an item
  const long long num_items = (n + R - 1) / R * passes;
  const int my_items = (int)((num_items - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const long long total = (long long)my_items * nk;

  if (warp < C::kProducers) {
    // ---- producers: lane j takes labels 8 (j / 8) .. + 7 of a chunk in
    // rows j % 8 + 8h (h < 2) of the warp's 16. Per row, a reference max m
    // of x = -E and this lane's part of the sum of exp(x - m): m is the first
    // chunk's max, raised to a later chunk's where that exceeds it by more
    // than kRescale log2 units, the sums and the consumers' accumulators
    // then scaled by exp(m_old - m_new) (the row's factor, and the warp's
    // flag, in the stage); q's terms are exp(x - m) < 2^kRescale, x - m
    // taken before the scaling to log2 units (as PyTorch's softmax, exact
    // near the max: E of several hundred scaled first moved 3e-5 of q), and
    // the last stage carries each row's 1 / sum. The pass-0 item of a tile
    // writes E.
    const int kg = lane >> 3, r8 = lane & 7;
    // item j's first row and pass
    auto item_at = [&](int j, long long& row0, int& p) {
      const int item = blockIdx.x + j * gridDim.x;
      row0 = (long long)(item / passes) * R, p = item % passes;
    };
    // a stage's values: E0, S and C of this lane's 2 x 8, as loaded
    uint4 v[3][2];
    auto load = [&](long long row0, int k) {
      const int l0 = k * kKc + 8 * kg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + kRpw * warp + 8 * h + r8;
        const long long base = (row < n ? row : n - 1) * L;
        v[0][h] = ld8(e0 + base, l0, L, vw), v[1][h] = ld8(s + base, l0, L, vw),
        v[2][h] = ld8(c + base, l0, L, vw);
      }
    };
    float mref[2], sum[2];
    int j = 0, k = 0, p, slot = 0, phase = 0;  // the stage's ring slot, and its round's parity
    long long row0;
    item_at(0, row0, p);
    load(row0, 0);
    for (long long q = 0; q < total; ++q) {
      const int l0 = k * kKc + 8 * kg;
      const bool whole = (k + 1) * kKc <= L;  // no label of the chunk past L
      float e[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a[8], b[8], cc[8];
        unpack8(v[0][h], a), unpack8(v[1][h], b), unpack8(v[2][h], cc);
#pragma unroll
        for (int i = 0; i < 8; ++i) e[h][i] = a[i] + (b[i] - cc[i]);
      }
      // the next stage's loads in flight
      int nj = j, nkk = k + 1, np = p;
      long long nrow0 = row0;
      if (nkk == nk) {
        nkk = 0, nj = j + 1;
        if (nj < my_items) item_at(nj, nrow0, np);
      }
      if (q + 1 < total) load(nrow0, nkk);
      float cm[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + kRpw * warp + 8 * h + r8;
        if (p == 0 && row < n) st8(e_out + row * L, l0, L, vw, e[h]);
        cm[h] = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (whole || l0 + i < L) cm[h] = fmaxf(cm[h], -e[h][i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the chunk's max of the row: its 4 lanes
        cm[h] = fmaxf(cm[h], __shfl_xor_sync(0xffffffffu, cm[h], 8));
        cm[h] = fmaxf(cm[h], __shfl_xor_sync(0xffffffffu, cm[h], 16));
      }
      float fac[2];
      bool grew = false;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fac[h] = 1.f;
        if (k == 0) {
          mref[h] = cm[h], sum[h] = 0.f;
        } else if ((cm[h] - mref[h]) * kLog2e > kRescale) {
          fac[h] = ex2((mref[h] - cm[h]) * kLog2e), sum[h] *= fac[h], mref[h] = cm[h], grew = true;
        }
      }
      mbar_wait(empty + slot, phase ^ 1);
      unsigned char* stage = smem + slot * C::kStageBytes;
      if (threadIdx.x == 0) fill_mu<bf16>(stage, mu_img, p, k, nk, full + slot);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float qv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          qv[i] = whole || l0 + i < L ? ex2((-e[h][i] - mref[h]) * kLog2e) : 0.f;
        // the lane's 8 pairwise, then into the row's running sum: as many
        // roundings of the sum as PyTorch's warp softmax takes
        sum[h] += ((qv[0] + qv[1]) + (qv[2] + qv[3])) + ((qv[4] + qv[5]) + (qv[6] + qv[7]));
        uint4 hi, mid, lo;
        split3_8(qv, hi, mid, lo);
        // core matrix (row group 2 warp + h, label group kg), row r8
        const int off = ((2 * warp + h) * (kKc / 8) + kg) * 128 + r8 * 16;
        *reinterpret_cast<uint4*>(stage + off) = hi;
        *reinterpret_cast<uint4*>(stage + C::kTermBytes + off) = mid;
        *reinterpret_cast<uint4*>(stage + 2 * C::kTermBytes + off) = lo;
      }
      float* aux = reinterpret_cast<float*>(stage + C::kQBytes + C::kMuBytes);
      float inv[2];
      if (k == nk - 1) {  // the row's sum: its 4 lanes
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float t = sum[h] + __shfl_xor_sync(0xffffffffu, sum[h], 8);
          t = t + __shfl_xor_sync(0xffffffffu, t, 16);
          inv[h] = 1.f / t;
        }
      }
      if (kg == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = kRpw * warp + 8 * h + r8;
          aux[r] = fac[h];
          if (k == nk - 1) aux[R + r] = inv[h];
        }
      }
      const unsigned any = __any_sync(0xffffffffu, grew);
      if (lane == 0) reinterpret_cast<int*>(aux + 2 * R)[warp] = any;
      fence_proxy_async();
      mbar_arrive(full + slot);
      if (++slot == kS) slot = 0, phase ^= 1;
      j = nj, k = nkk, row0 = nrow0, p = np;
    }
    return;
  }

  // ---- consumers: each warpgroup C' of the tile's 64 rows, its 256 columns
  const int ct = threadIdx.x - C::kProducers * 32;
  const int wg = ct >> 7, w4 = (ct >> 5) & 3, g = lane >> 2, tq = lane & 3;
  const int r0 = w4 * 16 + g;  // this thread's rows of the tile: r0, r0 + 8
  float acc[128];
  int slot = 0, phase = 0, prev = kS - 1;  // this stage's ring slot, its round's parity, the last
  for (int j = 0; j < my_items; ++j) {
    const int item = blockIdx.x + j * gridDim.x;
    const long long row0 = (long long)(item / passes) * R;
    const int p = item % passes;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    bool pending = false;  // the previous stage is not yet released
    for (int k = 0; k < nk; ++k) {
      mbar_wait(full + slot, phase);
      const unsigned char* stage = smem + slot * C::kStageBytes;
      const float* aux = reinterpret_cast<const float*>(stage + C::kQBytes + C::kMuBytes);
      // the producer warps' flags
      const int4 fl = *reinterpret_cast<const int4*>(aux + 2 * R);
      if (fl.x | fl.y | fl.z | fl.w) {  // a row's reference max grew: rescale
        wgmma_wait<0>();
        acc_fence(acc);
        if (pending) mbar_arrive(empty + prev), pending = false;
        const float f0 = aux[r0], f1 = aux[r0 + 8];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          acc[4 * i] *= f0, acc[4 * i + 1] *= f0;
          acc[4 * i + 2] *= f1, acc[4 * i + 3] *= f1;
        }
      }
      wgmma_fence();
      acc_fence(acc);
#pragma unroll
      for (int kk = 0; kk < kKc / 16; ++kk) {
        // B, this warpgroup's half: k-groups of 8 labels 16 x 256 bytes
        // apart, n-groups of 8 columns 128
        const uint64_t db = smem_desc(stage + C::kQBytes + wg * (C::kMuBytes / 2) + kk * 32 * 256,
                                      16 * 256, 128);
#pragma unroll
        for (int term = 2; term >= 0; --term) {  // lo, mid, hi
          // A: label groups 128 bytes apart, row groups (kKc / 8) 128
          const uint64_t da =
              smem_desc(stage + term * C::kTermBytes + kk * 256, 128, (kKc / 8) * 128);
          wgmma_64x256x16(acc, da, db);
        }
      }
      wgmma_commit();
      acc_fence(acc);
      wgmma_wait<1>();  // the previous stage's products are done
      if (pending) mbar_arrive(empty + prev);
      pending = true;
      prev = slot;
      if (++slot == kS) slot = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    acc_fence(acc);
    const float* aux =
        reinterpret_cast<const float*>(smem + prev * C::kStageBytes + C::kQBytes + C::kMuBytes);
    const float i0 = aux[R + r0], i1 = aux[R + r0 + 8];
    mbar_arrive(empty + prev);
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const int col = p * C::kNc + wg * 256 + jj * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + r0 + 8 * h;
        if (row >= n || col >= L) continue;
        bf16* dst = c_out + row * L + col;
        const float iv = h ? i1 : i0;
        const float v0 = acc[4 * jj + 2 * h] * iv, v1 = acc[4 * jj + 2 * h + 1] * iv;
        if (vec) {  // L even, 4-byte aligned: the pair is in or out
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          *dst = __float2bfloat16_rn(v0);
          if (col + 1 < L) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// f32: a work item is a tile of R rows, all its passes; the next tile's row
// statistics are walked between this one's chunks, a few steps a chunk
__device__ __forceinline__ void xxwide_f32(const float* __restrict__ e0,
                                           const float* __restrict__ s,
                                           const float* __restrict__ c,
                                           const unsigned char* __restrict__ mu_img,
                                           float* __restrict__ e_out, float* __restrict__ c_out,
                                           long long n, int L, int lp, int passes, int vec,
                                           unsigned char* smem, uint64_t* full,
                                           uint64_t* empty) {
  using C = Cfg<float>;
  constexpr int R = C::kRows, kS = C::kStages;
  constexpr int kRpw = R / C::kProducers;  // rows of a tile a producer warp owns
  float2* stats = reinterpret_cast<float2*>(smem + kS * C::kStageBytes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long num_tiles = (n + R - 1) / R;
  const int my_tiles = (int)((num_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  const int nk = lp / kKc;  // stages a pass
  const long long total = (long long)my_tiles * passes * nk;

  if (warp < C::kProducers) {
    // ---- producers: lane a takes label a of a chunk in the warp's rows ----
    const int chunks = passes * nk;  // stages a tile
    const int iters = (L + 31) / 32;
    auto tile_row0 = [&](int t) { return (blockIdx.x + (long long)t * gridDim.x) * R; };
    // The row statistics of a tile in PyTorch's warp-softmax order, walked
    // in steps of 8 x 32 labels: for each of the warp's rows, lane j on
    // labels j + 32 it, first E (written) and the max of -E, then the sum of
    // exp(-E - max) over it in order, both reduced by xor 16, 8, 4, 2, 1;
    // (max, sum) into the buffer of the tile's parity. Rows past n are not
    // walked. Returns whether the tile's rows are all done.
    int si = 0, walk = 0, it0 = 0;
    float m = -INFINITY, sum = 0.f;
    auto stats_step = [&](int t) {
      if (si == kRpw) return true;
      const int r = warp * kRpw + si;
      const long long row = tile_row0(t) + r, base = row * L;
      float2* dst = stats + (t & 1) * R + r;
      if (row >= n) {
        if (lane == 0) *dst = make_float2(0.f, 1.f);
        ++si;
        return si == kRpw;
      }
      if (walk == 0) {
        float a[8], b[8], cc[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int l = min(lane + 32 * (it0 + u), L - 1);
          a[u] = __ldg(e0 + base + l), b[u] = __ldg(s + base + l), cc[u] = __ldg(c + base + l);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int l = lane + 32 * (it0 + u);
          if (l < L) {
            const float e = a[u] + (b[u] - cc[u]);
            e_out[base + l] = e;
            m = m > -e ? m : -e;
          }
        }
        if ((it0 += 8) >= iters) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float other = __shfl_xor_sync(0xffffffffu, m, o);
            m = m > other ? m : other;
          }
          walk = 1, it0 = 0;
        }
      } else {
        float e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int l = lane + 32 * (it0 + u);
          e[u] = l < L ? e_out[base + l] : 0.f;  // this lane's own stores
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (lane + 32 * (it0 + u) < L) sum += expf(-e[u] - m);
        if ((it0 += 8) >= iters) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) sum = sum + __shfl_xor_sync(0xffffffffu, sum, o);
          if (lane == 0) *dst = make_float2(m, sum);
          ++si, walk = 0, it0 = 0, m = -INFINITY, sum = 0.f;
        }
      }
      return si == kRpw;
    };
    // steps a chunk: the tile's (at most) 2 kRpw ceil(iters / 8) over its chunks
    const int per_chunk = (2 * kRpw * ((iters + 7) / 8) + chunks - 1) / chunks;
    while (!stats_step(0)) {
    }
    si = 0;
    __syncwarp();
    float ra[kRpw];
    auto load = [&](int t, int k) {
      const long long row0 = tile_row0(t);
      const int l = k * kKc + lane;
#pragma unroll
      for (int i = 0; i < kRpw; ++i) {
        const long long row = row0 + warp * kRpw + i;
        ra[i] = row < n && l < L ? e_out[row * L + l] : 0.f;  // this lane's own stores
      }
    };
    float2 st[kRpw];  // (max, sum) of the warp's rows
    int t = 0, p = 0, k = 0, slot = 0, phase = 0;  // the stage's ring slot, its round's parity
    load(0, 0);
    for (long long q = 0; q < total; ++q) {
      if (p == 0 && k == 0) {
#pragma unroll
        for (int i = 0; i < kRpw; ++i) st[i] = stats[(t & 1) * R + warp * kRpw + i];
      }
      const long long row0 = tile_row0(t);
      const bool ok = k * kKc + lane < L;
      float v[kRpw];
#pragma unroll
      for (int i = 0; i < kRpw; ++i)
        v[i] = ok && row0 + warp * kRpw + i < n ? expf(-ra[i] - st[i].x) / st[i].y : 0.f;
      int nt = t, np = p, nkk = k + 1;
      if (nkk == nk) nkk = 0, np = p + 1;
      if (np == passes) np = 0, nt = t + 1;
      // the next stage's loads, and some of the next tile's statistics (all
      // of them, and E, before the loads of that tile, which read E)
      if (nt == t && q + 1 < total) load(nt, nkk);
      if (t + 1 < my_tiles) {
        if (nt != t) {
          while (!stats_step(t + 1)) {
          }
          si = 0;
        } else {
          for (int i = 0; i < per_chunk && !stats_step(t + 1); ++i) {
          }
        }
        __syncwarp();
      }
      if (nt != t && q + 1 < total) load(nt, nkk);
      mbar_wait(empty + slot, phase ^ 1);
      unsigned char* stage = smem + slot * C::kStageBytes;
      if (threadIdx.x == 0) fill_mu<float>(stage, mu_img, p, k, nk, full + slot);
      float* qa = reinterpret_cast<float*>(stage) + lane * C::kQStride + warp * kRpw;
#pragma unroll
      for (int i = 0; i < kRpw; i += 4)
        *reinterpret_cast<float4*>(qa + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      mbar_arrive(full + slot);
      if (++slot == kS) slot = 0, phase ^= 1;
      t = nt, p = np, k = nkk;
    }
    return;
  }

  // ---- consumers: C' = q . Mu, 512 columns a pass --------------------------
  // thread (rg, cg): rows 4 rg + {0..3, 16..19}, columns 4 cg + {0..3, 256..259}
  const int ct = threadIdx.x - C::kProducers * 32;
  const int rg = ct >> 6, cg = ct & 63;
  int slot = 0, phase = 0;  // this stage's ring slot, and its round's parity
  for (int t = 0; t < my_tiles; ++t) {
    const long long row0 = (blockIdx.x + (long long)t * gridDim.x) * R;
    for (int p = 0; p < passes; ++p) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
      for (int k = 0; k < nk; ++k) {
        mbar_wait(full + slot, phase);
        const float* qs = reinterpret_cast<const float*>(smem + slot * C::kStageBytes) + 4 * rg;
        const float* ms =
            reinterpret_cast<const float*>(smem + slot * C::kStageBytes + C::kQBytes) + 4 * cg;
        // over l in order from 0, one FFMA a (row, column) a label
#pragma unroll 8
        for (int a = 0; a < kKc; ++a) {
          const float4 q0 = *reinterpret_cast<const float4*>(qs + a * C::kQStride);
          const float4 q1 = *reinterpret_cast<const float4*>(qs + a * C::kQStride + 16);
          const float4 m0 = *reinterpret_cast<const float4*>(ms + a * C::kNc);
          const float4 m1 = *reinterpret_cast<const float4*>(ms + a * C::kNc + 256);
          const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
          const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(qv[i], mv[jj], acc[i][jj]);
        }
        mbar_arrive(empty + slot);
        if (++slot == kS) slot = 0, phase ^= 1;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long row = row0 + 4 * rg + (i & 3) + 16 * (i >> 2);
        if (row >= n) continue;
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          const int col = p * C::kNc + 4 * cg + 256 * hc;
          float* dst = c_out + row * L + col;
          if (vec) {  // L a multiple of 4, 16-byte aligned: the word is in or out
            if (col < L)
              *reinterpret_cast<float4*>(dst) = make_float4(
                  acc[i][4 * hc], acc[i][4 * hc + 1], acc[i][4 * hc + 2], acc[i][4 * hc + 3]);
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (col + v < L) dst[v] = acc[i][4 * hc + v];
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads<T>, 1)
fused_energy_update_xxwide_kernel(const T* __restrict__ e0, const T* __restrict__ s,
                                  const T* __restrict__ c,
                                  const unsigned char* __restrict__ mu_img,
                                  T* __restrict__ e_out, T* __restrict__ c_out, long long n,
                                  int L, int lp, int passes, int vw, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + bar_offset<T>());
  uint64_t* empty = full + Cfg<T>::kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < Cfg<T>::kStages; ++i) {
      mbar_init(full + i, Cfg<T>::kProducers * 32 + 1);  // the producers, the Mu tile's bytes
      mbar_init(empty + i, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (sizeof(T) == 2)
    xxwide_bf16(e0, s, c, mu_img, e_out, c_out, n, L, lp, passes, vw, vec, smem_raw, full, empty);
  else
    xxwide_f32(e0, s, c, mu_img, e_out, c_out, n, L, lp, passes, vec, smem_raw, full, empty);
}

// Mu's image as the ring's stages, in order (pass, k-tile): bf16 in two
// halves of 256 columns, each in 8 x 8 core matrices (k-group at 8 x 256
// elements, n-group at 64, k row at 8), f32 row-major; zero past L (the
// passes may run past L)
template <typename T>
__global__ void fused_energy_update_xxwide_tile_mu_kernel(const T* __restrict__ mu,
                                                         T* __restrict__ out, int L, int lp,
                                                         int passes) {
  constexpr int kNc = Cfg<T>::kNc;
  const int nk = lp / kKc;
  const long long cols = (long long)passes * kNc, total = (long long)lp * cols;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int l = (int)(i / cols), j = (int)(i % cols);
    const int a = l % kKc, jj = j % kNc;
    const long long stage = (long long)(j / kNc) * nk + l / kKc;
    const int jh = jj % 256;
    const int off = sizeof(T) == 2 ? jj / 256 * kKc * 256 + (a >> 3) * 8 * 256 + (jh >> 3) * 64 +
                                         (a & 7) * 8 + (jh & 7)
                                   : a * kNc + jj;
    out[stage * kKc * kNc + off] = l < L && j < L ? mu[(long long)l * L + j] : from_float<T>(0.f);
  }
}

template <typename T>
cudaError_t launch(const void* e0, const void* s, const void* c, const void* mu, void* mu_img,
                   void* e_out, void* c_out, long long n, int L, int lp, int rows, int passes,
                   int grid, int smem_bytes, int vw, int vec, cudaStream_t stream) {
  const long long tiles = (n + Cfg<T>::kRows - 1) / Cfg<T>::kRows;
  const long long items = sizeof(T) == 2 ? tiles * passes : tiles;  // bf16: (tile, pass)
  if (rows != Cfg<T>::kRows || smem_bytes != smem_for<T>() || grid < 1 || grid > items ||
      items > 0x7fffffff)
    return cudaErrorInvalidValue;
  const long long blocks = ((long long)lp * passes * Cfg<T>::kNc + 255) / 256;
  fused_energy_update_xxwide_tile_mu_kernel<T><<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                                                 stream>>>(static_cast<const T*>(mu),
                                                           static_cast<T*>(mu_img), L, lp, passes);
  auto kernel = fused_energy_update_xxwide_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads<T>, smem_bytes, stream>>>(
      static_cast<const T*>(e0), static_cast<const T*>(s), static_cast<const T*>(c),
      static_cast<const unsigned char*>(mu_img), static_cast<T*>(e_out), static_cast<T*>(c_out), n,
      L, lp, passes, vw, vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every array is row-major contiguous,
// aligned to its element; n > 0, L >= 1; `mu_img` is scratch of LP *
// (passes * 512) elements, 16-byte aligned, for Mu's stage images. The
// geometry comes from the wrapper's `xxwide_geometry`: LP = L padded to a
// multiple of 32, `rows` = R rows a tile (64 in bf16, 32 in f32), `passes`
// = L / 512 rounded up, `grid` persistent blocks (at most one a work item)
// and `smem_bytes`, re-checked here. Returns the launch's cudaError_t (0 =
// ok).
extern "C" int fused_energy_update_xxwide_launch(const void* e0, const void* s, const void* c,
                                                 const void* mu, void* mu_img, void* e_out,
                                                 void* c_out, long long n, int L, int dtype,
                                                 int lp, int rows, int passes, int grid,
                                                 int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = dtype == 0 ? Cfg<float>::kNc : Cfg<bf16>::kNc;
  if (n <= 0 || L <= 0 || lp != (L + kKc - 1) / kKc * kKc || passes != (L + nc - 1) / nc ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(mu_img) % 16) return (int)cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(e0) | reinterpret_cast<uintptr_t>(s) |
                          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(e_out) |
                          reinterpret_cast<uintptr_t>(c_out);
  if (dtype == 0) {
    const int vec = bases % 16 == 0 && L % 4 == 0;
    return (int)launch<float>(e0, s, c, mu, mu_img, e_out, c_out, n, L, lp, rows, passes, grid,
                              smem_bytes, 1, vec, st);
  }
  // bf16 loads and stores of E: 16 bytes where rows allow, else 8, else 2
  const int vw = bases % 16 == 0 && L % 8 == 0 ? 8 : bases % 8 == 0 && L % 4 == 0 ? 4 : 1;
  const int vec = bases % 4 == 0 && L % 2 == 0;
  return (int)launch<bf16>(e0, s, c, mu, mu_img, e_out, c_out, n, L, lp, rows, passes, grid,
                           smem_bytes, vw, vec, st);
}
