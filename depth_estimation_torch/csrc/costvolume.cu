// Stereo cost volume for Hopper (sm_90a): the aggregated matching cost E0 of
// a rectified pair in one launch, plain C interface.
//
// Replaces no Pallas kernel: the JAX package computes the cost volume with
// XLA ops (ops/costvolume.py's `cost_volume`). Added because PyTorch's plain
// version (`cost_volume_reference`) writes 3 L slices, stacks them into the
// (h, w, L) volume, pads it twice by index_select and runs each box filter as
// a pad copy, a cumsum and a difference: more than ten passes over a 1.07 GB
// volume (fullres128) and 3 L + ~15 launches a call.
//
// What it computes, for float32 (h, w, c) images, c = 1 or 3, and an odd
// window of radius r <= 8 (the plain version's `agg_mode="reflect"`):
//
//   cost(i, j, d) = sum_ch |left(i, j, ch) - right(i, j - d, ch)|,
//                   right reading 0 left of column 0 (also for d >= w);
//   E0(i, j, d)   = scale * sum_b sum_a cost(sym(i + a), sym(j + b), d),
//                   a, b in [-r, r],
//
// where sym is numpy's 'symmetric' index (the edge repeats; a pad longer
// than the side keeps reflecting with period 2n), taken before the shift by
// d, as the plain version pads the stacked volume and not the images. Each
// output is one thread's f32 sums in one fixed order: the channels, then the
// window's rows a = -r..r (the vertical sum), then its columns b = -r..r,
// then one multiply by `scale`, so the kernel is deterministic. Its error
// against float64 is a few roundings of the result, below the plain
// version's, whose cumsum differences round at the size of a prefix sum.
//
// Bound: bytes. The least work reads the two images once and writes the
// f32 volume once, 1.120 GB at fullres128 (1088 x 1920, L = 128), 0.334 ms
// at 3.35 TB/s; 1.921 GB, 0.573 ms at 994 x 1482, L = 320. Nothing but the
// output reaches device memory, and the images (25 MB each at fullres128)
// are read through L2.
//
// Design. Below the byte bound the limits are shared memory and instruction
// throughput: a first design that kept the raw costs in a ring in shared
// memory and summed both window directions from there read about one
// wavefront of shared memory an output (1.98 ms at fullres128; PERF.md
// lists the designs measured). This one keeps the vertical window in
// registers. A block owns a tile of TW output columns, a strip of HS output
// rows and a chunk of D labels (a power of two, 4 to 32; D = 32 stores each
// pixel's chunk as one 128-byte line of 16-byte words). Its 256 threads are the
// tile's TW + 2r haloed columns times D / 4 label quads (TW + 2r =
// 1024 / D), each owning its column for the whole strip, which it walks in
// groups of G = 2r + 1 rows (r is a template parameter, so the loop over a
// group unrolls and the register ring needs no moves):
//   1. the group's rows of the left tile and of the right strip (the
//      tile's columns widened by the chunk's disparities) are in shared
//      memory, copied by cp.async into one of two buffers while the
//      previous group was summed;
//   2. each thread forms the raw costs of its column and 4 labels for each
//      row into a ring of G float4 registers and, from row 2r on, sums the
//      ring in row order into the vertical window sum of row p - 2r, which
//      it writes to a buffer of the group's vertical sums;
//   3. a thread a run of kRun output pixels and 4 labels reads kRun + 2r
//      vertical sums and forms the kRun window sums in registers, each in
//      column order, scales them and stores 16 bytes a pixel (streaming
//      stores: the volume is larger than L2, and the images stay there).
// Lanes run along the columns in 2 and along the label quads in 3, and the
// buffer's rows are padded to an odd number of 16-byte words, so that
// neither pass has a bank conflict. Each raw cost of a strip is formed
// (TW + 2r) / TW times (once a column), its halo rows once a strip.
// `costvolume_geometry` chooses D and HS (D = 32 at every L >= 32 and window
// of the repo; strips of 256 rows: 64 to 512 were measured, PERF.md), and
// `costvolume_launch` refuses, with a negative code, what it does not take:
// 1 or 3 channels (grey and RGB, the images the repo reads) and windows up
// to 17 are instantiated.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;     // 1024 / D haloed columns x D / 4 label quads
constexpr int kRun = 8;           // output pixels a thread of the horizontal pass
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90
constexpr int kMaxRadius = 8;     // windows up to 17
constexpr int kStrip = 256;       // output rows a block
constexpr int kMaxLabels = 32;    // labels a block at most: 128-byte lines of f32

__device__ __forceinline__ void add4(float4& s, float4 v) {
  s.x = s.x + v.x;
  s.y = s.y + v.y;
  s.z = s.z + v.z;
  s.w = s.w + v.w;
}

// numpy's 'symmetric' source of position p on an axis of n: the edge
// repeats, and the pad keeps reflecting with period 2n
__device__ __forceinline__ int sym_index(int p, int n) {
  const int period = 2 * n;
  int q = p % period;
  if (q < 0) q += period;
  return q < n ? q : period - 1 - q;
}

template <int C>
__device__ __forceinline__ float raw_cost(float4 l, float4 r) {
  float s = fabsf(l.x - r.x);
  if (C > 1) s = s + fabsf(l.y - r.y);
  if (C > 2) s = s + fabsf(l.z - r.z);
  if (C > 3) s = s + fabsf(l.w - r.w);
  return s;
}

// the buffer of vertical sums: G rows x D / 4 label quads x P words of 16
// bytes, P >= TW + 2r + kRun - 1 (the last run reads past the tile), odd
__host__ __device__ inline int pitch(int D) { return (1024 / D + kRun - 1) | 1; }

// shared memory of a block, in bytes: two buffers of a group's left tile
// and right strip (float4 pixels), the buffer of vertical sums, and the
// column and row sources
long long smem_bytes(int r, int D, int HS) {
  const long long G = 2LL * r + 1, tw2 = 1024 / D, xw = tw2 + D - 1;
  return 2 * G * (tw2 + xw) * 16 + G * D * pitch(D) * 4LL + (tw2 + HS + 2LL * r + 2) * 4;
}

// start copying a group's rows g0 .. g0 + np - 1 of the left tile into Lb
// and of the right strip into Rb (cp.async, 4 bytes a channel; columns left
// of 0 filled with zeros), as one committed batch
template <int C>
__device__ __forceinline__ void stage(float4* Lb, float4* Rb, const float* __restrict__ left,
                                      const float* __restrict__ right, const int* srow,
                                      const int* scol, int g0, int np, int w, int logTW2,
                                      int XW, int XWC, int xb) {
  const int TW2 = 1 << logTW2;
  for (int k = threadIdx.x; k < np * TW2; k += kThreads) {
    const int pr = k >> logTW2, c = k & (TW2 - 1);
    const float* src = left + ((long long)srow[g0 + pr] * w + scol[c]) * C;
    float* dst = reinterpret_cast<float*>(Lb + k);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) __pipeline_memcpy_async(dst + ch, src + ch, 4);
  }
  for (int k = threadIdx.x; k < np * XW; k += kThreads) {
    const int pr = k / XW, x = k - pr * XW, col = xb + x;
    const float* src = right + ((long long)srow[g0 + pr] * w + max(col, 0)) * C;
    float* dst = reinterpret_cast<float*>(Rb + pr * XWC + x);
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      __pipeline_memcpy_async(dst + ch, src + ch, 4, col < 0 ? 4 : 0);
  }
  __pipeline_commit();
}

// blocks an SM: two (at most 128 registers a thread) up to r = 4; a wider
// window's register ring takes one block an SM, without spills (at r = 5
// two blocks spilled 12 bytes)
template <int R>
constexpr int kBlocks = R <= 4 ? 2 : 1;

template <int C, int R>
__global__ void __launch_bounds__(kThreads, kBlocks<R>)
costvolume_reflect_kernel(const float* __restrict__ left, const float* __restrict__ right,
                          float* __restrict__ out, int h, int w, int L, int logD, int HS,
                          float scale) {
  constexpr int G = 2 * R + 1;
  extern __shared__ float4 smem[];
  const int D = 1 << logD, logQ = logD - 2, Q = 1 << logQ;
  const int logTW2 = 10 - logD, TW2 = 1 << logTW2, TW = TW2 - 2 * R, XWC = TW2 + D - 1;
  const int P = pitch(D);
  float4* Lbuf = smem;                // 2 x (G, TW2)
  float4* Rbuf = Lbuf + 2 * G * TW2;  // 2 x (G, XWC)
  float4* Vs = Rbuf + 2 * G * XWC;    // (G, Q, P)
  int* scol = reinterpret_cast<int*>(Vs + G * Q * P);
  int* srow = scol + TW2;
  int* lims = srow + HS + 2 * R;

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x << logD;
  const int j0 = blockIdx.y * TW;
  const int i0 = blockIdx.z * HS;
  const int rows = min(HS, h - i0), prows = rows + 2 * R;
  const int cols = min(TW, w - j0);

  if (tid == 0) {
    lims[0] = INT_MAX;
    lims[1] = INT_MIN;
  }
  // the copies write channels 0 .. C - 1 alone: the others stay 0
  for (int k = tid; k < 2 * G * (TW2 + XWC); k += kThreads)
    Lbuf[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int p = tid; p < TW2; p += kThreads) {
    const int s = sym_index(j0 - R + p, w);
    scol[p] = s;
    atomicMin(lims, s);
    atomicMax(lims + 1, s);
  }
  for (int p = tid; p < prows; p += kThreads) srow[p] = sym_index(i0 - R + p, h);
  __syncthreads();
  // the right strip: columns xb .. xb + XW - 1 cover scol - d for every
  // haloed column and label of the chunk (sym is 1-Lipschitz, so XW <= XWC)
  const int xb = lims[0] - (d0 + D - 1);
  const int XW = lims[1] - lims[0] + D;
  // the column pass's thread: haloed column pc, labels d0 + 4q .. + 3,
  // whose right pixels are Rs[.][base - t], t = 0..3
  const int pc = tid & (TW2 - 1), q = tid >> logTW2;
  const int base = scol[pc] - d0 - 4 * q - xb;
  const int runs = (TW + kRun - 1) / kRun;
  const bool vec = (L & 3) == 0;
  float4 ring[G];  // raw costs of the column's last G rows, row p in ring[p % G]

  stage<C>(Lbuf, Rbuf, left, right, srow, scol, 0, min(G, prows), w, logTW2, XW, XWC, xb);
  for (int g0 = 0, buf = 0; g0 < prows; g0 += G, buf ^= 1) {
    const int np = min(G, prows - g0);
    // copy the next group's rows into the other buffer, read this group's
    // (the other buffer was last read before the previous group's second sync)
    if (g0 + G < prows)
      stage<C>(Lbuf + (buf ^ 1) * G * TW2, Rbuf + (buf ^ 1) * G * XWC, left, right, srow, scol,
               g0 + G, min(G, prows - g0 - G), w, logTW2, XW, XWC, xb);
    else
      __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const float4* Ls = Lbuf + buf * G * TW2;
    const float4* Rs = Rbuf + buf * G * XWC;
    // 1. raw costs into the ring; 2. vertical sums of rows p - 2r, row by row
#pragma unroll
    for (int k = 0; k < G; ++k) {  // row p = g0 + k, p % G = k
      if (k < np) {
        const float4 l = Ls[k * TW2 + pc];
        const float4* rr = Rs + k * XWC + base;
        ring[k] = make_float4(raw_cost<C>(l, rr[0]), raw_cost<C>(l, rr[-1]),
                              raw_cost<C>(l, rr[-2]), raw_cost<C>(l, rr[-3]));
        if (g0 + k >= 2 * R) {
          float4 s = ring[(k + 1) % G];  // row p - 2r, then on in row order
#pragma unroll
          for (int a = 2; a <= G; ++a) add4(s, ring[(k + a) % G]);
          Vs[(k * Q + q) * P + pc] = s;
        }
      }
    }
    __syncthreads();
    // 3. horizontal sums of the group's vertical sums, in column order,
    // scaled and stored; the next group's first sync orders these reads
    // before its writes
    for (int it = tid; it < np * runs * Q; it += kThreads) {
      const int qq = it & (Q - 1), rest = it >> logQ, run = rest % runs, k = rest / runs;
      const int i = g0 + k - 2 * R;  // the output row
      if (i < 0) continue;
      const float4* V = Vs + (k * Q + qq) * P + run * kRun;
      float4 acc[kRun];
#pragma unroll
      for (int c = 0; c < kRun + 2 * R; ++c) {
        const float4 v = V[c];
#pragma unroll
        for (int o = 0; o < kRun; ++o) {
          if (c == o) acc[o] = v;
          else if (c > o && c <= o + 2 * R) add4(acc[o], v);
        }
      }
      const int dq = d0 + 4 * qq;
      float* orow = out + ((long long)(i0 + i) * w + j0) * L + dq;
#pragma unroll
      for (int o = 0; o < kRun; ++o) {
        const int j = run * kRun + o;
        if (j >= cols) break;
        float4 e = acc[o];
        if (scale != 1.f) e = make_float4(e.x * scale, e.y * scale, e.z * scale, e.w * scale);
        float* dst = orow + (long long)j * L;
        if (vec) {
          if (dq < L) __stcs(reinterpret_cast<float4*>(dst), e);
        } else {  // rows off 16-byte alignment: the quad's labels one by one
          if (dq < L) __stcs(dst, e.x);
          if (dq + 1 < L) __stcs(dst + 1, e.y);
          if (dq + 2 < L) __stcs(dst + 2, e.z);
          if (dq + 3 < L) __stcs(dst + 3, e.w);
        }
      }
    }
  }
}

template <int C, int R>
cudaError_t launch_typed(const float* left, const float* right, float* out, int h, int w, int L,
                         int logD, int HS, float scale, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(costvolume_reflect_kernel<C, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int TW = (1024 >> logD) - 2 * R;
  const dim3 grid((L + (1 << logD) - 1) >> logD, (w + TW - 1) / TW, (h + HS - 1) / HS);
  costvolume_reflect_kernel<C, R><<<grid, kThreads, smem, st>>>(left, right, out, h, w, L, logD,
                                                                HS, scale);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_radius(const float* left, const float* right, float* out, int h, int w, int L,
                          int r, int logD, int HS, float scale, int smem, cudaStream_t st) {
#define COSTVOLUME(R) \
  case R:             \
    return launch_typed<C, R>(left, right, out, h, w, L, logD, HS, scale, smem, st)
  switch (r) {
    COSTVOLUME(0); COSTVOLUME(1); COSTVOLUME(2); COSTVOLUME(3); COSTVOLUME(4);
    COSTVOLUME(5); COSTVOLUME(6); COSTVOLUME(7); COSTVOLUME(8);
  }
#undef COSTVOLUME
  return cudaErrorInvalidValue;
}

}  // namespace

// The launch for an (h, w, c) frame, L labels and a window of radius r: D,
// the fewest labels a block (a power of two, 4 to 32) that cover L, doubled
// while the block's shared memory does not fit (it shrinks with the tile,
// 1024 / D - 2r columns); strips of kStrip rows. Writes D, the tile's
// columns, HS and the shared memory into geom[0..3] and returns 0, or
// returns what the kernel does not take: -1 the channels (1 or 3), -2 the
// window (radius 0 to 8), -3 the sizes (empty, or a grid too large).
extern "C" int costvolume_geometry(int h, int w, int c, int L, int r, int* geom) {
  if (c != 1 && c != 3) return -1;
  if (r < 0 || r > kMaxRadius) return -2;
  if (h <= 0 || w <= 0 || L <= 0) return -3;
  int D = 4;
  while (D < L && D < kMaxLabels) D *= 2;
  while (D < kMaxLabels && smem_bytes(r, D, kStrip) > kMaxSmem) D *= 2;
  const int TW = 1024 / D - 2 * r;
  const long long smem = smem_bytes(r, D, kStrip);
  if ((w + TW - 1) / TW > 65535 || (h + kStrip - 1) / kStrip > 65535 || smem > kMaxSmem)
    return -3;
  geom[0] = D;
  geom[1] = TW;
  geom[2] = kStrip;
  geom[3] = (int)smem;
  return 0;
}

// E0 of contiguous float32 (h, w, c) images into the contiguous float32
// (h, w, L) `out`, in costvolume_geometry's launch: 0, its refusal (< 0), or
// a CUDA error (> 0)
extern "C" int costvolume_launch(const void* left, const void* right, void* out, int h, int w,
                                 int c, int L, int r, float scale, void* stream) {
  int geom[4];
  const int refused = costvolume_geometry(h, w, c, L, r, geom);
  if (refused) return refused;
  int logD = 0;
  while ((1 << logD) < geom[0]) ++logD;
  const int HS = geom[2], smem = geom[3];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(left);
  const float* rr = static_cast<const float*>(right);
  float* o = static_cast<float*>(out);
  if (c == 1) return (int)launch_radius<1>(l, rr, o, h, w, L, r, logD, HS, scale, smem, st);
  return (int)launch_radius<3>(l, rr, o, h, w, L, r, logD, HS, scale, smem, st);
}
