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
// and writes E and C'. q never leaves registers.
//
// Bound: memory. The kernel reads E0, S and C and writes E and C': five
// (n, L) passes, 5 * 110592 * 16 * 2 B = 17.7 MB in bf16 at the flagship
// shape (35.4 MB in f32), about 5.3 us (10.6 us) at 3.35 TB/s. The math is
// about 2 L^2 + O(L) flops per row, ~3 flop per byte, far below the ridge.
// So the design makes one pass: one thread per row with L a template
// parameter, each row read with 16-byte vector loads and written with
// 16-byte stores, E/max/exp/sum and the L^2 FMAs of q . Mu in f32
// registers, Mu in shared memory (every thread of a warp reads the same
// word: a broadcast), each output rounded once to the I/O dtype. The
// ragged last block is masked, so any n works.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// One row of L values of type T as f32, by 16-byte vector loads.
template <int L>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float* out) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < L / 4; ++i) {
    uint4 w = v[i];
    out[4 * i + 0] = __uint_as_float(w.x);
    out[4 * i + 1] = __uint_as_float(w.y);
    out[4 * i + 2] = __uint_as_float(w.z);
    out[4 * i + 3] = __uint_as_float(w.w);
  }
}

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* out) {
  out[0] = __uint_as_float(w << 16);          // low half: the first element
  out[1] = __uint_as_float(w & 0xffff0000u);  // high half: the second
}

template <int L>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p, float* out) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < L / 8; ++i) {
    uint4 w = v[i];
    unpack_bf16x2(w.x, out + 8 * i + 0);
    unpack_bf16x2(w.y, out + 8 * i + 2);
    unpack_bf16x2(w.z, out + 8 * i + 4);
    unpack_bf16x2(w.w, out + 8 * i + 6);
  }
}

template <int L>
__device__ __forceinline__ void store_row(float* __restrict__ p, const float* in) {
  uint4* v = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < L / 4; ++i) {
    v[i] = make_uint4(__float_as_uint(in[4 * i + 0]), __float_as_uint(in[4 * i + 1]),
                      __float_as_uint(in[4 * i + 2]), __float_as_uint(in[4 * i + 3]));
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

template <int L>
__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ p, const float* in) {
  uint4* v = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < L / 8; ++i) {
    v[i] = make_uint4(pack_bf16x2(in[8 * i + 0], in[8 * i + 1]),
                      pack_bf16x2(in[8 * i + 2], in[8 * i + 3]),
                      pack_bf16x2(in[8 * i + 4], in[8 * i + 5]),
                      pack_bf16x2(in[8 * i + 6], in[8 * i + 7]));
  }
}

template <int L, typename T>
__global__ void __launch_bounds__(kThreads)
fused_energy_update_kernel(const T* __restrict__ e0, const T* __restrict__ s,
                           const T* __restrict__ c, const T* __restrict__ mu,
                           T* __restrict__ e_out, T* __restrict__ c_out, long long n) {
  __shared__ float mu_s[L * L];
  for (int i = threadIdx.x; i < L * L; i += kThreads) mu_s[i] = to_float(mu[i]);
  __syncthreads();

  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const long long off = row * L;

  float e[L], t[L], cc[L];
  load_row<L>(e0 + off, e);
  load_row<L>(s + off, t);
  load_row<L>(c + off, cc);
  float m = -INFINITY;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    e[l] = e[l] + (t[l] - cc[l]);
    m = fmaxf(m, -e[l]);
  }
  store_row<L>(e_out + off, e);

  float sum = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    t[l] = expf(-e[l] - m);
    sum += t[l];
  }
#pragma unroll
  for (int l = 0; l < L; ++l) t[l] = t[l] / sum;  // q

#pragma unroll
  for (int j = 0; j < L; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) acc = fmaf(t[l], mu_s[l * L + j], acc);
    cc[j] = acc;
  }
  store_row<L>(c_out + off, cc);
}

template <int L, typename T>
cudaError_t launch(const void* e0, const void* s, const void* c, const void* mu,
                   void* e_out, void* c_out, long long n, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  fused_energy_update_kernel<L, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(e0), static_cast<const T*>(s), static_cast<const T*>(c),
      static_cast<const T*>(mu), static_cast<T*>(e_out), static_cast<T*>(c_out), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int L, const void* e0, const void* s, const void* c, const void* mu,
                     void* e_out, void* c_out, long long n, cudaStream_t stream) {
  switch (L) {
    case 8: return launch<8, T>(e0, s, c, mu, e_out, c_out, n, stream);
    case 16: return launch<16, T>(e0, s, c, mu, e_out, c_out, n, stream);
    case 32: return launch<32, T>(e0, s, c, mu, e_out, c_out, n, stream);
    case 64: return launch<64, T>(e0, s, c, mu, e_out, c_out, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer is 16-byte aligned and
// row-major contiguous; n > 0. Returns the launch's cudaError_t (0 = ok).
extern "C" int fused_energy_update_launch(const void* e0, const void* s, const void* c,
                                          const void* mu, void* e_out, void* c_out,
                                          long long n, int L, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch<float>(L, e0, s, c, mu, e_out, c_out, n, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(L, e0, s, c, mu, e_out, c_out, n, st);
  return (int)cudaErrorInvalidValue;
}
