// Lattice apply for Hopper (sm_90a): the untiled splat and slice of the
// permutohedral lattice, plain C interface.
//
// Replaces no Pallas kernel: the JAX package leaves the splat and slice to
// XLA. Added because PyTorch's plain version of the untiled apply moves
// about a hundred times the bytes the two steps need: the splat builds an
// (n, d+1, L) f32 product (6.4 GB at fullres128's (2088960, 128)) and sums
// it by index_add_, the slice runs d+1 gathers of (n, L), each with its own
// product and sum.
//
// The plan's sparse incidence S is n x C with d+1 weights a row: pixel i
// touches vertex slot[i, r] with weight bary[i, r], r = 0..d. Slot C is the
// zero sentinel (capacity overflow). The two kernels are each other's
// transpose:
//
//   slice:  out[i, :]   = s * sum_r bary[i, r] * vals[slot[i, r], :]    (S.V)
//   splat:  table[c, :] = s * sum_{slot[i, r] = c} bary[i, r] * src[i, :] (S^T.x)
//
// Both read their operands in place and keep no per-entry intermediate in
// device memory. Lanes of a team (1 to 32, the power of two that covers L
// at `vec` values a lane) share a row, `vec` values a lane (8: one 16-byte
// bf16 word, two f32 or four f64 ones; 1 where L or the alignment do not
// allow it); rows wider than a team's lanes take column passes. The wrapper
// (ops/cuda/lattice.py, `apply_geometry`) computes the geometry and this
// side re-checks it. Both are bound by how many rows' loads are in flight,
// not by arithmetic, so their registers are held down for occupancy; the
// settings are the fastest of those measured on the H100 (PERF.md).
//
// Slice. A team a pixel, 8 blocks an SM: it gathers the pixel's d+1 rows of
// vals one after the other (more rows in flight a team, at fewer teams an
// SM, measured slower), each with its slot and weight, and sums in the
// plain version's order, r = 0..d, with separately rounded products and
// sums (no FMA contraction), then scales: bit for bit PyTorch's
// `bary[:, 0] * vals[slot[:, 0]] + ...` followed by `* s`. It writes the
// promoted dtype of weights and values (f32 at fullres128). The slots are
// int64 below 2^31, so it reads their low words. Bound: bytes, the slots,
// weights and output once and the table once, 1.25 GB at fullres128,
// 0.37 ms at 3.35 TB/s; the table (33.5 MB in bf16) sits in L2, so its
// d+1 gathers a pixel are L2 traffic.
//
// Splat: a segmented reduce over the entries sorted by slot (the plan's
// `entry_order`, entry = r * n + i, its weights in the same order,
// `entry_weight`, `slot_start`, the CSR row starts, and `chunk_start`, which
// numbers each slot's chunks). Each slot's entries are cut into chunks of
// kChunk from its own start, a team a chunk, so that a vertex with
// thousands of entries does not set the tail. A team walks its chunk in
// order, the next entries' indices and weights loaded while the current
// ones' rows are in flight, and sums weight * src in registers (f32; f64
// for f64 values). A slot of one chunk is stored into the zeroed table as
// its team ends; a second pass, a team a slot, adds the sums of a longer
// slot's chunks in order. So every sum is taken in an order fixed by the
// slot's own entries alone: the splat is deterministic, has no atomics, and
// two plans that number the same vertices otherwise give the same sums.
// Entries past slot_start[C] (capacity overflow) are dropped and row C
// stays zero, unless `sentinel` (the slice's backward, where vals' row C
// is an input like any other) sums them into it. The src rows are read
// about d+1 times, in slot order and so from device memory: about 3.2 GB
// at fullres128, against a bound (src, entries, weights and table once) of
// 0.67 GB, 0.20 ms. That is the cost traded for no scatter: a pixel-major
// splat would add n (d+1) L values atomically, in no fixed order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // sorted entries a team walks in the splat

template <typename V>
struct SplatAcc {  // the splat's sums: f32, or f64 for f64 values
  using T = typename std::conditional<std::is_same<V, double>::value, double, float>::type;
};

template <typename W, typename V>
struct SliceAcc {  // the slice's arithmetic: the promoted dtype of weights and values
  using T = typename std::conditional<std::is_same<W, double>::value ||
                                          std::is_same<V, double>::value,
                                      double, float>::type;
};

// blocks an SM (__launch_bounds__), as many as the registers allow without
// spills: the splat at most 64 registers a thread (128 with f64 weights or
// values), the slice 32 (42 for f32 values, 64 for f64 arithmetic)
template <typename W, typename V, typename A>
struct Blocks {
  static constexpr int splat = sizeof(W) == 8 || sizeof(V) == 8 ? 2 : 4;
  static constexpr int slice = sizeof(A) == 8 ? 4 : sizeof(V) == 4 ? 6 : 8;
};

template <typename A>
__device__ __forceinline__ A to_acc(float x) { return (A)x; }
template <typename A>
__device__ __forceinline__ A to_acc(double x) { return (A)x; }
template <typename A>
__device__ __forceinline__ A to_acc(__nv_bfloat16 x) { return (A)__bfloat162float(x); }

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// VEC values of a row into the accumulator's type (VEC = 8: 16-byte words)
template <typename A, typename V, int VEC>
__device__ __forceinline__ void load_row(const V* p, A (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_acc<A>(__ldg(p));
  } else if constexpr (std::is_same<V, __nv_bfloat16>::value) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&words[k]);
      out[2 * k] = (A)__low2float(h);
      out[2 * k + 1] = (A)__high2float(h);
    }
  } else if constexpr (std::is_same<V, float>::value) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + k);
      out[4 * k] = (A)v.x;
      out[4 * k + 1] = (A)v.y;
      out[4 * k + 2] = (A)v.z;
      out[4 * k + 3] = (A)v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double2 v = __ldg(reinterpret_cast<const double2*>(p) + k);
      out[2 * k] = (A)v.x; out[2 * k + 1] = (A)v.y;
    }
  }
}

template <typename A, int VEC>
__device__ __forceinline__ void store_row(A* p, const A (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = v[0];
  } else if constexpr (std::is_same<A, float>::value) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      reinterpret_cast<double2*>(p)[k] = make_double2(v[2 * k], v[2 * k + 1]);
  }
}

// a run's sum `acc` times `sc` into row `dst`
template <typename A, int VEC>
__device__ __forceinline__ void store_scaled(A* dst, const A (&acc)[VEC], A sc) {
  A out[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = acc[k] * sc;
  store_row<A, VEC>(dst, out);
}

// The run of slot s ends where slot s + 1 begins; slot C's (the sentinel's)
// at the last entry.
__device__ __forceinline__ int run_end(const int* start, int s, int C, int N) {
  return s == C ? N : __ldg(start + s + 1);
}

// The chunk a team of the splat walks: team t takes chunk k of slot s, the
// slot's entries [start[s] + k kChunk, start[s] + (k + 1) kChunk), where
// chunk0[s] (the plan's `chunk_start`) numbers the slots' chunks in slot
// order and slot C's follow them. Returns false where t has no chunk.
__device__ __forceinline__ bool team_chunk(long long t, const int* start, const int* chunk0,
                                           int C, int N, int sentinel, int& s, int& k) {
  const int kept = __ldg(chunk0 + C);  // the chunks of the slots below C
  if (t >= kept) {
    if (!sentinel) return false;
    s = C;
    k = (int)(t - kept);
  } else {  // the last s below C whose chunks begin at or before t
    int hi = C - 1;
    s = 0;
    while (s < hi) {
      const int mid = (s + hi + 1) >> 1;
      if (__ldg(chunk0 + mid) <= t) s = mid; else hi = mid - 1;
    }
    k = (int)(t - __ldg(chunk0 + s));
  }
  return __ldg(start + s) + (long long)k * kChunk < run_end(start, s, C, N);
}

template <typename W, typename V, int VEC>
__global__ void __launch_bounds__(kThreads, (Blocks<W, V, typename SplatAcc<V>::T>::splat))
lattice_splat_kernel(const V* __restrict__ src, const int* __restrict__ order,
                     const W* __restrict__ weight, const int* __restrict__ start,
                     const int* __restrict__ chunk0, typename SplatAcc<V>::T* __restrict__ table,
                     typename SplatAcc<V>::T* __restrict__ part, int n, int L, int C, int N,
                     long long teams, int team, int passes, int sentinel, double scale) {
  using A = typename SplatAcc<V>::T;
  constexpr int kUnroll = VEC == 1 ? 4 : 2;  // entries whose rows are in flight at once
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long t = g / team;  // this team's chunk
  const int lane = (int)(g - t * team);
  int s, k;
  if (t >= teams || !team_chunk(t, start, chunk0, C, N, sentinel, s, k)) return;
  const int lo = __ldg(start + s), hi = run_end(start, s, C, N);
  const int q0 = lo + k * kChunk;
  const int q1 = min(hi, q0 + kChunk);
  const bool alone = hi - lo <= kChunk;  // the slot's one chunk: its sum is the row
  const A sc = (A)scale;
  for (int pass = 0; pass < passes; ++pass) {
    const int col = (pass * team + lane) * VEC;
    const bool live = col < L;  // VEC divides L where it is 8
    A acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0;
    int row[kUnroll];
    A w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = q0 + u < q1;
      row[u] = in ? __ldg(order + q0 + u) % n : 0;
      w[u] = in ? (A)__ldg(weight + q0 + u) : (A)0;
    }
    for (int q = q0; q < q1; q += kUnroll) {
      A v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (live && q + u < q1) {
          load_row<A, V, VEC>(src + (size_t)row[u] * L + col, v[u]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[u][j] = 0;
        }
      }
      // the next entries, in flight with these rows
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int qn = q + kUnroll + u;
        const bool in = qn < q1;
        row[u] = in ? __ldg(order + qn) % n : 0;
        const A wn = in ? (A)__ldg(weight + qn) : (A)0;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = fma_rn(w[u], v[u][j], acc[j]);
        w[u] = wn;
      }
    }
    if (live) {
      if (alone)
        store_scaled<A, VEC>(table + (size_t)s * L + col, acc, sc);
      else
        store_row<A, VEC>(part + (size_t)t * L + col, acc);
    }
  }
}

// The second pass: a team a slot of more than one chunk adds its chunks'
// sums in order into its row.
template <typename V, int VEC>
__global__ void __launch_bounds__(kThreads)
lattice_splat_join_kernel(const typename SplatAcc<V>::T* __restrict__ part,
                          const int* __restrict__ start, const int* __restrict__ chunk0,
                          typename SplatAcc<V>::T* __restrict__ table, int L, int C, int N,
                          int team, int passes, int sentinel, double scale) {
  using A = typename SplatAcc<V>::T;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long s = g / team;  // this team's slot
  const int lane = (int)(g - s * team);
  if (s > C || (s == C && !sentinel)) return;
  const int chunks = (run_end(start, (int)s, C, N) - __ldg(start + s) + kChunk - 1) / kChunk;
  if (chunks <= 1) return;
  const long long first = __ldg(chunk0 + s);
  const A sc = (A)scale;
  for (int pass = 0; pass < passes; ++pass) {
    const int col = (pass * team + lane) * VEC;
    if (col >= L) break;
    A acc[VEC], v[VEC];
    load_row<A, A, VEC>(part + (size_t)first * L + col, acc);
    for (int c = 1; c < chunks; ++c) {
      load_row<A, A, VEC>(part + (size_t)(first + c) * L + col, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += v[j];
    }
    store_scaled<A, VEC>(table + (size_t)s * L + col, acc, sc);
  }
}

template <typename W, typename V, int VEC>
__global__ void __launch_bounds__(kThreads, (Blocks<W, V, typename SliceAcc<W, V>::T>::slice))
lattice_slice_kernel(const V* __restrict__ vals, const long long* __restrict__ slot,
                     const W* __restrict__ bary, typename SliceAcc<W, V>::T* __restrict__ out,
                     int n, int L, int d1, int ss_i, int ss_r, int sb_i, int sb_r, int team,
                     int passes, double scale) {
  using A = typename SliceAcc<W, V>::T;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int i = (int)(g / team);  // this team's pixel
  const int lane = (int)(g - (long long)i * team);
  if (i >= n) return;
  const A sc = (A)scale;
  for (int pass = 0; pass < passes; ++pass) {
    const int col = (pass * team + lane) * VEC;
    if (col >= L) break;
    A acc[VEC];
    for (int r = 0; r < d1; ++r) {
      // the slot's low word: slots are below 2^31 (the wrapper checks)
      const int c = __ldg(reinterpret_cast<const int*>(slot + (i * ss_i + r * ss_r)));
      const A w = (A)__ldg(bary + (i * sb_i + r * sb_r));
      A v[VEC];
      load_row<A, V, VEC>(vals + (size_t)c * L + col, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const A p = mul_rn(w, v[k]);
        acc[k] = r == 0 ? p : add_rn(acc[k], p);
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = mul_rn(acc[k], sc);
    store_row<A, VEC>(out + (size_t)i * L + col, acc);
  }
}

bool geometry_ok(long long teams, int L, int vec, int team, int passes, long long grid) {
  if (vec != 1 && vec != 8) return false;
  if (vec == 8 && L % 8 != 0) return false;
  if (team < 1 || team > 32 || (team & (team - 1)) != 0) return false;
  if (passes != (L + team * vec - 1) / (team * vec)) return false;
  return grid == (teams * team + kThreads - 1) / kThreads && grid > 0 && grid <= 0x7fffffffLL;
}

template <typename W, typename V, int VEC>
cudaError_t splat_vec(const void* src, const int* order, const void* weight, const int* start,
                      const int* chunk0, void* table, void* part, int n, int L, int C, int N,
                      long long teams, int team, int passes, long long grid, int sentinel,
                      double scale, cudaStream_t st) {
  using A = typename SplatAcc<V>::T;
  lattice_splat_kernel<W, V, VEC><<<(unsigned)grid, kThreads, 0, st>>>(
      static_cast<const V*>(src), order, static_cast<const W*>(weight), start, chunk0,
      static_cast<A*>(table), static_cast<A*>(part), n, L, C, N, teams, team, passes, sentinel,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long join_grid = ((long long)(C + 1) * team + kThreads - 1) / kThreads;
  lattice_splat_join_kernel<V, VEC><<<(unsigned)join_grid, kThreads, 0, st>>>(
      static_cast<const A*>(part), start, chunk0, static_cast<A*>(table), L, C, N, team, passes,
      sentinel, scale);
  return cudaGetLastError();
}

template <typename W, typename V>
cudaError_t splat_typed(const void* src, const int* order, const void* weight, const int* start,
                        const int* chunk0, void* table, void* part, int n, int L, int C, int N,
                        long long teams, int vec, int team, int passes, long long grid,
                        int sentinel, double scale, cudaStream_t st) {
  return vec == 8 ? splat_vec<W, V, 8>(src, order, weight, start, chunk0, table, part, n, L, C, N,
                                       teams, team, passes, grid, sentinel, scale, st)
                  : splat_vec<W, V, 1>(src, order, weight, start, chunk0, table, part, n, L, C, N,
                                       teams, team, passes, grid, sentinel, scale, st);
}

template <typename W, typename V>
cudaError_t slice_typed(const void* vals, const long long* slot, const void* bary, void* out,
                        int n, int L, int d1, int ss_i, int ss_r, int sb_i, int sb_r, int vec,
                        int team, int passes, long long grid, double scale, cudaStream_t st) {
  using A = typename SliceAcc<W, V>::T;
  const V* v = static_cast<const V*>(vals);
  const W* b = static_cast<const W*>(bary);
  A* o = static_cast<A*>(out);
  if (vec == 8)
    lattice_slice_kernel<W, V, 8><<<(unsigned)grid, kThreads, 0, st>>>(
        v, slot, b, o, n, L, d1, ss_i, ss_r, sb_i, sb_r, team, passes, scale);
  else
    lattice_slice_kernel<W, V, 1><<<(unsigned)grid, kThreads, 0, st>>>(
        v, slot, b, o, n, L, d1, ss_i, ss_r, sb_i, sb_r, team, passes, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes of the wrapper: 0 float32, 1 bfloat16, 2 float64 (weights: 0 or 2)
// `part` holds a row of L sums a team (the chunks of slots that have more
// than one), scratch that the wrapper allocates; the teams are the chunks'
// upper bound, one a kChunk entries and one more a slot
extern "C" int lattice_splat_launch(const void* src, const void* order, const void* weight,
                                    const void* start, const void* chunk0, void* table,
                                    void* part, int n, int L, int C, int N, int wdt, int vdt,
                                    int vec, int team, int passes, long long grid, int sentinel,
                                    double scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long teams = ((long long)N + kChunk - 1) / kChunk + min(C + 1, N);
  if (n <= 0 || L <= 0 || C < 0 || N <= 0 || N % n != 0 || N > 0x7fffffff - kChunk ||
      !geometry_ok(teams, L, vec, team, passes, grid))
    return (int)cudaErrorInvalidValue;
  const int* o = static_cast<const int*>(order);
  const int* s = static_cast<const int*>(start);
  const int* c0 = static_cast<const int*>(chunk0);
#define LATTICE_SPLAT(W, V) \
  splat_typed<W, V>(src, o, weight, s, c0, table, part, n, L, C, N, teams, vec, team, passes, \
                    grid, sentinel, scale, st)
  if (wdt == 0 && vdt == 0) return (int)LATTICE_SPLAT(float, float);
  if (wdt == 0 && vdt == 1) return (int)LATTICE_SPLAT(float, __nv_bfloat16);
  if (wdt == 0 && vdt == 2) return (int)LATTICE_SPLAT(float, double);
  if (wdt == 2 && vdt == 0) return (int)LATTICE_SPLAT(double, float);
  if (wdt == 2 && vdt == 1) return (int)LATTICE_SPLAT(double, __nv_bfloat16);
  if (wdt == 2 && vdt == 2) return (int)LATTICE_SPLAT(double, double);
#undef LATTICE_SPLAT
  return (int)cudaErrorInvalidValue;
}

extern "C" int lattice_slice_launch(const void* vals, const void* slot, const void* bary,
                                    void* out, int n, int L, int d1, int ss_i, int ss_r,
                                    int sb_i, int sb_r, int wdt, int vdt, int vec, int team,
                                    int passes, long long grid, double scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || L <= 0 || d1 <= 0 || !geometry_ok(n, L, vec, team, passes, grid))
    return (int)cudaErrorInvalidValue;
  const long long* sl = static_cast<const long long*>(slot);
#define LATTICE_SLICE(W, V) \
  slice_typed<W, V>(vals, sl, bary, out, n, L, d1, ss_i, ss_r, sb_i, sb_r, vec, team, passes, \
                    grid, scale, st)
  if (wdt == 0 && vdt == 0) return (int)LATTICE_SLICE(float, float);
  if (wdt == 0 && vdt == 1) return (int)LATTICE_SLICE(float, __nv_bfloat16);
  if (wdt == 0 && vdt == 2) return (int)LATTICE_SLICE(float, double);
  if (wdt == 2 && vdt == 0) return (int)LATTICE_SLICE(double, float);
  if (wdt == 2 && vdt == 1) return (int)LATTICE_SLICE(double, __nv_bfloat16);
  if (wdt == 2 && vdt == 2) return (int)LATTICE_SLICE(double, double);
#undef LATTICE_SLICE
  return (int)cudaErrorInvalidValue;
}
