// Train-mode BatchNorm, forward (N1) and backward (N2), for sm_90a.
//
// Replaces no Pallas kernel. It is the counterpart of the plain-JAX custom
// VJP ``batch_norm_train`` of iv2019_tpu/ops/fused_bn.py:52, which the JAX
// package runs under ``bn_impl="fused"`` (models/layers.py: Norm ->
// FusedBatchNorm) on an exact f32 upcast of the compute-type activation.
// These kernels read that activation as it is (bf16 or f32), keep the
// statistics and every sum in f32 or wider, and write y and dx back in the
// activation's type, so no f32 copy of x is made or saved.
//
// What they compute, per channel c over the M = N * H * W rows of x, laid
// out (M, C) with channels contiguous (the NHWC storage of a channels_last
// tensor):
//   N1  bn_stats_kernel     per-block f32 sums of x and x^2 -> partials
//       bn_combine_kernel   the partials in one fixed order, in f64 ->
//                           sums[0:2C] (f32), sums[2C] = M
//       (the wrapper all-reduces sums over the ranks of a mesh here)
//       bn_apply_kernel     mean = s1 / m, var = max(0, s2 / m - mean^2),
//                           rstd = rsqrt(var + eps),
//                           y = (x - mean) * (rstd * scale) + bias
//   N2  bn_bwd_reduce_kernel  per-block f32 sums of dy and dy * xhat,
//                           xhat = (x - mean) * rstd -> partials
//       bn_combine_kernel   -> sums[0:2C] = (dbeta, dgamma)
//       (the wrapper all-reduces a copy of them over the ranks)
//       bn_bwd_dx_kernel    dx = (scale * rstd)
//                                * (dy - dbeta / m - xhat * (dgamma / m))
// in JAX's association (fused_bn.py:63-64, :82-85). The variance is JAX's
// single-pass E[x^2] - E[x]^2, clamped at 0 (not Welford), so both
// packages cancel alike on channels with a large mean; a channel of
// constant input takes the unclamped branch in the backward, as JAX's does.
//
// What bounds them on the H100: bytes. N1 reads x twice (the statistics,
// then y) and writes y: 3 x sizeof(T) bytes an element, 6 in bf16; N2 reads
// x and dy twice and writes dx: 5 x sizeof(T), 10 in bf16. A few f32
// operations an element are far below the ~20 FLOP a byte at which f32
// arithmetic outside the tensor cores would bound them. The design only
// streams: each thread owns V contiguous channels (16-byte loads of 8 bf16
// or 4 f32 where C and the pointers allow, else 8, 4 or 2 bytes, down to one
// element for ragged C such as the heads' 3, 7 and 14), a block covers tc
// channel vectors of tr = 256 / tc rows at a time, and the grid splits the
// rows into ``splits`` contiguous ranges, picked from M and C by the
// wrapper (ops/fused_bn.py::bn_plan) so that every shape fills the 132 SMs.
//
// Determinism. Blocks run in no order, so no block adds into another's
// result: each writes its per-channel partials (f32: a thread's own rows,
// then the block's rows in the order of its threads) to its own slot, and
// the combine adds the slots in a fixed order in f64. The plan depends on
// the shape and the pointers' alignment only, so two launches on the same
// inputs give the same bits. Every element-wise product and sum is rounded
// on its own (the _rn intrinsics: no FMA contraction), as the plain
// PyTorch version's separate tensor operations are.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// iv2019_tpu_torch/ops/fused_bn.py. Each entry point returns
// cudaGetLastError(), or -1 for a type or vector width it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kCombineLanes = 32;  // channels a combine block covers
constexpr int kCombineSlices = 16;  // ranges of splits it adds in parallel

// V contiguous elements of type T, loaded as one vector and widened to f32
// (and narrowed and stored back).
template <typename T, int V>
struct Pack;

template <int V>
struct Pack<float, V> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    if constexpr (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else if constexpr (V == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      out[0] = v.x; out[1] = v.y;
    } else {
      out[0] = *p;
    }
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
    } else {
      *p = in[0];
    }
  }
};

template <int V>
struct Pack<__nv_bfloat16, V> {
  // V bf16 values as raw 16-bit words: 16, 8, 4 or 2 bytes
  using Raw = typename std::conditional<
      V == 8, uint4, typename std::conditional<
          V == 4, uint2, typename std::conditional<V == 2, unsigned int,
                                                   unsigned short>::type>::type>::type;
  union U {
    Raw raw;
    __nv_bfloat16 h[V];
  };
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    U u;
    u.raw = *reinterpret_cast<const Raw*>(p);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = __bfloat162float(u.h[j]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* in) {
    U u;
#pragma unroll
    for (int j = 0; j < V; ++j) u.h[j] = __float2bfloat16_rn(in[j]);
    *reinterpret_cast<Raw*>(p) = u.raw;
  }
};

// The block's place in the plan: its channel vector, its rows.
struct Tile {
  int tx, ty, tr;
  int c0;  // first channel of this thread's vector
  bool active;  // the vector lies inside C
  long long r0, r1;  // rows [r0, r1) of the block's split
};

template <int V>
__device__ __forceinline__ Tile tile_of(long long m, int c, int tc, long long rows) {
  Tile t;
  t.tx = threadIdx.x % tc;
  t.ty = threadIdx.x / tc;
  t.tr = kThreads / tc;
  t.c0 = (blockIdx.x * tc + t.tx) * V;
  t.active = t.c0 < c;
  t.r0 = static_cast<long long>(blockIdx.y) * rows;
  t.r1 = t.r0 + rows < m ? t.r0 + rows : m;
  return t;
}

// The block's per-thread sums a[V], b[V], added over its tr row lanes in
// the order of the lanes (f32) and written to this block's slot of
// ``partials`` (splits, 2C): a at [0, C), b at [C, 2C).
template <int V>
__device__ __forceinline__ void block_partials(const Tile& t, const float* a, const float* b,
                                               int c, float* partials) {
  __shared__ float red[2][kThreads * 8];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[0][threadIdx.x * V + j] = a[j];
    red[1][threadIdx.x * V + j] = b[j];
  }
  __syncthreads();
  if (t.ty != 0 || !t.active) return;
  const int tc = kThreads / t.tr;
  float* slot = partials + static_cast<long long>(blockIdx.y) * 2 * c;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float sa = 0.0f, sb = 0.0f;
    for (int lane = 0; lane < t.tr; ++lane) {
      sa = __fadd_rn(sa, red[0][(lane * tc + t.tx) * V + j]);
      sb = __fadd_rn(sb, red[1][(lane * tc + t.tx) * V + j]);
    }
    slot[t.c0 + j] = sa;
    slot[c + t.c0 + j] = sb;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials, long long m, int c,
                int tc, long long rows) {
  const Tile t = tile_of<V>(m, c, tc, rows);
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.0f;
  if (t.active) {
#pragma unroll 4
    for (long long r = t.r0 + t.ty; r < t.r1; r += t.tr) {
      float v[V];
      Pack<T, V>::load(x + r * c + t.c0, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] = __fadd_rn(s1[j], v[j]);
        s2[j] = __fadd_rn(s2[j], __fmul_rn(v[j], v[j]));
      }
    }
  }
  block_partials<V>(t, s1, s2, c, partials);
}

// sums[j] = the f64 sum over s of partials[s][j], in the order of s (each
// of kCombineSlices lanes adds every kCombineSlices-th split, then the
// lanes are added in order), rounded to f32; sums[n] = count when count
// >= 0.
__global__ void __launch_bounds__(kCombineLanes * kCombineSlices)
bn_combine_kernel(const float* __restrict__ partials, int splits, int n, float* __restrict__ sums,
                  float count) {
  __shared__ double red[kCombineSlices][kCombineLanes];
  const int lane = threadIdx.x % kCombineLanes;
  const int slice = threadIdx.x / kCombineLanes;
  const int j = blockIdx.x * kCombineLanes + lane;
  double acc = 0.0;
  if (j < n) {
#pragma unroll 8
    for (int s = slice; s < splits; s += kCombineSlices) {
      acc += static_cast<double>(partials[static_cast<long long>(s) * n + j]);
    }
  }
  red[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && j < n) {
    double total = 0.0;
    for (int k = 0; k < kCombineSlices; ++k) total += red[k][lane];
    sums[j] = static_cast<float>(total);
  }
  if (count >= 0.0f && blockIdx.x == 0 && threadIdx.x == 0) sums[n] = count;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ sums,
                const float* __restrict__ scale, const float* __restrict__ bias, float eps,
                T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ var_out,
                float* __restrict__ rstd_out, long long m, int c, int tc, long long rows) {
  const Tile t = tile_of<V>(m, c, tc, rows);
  if (!t.active) return;
  const float count = sums[2 * c];
  float mean[V], mul[V], add[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = t.c0 + j;
    mean[j] = __fdiv_rn(sums[ch], count);
    const float var = fmaxf(0.0f, __fsub_rn(__fdiv_rn(sums[c + ch], count),
                                            __fmul_rn(mean[j], mean[j])));
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    mul[j] = __fmul_rn(rstd, scale[ch]);
    add[j] = bias[ch];
    if (blockIdx.y == 0 && t.ty == 0) {
      mean_out[ch] = mean[j];
      var_out[ch] = var;
      rstd_out[ch] = rstd;
    }
  }
#pragma unroll 4
  for (long long r = t.r0 + t.ty; r < t.r1; r += t.tr) {
    float v[V];
    Pack<T, V>::load(x + r * c + t.c0, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mean[j]), mul[j]), add[j]);
    Pack<T, V>::store(y + r * c + t.c0, v);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     float* __restrict__ partials, long long m, int c, int tc, long long rows) {
  const Tile t = tile_of<V>(m, c, tc, rows);
  float db[V], dg[V], mu[V], rs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    db[j] = dg[j] = 0.0f;
    mu[j] = t.active ? mean[t.c0 + j] : 0.0f;
    rs[j] = t.active ? rstd[t.c0 + j] : 0.0f;
  }
  if (t.active) {
#pragma unroll 4
    for (long long r = t.r0 + t.ty; r < t.r1; r += t.tr) {
      float xv[V], gv[V];
      Pack<T, V>::load(x + r * c + t.c0, xv);
      Pack<T, V>::load(dy + r * c + t.c0, gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xhat = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]);
        db[j] = __fadd_rn(db[j], gv[j]);
        dg[j] = __fadd_rn(dg[j], __fmul_rn(gv[j], xhat));
      }
    }
  }
  block_partials<V>(t, db, dg, c, partials);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 const float* __restrict__ scale, const float* __restrict__ sums,
                 const float* __restrict__ count_ptr, T* __restrict__ dx, long long m, int c,
                 int tc, long long rows) {
  const Tile t = tile_of<V>(m, c, tc, rows);
  if (!t.active) return;
  const float count = *count_ptr;
  float mu[V], rs[V], a[V], b[V], d[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = t.c0 + j;
    mu[j] = mean[ch];
    rs[j] = rstd[ch];
    a[j] = __fmul_rn(scale[ch], rs[j]);
    b[j] = __fdiv_rn(sums[ch], count);
    d[j] = __fdiv_rn(sums[c + ch], count);
  }
#pragma unroll 4
  for (long long r = t.r0 + t.ty; r < t.r1; r += t.tr) {
    float xv[V], gv[V];
    Pack<T, V>::load(x + r * c + t.c0, xv);
    Pack<T, V>::load(dy + r * c + t.c0, gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xhat = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]);
      xv[j] = __fmul_rn(a[j], __fsub_rn(__fsub_rn(gv[j], b[j]), __fmul_rn(xhat, d[j])));
    }
    Pack<T, V>::store(dx + r * c + t.c0, xv);
  }
}

void combine(const float* partials, int splits, int n, float* sums, float count,
             cudaStream_t stream) {
  const int blocks = (n + kCombineLanes - 1) / kCombineLanes;
  bn_combine_kernel<<<blocks, kCombineLanes * kCombineSlices, 0, stream>>>(partials, splits, n,
                                                                          sums, count);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; vec: the elements a thread loads at once.
// A macro over the (type, vector) pairs each entry point takes.
#define IV_BN_DISPATCH(CALL)                                  \
  if (dtype == 0 && vec == 4) { CALL(float, 4); }             \
  else if (dtype == 0 && vec == 2) { CALL(float, 2); }        \
  else if (dtype == 0 && vec == 1) { CALL(float, 1); }        \
  else if (dtype == 1 && vec == 8) { CALL(__nv_bfloat16, 8); } \
  else if (dtype == 1 && vec == 4) { CALL(__nv_bfloat16, 4); } \
  else if (dtype == 1 && vec == 2) { CALL(__nv_bfloat16, 2); } \
  else if (dtype == 1 && vec == 1) { CALL(__nv_bfloat16, 1); } \
  else { return -1; }

// N1, first half: sums (2C + 1 floats) = (sum x, sum x^2, M).
extern "C" int iv_bn_stats(int dtype, int vec, const void* x, float* partials, float* sums,
                           long long m, int c, int tc, int tiles, int splits, long long rows,
                           cudaStream_t stream) {
  const dim3 grid(tiles, splits);
#define IV_BN_STATS(T, V)                                                                  \
  bn_stats_kernel<T, V><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), partials, \
                                                        m, c, tc, rows)
  IV_BN_DISPATCH(IV_BN_STATS)
#undef IV_BN_STATS
  combine(partials, splits, 2 * c, sums, static_cast<float>(m), stream);
  return static_cast<int>(cudaGetLastError());
}

// N1, second half: y, mean, var (biased), rstd from the (all-reduced) sums.
extern "C" int iv_bn_apply(int dtype, int vec, const void* x, const float* sums,
                           const float* scale, const float* bias, float eps, void* y,
                           float* mean, float* var, float* rstd, long long m, int c, int tc,
                           int tiles, int splits, long long rows, cudaStream_t stream) {
  const dim3 grid(tiles, splits);
#define IV_BN_APPLY(T, V)                                                                   \
  bn_apply_kernel<T, V><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), sums, scale, \
                                                        bias, eps, static_cast<T*>(y), mean,  \
                                                        var, rstd, m, c, tc, rows)
  IV_BN_DISPATCH(IV_BN_APPLY)
#undef IV_BN_APPLY
  return static_cast<int>(cudaGetLastError());
}

// N2, first half: sums (2C floats) = (sum dy, sum dy * xhat).
extern "C" int iv_bn_bwd_reduce(int dtype, int vec, const void* x, const void* dy,
                                const float* mean, const float* rstd, float* partials,
                                float* sums, long long m, int c, int tc, int tiles, int splits,
                                long long rows, cudaStream_t stream) {
  const dim3 grid(tiles, splits);
#define IV_BN_BWD_REDUCE(T, V)                                                           \
  bn_bwd_reduce_kernel<T, V><<<grid, kThreads, 0, stream>>>(                             \
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, rstd, partials, m, c, tc, \
      rows)
  IV_BN_DISPATCH(IV_BN_BWD_REDUCE)
#undef IV_BN_BWD_REDUCE
  combine(partials, splits, 2 * c, sums, -1.0f, stream);
  return static_cast<int>(cudaGetLastError());
}

// N2, second half: dx from the (all-reduced) sums and the forward's row
// count (device memory, so the host never waits for it).
extern "C" int iv_bn_bwd_dx(int dtype, int vec, const void* x, const void* dy,
                            const float* mean, const float* rstd, const float* scale,
                            const float* sums, const float* count, void* dx, long long m, int c,
                            int tc, int tiles, int splits, long long rows, cudaStream_t stream) {
  const dim3 grid(tiles, splits);
#define IV_BN_BWD_DX(T, V)                                                                  \
  bn_bwd_dx_kernel<T, V><<<grid, kThreads, 0, stream>>>(                                    \
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, rstd, scale, sums, count, \
      static_cast<T*>(dx), m, c, tc, rows)
  IV_BN_DISPATCH(IV_BN_BWD_DX)
#undef IV_BN_BWD_DX
  return static_cast<int>(cudaGetLastError());
}
