// BatchNorm for sm_90a: train mode, forward (N1) and backward (N2), and
// eval mode on the running statistics (N3).
//
// None replaces a Pallas kernel. N1/N2 are the counterpart of the plain-JAX
// custom VJP ``batch_norm_train`` of iv2019_tpu/ops/fused_bn.py:52, which the JAX
// package runs under ``bn_impl="fused"`` (models/layers.py: Norm ->
// FusedBatchNorm) on an exact f32 upcast of the compute-type activation.
// These kernels read that activation as it is (bf16 or f32), keep the
// statistics and every sum in f32 or wider, and write y and dx back in the
// activation's type, so no f32 copy of x is made or saved. N3 is the eval
// BatchNorm of the same Norm (flax's ``use_running_average``), where XLA
// fuses the cast, the normalisation, the ReLU and a bottleneck unit's
// residual add into the neighbouring ops: in eager PyTorch they were five
// f32 passes a layer and two bf16 ones.
//
// What they compute, per channel c over the M = N * H * W rows of x, laid
// out (M, C) with channels contiguous (the NHWC storage of a channels_last
// tensor):
//   N1  bn_fwd_kernel   reduction: sums of x and x^2 -> f64 sums[0:2C],
//                       sums[2C] = M (the wrapper all-reduces them over a
//                       mesh here); elementwise: mean = s1 / m,
//                       var = max(0, s2 / m - mean^2), rstd = rsqrt(var + eps)
//                       (in f64, each rounded once to f32), then in f32
//                       y = (x - mean) * (rstd * scale) + bias
//   N2  bn_bwd_kernel   reduction: sums of dy and dy * xhat,
//                       xhat = (x - mean) * rstd -> f64 sums[0:2C] =
//                       (dbeta, dgamma), their f32 roundings the scale and
//                       bias gradients (the wrapper all-reduces a copy);
//                       elementwise: dx = (scale * rstd)
//                                    * (dy - dbeta / m - xhat * (dgamma / m))
//   N3  bn_eval_kernel  elementwise on the running mean and var: in f32
//                       y = (x - mean) * (rsqrt(var + eps) * scale) + bias,
//                       rounded to x's type; with a residual r (x's type)
//                       y = r + y in f32, rounded again; then max(y, 0)
//                       where asked (NaN kept)
// N1/N2 in JAX's association (fused_bn.py:63-64, :82-85). The variance is JAX's
// single-pass E[x^2] - E[x]^2, clamped at 0 (not Welford); a channel of
// constant input takes the unclamped branch in the backward, as JAX's does.
// N3 in the order and with the roundings of the plain PyTorch chain it
// replaces (ops/fused_bn.py::batch_norm_eval_plain: the per-channel factor,
// then one ATen op a step, then ATen's bf16 add and ReLU).
//
// What bounds them on the H100: bytes. The least is one pass: x (and dy)
// read once, y (dx) written once, 2 x sizeof(T) bytes an element in N1 and
// 3 x sizeof(T) in N2 (4 and 6 in bf16); N3 2 x sizeof(T), 3 x sizeof(T)
// with a residual, and it does move just that. N1/N2 read x (and dy) a
// second time after the statistics, so from HBM they move up to 3 and 5 x
// sizeof(T); a few f32 operations an element are far below the ~20 FLOP a
// byte at which f32 arithmetic would bound it. The design, against what
// held the first version (two kernels and a combine a half) back:
//
// - Launches: one a half on one rank (mode kOneLaunch). A persistent grid
//   of co-resident blocks (launched cooperatively, sized by the wrapper from
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor, iv_bn_capacity) reduces
//   its rows to per-block partials, meets at a grid barrier, adds the
//   partials (the 2C values in groups of 8, spread over the blocks), meets
//   at a second barrier, and runs the elementwise pass. The combine is
//   inside the reduction; there is no combine launch and one C call.
// - With a mesh the same kernel runs as two cooperative launches on the
//   same grid (kReduce: the partials, the barrier and the combine; kApply:
//   the elementwise pass), with the wrapper's all-reduce between them. Both
//   paths run the same arithmetic on the same plan, so on one rank they
//   give the same bits; so do two launches.
// - The second pass: rows in the same forward order as the first, plain
//   stores. L2 holds too little of a map of 268 MB or more to cut its
//   second read. At 34-134 MB a reversed walk (the rows the reduction read
//   last, still in L2, first) read 4-9% less device time in an earlier
//   version, beside cp.async rings and streaming stores, which together
//   timed alike launch-weighted (PERF.md, §6); none is kept until a
//   change measures the walk alone.
// - Bytes in flight: each thread loads kFwdStages (N1) or kBwdStages (N2,
//   each of x and dy) rows' vectors into registers before it adds the
//   first, and a block covers at most 32 channel vectors (512 contiguous
//   bytes of a row). Loads are 16 bytes (8 bf16, 4 f32) where C and the
//   pointers allow, else 8, 4 or 2 bytes, down to one element for ragged C
//   such as the heads' 3, 7 and 14.
// - Reads of the sums: each block reads its channel tile's sums once into
//   shared memory; a read by every thread queued at the L2 slices that hold
//   them.
// - N3 is one pass and no reduction, so it takes an ordinary launch: a
//   grid of as many blocks as the card holds at once (the occupancy query,
//   asked once a device and instantiation) over the same channel tiles,
//   each thread walking its channel vector down the rows with a grid
//   stride; its per-channel factors computed once a thread, in registers;
//   kEvalStages rows of x (and of the residual) loaded before the first is
//   stored. The vector width follows C and the pointers as in N1/N2, so the
//   heads' 3, 7, 14 and 53 channels and PSP's bins take narrower loads.
//
// Accuracy and determinism. A thread sums its own rows in order as a
// compensated (Kahan) f32 sum; the block adds its row lanes in a fixed tree
// in f64 and writes its partials (f64) to its own slot; the partials are
// added in f64 in a fixed order (value j's slice k of 32 adds splits k,
// k + 32, ..., then the slices in order), and the statistics are finished in
// f64 and rounded once. Blocks run in no order, and no block adds into
// another's result; the plan depends on the shape, the pointers' alignment
// and the kernel's occupancy only. Every element-wise product and sum is
// rounded on its own (the _rn intrinsics: no FMA contraction), as the plain
// PyTorch version's separate tensor operations are.
//
// The workspace (f32, one allocation a call; ops/fused_bn.py::_layout):
// the f64 sums at [0, 4C + 2) floats, the f32 outputs from 4C + 2 (N1:
// count, mean, var, rstd; N2: dbias, dscale), the f64 partials (splits x
// 2C) from ``partials_at``.
//
// Plain C interface (no PyTorch headers). N1/N2 are loaded with ctypes by
// iv2019_tpu_torch/ops/fused_bn.py; N3 (iv_bn_eval) is called by the
// operator iv2019::bn_eval of csrc/torch_ops.cpp, the route of eager calls
// and of exported programs alike. Each entry point returns the launch's
// CUDA error, or -1 for a mode, type or vector width it does not take.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <initializer_list>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;  // values a combine group covers
constexpr int kSlices = kThreads / kLanes;  // ranges of splits it adds in parallel
constexpr int kFwdStages = 8;  // rows loaded before the first is added, N1
constexpr int kBwdStages = 4;  // N2, each of x and dy
constexpr int kEvalStages = 4;  // N3, each of x and the residual
constexpr int kMaxDevices = 64;  // N3's occupancy answers kept a process

enum Mode : int { kOneLaunch = 0, kReduce = 1, kApply = 2 };

template <int Bytes>
struct RawOf;
template <>
struct RawOf<16> { using type = uint4; };
template <>
struct RawOf<8> { using type = uint2; };
template <>
struct RawOf<4> { using type = unsigned int; };
template <>
struct RawOf<2> { using type = unsigned short; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V contiguous elements of type T as one raw vector: widened to f32, and
// narrowed and stored.
template <typename T, int V>
struct Pack {
  using Raw = typename RawOf<sizeof(T) * V>::type;
  union U {
    Raw raw;
    T e[V];
  };
  static __device__ __forceinline__ void unpack(Raw r, float* out) {
    U u;
    u.raw = r;
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = widen(u.e[j]);
  }
  static __device__ __forceinline__ void store(T* p, const float* in) {
    U u;
#pragma unroll
    for (int j = 0; j < V; ++j) u.e[j] = narrow<T>(in[j]);
    *reinterpret_cast<Raw*>(p) = u.raw;
  }
};

// A thread's place in the plan: its channel vector (blockIdx.x's tile of tc
// vectors), its row lane ty of tr = 256 / tc, and the rows of that lane in
// the block's split (blockIdx.y's range of split_rows rows): first, first +
// tr, ..., ``rows`` of them.
struct Tile {
  int tx, ty, tr, tc;
  int c0;  // first channel of this thread's vector
  bool active;  // the vector lies inside C
  long long first;
  int rows;
};

__device__ __forceinline__ Tile tile_of(long long m, int c, int tc, long long split_rows, int v) {
  Tile t;
  t.tc = tc;
  t.tx = threadIdx.x % tc;
  t.ty = threadIdx.x / tc;
  t.tr = kThreads / tc;
  t.c0 = (blockIdx.x * tc + t.tx) * v;
  t.active = t.c0 < c;
  const long long b0 = static_cast<long long>(blockIdx.y) * split_rows;
  const long long b1 = b0 + split_rows < m ? b0 + split_rows : m;
  t.first = b0 + t.ty;
  t.rows = t.first < b1 ? static_cast<int>((b1 - t.first + t.tr - 1) / t.tr) : 0;
  return t;
}

// The thread's rows k = 0, 1, ..., rows - 1 in order (row k's vector of
// each of the N tensors at src[i] + k * step): S rows' vectors are loaded
// into registers before ``body(k, raw)`` sees the first of them, so S loads
// a tensor are in flight at once.
template <int S, int N, typename Raw, typename Body>
__device__ __forceinline__ void walk_rows(const Raw* const (&src)[N], long long step, int rows,
                                          Body body) {
  for (int k0 = 0; k0 < rows; k0 += S) {
    Raw raw[S][N];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      if (k0 + u < rows) {
#pragma unroll
        for (int i = 0; i < N; ++i) raw[u][i] = src[i][(k0 + u) * step];
      }
    }
#pragma unroll
    for (int u = 0; u < S; ++u) {
      if (k0 + u < rows) body(k0 + u, raw[u]);
    }
  }
}

// A thread's compensated (Kahan) f32 sums of V values over its rows, in row
// order: ``sum`` and the negative of what its roundings dropped, ``lost``,
// so that sum - lost carries the f32 sum's lost bits; as accurate as f64
// running sums without f64 registers or conversions in the row loop.
template <int V>
struct KahanSum {
  float sum[V], lost[V];
  __device__ __forceinline__ KahanSum() {
#pragma unroll
    for (int j = 0; j < V; ++j) sum[j] = lost[j] = 0.0f;
  }
  __device__ __forceinline__ void add(int j, float v) {
    const float y = __fsub_rn(v, lost[j]);
    const float t = __fadd_rn(sum[j], y);
    lost[j] = __fsub_rn(__fsub_rn(t, sum[j]), y);
    sum[j] = t;
  }
  __device__ __forceinline__ double value(int j) const {
    return __dsub_rn(static_cast<double>(sum[j]), static_cast<double>(lost[j]));
  }
};

// The block's per-thread sums a, b (compensated f32 over the thread's own
// rows), in f64, added over its tr row lanes in a fixed tree (f64, in
// ``red``: 2 x 256 x V doubles) and written to the block's slot of the
// partials (f64): a at [0, C), b at [C, 2C).
template <int V>
__device__ __forceinline__ void block_partials(const Tile& t, const KahanSum<V>& a,
                                               const KahanSum<V>& b, int c, double* slot,
                                               double* red) {
  const int i = threadIdx.x * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[i + j] = a.value(j);
    red[kThreads * V + i + j] = b.value(j);
  }
  __syncthreads();
  for (int s = t.tr / 2; s > 0; s /= 2) {
    if (t.ty < s) {
      const int o = i + s * t.tc * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[i + j] = __dadd_rn(red[i + j], red[o + j]);
        red[kThreads * V + i + j] = __dadd_rn(red[kThreads * V + i + j], red[kThreads * V + o + j]);
      }
    }
    __syncthreads();
  }
  if (t.ty == 0 && t.active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      slot[t.c0 + j] = red[i + j];
      slot[c + t.c0 + j] = red[kThreads * V + i + j];
    }
  }
}

// Where a half writes its sums: ``sums`` (f64, n values) and, for N2,
// ``out`` (their f32 roundings: dbias, dscale); N1 also writes the row
// count ``count`` to sums[n].
struct SumsOut {
  double* sums;
  float* out;
  double count;
};

// Group g's kLanes values of the partials (splits, n), a thread a (value,
// slice): value j's slice k is the f64 sum of partials[s][j] for s = k, k +
// kSlices, ... in order, and its total the f64 sum of its slices in order
// (each from 0.0). ``red``: kSlices x kLanes.
__device__ __forceinline__ void combine_group(const double* partials, int splits, int n, int g,
                                              const SumsOut& o, double* red) {
  const int lane = threadIdx.x % kLanes;
  const int slice = threadIdx.x / kLanes;
  const int j = g * kLanes + lane;
  double acc = 0.0;
  if (j < n) {
#pragma unroll 4
    for (int s = slice; s < splits; s += kSlices) {
      acc = __dadd_rn(acc, __ldcg(partials + static_cast<long long>(s) * n + j));
    }
  }
  red[slice * kLanes + lane] = acc;
  __syncthreads();
  if (slice == 0 && j < n) {
    double total = 0.0;
    for (int k = 0; k < kSlices; ++k) total = __dadd_rn(total, red[k * kLanes + lane]);
    o.sums[j] = total;
    if (o.out) o.out[j] = __double2float_rn(total);
  }
  __syncthreads();
}

// After the block's partials are written: every block meets at a grid
// barrier, and the groups of the 2C values are combined across the blocks;
// a count >= 0 goes to sums[n]. Every block of a cooperative grid calls it.
__device__ __forceinline__ void combine(const double* partials, int n, const SumsOut& o,
                                        double* red) {
  const int blocks = gridDim.x * gridDim.y;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  cg::this_grid().sync();
  const int groups = (n + kLanes - 1) / kLanes;
  for (int g = block; g < groups; g += blocks) combine_group(partials, gridDim.y, n, g, o, red);
  if (o.count >= 0.0 && block == 0 && threadIdx.x == 0) o.sums[n] = o.count;
}

// The 2 x tc x V f64 sums of the block's channel tile (and, with ``count``,
// the value after the 2C sums) into ``own``, read once a block: every block
// reads the same few lines, so a read by every thread would queue at the L2
// slices that hold them.
__device__ __forceinline__ void tile_sums(const double* sums, int c, int tcv, bool count,
                                          double* own) {
  const int c0 = blockIdx.x * tcv;
  for (int i = threadIdx.x; i < 2 * tcv; i += kThreads) {
    const int ch = c0 + i % tcv;
    if (ch < c) own[i] = __ldcg(sums + (i < tcv ? 0 : c) + ch);
  }
  if (count && threadIdx.x == 0) own[2 * tcv] = __ldcg(sums + 2 * c);
  __syncthreads();
}

// The workspace (floats): the f64 sums [0, 4C + 2), then the f32 outputs
// from 4C + 2 (N1: count, mean, var, rstd; N2: dbias, dscale), the f64
// partials from ``partials_at``.
struct Workspace {
  double* sums;
  float* out;
  double* partials;
  __device__ __forceinline__ Workspace(float* ws, int c, long long partials_at)
      : sums(reinterpret_cast<double*>(ws)),
        out(ws + 4LL * c + 2),
        partials(reinterpret_cast<double*>(ws + partials_at)) {}
};

// At least two blocks an SM (128 registers a thread); iv_bn_capacity asks
// the card how many it holds.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
bn_fwd_kernel(int mode, const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, float eps, T* __restrict__ y, float* ws,
              long long m, int c, int tc, long long split_rows, long long partials_at) {
  using P = Pack<T, V>;
  using Raw = typename P::Raw;
  __shared__ double red[2 * kThreads * V];  // the block's row lanes, added in a tree
  __shared__ double red64[2 * kThreads + 1];  // the combine's scratch, then the tile's sums
  const Tile t = tile_of(m, c, tc, split_rows, V);
  const int n = 2 * c;
  const Workspace w(ws, c, partials_at);
  float* count_out = w.out;
  float* mean_out = w.out + 1;
  float* var_out = mean_out + c;
  float* rstd_out = var_out + c;
  const long long step = static_cast<long long>(t.tr) * c / V;  // in vectors
  const Raw* const src[1] = {reinterpret_cast<const Raw*>(x + t.first * c + t.c0)};
  if (mode != kApply) {
    KahanSum<V> s1, s2;
    if (t.active) {
      walk_rows<kFwdStages, 1>(src, step, t.rows, [&](int, const Raw* raw) {
        float v[V];
        P::unpack(raw[0], v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s1.add(j, v[j]);
          s2.add(j, __fmul_rn(v[j], v[j]));
        }
      });
    }
    block_partials<V>(t, s1, s2, c, w.partials + static_cast<long long>(blockIdx.y) * n, red);
    combine(w.partials, n, SumsOut{w.sums, nullptr, static_cast<double>(m)}, red64);
    if (mode == kReduce) return;
    cg::this_grid().sync();
  }
  // the statistics in f64 from the f64 sums (of every rank, after the
  // all-reduce of a mesh), each rounded once to f32
  const int tcv = t.tc * V;
  tile_sums(w.sums, c, tcv, true, red64);
  const double count = red64[2 * tcv];
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    *count_out = __double2float_rn(count);
  }
  if (!t.active) return;
  float mean[V], mul[V], add[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = t.c0 + j;
    const int i = t.tx * V + j;
    const double mean64 = __ddiv_rn(red64[i], count);
    const double var64 = fmax(0.0, __dsub_rn(__ddiv_rn(red64[tcv + i], count),
                                             __dmul_rn(mean64, mean64)));
    const float rstd = __double2float_rn(__drcp_rn(__dsqrt_rn(__dadd_rn(var64, eps))));
    mean[j] = __double2float_rn(mean64);
    mul[j] = __fmul_rn(rstd, scale[ch]);
    add[j] = bias[ch];
    if (blockIdx.y == 0 && t.ty == 0) {
      mean_out[ch] = mean[j];
      var_out[ch] = __double2float_rn(var64);
      rstd_out[ch] = rstd;
    }
  }
  T* yp = y + t.first * c + t.c0;
  walk_rows<kFwdStages, 1>(src, step, t.rows, [&](int k, const Raw* raw) {
    float v[V];
    P::unpack(raw[0], v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mean[j]), mul[j]), add[j]);
    }
    P::store(yp + k * step * V, v);
  });
}

// At least two blocks an SM, as N1.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
bn_bwd_kernel(int mode, const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ scale, const float* __restrict__ count_ptr,
              const double* sums_in, T* __restrict__ dx, float* ws, long long m, int c, int tc,
              long long split_rows, long long partials_at) {
  using P = Pack<T, V>;
  using Raw = typename P::Raw;
  __shared__ double red[2 * kThreads * V];  // the block's row lanes, added in a tree
  __shared__ double red64[2 * kThreads];  // the combine's scratch, then the tile's sums
  const Tile t = tile_of(m, c, tc, split_rows, V);
  const int n = 2 * c;
  const Workspace w(ws, c, partials_at);
  const long long step = static_cast<long long>(t.tr) * c / V;  // in vectors
  const long long at = t.first * c + t.c0;
  const Raw* const src[2] = {reinterpret_cast<const Raw*>(x + at),
                             reinterpret_cast<const Raw*>(dy + at)};
  // the tile's mean and rstd, read from shared memory in the row loops (in
  // registers beside the compensated sums or the staged rows they spill)
  __shared__ float murs[2 * kThreads];
  const int tcv = t.tc * V;
  for (int i = threadIdx.x; i < tcv; i += kThreads) {
    const int ch = blockIdx.x * tcv + i;
    if (ch < c) {
      murs[i] = mean[ch];
      murs[tcv + i] = rstd[ch];
    }
  }
  __syncthreads();
  const float* mu = murs + t.tx * V;
  const float* rs = murs + tcv + t.tx * V;
  if (mode != kApply) {
    KahanSum<V> db, dg;
    if (t.active) {
      walk_rows<kBwdStages, 2>(src, step, t.rows, [&](int, const Raw* raw) {
        float xv[V], gv[V];
        P::unpack(raw[0], xv);
        P::unpack(raw[1], gv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xhat = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]);
          db.add(j, gv[j]);
          dg.add(j, __fmul_rn(gv[j], xhat));
        }
      });
    }
    block_partials<V>(t, db, dg, c, w.partials + static_cast<long long>(blockIdx.y) * n, red);
    combine(w.partials, n, SumsOut{w.sums, w.out, -1.0}, red64);
    if (mode == kReduce) return;
    cg::this_grid().sync();
  }
  tile_sums(sums_in, c, tcv, false, red64);
  if (!t.active) return;
  const double count = static_cast<double>(*count_ptr);
  float a[V], b[V], d[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = t.c0 + j;
    const int i = t.tx * V + j;
    a[j] = __fmul_rn(scale[ch], rs[j]);
    b[j] = __double2float_rn(__ddiv_rn(red64[i], count));
    d[j] = __double2float_rn(__ddiv_rn(red64[tcv + i], count));
  }
  T* dxp = dx + at;
  walk_rows<kBwdStages, 2>(src, step, t.rows, [&](int k, const Raw* raw) {
    float xv[V], gv[V];
    P::unpack(raw[0], xv);
    P::unpack(raw[1], gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xhat = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]);
      xv[j] = __fmul_rn(a[j], __fsub_rn(__fsub_rn(gv[j], b[j]), __fmul_rn(xhat, d[j])));
    }
    P::store(dxp + k * step * V, xv);
  });
}

// A value's rounding to T, back in f32.
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return widen(narrow<T>(v));
}

// ATen's ReLU: max(v, 0), a NaN kept.
__device__ __forceinline__ float relu_of(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// N3: a thread's channel vector (blockIdx.x's tile of tc vectors, lane tx)
// down rows blockIdx.y * tr + ty, then gridDim.y * tr further each time.
template <typename T, int V, bool Res>
__global__ void __launch_bounds__(kThreads, 2)
bn_eval_kernel(const T* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ var, const float* __restrict__ scale,
               const float* __restrict__ bias, float eps, const T* __restrict__ residual,
               int relu, T* __restrict__ y, long long m, int c, int tc) {
  using P = Pack<T, V>;
  using Raw = typename P::Raw;
  const int tx = threadIdx.x % tc;
  const int ty = threadIdx.x / tc;
  const int tr = kThreads / tc;
  const int c0 = (blockIdx.x * tc + tx) * V;
  if (c0 >= c) return;
  // the plain chain's per-channel factor: rsqrt(var + eps), then * scale;
  // with no var, scale is that factor already (an exported program's table)
  float mu[V], mul[V], add[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = c0 + j;
    mu[j] = mean[ch];
    mul[j] = var ? __fmul_rn(rsqrtf(__fadd_rn(var[ch], eps)), scale[ch]) : scale[ch];
    add[j] = bias[ch];
  }
  const long long cv = c / V;  // a row, in vectors
  const long long stride = static_cast<long long>(gridDim.y) * tr;
  const Raw* xs = reinterpret_cast<const Raw*>(x + c0);
  const Raw* rs = Res ? reinterpret_cast<const Raw*>(residual + c0) : nullptr;
  for (long long r0 = static_cast<long long>(blockIdx.y) * tr + ty; r0 < m;
       r0 += kEvalStages * stride) {
    Raw xr[kEvalStages], rr[Res ? kEvalStages : 1];
#pragma unroll
    for (int u = 0; u < kEvalStages; ++u) {
      const long long r = r0 + u * stride;
      if (r < m) {
        xr[u] = xs[r * cv];
        if (Res) rr[u] = rs[r * cv];
      }
    }
#pragma unroll
    for (int u = 0; u < kEvalStages; ++u) {
      const long long r = r0 + u * stride;
      if (r >= m) continue;
      float v[V];
      P::unpack(xr[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mu[j]), mul[j]), add[j]);
      }
      if (Res) {
        float s[V];
        P::unpack(rr[Res ? u : 0], s);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = __fadd_rn(s[j], rounded<T>(v[j]));
      }
      if (relu) {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = relu_of(v[j]);
      }
      P::store(y + r * c + c0, v);
    }
  }
}

// One cooperative launch of ``kernel`` on the plan's (tiles, splits) grid:
// the grid barriers need every block resident, and the launch fails, and
// does not hang, on a grid the card cannot hold at once.
template <typename... Exp, typename... Act>
cudaError_t launch(void (*kernel)(Exp...), int tiles, int splits, cudaStream_t stream,
                   Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
}

// N3 on (tiles, splits) blocks, splits as many as fill the card's resident
// blocks (asked once a device) without more row groups than rows.
template <typename T, int V, bool Res>
cudaError_t launch_eval(const T* x, const float* mean, const float* var, const float* scale,
                        const float* bias, float eps, const T* residual, int relu, T* y,
                        long long m, int c, cudaStream_t stream) {
  static std::atomic<int> resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int capacity = dev < kMaxDevices ? resident[dev].load(std::memory_order_relaxed) : 0;
  if (capacity < 1) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bn_eval_kernel<T, V, Res>,
                                                          kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    capacity = per_sm * sms > 1 ? per_sm * sms : 1;
    if (dev < kMaxDevices) resident[dev].store(capacity, std::memory_order_relaxed);
  }
  const int cv = c / V;
  int tc = 1;
  while (tc < cv && tc < 32) tc *= 2;
  const int tiles = (cv + tc - 1) / tc;
  const long long tr = kThreads / tc;
  long long splits = capacity / tiles;
  const long long groups = (m + tr - 1) / tr;
  if (splits > groups) splits = groups;
  if (splits < 1) splits = 1;
  bn_eval_kernel<T, V, Res><<<dim3(tiles, static_cast<unsigned>(splits)), kThreads, 0, stream>>>(
      x, mean, var, scale, bias, eps, residual, relu, y, m, c, tc);
  return cudaGetLastError();
}


int finish(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
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

// The blocks of N1's (half 0) or N2's (half 1) kernel that the current
// device holds at once: the largest grid of a launch.
extern "C" int iv_bn_capacity(int half, int dtype, int vec, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (half != 0 && half != 1) return -1;
#define IV_BN_CAPACITY(T, V)                                                              \
  if (err == cudaSuccess) {                                                               \
    err = half == 0                                                                       \
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bn_fwd_kernel<T, V>, \
                                                              kThreads, 0)                \
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bn_bwd_kernel<T, V>, \
                                                              kThreads, 0);               \
  }
  IV_BN_DISPATCH(IV_BN_CAPACITY)
#undef IV_BN_CAPACITY
  *blocks = per_sm * sms;
  return finish(err);
}

// N1 in ``mode``: kOneLaunch (y, mean, var, rstd and the sums with the row
// count in ``ws``), kReduce (the sums alone), kApply (the rest, from the
// sums in ``ws``, all-reduced in between by the wrapper).
extern "C" int iv_bn_fwd(int mode, int dtype, int vec, const void* x, const float* scale,
                         const float* bias, float eps, void* y, float* ws, long long m, int c,
                         int tc, int tiles, int splits, long long split_rows,
                         long long partials_at, cudaStream_t stream) {
  if (mode < kOneLaunch || mode > kApply) return -1;
  cudaError_t err = cudaSuccess;
#define IV_BN_FWD(T, V)                                                                     \
  err = launch(&bn_fwd_kernel<T, V>, tiles, splits, stream, mode, static_cast<const T*>(x), \
               scale, bias, eps, static_cast<T*>(y), ws, m, c, tc, split_rows, partials_at)
  IV_BN_DISPATCH(IV_BN_FWD)
#undef IV_BN_FWD
  return finish(err);
}

// N2 in ``mode``: kOneLaunch (dx, and the local sums (dbeta, dgamma) in
// ``ws``), kReduce (the local sums alone), kApply (dx from ``sums``: the
// all-reduced copy, or ``ws`` itself on one rank). ``count`` is N1's row
// count (device memory, so the host never waits for it).
extern "C" int iv_bn_bwd(int mode, int dtype, int vec, const void* x, const void* dy,
                         const float* mean, const float* rstd, const float* scale,
                         const float* count, const double* sums, void* dx, float* ws,
                         long long m, int c, int tc, int tiles, int splits, long long split_rows,
                         long long partials_at, cudaStream_t stream) {
  if (mode < kOneLaunch || mode > kApply) return -1;
  cudaError_t err = cudaSuccess;
#define IV_BN_BWD(T, V)                                                                    \
  err = launch(&bn_bwd_kernel<T, V>, tiles, splits, stream, mode, static_cast<const T*>(x), \
               static_cast<const T*>(dy), mean, rstd, scale, count, sums,                  \
               static_cast<T*>(dx), ws, m, c, tc, split_rows, partials_at)
  IV_BN_DISPATCH(IV_BN_BWD)
#undef IV_BN_BWD
  return finish(err);
}

// N3: y (M, C) of x (M, C), both of ``dtype``, on the running statistics
// and f32 parameters (C each), plus ``residual`` (x's type and layout, or
// null), with ``relu`` non-zero a ReLU last. A null ``var`` takes ``scale``
// as the factor rsqrt(var + eps) * scale itself (eps unused). The load
// width is the widest that C and the three pointers allow. Nothing to do
// for M = 0.
extern "C" int iv_bn_eval(int dtype, const void* x, const float* mean, const float* var,
                          const float* scale, const float* bias, float eps,
                          const void* residual, int relu, void* y, long long m, int c,
                          cudaStream_t stream) {
  if (c < 1 || m < 0 || (dtype != 0 && dtype != 1)) return -1;
  if (m == 0) return 0;
  const int itemsize = dtype == 0 ? 4 : 2;
  int align = 16;
  for (const void* p : {x, residual, static_cast<const void*>(y)}) {
    while (p && reinterpret_cast<unsigned long long>(p) % align) align /= 2;
  }
  int vec = 1;
  for (int v : {8, 4, 2}) {
    if (v * itemsize <= 16 && c % v == 0 && align % (v * itemsize) == 0) {
      vec = v;
      break;
    }
  }
  cudaError_t err = cudaSuccess;
#define IV_BN_EVAL(T, V)                                                                   \
  err = residual                                                                          \
            ? launch_eval<T, V, true>(static_cast<const T*>(x), mean, var, scale, bias, eps, \
                                      static_cast<const T*>(residual), relu,               \
                                      static_cast<T*>(y), m, c, stream)                    \
            : launch_eval<T, V, false>(static_cast<const T*>(x), mean, var, scale, bias,   \
                                       eps, nullptr, relu, static_cast<T*>(y), m, c, stream)
  IV_BN_DISPATCH(IV_BN_EVAL)
#undef IV_BN_EVAL
  return finish(err);
}
