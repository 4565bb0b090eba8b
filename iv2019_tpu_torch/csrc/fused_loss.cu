// Fused hierarchical loss, forward (B1) and backward (B2), for sm_90a.
//
// Replaces the Pallas TPU kernels of iv2019_tpu/ops/fused_loss.py,
// make_fused_hierarchical_loss: ``fwd_kernel`` (B1) and ``bwd_kernel`` (B2).
//
// What they compute. The three heads' stride-8 logits (N, h, w, C) are
// upsampled x8 to (H, W) with TF1 align-corners bilinear weights. For every
// output pixel: log-sum-exp and the first-max argmax of each head, the fused
// hierarchical decision, and
//   - per-pixel images (n < n_pp): the sparse CE of each head against its
//     label, the head's void class weighted 0;
//   - weak images: the dense CE of the vehicle and human heads against the
//     15-class weak multinomial projected onto each head, weighted by the
//     gate  not-void AND l1 decision == metaclass AND max label >= 0.01.
// B1 returns the six sums (weighted CE and weight count per head) and the
// decision maps. B2 returns d(sum . g)/d logits at stride 8, with g the
// three heads' cotangents: w * g * (softmax - onehot or label), taken back
// through the upsample. Weak images give no L1 gradient.
//
// What bounds them on the H100: bytes. The weak labels alone are
// 12 x 15 x 512 x 1024 x 4 B = 377 MB per step and the two decision maps
// 67 MB; the logits (13 MB) stay in L2. Per pixel there are ~400 flops (~1
// per byte moved), far below the card's ridge. So both kernels read every label once, in the
// pixel order of the maps, and keep everything else on chip:
//   - the upsample is separable with two taps per axis, so each output
//     logit is a 4-tap blend of the stride-8 logits (rows first, then
//     columns, as the reference's A @ lr @ B), read through L1/L2; no dense
//     interpolation matrix, no full-resolution logit tensor;
//   - the weak labels are read NHWC directly (the TPU kernel's channel-major
//     transpose was a VMEM layout choice);
//   - argmax is first-max (strict >), as the reference.
//
// Determinism. The Pallas forward accumulates per-tile partial sums that
// XLA adds afterwards; here each block writes its six partial sums to its
// own slot and a one-block pass adds the slots in a fixed order (in f64).
// The Pallas backward zeroes its stride-8 output at the first row tile and
// adds into it across the sequential grid; CUDA blocks run in no order, and
// f32 atomics would make the result change from run to run. So B2 is two
// passes, each a gather in a fixed order:
//   1. one block per (image, output row, chunk of 16 stride-8 columns)
//      recomputes the forward for the output pixels those columns touch,
//      keeps the per-pixel gradients in shared memory, and contracts them
//      over the output columns: R[n, y, j, c] = sum_x B[j, x] d[n, y, x, c];
//   2. one thread per stride-8 logit contracts R over the output rows that
//      touch it: dlogit[n, i, j, c] = sum_y A[y, i] R[n, y, j, c].
// R (N x H x w x C floats, 100 MB at the flagship shapes) is the price of
// determinism without atomics; the recompute overlaps by one tap (~6%).
//
// Any H, W with out >= in work: each block masks its ragged edge; the TPU
// kernel's zero-weight row padding does not exist here.
//
// Tap tables (built on the host from the same f32 matrices as the plain
// version, iv2019_tpu_torch/ops/resize.py::_bilinear_matrix), int32 ``itab``:
//   row_lo[H], row_hi[H], col_lo[W], col_hi[W],
//   row_first[h], row_end[h], col_first[w], col_end[w]
// and f32 ``ftab``: row_w0[H], row_w1[H], col_w0[W], col_w1[W]. Where lo ==
// hi the whole matrix entry is w0 and w1 is 0. row_first/row_end give the
// output rows y (a contiguous range) whose taps touch stride-8 row i, and
// the same for columns.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// iv2019_tpu_torch/ops/fused_loss.py. Each entry point returns
// cudaGetLastError(), or a negative code for shapes it does not take.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWeak = 15;
constexpr int kMaxClasses = 64;
constexpr int kFwdThreads = 256;
constexpr int kFwdPixelsPerThread = 4;
constexpr int kFwdPixels = kFwdThreads * kFwdPixelsPerThread;
constexpr int kRowThreads = 128;
constexpr int kJChunk = 16;
constexpr int kColThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

struct Tables {
  int pb2veh[kWeak];
  int pb2hum[kWeak];
  int l1_common[kMaxClasses];
  int veh_common[kMaxClasses];
  int hum_common[kMaxClasses];
  int cid_v, cid_h;
};

struct Args {
  const float* l1;  // (N, h, w, C1)
  const float* veh;  // (N, h, w, CV)
  const float* hum;  // (N, h, w, CH)
  const int* pp_l1;  // (n_pp, H, W)
  const int* pp_veh;
  const int* pp_hum;
  const float* weak;  // (n_weak, H, W, 15)
  const int* itab;
  const float* ftab;
  int n_pp, h, w, H, W;
};

struct Taps {
  int y0, y1, x0, x1;
  float wy0, wy1, wx0, wx1;
};

__device__ __forceinline__ Taps taps_of(const Args& a, int y, int x) {
  Taps t;
  t.y0 = a.itab[y];
  t.y1 = a.itab[a.H + y];
  t.x0 = a.itab[2 * a.H + x];
  t.x1 = a.itab[2 * a.H + a.W + x];
  t.wy0 = a.ftab[y];
  t.wy1 = a.ftab[a.H + y];
  t.wx0 = a.ftab[2 * a.H + x];
  t.wx1 = a.ftab[2 * a.H + a.W + x];
  return t;
}

// 4-tap blend of one head's stride-8 logits at one output pixel: rows, then
// columns; one rounding per operation (no FMA contraction).
template <int C>
__device__ __forceinline__ void upsample(const float* lr, const Args& a, int n, const Taps& t,
                                         float (&u)[C]) {
  const long long base = static_cast<long long>(n) * a.h * a.w;
  const float* p00 = lr + (base + static_cast<long long>(t.y0) * a.w + t.x0) * C;
  const float* p10 = lr + (base + static_cast<long long>(t.y1) * a.w + t.x0) * C;
  const float* p01 = lr + (base + static_cast<long long>(t.y0) * a.w + t.x1) * C;
  const float* p11 = lr + (base + static_cast<long long>(t.y1) * a.w + t.x1) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float r0 = __fadd_rn(__fmul_rn(t.wy0, __ldg(p00 + c)), __fmul_rn(t.wy1, __ldg(p10 + c)));
    const float r1 = __fadd_rn(__fmul_rn(t.wy0, __ldg(p01 + c)), __fmul_rn(t.wy1, __ldg(p11 + c)));
    u[c] = __fadd_rn(__fmul_rn(t.wx0, r0), __fmul_rn(t.wx1, r1));
  }
}

// log-sum-exp (max first, then the sum of exponentials in class order) and
// the first-max argmax.
template <int C>
__device__ __forceinline__ void head_stats(const float (&u)[C], float& lse, int& dec) {
  float m = u[0];
  dec = 0;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    if (u[c] > m) {
      m = u[c];
      dec = c;
    }
  }
  float se = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) se += expf(u[c] - m);
  lse = m + logf(se);
}

template <int C>
__device__ __forceinline__ float pick(const float (&u)[C], int lab) {
  float v = u[0];
#pragma unroll
  for (int c = 1; c < C; ++c) v = (lab == c) ? u[c] : v;
  return v;
}

// The weak multinomial projected onto a head (class sums in weak-class order).
template <int C>
__device__ __forceinline__ void project(const float (&wk)[kWeak], const int* table,
                                        float (&lab)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) lab[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < kWeak; ++k) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (table[k] == c) lab[c] += wk[k];
    }
  }
}

template <int C>
__device__ __forceinline__ bool weak_gate(const float (&lab)[C], int l1_dec, int cid) {
  float mx = lab[0];
#pragma unroll
  for (int c = 1; c < C - 1; ++c) mx = fmaxf(mx, lab[c]);
  return (1.0f - lab[C - 1]) > 0.01f && l1_dec == cid && mx >= 0.01f;
}

template <int C>
__device__ __forceinline__ float dense_ce(const float (&u)[C], float lse, const float (&lab)[C]) {
  float ce = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) ce += lab[c] * (lse - u[c]);
  return ce;
}

// Everything the forward needs of one output pixel.
template <int C1, int CV, int CH>
struct Pixel {
  float u1[C1], uv[CV], uh[CH];
  float lse1, lsev, lseh;
  int d1, dv, dh;
};

template <int C1, int CV, int CH>
__device__ __forceinline__ void eval_pixel(const Args& a, int n, int y, int x,
                                           Pixel<C1, CV, CH>& px) {
  const Taps t = taps_of(a, y, x);
  upsample<C1>(a.l1, a, n, t, px.u1);
  upsample<CV>(a.veh, a, n, t, px.uv);
  upsample<CH>(a.hum, a, n, t, px.uh);
  head_stats<C1>(px.u1, px.lse1, px.d1);
  head_stats<CV>(px.uv, px.lsev, px.dv);
  head_stats<CH>(px.uh, px.lseh, px.dh);
}

__device__ __forceinline__ void load_weak(const Args& a, int n, long long p, float (&wk)[kWeak]) {
  const float* src = a.weak + (static_cast<long long>(n - a.n_pp) * a.H * a.W + p) * kWeak;
#pragma unroll
  for (int k = 0; k < kWeak; ++k) wk[k] = __ldg(src + k);
}

// ---------------------------------------------------------------- B1

template <int C1, int CV, int CH>
__global__ void __launch_bounds__(kFwdThreads)
fwd_kernel(Args a, Tables tb, float* partials, int* dec_out, int* l1dec_out) {
  const int n = blockIdx.y;
  const long long hw = static_cast<long long>(a.H) * a.W;
  const long long p0 = static_cast<long long>(blockIdx.x) * kFwdPixels;
  const bool is_pp = n < a.n_pp;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < kFwdPixelsPerThread; ++k) {
    const long long p = p0 + k * kFwdThreads + threadIdx.x;
    if (p >= hw) break;
    const int y = static_cast<int>(p / a.W);
    const int x = static_cast<int>(p % a.W);
    Pixel<C1, CV, CH> px;
    eval_pixel<C1, CV, CH>(a, n, y, x, px);
    const int fused = px.d1 == tb.cid_v   ? tb.veh_common[px.dv]
                      : px.d1 == tb.cid_h ? tb.hum_common[px.dh]
                                          : tb.l1_common[px.d1];
    dec_out[n * hw + p] = fused;
    l1dec_out[n * hw + p] = px.d1;
    if (is_pp) {
      const long long q = static_cast<long long>(n) * hw + p;
      const int l1lab = a.pp_l1[q], vlab = a.pp_veh[q], hlab = a.pp_hum[q];
      const float w1 = l1lab != C1 - 1 ? 1.0f : 0.0f;
      const float wv = vlab != CV - 1 ? 1.0f : 0.0f;
      const float wh = hlab != CH - 1 ? 1.0f : 0.0f;
      acc[0] += (px.lse1 - pick<C1>(px.u1, l1lab)) * w1;
      acc[1] += w1;
      acc[2] += (px.lsev - pick<CV>(px.uv, vlab)) * wv;
      acc[3] += wv;
      acc[4] += (px.lseh - pick<CH>(px.uh, hlab)) * wh;
      acc[5] += wh;
    } else {
      float wk[kWeak];
      load_weak(a, n, p, wk);
      float vlab[CV], hlab[CH];
      project<CV>(wk, tb.pb2veh, vlab);
      project<CH>(wk, tb.pb2hum, hlab);
      const float wv = weak_gate<CV>(vlab, px.d1, tb.cid_v) ? 1.0f : 0.0f;
      const float wh = weak_gate<CH>(hlab, px.d1, tb.cid_h) ? 1.0f : 0.0f;
      acc[2] += dense_ce<CV>(px.uv, px.lsev, vlab) * wv;
      acc[3] += wv;
      acc[4] += dense_ce<CH>(px.uh, px.lseh, hlab) * wh;
      acc[5] += wh;
    }
  }
  __shared__ float sh[6][kFwdThreads];
#pragma unroll
  for (int i = 0; i < 6; ++i) sh[i][threadIdx.x] = acc[i];
  __syncthreads();
  for (int off = kFwdThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
#pragma unroll
      for (int i = 0; i < 6; ++i) sh[i][threadIdx.x] += sh[i][threadIdx.x + off];
    }
    __syncthreads();
  }
  if (threadIdx.x < 6) {
    partials[(static_cast<long long>(n) * gridDim.x + blockIdx.x) * 6 + threadIdx.x] =
        sh[threadIdx.x][0];
  }
}

// One block: the (count, 6) partial sums, slot by slot in a fixed order.
__global__ void __launch_bounds__(kFwdThreads)
sum_partials(const float* partials, int count, float* sums) {
  __shared__ double sh[kFwdThreads];
  for (int i = 0; i < 6; ++i) {
    double acc = 0.0;
    for (int b = threadIdx.x; b < count; b += kFwdThreads) acc += partials[b * 6 + i];
    sh[threadIdx.x] = acc;
    __syncthreads();
    for (int off = kFwdThreads / 2; off > 0; off >>= 1) {
      if (threadIdx.x < off) sh[threadIdx.x] += sh[threadIdx.x + off];
      __syncthreads();
    }
    if (threadIdx.x == 0) sums[i] = static_cast<float>(sh[0]);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- B2

// Per-pixel gradient w.r.t. the upsampled logits, all heads, into d[0..Ctot).
template <int C1, int CV, int CH>
__device__ __forceinline__ void pixel_grad(const Args& a, const Tables& tb, const float* g3,
                                           int n, int y, int x, float* d) {
  Pixel<C1, CV, CH> px;
  eval_pixel<C1, CV, CH>(a, n, y, x, px);
  const long long p = static_cast<long long>(y) * a.W + x;
  const float g1 = g3[0], gv = g3[1], gh = g3[2];
  if (n < a.n_pp) {
    const long long q = static_cast<long long>(n) * a.H * a.W + p;
    const int l1lab = a.pp_l1[q], vlab = a.pp_veh[q], hlab = a.pp_hum[q];
    const float w1 = (l1lab != C1 - 1 ? 1.0f : 0.0f) * g1;
    const float wv = (vlab != CV - 1 ? 1.0f : 0.0f) * gv;
    const float wh = (hlab != CH - 1 ? 1.0f : 0.0f) * gh;
#pragma unroll
    for (int c = 0; c < C1; ++c)
      d[c] = w1 * (expf(px.u1[c] - px.lse1) - (l1lab == c ? 1.0f : 0.0f));
#pragma unroll
    for (int c = 0; c < CV; ++c)
      d[C1 + c] = wv * (expf(px.uv[c] - px.lsev) - (vlab == c ? 1.0f : 0.0f));
#pragma unroll
    for (int c = 0; c < CH; ++c)
      d[C1 + CV + c] = wh * (expf(px.uh[c] - px.lseh) - (hlab == c ? 1.0f : 0.0f));
  } else {
    float wk[kWeak];
    load_weak(a, n, p, wk);
    float vlab[CV], hlab[CH];
    project<CV>(wk, tb.pb2veh, vlab);
    project<CH>(wk, tb.pb2hum, hlab);
    const float wv = (weak_gate<CV>(vlab, px.d1, tb.cid_v) ? 1.0f : 0.0f) * gv;
    const float wh = (weak_gate<CH>(hlab, px.d1, tb.cid_h) ? 1.0f : 0.0f) * gh;
#pragma unroll
    for (int c = 0; c < C1; ++c) d[c] = 0.0f;
#pragma unroll
    for (int c = 0; c < CV; ++c) d[C1 + c] = wv * (expf(px.uv[c] - px.lsev) - vlab[c]);
#pragma unroll
    for (int c = 0; c < CH; ++c) d[C1 + CV + c] = wh * (expf(px.uh[c] - px.lseh) - hlab[c]);
  }
}

// Pass 1: block (chunk of 16 stride-8 columns, output row y, image n).
template <int C1, int CV, int CH>
__global__ void __launch_bounds__(kRowThreads)
bwd_rows_kernel(Args a, Tables tb, const float* g3, float* R) {
  constexpr int Ct = C1 + CV + CH;
  extern __shared__ float dsm[];  // [x - x_begin][Ct]
  const int n = blockIdx.z, y = blockIdx.y;
  const int j0 = blockIdx.x * kJChunk;
  const int j1 = min(j0 + kJChunk, a.w);
  const int* col_lo = a.itab + 2 * a.H;
  const int* col_hi = col_lo + a.W;
  const int* col_first = a.itab + 2 * a.H + 2 * a.W + 2 * a.h;
  const int* col_end = col_first + a.w;
  const float* col_w0 = a.ftab + 2 * a.H;
  const float* col_w1 = col_w0 + a.W;
  const int x_begin = col_first[j0];
  const int x_end = col_end[j1 - 1];
  for (int x = x_begin + threadIdx.x; x < x_end; x += kRowThreads) {
    pixel_grad<C1, CV, CH>(a, tb, g3, n, y, x, dsm + (x - x_begin) * Ct);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < (j1 - j0) * Ct; idx += kRowThreads) {
    const int j = j0 + idx / Ct, c = idx % Ct;
    float acc = 0.0f;
    for (int x = col_first[j]; x < col_end[j]; ++x) {
      const float coef = (col_lo[x] == j ? col_w0[x] : 0.0f) + (col_hi[x] == j ? col_w1[x] : 0.0f);
      acc += coef * dsm[(x - x_begin) * Ct + c];
    }
    R[((static_cast<long long>(n) * a.H + y) * a.w + j) * Ct + c] = acc;
  }
}

// Pass 2: one thread per stride-8 logit (n, i, j, c) of all heads.
template <int C1, int CV, int CH>
__global__ void __launch_bounds__(kColThreads)
bwd_cols_kernel(Args a, const float* R, float* dl1, float* dveh, float* dhum) {
  constexpr int Ct = C1 + CV + CH;
  const int n = blockIdx.z, i = blockIdx.y;
  const int idx = blockIdx.x * kColThreads + threadIdx.x;
  if (idx >= a.w * Ct) return;
  const int j = idx / Ct, c = idx % Ct;
  const int* row_lo = a.itab;
  const int* row_hi = a.itab + a.H;
  const int* row_first = a.itab + 2 * a.H + 2 * a.W;
  const int* row_end = row_first + a.h;
  const float* row_w0 = a.ftab;
  const float* row_w1 = a.ftab + a.H;
  float acc = 0.0f;
  for (int y = row_first[i]; y < row_end[i]; ++y) {
    const float coef = (row_lo[y] == i ? row_w0[y] : 0.0f) + (row_hi[y] == i ? row_w1[y] : 0.0f);
    acc += coef * R[((static_cast<long long>(n) * a.H + y) * a.w + j) * Ct + c];
  }
  const long long cell = (static_cast<long long>(n) * a.h + i) * a.w + j;
  if (c < C1) {
    dl1[cell * C1 + c] = acc;
  } else if (c < C1 + CV) {
    dveh[cell * CV + (c - C1)] = acc;
  } else {
    dhum[cell * CH + (c - C1 - CV)] = acc;
  }
}

// ---------------------------------------------------------------- launch

Tables make_tables(const int* host_tables, int c1, int cv, int ch, int cid_v, int cid_h) {
  Tables t;
  const int* p = host_tables;
  for (int k = 0; k < kWeak; ++k) t.pb2veh[k] = *p++;
  for (int k = 0; k < kWeak; ++k) t.pb2hum[k] = *p++;
  for (int k = 0; k < c1; ++k) t.l1_common[k] = *p++;
  for (int k = 0; k < cv; ++k) t.veh_common[k] = *p++;
  for (int k = 0; k < ch; ++k) t.hum_common[k] = *p++;
  t.cid_v = cid_v;
  t.cid_h = cid_h;
  return t;
}

template <int C1, int CV, int CH>
int launch_fwd(const Args& a, const Tables& tb, int n, float* partials, long long partials_cap,
               float* sums, int* dec, int* l1dec, cudaStream_t stream) {
  const long long hw = static_cast<long long>(a.H) * a.W;
  const int blocks = static_cast<int>((hw + kFwdPixels - 1) / kFwdPixels);
  if (static_cast<long long>(blocks) * n * 6 > partials_cap) return -3;
  fwd_kernel<C1, CV, CH><<<dim3(blocks, n), kFwdThreads, 0, stream>>>(a, tb, partials, dec, l1dec);
  sum_partials<<<1, kFwdThreads, 0, stream>>>(partials, blocks * n, sums);
  return static_cast<int>(cudaGetLastError());
}

template <int C1, int CV, int CH>
int launch_bwd(const Args& a, const Tables& tb, int n, const float* g3, float* R,
               float* dl1, float* dveh, float* dhum, int smem_bytes, cudaStream_t stream) {
  constexpr int Ct = C1 + CV + CH;
  if (smem_bytes > kMaxSmem) return -2;
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(bwd_rows_kernel<C1, CV, CH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  }
  const dim3 rows_grid((a.w + kJChunk - 1) / kJChunk, a.H, n);
  bwd_rows_kernel<C1, CV, CH><<<rows_grid, kRowThreads, smem_bytes, stream>>>(a, tb, g3, R);
  const dim3 cols_grid((a.w * Ct + kColThreads - 1) / kColThreads, a.h, n);
  bwd_cols_kernel<C1, CV, CH><<<cols_grid, kColThreads, 0, stream>>>(a, R, dl1, dveh, dhum);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* l1, const float* veh, const float* hum, const int* pp_l1,
               const int* pp_veh, const int* pp_hum, const float* weak, const int* itab,
               const float* ftab, int n_pp, int h, int w, int H, int W) {
  Args a;
  a.l1 = l1;
  a.veh = veh;
  a.hum = hum;
  a.pp_l1 = pp_l1;
  a.pp_veh = pp_veh;
  a.pp_hum = pp_hum;
  a.weak = weak;
  a.itab = itab;
  a.ftab = ftab;
  a.n_pp = n_pp;
  a.h = h;
  a.w = w;
  a.H = H;
  a.W = W;
  return a;
}

}  // namespace

// The head widths the kernels are compiled for: Cityscapes (14, 7, 3) and
// Vistas (53, 12, 5). Others return -1.
#define IV_DISPATCH(C1, CV, CH, CALL)                      \
  if (c1 == C1 && cv == CV && ch == CH) return CALL<C1, CV, CH>

extern "C" int iv_fused_loss_fwd(const float* l1, const float* veh, const float* hum,
                                 const int* pp_l1, const int* pp_veh, const int* pp_hum,
                                 const float* weak, const int* itab, const float* ftab,
                                 const int* host_tables, float* partials,
                                 long long partials_cap, float* sums, int* dec, int* l1dec,
                                 int n, int n_pp, int h, int w, int H, int W, int c1, int cv,
                                 int ch, int cid_v, int cid_h, cudaStream_t stream) {
  if (c1 > kMaxClasses || cv > kMaxClasses || ch > kMaxClasses) return -1;
  const Args a = make_args(l1, veh, hum, pp_l1, pp_veh, pp_hum, weak, itab, ftab, n_pp, h, w, H, W);
  const Tables tb = make_tables(host_tables, c1, cv, ch, cid_v, cid_h);
  IV_DISPATCH(14, 7, 3, launch_fwd)(a, tb, n, partials, partials_cap, sums, dec, l1dec, stream);
  IV_DISPATCH(53, 12, 5, launch_fwd)(a, tb, n, partials, partials_cap, sums, dec, l1dec, stream);
  return -1;
}

extern "C" int iv_fused_loss_bwd(const float* l1, const float* veh, const float* hum,
                                 const int* pp_l1, const int* pp_veh, const int* pp_hum,
                                 const float* weak, const int* itab, const float* ftab,
                                 const int* host_tables, const float* g3, float* R, float* dl1,
                                 float* dveh, float* dhum, int n, int n_pp, int h, int w, int H,
                                 int W, int c1, int cv, int ch, int cid_v, int cid_h,
                                 int smem_bytes, cudaStream_t stream) {
  if (c1 > kMaxClasses || cv > kMaxClasses || ch > kMaxClasses) return -1;
  const Args a = make_args(l1, veh, hum, pp_l1, pp_veh, pp_hum, weak, itab, ftab, n_pp, h, w, H, W);
  const Tables tb = make_tables(host_tables, c1, cv, ch, cid_v, cid_h);
  IV_DISPATCH(14, 7, 3, launch_bwd)(a, tb, n, g3, R, dl1, dveh, dhum, smem_bytes, stream);
  IV_DISPATCH(53, 12, 5, launch_bwd)(a, tb, n, g3, R, dl1, dveh, dhum, smem_bytes, stream);
  return -1;
}
