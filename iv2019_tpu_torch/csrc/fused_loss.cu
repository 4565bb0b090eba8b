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
// What bounds them on the H100: bytes by the count, instruction issue in
// practice. The weak labels alone are 12 x 15 x 512 x 1024 x 4 B = 377 MB per
// step and the two decision maps 67 MB; the logits (13 MB) stay in L2: 0.13
// to 0.14 ms at 3.35 TB/s. But a pixel costs several hundred instructions
// (blend, max, exponentials, projection, gates, contraction), and 8.4M
// pixels at the card's 132 x 4 warp instructions a clock take longer than
// the bytes do: fewer instructions per pixel is the first lever. So both
// kernels read every label once and keep everything else on chip:
//   - the upsample is separable with two taps per axis, so each output
//     logit is a 4-tap blend of the stride-8 logits (rows first, then
//     columns, as the reference's A @ lr @ B); no dense interpolation
//     matrix, no full-resolution logit tensor;
//   - the weak labels are read NHWC directly (the TPU kernel's channel-major
//     transpose was a VMEM layout choice);
//   - argmax is first-max (strict >), as the reference;
//   - B2 blends the rows once per (output row, stride-8 column, class) in
//     shared memory instead of once per pixel, takes each exponential once,
//     and skips what a pixel's gradient does not need (the L1 softmax of a
//     weak image, a head whose gate is closed or whose label is void).
//
// Determinism. The Pallas forward accumulates per-tile partial sums that
// XLA adds afterwards; here each block writes its six partial sums to its
// own slot and a one-block pass adds the slots in a fixed order (in f64).
// The Pallas backward zeroes its stride-8 output at the first row tile and
// adds into it across the sequential grid; CUDA blocks run in no order, and
// f32 atomics would make the result change from run to run. In B2 the loop
// inside a block takes the place of that sequential grid dimension: a block
// walks down the output rows of its band and sums in the order of the rows
// (see the B2 section).
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
#include <stdint.h>

namespace {

constexpr int kWeak = 15;
constexpr int kMaxClasses = 64;
constexpr int kFwdThreads = 256;
constexpr int kFwdPixelsPerThread = 4;
constexpr int kFwdPixels = kFwdThreads * kFwdPixelsPerThread;
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
//
// One kernel. A block owns, for one image, a chunk of stride-8 columns
// [j0, j1) and a band of stride-8 rows [i0, i1), and walks the output rows
// that touch the band, y ascending. Per row:
//   labels   the row segment of the labels lies in shared memory, brought
//            there ahead of its row by one thread's bulk copy (the 1-D TMA
//            copy) that completes on an mbarrier (a ring of kLabelRing row
//            buffers);
//   blend    rb[j][c] = wy0 * lr[y0][j][c] + wy1 * lr[y1][j][c] for the
//            chunk's columns and their halo, once per row, from the band's
//            logit rows staged at the start (the operations of ``upsample``
//            in the same order, so the decisions are the forward's);
//   pixel    one thread per output pixel: the column blend, then per head
//            only what its gradient needs (see grad_sparse / grad_dense);
//            the gradients go to a shared tile as 16-byte stores, the pixel
//            stride an odd number of 16-byte groups (no bank conflicts);
//   columns  the thread that owns (j, four classes) contracts the tile over
//            the output columns that touch j, x ascending, one 16-byte load
//            per column, with coefficients tabled at the start;
//   rows     and adds the result, times the row's two weights, into the two
//            live stride-8 rows lo[y] and lo[y] + 1. lo never decreases, so
//            when it moves on a row is complete and is stored.
// A band also walks the rows that touch it from the neighbouring bands (one
// tap of recompute per edge) and keeps only its own rows' sums, so every
// logit is written by exactly one thread, summed in the fixed order of y:
// no atomics, no scratch, the same bits from run to run.
//
// stage_words, blend_cols and the row blend know nothing of the gradient:
// the forward can take the same staging over.
//
// The launch plan (chunk and band sizes, threads, the shared-memory
// regions) comes from ops/fused_loss.py::_bwd_plan; bwd_smem_words repeats
// its layout and launch_bwd refuses a plan that disagrees.

constexpr int kBwdMaxThreads = 320;  // two blocks of them per SM leave 102 registers a thread
constexpr int kLabelRing = 2;  // two keep four blocks on an SM; three cost one (measured slower)

__host__ __device__ constexpr int pad4(int c) { return (c + 3) / 4 * 4; }
// The gradient tile's pixel stride in words: the classes in groups of four,
// padded to an odd number of groups.
__host__ __device__ constexpr int bwd_stride(int ct) { return 4 * (((ct + 3) / 4) | 1); }
// Most (column, four classes) units one thread owns: 16 columns over 128 threads.
__host__ __device__ constexpr int bwd_units(int ct) { return (16 * ((ct + 3) / 4) + 127) / 128; }

struct WalkPlan {
  int jc, ib;       // stride-8 columns per chunk, stride-8 rows per band
  int threads;      // >= the pixels of a chunk (one trip of the pixel loop) wherever a
                    // chunk of one column allows it
  int px_max;       // most output pixels of one chunk
  int cols_max;     // most stride-8 columns a chunk stages (its own and the halo)
  int rows_max;     // most stride-8 rows a band stages
  int taps_max;     // most output columns that touch one stride-8 column
  int label_words;  // words of one label-row buffer
  int smem_bytes;
};

// The 0/1 projection of the weak classes onto the two L2 heads, as kernel
// parameters: after unrolling, each entry is a constant-bank operand.
template <int CV, int CH>
struct WeakMasks {
  float veh[kWeak][CV];
  float hum[kWeak][CH];
};

// Word offsets of the shared-memory regions, each a multiple of 4 words.
struct WalkSmem {
  int lr, rb, d, coef, cstart, ccnt, bars, labels, total;
};

__host__ __device__ inline WalkSmem bwd_smem_words(const WalkPlan& p, int cp, int s) {
  WalkSmem m;
  int at = 0;
  m.lr = at, at += pad4(p.rows_max * p.cols_max * cp);
  m.rb = at, at += pad4(p.cols_max * cp);
  m.d = at, at += pad4(p.px_max * s);
  m.coef = at, at += pad4(p.jc * p.taps_max);
  m.cstart = at, at += pad4(p.jc);
  m.ccnt = at, at += pad4(p.jc);
  m.bars = at, at += pad4(2 * kLabelRing);  // one 8-byte mbarrier per label buffer
  m.labels = at, at += kLabelRing * p.label_words;
  m.total = at;
  return m;
}

// Copies words [e0, e1) of ``src`` (``total`` words in all) to shared
// memory as one bulk copy (the 1-D TMA copy) that completes on ``bar``, from
// e0 rounded down to 4 words and up to whole 16-byte pieces: word e lands at
// dst + (e - (e0 & ~3)). Called by one thread. Where the last piece would
// cross the tensor's end, its words come by plain loads. Returns the bytes
// the barrier has to expect.
__device__ __forceinline__ uint32_t stage_words(uint32_t dst, const void* src, long long e0,
                                                long long e1, long long total, uint32_t bar) {
  const long long a = e0 & ~3LL;
  const long long pieces = min((e1 - a + 3) >> 2, (total - a) >> 2);
  const uint32_t bytes = static_cast<uint32_t>(pieces) * 16u;
  const char* from = static_cast<const char*>(src) + a * 4;
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(from), "r"(bytes), "r"(bar) : "memory");
  for (long long e = a + 4 * pieces; e < e1; ++e) {  // at most 3 words, at the tensor's end
    const uint32_t v = static_cast<const uint32_t*>(src)[e];
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(dst + static_cast<uint32_t>(e - a) * 4u), "r"(v)
                 : "memory");
  }
  return bytes;
}

// The column blend of one head from the row-blended logits of the pixel's
// two stride-8 columns (16-byte aligned, the head padded to 4 floats).
template <int C>
__device__ __forceinline__ void blend_cols(const float* r0, const float* r1, float wx0, float wx1,
                                           float (&u)[C]) {
#pragma unroll
  for (int q = 0; q < (C + 3) / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(r0)[q];
    const float4 b = reinterpret_cast<const float4*>(r1)[q];
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * q + k < C)
        u[4 * q + k] = __fadd_rn(__fmul_rn(wx0, av[k]), __fmul_rn(wx1, bv[k]));
    }
  }
}

template <int C>
__device__ __forceinline__ void zero_grad(float* dp) {
#pragma unroll
  for (int c = 0; c < C; ++c) dp[c] = 0.0f;
}

// exp(u - max) once per class, overwriting u; returns the sum. __expf is
// ex2.approx of a scaled argument: for arguments <= 0 its error is a few
// ulp of a value <= 1, far inside the 1e-4 the gradients are held to. The
// decisions are taken from u before this and are not affected.
template <int C>
__device__ __forceinline__ float exp_sum(float (&u)[C]) {
  float m = u[0];
#pragma unroll
  for (int c = 1; c < C; ++c) m = fmaxf(m, u[c]);
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    u[c] = __expf(u[c] - m);
    s += u[c];
  }
  return s;
}

// Per-pixel image: g * [lab != void] * (softmax - onehot(lab)). A void or
// unweighted pixel costs nothing but the zeros.
template <int C>
__device__ __forceinline__ void grad_sparse(const float* r0, const float* r1, float wx0, float wx1,
                                            int lab, float g, float* dp) {
  const float w = lab != C - 1 ? g : 0.0f;
  if (w == 0.0f) {
    zero_grad<C>(dp);
    return;
  }
  float u[C];
  blend_cols<C>(r0, r1, wx0, wx1, u);
  const float inv = __fdividef(w, exp_sum<C>(u));
#pragma unroll
  for (int c = 0; c < C; ++c) dp[c] = u[c] * inv - (lab == c ? w : 0.0f);
}

// The first-max argmax of one head (strict >, as the forward).
template <int C>
__device__ __forceinline__ int argmax_head(const float* r0, const float* r1, float wx0,
                                           float wx1) {
  float u[C];
  blend_cols<C>(r0, r1, wx0, wx1, u);
  float m = u[0];
  int dec = 0;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    if (u[c] > m) {
      m = u[c];
      dec = c;
    }
  }
  return dec;
}

// Weak image, the head whose metaclass the L1 decision named:
// g * gate * (softmax - projected label). The projection adds the weak
// classes in their order, as ``project`` (wk * 1 + lab and wk * 0 + lab are
// exact), so the gate is the forward's.
template <int C>
__device__ __forceinline__ void grad_dense(const float* r0, const float* r1, float wx0, float wx1,
                                           const float* wk, const float (&mask)[kWeak][C], float g,
                                           float* dp) {
  float lab[C];
#pragma unroll
  for (int c = 0; c < C; ++c) lab[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < kWeak; ++k) {
    const float v = wk[k];
#pragma unroll
    for (int c = 0; c < C; ++c) lab[c] = fmaf(v, mask[k][c], lab[c]);
  }
  float mx = lab[0];
#pragma unroll
  for (int c = 1; c < C - 1; ++c) mx = fmaxf(mx, lab[c]);
  if (!((1.0f - lab[C - 1]) > 0.01f && mx >= 0.01f) || g == 0.0f) {
    zero_grad<C>(dp);
    return;
  }
  float u[C];
  blend_cols<C>(r0, r1, wx0, wx1, u);
  const float inv = __fdividef(g, exp_sum<C>(u));
#pragma unroll
  for (int c = 0; c < C; ++c) dp[c] = u[c] * inv - g * lab[c];
}

// kWide: one stride-8 column alone touches more output pixels than the
// block has threads, so the pixel loop takes several trips (its own instance:
// the loop's second copy of the pixel code costs the common one registers).
template <int C1, int CV, int CH, bool kWide>
__global__ void __launch_bounds__(kBwdMaxThreads, 2)
bwd_walk_kernel(Args a, WalkPlan p, const __grid_constant__ WeakMasks<CV, CH> masks, int cid_v, int cid_h,
                const float* __restrict__ g3, long long pp_words, long long weak_words,
                float* __restrict__ dl1, float* __restrict__ dveh, float* __restrict__ dhum) {
  constexpr int Ct = C1 + CV + CH;
  constexpr int CP = pad4(C1) + pad4(CV) + pad4(CH);  // a staged column, heads padded
  constexpr int C4 = (Ct + 3) / 4;                    // groups of four classes
  constexpr int S = bwd_stride(Ct);                   // gradient tile's pixel stride
  constexpr int kUnits = bwd_units(Ct);
  constexpr int kOffV = pad4(C1), kOffH = pad4(C1) + pad4(CV);
  extern __shared__ __align__(16) float smem[];
  const WalkSmem sm = bwd_smem_words(p, CP, S);
  float* lr = smem + sm.lr;
  float* rb = smem + sm.rb;
  float* d = smem + sm.d;
  float* coef = smem + sm.coef;
  int* cstart = reinterpret_cast<int*>(smem + sm.cstart);
  int* ccnt = reinterpret_cast<int*>(smem + sm.ccnt);
  const float* labels = smem + sm.labels;
  const uint32_t labels_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(labels));

  const int tid = threadIdx.x, T = blockDim.x;
  const int n = blockIdx.z;
  const int j0 = blockIdx.x * p.jc, j1 = min(j0 + p.jc, a.w);
  const int i0 = blockIdx.y * p.ib, i1 = min(i0 + p.ib, a.h);
  const int* row_lo = a.itab;
  const int* row_hi = row_lo + a.H;
  const int* col_lo = row_hi + a.H;
  const int* col_hi = col_lo + a.W;
  const int* row_first = col_hi + a.W;
  const int* row_end = row_first + a.h;
  const int* col_first = row_end + a.h;
  const int* col_end = col_first + a.w;
  const float* row_w0 = a.ftab;
  const float* row_w1 = row_w0 + a.H;
  const float* col_w0 = row_w1 + a.H;
  const float* col_w1 = col_w0 + a.W;

  const int x_begin = col_first[j0], x_end = col_end[j1 - 1];
  const int y_begin = row_first[i0], y_end = row_end[i1 - 1];
  if (x_end <= x_begin || y_end <= y_begin) return;
  const int jlo = col_lo[x_begin], ncols = col_hi[x_end - 1] - jlo + 1;
  const int ilo = row_lo[y_begin], nrows = row_hi[y_end - 1] - ilo + 1;
  const int px = x_end - x_begin;
  if (px > p.px_max || (!kWide && px > T) || ncols > p.cols_max || nrows > p.rows_max ||
      (j1 - j0) * C4 > kUnits * T)
    __trap();  // the plan and the tables disagree

  const bool is_pp = n < a.n_pp;
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(smem + sm.bars));
  if (tid == 0) {
    for (int k = 0; k < kLabelRing; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bars + 8u * k) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // labels of output row y into ring slot ``slot``, by one thread: the copies
  // complete on the slot's barrier, which the row's readers wait for
  auto stage_labels = [&](int y, int slot) {
    const uint32_t dst = labels_u32 + static_cast<uint32_t>(slot * p.label_words) * 4u;
    const uint32_t bar = bars + 8u * slot;
    uint32_t bytes;
    if (is_pp) {
      const long long e0 = (static_cast<long long>(n) * a.H + y) * a.W + x_begin;
      const uint32_t sub = static_cast<uint32_t>(pad4(p.px_max + 3)) * 4u;
      bytes = stage_words(dst, a.pp_l1, e0, e0 + px, pp_words, bar);
      bytes += stage_words(dst + sub, a.pp_veh, e0, e0 + px, pp_words, bar);
      bytes += stage_words(dst + 2 * sub, a.pp_hum, e0, e0 + px, pp_words, bar);
    } else {
      const long long e0 =
          ((static_cast<long long>(n - a.n_pp) * a.H + y) * a.W + x_begin) * kWeak;
      bytes = stage_words(dst, a.weak, e0, e0 + static_cast<long long>(px) * kWeak, weak_words,
                          bar);
    }
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
  };
  // rows y_begin .. y_begin + kLabelRing - 2 fly ahead
  if (tid == 0) {
    for (int k = 0; k < kLabelRing - 1; ++k)
      if (y_begin + k < y_end) stage_labels(y_begin + k, k);
  }

  // the band's logit rows, heads padded to 4 floats: lr[row][column][CP]
  for (int idx = tid; idx < nrows * ncols * Ct; idx += T) {
    const int c = idx % Ct, cell = idx / Ct;
    const int col = cell % ncols, row = cell / ncols;
    const long long g = (static_cast<long long>(n) * a.h + ilo + row) * a.w + jlo + col;
    float v;
    int at;
    if (c < C1) {
      v = __ldg(a.l1 + g * C1 + c), at = c;
    } else if (c < C1 + CV) {
      v = __ldg(a.veh + g * CV + (c - C1)), at = kOffV + c - C1;
    } else {
      v = __ldg(a.hum + g * CH + (c - C1 - CV)), at = kOffH + c - C1 - CV;
    }
    lr[(row * p.cols_max + col) * CP + at] = v;
  }
  // column coefficients: coef[j - j0][k] weighs output column col_first[j] + k
  for (int idx = tid; idx < (j1 - j0) * p.taps_max; idx += T) {
    const int jl = idx / p.taps_max, k = idx % p.taps_max, j = j0 + jl;
    const int x = col_first[j] + k;
    float v = 0.0f;
    if (x < col_end[j])
      v = (col_lo[x] == j ? col_w0[x] : 0.0f) + (col_hi[x] == j ? col_w1[x] : 0.0f);
    coef[idx] = v;
    if (k == 0) {
      cstart[jl] = col_first[j] - x_begin;
      ccnt[jl] = col_end[j] - col_first[j];
    }
  }

  // this thread's output pixel (column x of every row of the walk): its taps
  // stay in registers. Where one stride-8 column alone touches more pixels
  // than the block has threads, further trips look theirs up.
  const int x = x_begin + min(tid, px - 1);
  const float* own_rb0 = rb + (col_lo[x] - jlo) * CP;
  const float* own_rb1 = rb + (col_hi[x] - jlo) * CP;
  const float own_wx0 = col_w0[x], own_wx1 = col_w1[x];
  const float g1 = g3[0], gv = g3[1], gh = g3[2];

  float4 acc_lo[kUnits], acc_hi[kUnits];
#pragma unroll
  for (int m = 0; m < kUnits; ++m) acc_lo[m] = acc_hi[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int units = (j1 - j0) * C4;
  int cur = ilo;  // acc_lo sums stride-8 row cur, acc_hi row cur + 1

  // stores row i of this thread's pairs if the band owns it, then moves on
  auto retire = [&](int i) {
    if (i >= i0 && i < i1) {
#pragma unroll
      for (int m = 0; m < kUnits; ++m) {
        const int q = tid + m * T;
        if (q < units) {
          const long long cell = (static_cast<long long>(n) * a.h + i) * a.w + j0 + q / C4;
          const float v[4] = {acc_lo[m].x, acc_lo[m].y, acc_lo[m].z, acc_lo[m].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int c = q % C4 * 4 + k;
            if (c < C1) {
              dl1[cell * C1 + c] = v[k];
            } else if (c < C1 + CV) {
              dveh[cell * CV + (c - C1)] = v[k];
            } else if (c < Ct) {
              dhum[cell * CH + (c - C1 - CV)] = v[k];
            }
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kUnits; ++m) {
      acc_lo[m] = acc_hi[m];
      acc_hi[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  __syncthreads();  // lr, coef, cstart, ccnt are written
  for (int y = y_begin; y < y_end; ++y) {
    const int slot = (y - y_begin) % kLabelRing;
    const float wy0 = row_w0[y], wy1 = row_w1[y];
    {  // row blend, as ``upsample``: rows first, one rounding per operation
      const float4* lr0 = reinterpret_cast<const float4*>(lr + (row_lo[y] - ilo) * p.cols_max * CP);
      const float4* lr1 = reinterpret_cast<const float4*>(lr + (row_hi[y] - ilo) * p.cols_max * CP);
      for (int idx = tid; idx < ncols * (CP / 4); idx += T) {
        const float4 u0 = lr0[idx], u1 = lr1[idx];
        reinterpret_cast<float4*>(rb)[idx] =
            make_float4(__fadd_rn(__fmul_rn(wy0, u0.x), __fmul_rn(wy1, u1.x)),
                        __fadd_rn(__fmul_rn(wy0, u0.y), __fmul_rn(wy1, u1.y)),
                        __fadd_rn(__fmul_rn(wy0, u0.z), __fmul_rn(wy1, u1.z)),
                        __fadd_rn(__fmul_rn(wy0, u0.w), __fmul_rn(wy1, u1.w)));
      }
    }
    __syncthreads();
    // the buffer that row y - 1 read is free: a later row's labels fly into it
    if (tid == 0 && y + kLabelRing - 1 < y_end)
      stage_labels(y + kLabelRing - 1, (slot + kLabelRing - 1) % kLabelRing);
    // this row's labels have arrived: its buffer's barrier is in its round
    // (y - y_begin) / kLabelRing
    asm volatile(
        "{\n.reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@p bra DONE;\n"
        "bra WAIT;\n"
        "DONE:\n}\n"
        :: "r"(bars + 8u * slot), "r"(((y - y_begin) / kLabelRing) & 1) : "memory");
    const float* lab = labels + slot * p.label_words;
    // the gradients of output pixel x_begin + xl of this row into the tile
    auto pixel = [&](int xl, const float* rb0, const float* rb1, float wx0, float wx1) {
      float g[4 * C4];  // this pixel's gradients, all heads (registers)
#pragma unroll
      for (int c = Ct; c < 4 * C4; ++c) g[c] = 0.0f;
      if (is_pp) {
        const int shift = static_cast<int>(
            ((static_cast<long long>(n) * a.H + y) * a.W + x_begin) & 3);
        const int* li = reinterpret_cast<const int*>(lab) + shift + xl;
        const int sub = pad4(p.px_max + 3);
        grad_sparse<C1>(rb0, rb1, wx0, wx1, li[0], g1, g);
        grad_sparse<CV>(rb0 + kOffV, rb1 + kOffV, wx0, wx1, li[sub], gv, g + C1);
        grad_sparse<CH>(rb0 + kOffH, rb1 + kOffH, wx0, wx1, li[2 * sub], gh, g + C1 + CV);
      } else {
        const int shift = static_cast<int>(
            (((static_cast<long long>(n - a.n_pp) * a.H + y) * a.W + x_begin) * kWeak) & 3);
        const float* wk = lab + shift + xl * kWeak;
        // weak images give no L1 gradient; its head only names the metaclass
        const int d1 = argmax_head<C1>(rb0, rb1, wx0, wx1);
        zero_grad<C1>(g);
        if (d1 == cid_v) {
          grad_dense<CV>(rb0 + kOffV, rb1 + kOffV, wx0, wx1, wk, masks.veh, gv, g + C1);
        } else {
          zero_grad<CV>(g + C1);
        }
        if (d1 == cid_h) {
          grad_dense<CH>(rb0 + kOffH, rb1 + kOffH, wx0, wx1, wk, masks.hum, gh, g + C1 + CV);
        } else {
          zero_grad<CH>(g + C1 + CV);
        }
      }
      float4* dp = reinterpret_cast<float4*>(d + xl * S);
#pragma unroll
      for (int q = 0; q < C4; ++q)
        dp[q] = make_float4(g[4 * q], g[4 * q + 1], g[4 * q + 2], g[4 * q + 3]);
    };
    if (tid < px) pixel(tid, own_rb0, own_rb1, own_wx0, own_wx1);
    if constexpr (kWide) {
      for (int xl = tid + T; xl < px; xl += T) {
        const int xe = x_begin + xl;
        pixel(xl, rb + (col_lo[xe] - jlo) * CP, rb + (col_hi[xe] - jlo) * CP, col_w0[xe],
              col_w1[xe]);
      }
    }
    __syncthreads();

    while (cur < row_lo[y]) retire(cur++);
#pragma unroll
    for (int m = 0; m < kUnits; ++m) {
      const int q = tid + m * T;
      if (q < units) {
        const int jl = q / C4;
        const float4* dq = reinterpret_cast<const float4*>(d + cstart[jl] * S) + q % C4;
        const float* cf = coef + jl * p.taps_max;
        const int cnt = ccnt[jl];
        float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int k = 0; k < cnt; ++k) {
          const float w = cf[k];
          const float4 v = dq[k * (S / 4)];
          r.x = fmaf(w, v.x, r.x), r.y = fmaf(w, v.y, r.y);
          r.z = fmaf(w, v.z, r.z), r.w = fmaf(w, v.w, r.w);
        }
        acc_lo[m].x = fmaf(wy0, r.x, acc_lo[m].x), acc_lo[m].y = fmaf(wy0, r.y, acc_lo[m].y);
        acc_lo[m].z = fmaf(wy0, r.z, acc_lo[m].z), acc_lo[m].w = fmaf(wy0, r.w, acc_lo[m].w);
        acc_hi[m].x = fmaf(wy1, r.x, acc_hi[m].x), acc_hi[m].y = fmaf(wy1, r.y, acc_hi[m].y);
        acc_hi[m].z = fmaf(wy1, r.z, acc_hi[m].z), acc_hi[m].w = fmaf(wy1, r.w, acc_hi[m].w);
      }
    }
  }
  retire(cur);
  retire(cur + 1);
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
int launch_bwd(const Args& a, const int* host_tables, int n, const int* plan, int cid_v, int cid_h,
               const float* g3, float* dl1, float* dveh, float* dhum, cudaStream_t stream) {
  constexpr int Ct = C1 + CV + CH;
  constexpr int CP = pad4(C1) + pad4(CV) + pad4(CH);
  WalkPlan p;
  p.jc = plan[0], p.ib = plan[1], p.threads = plan[2], p.px_max = plan[3];
  p.cols_max = plan[4], p.rows_max = plan[5], p.taps_max = plan[6];
  p.label_words = plan[7], p.smem_bytes = plan[8];
  const int label_need = max(pad4(p.px_max * kWeak + 3), 3 * pad4(p.px_max + 3));
  if (p.jc < 1 || p.ib < 1 || p.threads < 32 || p.threads % 32 || p.threads > kBwdMaxThreads ||
      p.px_max < 1 ||
      p.jc * ((Ct + 3) / 4) > bwd_units(Ct) * p.threads ||
      p.cols_max < 1 || p.rows_max < 1 || p.taps_max < 1 || p.label_words != label_need ||
      bwd_smem_words(p, CP, bwd_stride(Ct)).total * 4 != p.smem_bytes)
    return -4;
  if (p.smem_bytes > kMaxSmem) return -2;
  WeakMasks<CV, CH> masks;
  for (int k = 0; k < kWeak; ++k) {
    for (int c = 0; c < CV; ++c) masks.veh[k][c] = host_tables[k] == c ? 1.0f : 0.0f;
    for (int c = 0; c < CH; ++c) masks.hum[k][c] = host_tables[kWeak + k] == c ? 1.0f : 0.0f;
  }
  auto kernel = p.px_max > p.threads ? bwd_walk_kernel<C1, CV, CH, true>
                                     : bwd_walk_kernel<C1, CV, CH, false>;
  if (p.smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  const long long hw = static_cast<long long>(a.H) * a.W;
  const dim3 grid((a.w + p.jc - 1) / p.jc, (a.h + p.ib - 1) / p.ib, n);
  kernel<<<grid, p.threads, p.smem_bytes, stream>>>(
      a, p, masks, cid_v, cid_h, g3, a.n_pp * hw, (n - a.n_pp) * hw * kWeak, dl1, dveh, dhum);
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

// plan: the nine ints of WalkPlan, from ops/fused_loss.py::_bwd_plan. -4: the
// plan disagrees with the kernel's layout; -2: it is over the shared memory.
extern "C" int iv_fused_loss_bwd(const float* l1, const float* veh, const float* hum,
                                 const int* pp_l1, const int* pp_veh, const int* pp_hum,
                                 const float* weak, const int* itab, const float* ftab,
                                 const int* host_tables, const float* g3, const int* plan,
                                 float* dl1, float* dveh, float* dhum, int n, int n_pp, int h,
                                 int w, int H, int W, int c1, int cv, int ch, int cid_v,
                                 int cid_h, cudaStream_t stream) {
  if (c1 > kMaxClasses || cv > kMaxClasses || ch > kMaxClasses) return -1;
  const Args a = make_args(l1, veh, hum, pp_l1, pp_veh, pp_hum, weak, itab, ftab, n_pp, h, w, H, W);
  IV_DISPATCH(14, 7, 3, launch_bwd)(a, host_tables, n, plan, cid_v, cid_h, g3, dl1, dveh, dhum,
                                    stream);
  IV_DISPATCH(53, 12, 5, launch_bwd)(a, host_tables, n, plan, cid_v, cid_h, g3, dl1, dveh, dhum,
                                     stream);
  return -1;
}
