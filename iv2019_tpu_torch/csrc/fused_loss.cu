// Fused hierarchical loss, forward (B1) and backward (B2), for sm_90a.
//
// Replaces the Pallas TPU kernels of iv2019_tpu/ops/fused_loss.py,
// make_fused_hierarchical_loss: ``fwd_kernel`` (B1, iv2019_tpu/ops/fused_loss.py:196)
// and ``bwd_kernel`` (B2, :250).
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
// to 0.14 ms at 3.35 TB/s. But a pixel costs a few hundred instructions
// (blend, max, exponentials, projection, gates), and 8.4M pixels at the
// card's 132 x 4 warp instructions a clock take about as long as the bytes
// do, with the barriers and the latency of each row's label copy on top.
// So both kernels walk down the output rows of a block, read every label
// once, by bulk copy, and keep everything else on chip:
//   - the upsample is separable with two taps per axis, so each output
//     logit is a 4-tap blend of the stride-8 logits: rows first, once per
//     (output row, stride-8 column, class) in shared memory (``row_blend``),
//     then columns per pixel (``blend_cols``), as the reference's
//     A @ lr @ B; no dense interpolation matrix, no full-resolution logits;
//   - every blend is a separate f32 multiply and add, rounded once each (no
//     FMA): B1's decisions and the ones B2 recomputes for the weak gates are
//     the same bits;
//   - the label rows arrive a row ahead by one thread's bulk copy (the 1-D
//     TMA copy) on an mbarrier, NHWC as they lie in memory (the TPU kernel's
//     channel-major transpose was a VMEM layout choice);
//   - argmax is first-max (strict >), as the reference;
//   - a pixel does only what its outputs need: no L1 softmax on weak images,
//     at most the one L2 head that the L1 decision names there, no CE where
//     a label is void.
// Not tensor cores: the upsample is two taps per axis (six f32 operations per
// class and pixel, no reduction to feed a matrix unit), and TF32 or bf16
// `wgmma` would change the decisions, which must stay bit-equal in f32.
//
// Determinism. The Pallas forward accumulates per-tile partial sums that
// XLA adds afterwards; here each B1 block reduces its threads' sums in a
// fixed order into its own slot and a one-block pass adds the slots in a
// fixed order (in f64). The Pallas backward zeroes its stride-8 output at the
// first row tile and adds into it across the sequential grid; CUDA blocks run
// in no order, and f32 atomics would make the result change from run to run.
// In B2 the loop inside a block takes the place of that sequential grid
// dimension: a block walks down the output rows of its band and sums in the
// order of the rows (see the B2 section). No atomics anywhere: two launches
// give the same bits.
//
// Any H, W with out >= in work: each block masks its ragged edge; the TPU
// kernel's zero-weight row padding does not exist here. Label tensors may
// start anywhere on 4 bytes: the wrapper passes each one's address rounded
// down to 16 bytes and the skew in words (``Args::skew``), and the copies
// start from the rounded address.
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
// cudaGetLastError(), or a negative code for shapes or plans it does not take.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWeak = 15;
constexpr int kMaxClasses = 64;
constexpr int kSumThreads = 256;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kLabelRing = 2;  // label-row buffers; two keep B2 at four blocks an SM

// The fused decision's tables: each head's classes in the common space.
struct Tables {
  int l1_common[kMaxClasses];
  int veh_common[kMaxClasses];
  int hum_common[kMaxClasses];
  int cid_v, cid_h;
};

struct Args {
  const float* l1;  // (N, h, w, C1)
  const float* veh;  // (N, h, w, CV)
  const float* hum;  // (N, h, w, CH)
  // the label tensors' addresses rounded down to 16 bytes: element e of
  // tensor k is word e + skew[k] there (pp_l1, pp_veh, pp_hum, weak)
  const int* pp_l1;  // (n_pp, H, W)
  const int* pp_veh;
  const int* pp_hum;
  const float* weak;  // (n_weak, H, W, 15)
  const int* itab;
  const float* ftab;
  int skew[4];
  long long pp_words, weak_words;  // elements of one per-pixel tensor, of weak
  int n_pp, h, w, H, W;
};

__host__ __device__ constexpr int pad4(int c) { return (c + 3) / 4 * 4; }

// The 0/1 projection of the weak classes onto the two L2 heads, as kernel
// parameters: after unrolling, each entry is a constant-bank operand.
template <int CV, int CH>
struct WeakMasks {
  float veh[kWeak][CV];
  float hum[kWeak][CH];
};

// ---------------------------------------------------------------- staging
//
// Shared by B1 and B2. A block's label buffers are a ring of kLabelRing row
// buffers in shared memory, each with its mbarrier; one thread copies the
// labels of a later output row into the buffer that the block has finished
// with, and the row's readers wait for its barrier's phase.

// Copies words [e0, e1) of ``src`` (``total`` words in all) to shared
// memory as one bulk copy (the 1-D TMA copy) that completes on ``bar``, from
// e0 rounded down to 4 words and up to whole 16-byte pieces: word e lands at
// dst + (e - (e0 & ~3)). ``src`` starts on 16 bytes. Called by one thread.
// Where the last piece would cross the tensor's end, its words come by plain
// loads. Returns the bytes the barrier has to expect.
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

// Index of the first label of image n's output row y, column x0: an element
// of the per-pixel label tensors, or a word of the weak one.
__device__ __forceinline__ long long label_element(const Args& a, int n, int y, int x0) {
  if (n < a.n_pp) return (static_cast<long long>(n) * a.H + y) * a.W + x0;
  return ((static_cast<long long>(n - a.n_pp) * a.H + y) * a.W + x0) * kWeak;
}

// Word, in its segment of the label buffer, of the row's first label of
// tensor k (0-2: the per-pixel heads, 3: weak), from label_element & 3.
__device__ __forceinline__ int label_shift(const Args& a, int k, int first3) {
  return (first3 + a.skew[k]) & 3;
}

// The labels of image n's output row y, columns [x0, x0 + px), into the
// buffer at ``dst`` (per-pixel heads ``sub`` words apart), completing on
// ``bar``. Called by one thread. Label e of the row lies at word
// ``label_shift`` + e (times 15 for weak images) of its segment.
__device__ __forceinline__ void stage_labels(const Args& a, int n, int y, int x0, int px, int sub,
                                             uint32_t dst, uint32_t bar) {
  const long long first = label_element(a, n, y, x0);
  uint32_t bytes = 0;
  if (n < a.n_pp) {
    const int* src[3] = {a.pp_l1, a.pp_veh, a.pp_hum};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const long long e0 = first + a.skew[k];
      bytes += stage_words(dst + static_cast<uint32_t>(k * sub) * 4u, src[k], e0, e0 + px,
                           a.pp_words + a.skew[k], bar);
    }
  } else {
    const long long e0 = first + a.skew[3];
    bytes = stage_words(dst, a.weak, e0, e0 + static_cast<long long>(px) * kWeak,
                        a.weak_words + a.skew[3], bar);
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One thread: the ring's barriers, one arrival each.
__device__ __forceinline__ void init_label_bars(uint32_t bars) {
  for (int k = 0; k < kLabelRing; ++k)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bars + 8u * k) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits until the barrier's phase ``parity`` has completed (the loop in PTX).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// Stages a band's logit rows [ilo, ilo + nrows) x columns [jlo, jlo + ncols)
// of image n into lr[row][column][CP], each head padded to 4 floats, by the
// block's threads. Returns which heads (bits 0-2) had a non-finite value.
template <int C1, int CV, int CH>
__device__ __forceinline__ int stage_logits(const Args& a, int n, int ilo, int nrows, int jlo,
                                            int ncols, int cols_max, float* lr) {
  constexpr int Ct = C1 + CV + CH;
  constexpr int CP = pad4(C1) + pad4(CV) + pad4(CH);
  constexpr int kOffV = pad4(C1), kOffH = pad4(C1) + pad4(CV);
  int bad = 0;
  for (int idx = threadIdx.x; idx < nrows * ncols * Ct; idx += blockDim.x) {
    const int c = idx % Ct, cell = idx / Ct;
    const int col = cell % ncols, row = cell / ncols;
    const long long g = (static_cast<long long>(n) * a.h + ilo + row) * a.w + jlo + col;
    float v;
    int at, head;
    if (c < C1) {
      v = __ldg(a.l1 + g * C1 + c), at = c, head = 0;
    } else if (c < C1 + CV) {
      v = __ldg(a.veh + g * CV + (c - C1)), at = kOffV + c - C1, head = 1;
    } else {
      v = __ldg(a.hum + g * CH + (c - C1 - CV)), at = kOffH + c - C1 - CV, head = 2;
    }
    bad |= isfinite(v) ? 0 : 1 << head;
    lr[(row * cols_max + col) * CP + at] = v;
  }
  return bad;
}

// The row half of the upsample for one output row, by the block's threads:
// rb[j][c] = wy0 * lr0[j][c] + wy1 * lr1[j][c] over n4 groups of four floats,
// one rounding per operation.
__device__ __forceinline__ void row_blend(const float* lr0, const float* lr1, float wy0, float wy1,
                                          float* rb, int n4) {
  const float4* p0 = reinterpret_cast<const float4*>(lr0);
  const float4* p1 = reinterpret_cast<const float4*>(lr1);
  for (int idx = threadIdx.x; idx < n4; idx += blockDim.x) {
    const float4 u0 = p0[idx], u1 = p1[idx];
    reinterpret_cast<float4*>(rb)[idx] =
        make_float4(__fadd_rn(__fmul_rn(wy0, u0.x), __fmul_rn(wy1, u1.x)),
                    __fadd_rn(__fmul_rn(wy0, u0.y), __fmul_rn(wy1, u1.y)),
                    __fadd_rn(__fmul_rn(wy0, u0.z), __fmul_rn(wy1, u1.z)),
                    __fadd_rn(__fmul_rn(wy0, u0.w), __fmul_rn(wy1, u1.w)));
  }
}

// The column half for one pixel and head, from the row-blended logits of the
// pixel's two stride-8 columns (16-byte aligned, the head padded to 4 floats).
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

// The first-max argmax (strict >, as the reference).
template <int C>
__device__ __forceinline__ int argmax_of(const float (&u)[C]) {
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

// The weak multinomial projected onto a head, the weak classes added in
// their order (wk * 1 + lab and wk * 0 + lab are exact), and its gate's label
// part: not void and some class >= 0.01 (the reference's _weak_gate; the
// decision part is the caller's).
template <int C>
__device__ __forceinline__ bool project_weak(const float* wk, const float (&mask)[kWeak][C],
                                             float (&lab)[C]) {
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
  return (1.0f - lab[C - 1]) > 0.01f && mx >= 0.01f;
}

// exp(u - max) once per class, overwriting u; returns the sum. __expf is
// ex2.approx of a scaled argument: for arguments <= 0 its error is a few
// ulp of a value <= 1, far inside the 1e-4 the sums and gradients are held
// to. Decisions are taken from u before this and are not affected.
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

// ---------------------------------------------------------------- B1
//
// One kernel and the fixed-order sum of its slots. A block owns, for one
// image, a chunk of output columns [x0, x1) and a band of output rows
// [y0, y1); the chunks and bands partition the image, so every output pixel
// is evaluated once (no halo: nothing is summed across blocks but the six
// sums). The block stages the stride-8 logit rows and columns its pixels'
// taps reach, once, and walks its rows, y ascending. Per row:
//   blend    the row blend into one of two rb buffers (so one barrier a row
//            suffices: a thread can be one row ahead of the slowest);
//   labels   the row's labels have arrived in its ring buffer; one thread
//            starts the copy of the next row's into the buffer the block
//            finished with a row ago;
//   pixel    one thread per output column: the L1 column blend and argmax;
//            on per-pixel images each head's CE where its label is not void,
//            and the L2 argmax where the L1 decision names the head; on weak
//            images only the L2 head that the L1 decision names: its blend,
//            argmax, projected label, gate and, where the gate opens, its
//            dense CE; the two decisions, stored as int32 rows.
// Each thread sums over its walk; the block reduces the sums in a fixed
// order (warp shuffles, then warps in order) into its own slot.
//
// Skipped terms have weight 0 and would add +-0 on finite logits. Where a
// staged logit is not finite the reference's sums are not (its dense
// upsample multiplies every logit of a column, weight 0 or not): the block
// then writes NaN for that head's sum (the L1 sum of a weak image excepted,
// which the reference does not take), so a diverged step stays visible.
//
// The launch plan (chunk and band sizes, threads, the shared-memory regions)
// comes from ops/fused_loss.py::_fwd_plan; fwd_smem_words repeats its layout
// and launch_fwd refuses a plan that disagrees.

constexpr int kFwdMaxThreads = 128;
constexpr int kFwdMinBlocks = 5;  // 102 registers a thread
constexpr int kFwdMaxWarps = kFwdMaxThreads / 32;

struct FwdPlan {
  int xc, yb;       // output columns per chunk, output rows per band
  int threads;      // >= xc
  int cols_max;     // most stride-8 columns a chunk stages
  int rows_max;     // most stride-8 rows a band stages
  int label_words;  // words of one label-row buffer
  int smem_bytes;
};

// Word offsets of the shared-memory regions, each a multiple of 4 words.
struct FwdSmem {
  int lr, rb, red, bars, labels, total;
};

__host__ __device__ inline FwdSmem fwd_smem_words(const FwdPlan& p, int cp) {
  FwdSmem m;
  int at = 0;
  m.lr = at, at += pad4(p.rows_max * p.cols_max * cp);
  m.rb = at, at += pad4(2 * p.cols_max * cp);
  m.red = at, at += pad4(6 * kFwdMaxWarps);
  m.bars = at, at += pad4(2 * kLabelRing);  // one 8-byte mbarrier per label buffer
  m.labels = at, at += kLabelRing * p.label_words;
  m.total = at;
  return m;
}

// Per-pixel CE of one head: logsumexp - u[lab], u overwritten.
template <int C>
__device__ __forceinline__ float sparse_ce(float (&u)[C], int lab) {
  float v = u[0];
#pragma unroll
  for (int c = 1; c < C; ++c) v = (lab == c) ? u[c] : v;
  float m = u[0];
#pragma unroll
  for (int c = 1; c < C; ++c) m = fmaxf(m, u[c]);
  const float s = exp_sum<C>(u);
  return (m - v) + __logf(s);
}

// Weak image, the L2 head that the L1 decision named: its argmax, and where
// the gate opens its dense CE added into (sum, cnt).
template <int C>
__device__ __forceinline__ int weak_head(const float* r0, const float* r1, float wx0, float wx1,
                                         const float* wk, const float (&mask)[kWeak][C],
                                         float& sum, float& cnt) {
  float u[C];
  blend_cols<C>(r0, r1, wx0, wx1, u);
  const int dec = argmax_of<C>(u);
  float lab[C];
  if (project_weak<C>(wk, mask, lab)) {
    float m = u[0];
#pragma unroll
    for (int c = 1; c < C; ++c) m = fmaxf(m, u[c]);
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) s += __expf(u[c] - m);
    const float lse = m + __logf(s);
    float ce = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) ce += lab[c] * (lse - u[c]);
    sum += ce;
    cnt += 1.0f;
  }
  return dec;
}

template <int C1, int CV, int CH>
__global__ void __launch_bounds__(kFwdMaxThreads, kFwdMinBlocks)
fwd_walk_kernel(Args a, FwdPlan p, Tables tb, const __grid_constant__ WeakMasks<CV, CH> masks,
                float* __restrict__ partials, int* __restrict__ dec_out,
                int* __restrict__ l1dec_out) {
  constexpr int CP = pad4(C1) + pad4(CV) + pad4(CH);
  constexpr int kOffV = pad4(C1), kOffH = pad4(C1) + pad4(CV);
  extern __shared__ __align__(16) float smem[];
  const FwdSmem sm = fwd_smem_words(p, CP);
  float* lr = smem + sm.lr;
  float* red = smem + sm.red;
  const float* labels = smem + sm.labels;
  const uint32_t labels_u32 = static_cast<uint32_t>(__cvta_generic_to_shared(labels));
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(smem + sm.bars));

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * p.xc, x1 = min(x0 + p.xc, a.W);
  const int y0 = blockIdx.y * p.yb, y1 = min(y0 + p.yb, a.H);
  const int* row_lo = a.itab;
  const int* row_hi = row_lo + a.H;
  const int* col_lo = row_hi + a.H;
  const int* col_hi = col_lo + a.W;
  const float* row_w0 = a.ftab;
  const float* row_w1 = row_w0 + a.H;
  const float* col_w0 = row_w1 + a.H;
  const float* col_w1 = col_w0 + a.W;
  const int jlo = col_lo[x0], ncols = col_hi[x1 - 1] - jlo + 1;
  const int ilo = row_lo[y0], nrows = row_hi[y1 - 1] - ilo + 1;
  const int px = x1 - x0;
  if (px > static_cast<int>(blockDim.x) || ncols > p.cols_max || nrows > p.rows_max)
    __trap();  // the plan and the tables disagree

  const bool is_pp = n < a.n_pp;
  const int sub = pad4(p.xc + 3);  // words between the per-pixel heads' label segments
  if (tid == 0) {
    init_label_bars(bars);
    // rows y0 .. y0 + kLabelRing - 2 fly ahead
    for (int k = 0; k < kLabelRing - 1; ++k)
      if (y0 + k < y1)
        stage_labels(a, n, y0 + k, x0, px, sub,
                     labels_u32 + static_cast<uint32_t>(k * p.label_words) * 4u, bars + 8u * k);
  }
  const int bad = stage_logits<C1, CV, CH>(a, n, ilo, nrows, jlo, ncols, p.cols_max, lr);
  // the barriers after the logits are written, with the non-finite flags
  const bool bad1 = __syncthreads_or(bad & 1) && is_pp;
  const bool badv = __syncthreads_or(bad & 2);
  const bool badh = __syncthreads_or(bad & 4);

  // this thread's output column: its taps stay in registers
  const int x = x0 + min(tid, px - 1);
  const int c0 = (col_lo[x] - jlo) * CP, c1 = (col_hi[x] - jlo) * CP;
  const float wx0 = col_w0[x], wx1 = col_w1[x];
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const long long hw = static_cast<long long>(a.H) * a.W;

  for (int y = y0; y < y1; ++y) {
    const int r = y - y0, slot = r % kLabelRing;
    float* rb = smem + sm.rb + (r & 1) * p.cols_max * CP;
    row_blend(lr + (row_lo[y] - ilo) * p.cols_max * CP, lr + (row_hi[y] - ilo) * p.cols_max * CP,
              row_w0[y], row_w1[y], rb, ncols * (CP / 4));
    __syncthreads();
    // the buffer that row y - 1 read is free: a later row's labels fly into it
    if (tid == 0 && y + kLabelRing - 1 < y1) {
      const int next = (slot + kLabelRing - 1) % kLabelRing;
      stage_labels(a, n, y + kLabelRing - 1, x0, px, sub,
                   labels_u32 + static_cast<uint32_t>(next * p.label_words) * 4u,
                   bars + 8u * next);
    }
    if (tid >= px) continue;
    // this row's labels have arrived: its buffer's barrier is in its round
    // r / kLabelRing
    mbar_wait(bars + 8u * slot, (r / kLabelRing) & 1);
    const float* lab = labels + slot * p.label_words;
    const float* r0 = rb + c0;
    const float* r1 = rb + c1;
    float u1[C1];
    blend_cols<C1>(r0, r1, wx0, wx1, u1);
    const int d1 = argmax_of<C1>(u1);
    int dv = 0, dh = 0;
    const int first3 = static_cast<int>(label_element(a, n, y, x0) & 3);
    if (is_pp) {
      const int* li = reinterpret_cast<const int*>(lab) + tid;
      const int l1lab = li[label_shift(a, 0, first3)];
      const int vlab = li[sub + label_shift(a, 1, first3)];
      const int hlab = li[2 * sub + label_shift(a, 2, first3)];
      if (l1lab != C1 - 1) {
        acc[0] += sparse_ce<C1>(u1, l1lab);
        acc[1] += 1.0f;
      }
      if (vlab != CV - 1 || d1 == tb.cid_v) {
        float uv[CV];
        blend_cols<CV>(r0 + kOffV, r1 + kOffV, wx0, wx1, uv);
        if (d1 == tb.cid_v) dv = argmax_of<CV>(uv);
        if (vlab != CV - 1) {
          acc[2] += sparse_ce<CV>(uv, vlab);
          acc[3] += 1.0f;
        }
      }
      if (hlab != CH - 1 || d1 == tb.cid_h) {
        float uh[CH];
        blend_cols<CH>(r0 + kOffH, r1 + kOffH, wx0, wx1, uh);
        if (d1 == tb.cid_h) dh = argmax_of<CH>(uh);
        if (hlab != CH - 1) {
          acc[4] += sparse_ce<CH>(uh, hlab);
          acc[5] += 1.0f;
        }
      }
    } else {
      // weak images: no L1 CE; the head the L1 decision does not name has
      // its gate closed (l1 decision == metaclass) and decides nothing
      const float* wk = lab + label_shift(a, 3, first3) + tid * kWeak;
      if (d1 == tb.cid_v) {
        dv = weak_head<CV>(r0 + kOffV, r1 + kOffV, wx0, wx1, wk, masks.veh, acc[2], acc[3]);
      } else if (d1 == tb.cid_h) {
        dh = weak_head<CH>(r0 + kOffH, r1 + kOffH, wx0, wx1, wk, masks.hum, acc[4], acc[5]);
      }
    }
    const int fused = d1 == tb.cid_v   ? tb.veh_common[dv]
                      : d1 == tb.cid_h ? tb.hum_common[dh]
                                       : tb.l1_common[d1];
    const long long q = n * hw + static_cast<long long>(y) * a.W + x;
    dec_out[q] = fused;
    l1dec_out[q] = d1;
  }

  // the block's sums in a fixed order: lanes by a shuffle tree, then warps
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[i * kFwdMaxWarps + warp] = v;
  }
  __syncthreads();
  if (tid < 6) {
    float s = 0.0f;
    for (int k = 0; k < static_cast<int>(blockDim.x) / 32; ++k) s += red[tid * kFwdMaxWarps + k];
    if ((tid == 0 && bad1) || (tid == 2 && badv) || (tid == 4 && badh)) s = __int_as_float(0x7fc00000);
    const long long slot = (static_cast<long long>(n) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partials[slot * 6 + tid] = s;
  }
}

// One block: the (count, 6) partial sums, slot by slot in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
sum_partials(const float* partials, int count, float* sums) {
  __shared__ double sh[kSumThreads];
  for (int i = 0; i < 6; ++i) {
    double acc = 0.0;
    for (int b = threadIdx.x; b < count; b += kSumThreads) acc += partials[b * 6 + i];
    sh[threadIdx.x] = acc;
    __syncthreads();
    for (int off = kSumThreads / 2; off > 0; off >>= 1) {
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
//            logit rows staged at the start (``row_blend``, B1's, so the
//            decisions are the forward's);
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
// The staging (label rows, logit rows, the row blend) is B1's.
//
// The launch plan (chunk and band sizes, threads, the shared-memory
// regions) comes from ops/fused_loss.py::_bwd_plan; bwd_smem_words repeats
// its layout and launch_bwd refuses a plan that disagrees.

constexpr int kBwdMaxThreads = 320;  // two blocks of them per SM leave 102 registers a thread
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

template <int C>
__device__ __forceinline__ void zero_grad(float* dp) {
#pragma unroll
  for (int c = 0; c < C; ++c) dp[c] = 0.0f;
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

// The first-max argmax of one head, blended as the forward blends it.
template <int C>
__device__ __forceinline__ int argmax_head(const float* r0, const float* r1, float wx0,
                                           float wx1) {
  float u[C];
  blend_cols<C>(r0, r1, wx0, wx1, u);
  return argmax_of<C>(u);
}

// Weak image, the head whose metaclass the L1 decision named:
// g * gate * (softmax - projected label), the projection and gate the
// forward's (``project_weak``).
template <int C>
__device__ __forceinline__ void grad_dense(const float* r0, const float* r1, float wx0, float wx1,
                                           const float* wk, const float (&mask)[kWeak][C], float g,
                                           float* dp) {
  float lab[C];
  if (!project_weak<C>(wk, mask, lab) || g == 0.0f) {
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
                const float* __restrict__ g3,
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
  const int sub = pad4(p.px_max + 3);  // words between the per-pixel heads' label segments
  // labels of output row y into ring slot ``slot``, by one thread: the copies
  // complete on the slot's barrier, which the row's readers wait for
  auto stage_row = [&](int y, int slot) {
    stage_labels(a, n, y, x_begin, px, sub,
                 labels_u32 + static_cast<uint32_t>(slot * p.label_words) * 4u, bars + 8u * slot);
  };
  if (tid == 0) {
    init_label_bars(bars);
    // rows y_begin .. y_begin + kLabelRing - 2 fly ahead
    for (int k = 0; k < kLabelRing - 1; ++k)
      if (y_begin + k < y_end) stage_row(y_begin + k, k);
  }

  // the band's logit rows, heads padded to 4 floats: lr[row][column][CP]
  stage_logits<C1, CV, CH>(a, n, ilo, nrows, jlo, ncols, p.cols_max, lr);
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
    row_blend(lr + (row_lo[y] - ilo) * p.cols_max * CP, lr + (row_hi[y] - ilo) * p.cols_max * CP,
              wy0, wy1, rb, ncols * (CP / 4));
    __syncthreads();
    // the buffer that row y - 1 read is free: a later row's labels fly into it
    if (tid == 0 && y + kLabelRing - 1 < y_end)
      stage_row(y + kLabelRing - 1, (slot + kLabelRing - 1) % kLabelRing);
    // this row's labels have arrived: its buffer's barrier is in its round
    // (y - y_begin) / kLabelRing
    mbar_wait(bars + 8u * slot, ((y - y_begin) / kLabelRing) & 1);
    const float* lab = labels + slot * p.label_words;
    const int first3 = static_cast<int>(label_element(a, n, y, x_begin) & 3);
    // the gradients of output pixel x_begin + xl of this row into the tile
    auto pixel = [&](int xl, const float* rb0, const float* rb1, float wx0, float wx1) {
      float g[4 * C4];  // this pixel's gradients, all heads (registers)
#pragma unroll
      for (int c = Ct; c < 4 * C4; ++c) g[c] = 0.0f;
      if (is_pp) {
        const int* li = reinterpret_cast<const int*>(lab) + xl;
        grad_sparse<C1>(rb0, rb1, wx0, wx1, li[label_shift(a, 0, first3)], g1, g);
        grad_sparse<CV>(rb0 + kOffV, rb1 + kOffV, wx0, wx1,
                        li[sub + label_shift(a, 1, first3)], gv, g + C1);
        grad_sparse<CH>(rb0 + kOffH, rb1 + kOffH, wx0, wx1,
                        li[2 * sub + label_shift(a, 2, first3)], gh, g + C1 + CV);
      } else {
        const float* wk = lab + label_shift(a, 3, first3) + xl * kWeak;
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
  const int* p = host_tables + 2 * kWeak;  // after the weak-class projections
  for (int k = 0; k < c1; ++k) t.l1_common[k] = *p++;
  for (int k = 0; k < cv; ++k) t.veh_common[k] = *p++;
  for (int k = 0; k < ch; ++k) t.hum_common[k] = *p++;
  t.cid_v = cid_v;
  t.cid_h = cid_h;
  return t;
}

template <int CV, int CH>
WeakMasks<CV, CH> make_masks(const int* host_tables) {
  WeakMasks<CV, CH> masks;
  for (int k = 0; k < kWeak; ++k) {
    for (int c = 0; c < CV; ++c) masks.veh[k][c] = host_tables[k] == c ? 1.0f : 0.0f;
    for (int c = 0; c < CH; ++c) masks.hum[k][c] = host_tables[kWeak + k] == c ? 1.0f : 0.0f;
  }
  return masks;
}

// Words of one label-row buffer for rows of ``px`` pixels: a weak row, or the
// three per-pixel heads' segments, each with up to 3 words of skew.
__host__ __device__ inline int label_buffer_words(int px) {
  return max(pad4(px * kWeak + 3), 3 * pad4(px + 3));
}

template <int C1, int CV, int CH>
int launch_fwd(const Args& a, const int* host_tables, int n, const int* plan, int cid_v,
               int cid_h, float* partials, long long partials_cap, float* sums, int* dec,
               int* l1dec, cudaStream_t stream) {
  constexpr int CP = pad4(C1) + pad4(CV) + pad4(CH);
  FwdPlan p;
  p.xc = plan[0], p.yb = plan[1], p.threads = plan[2], p.cols_max = plan[3];
  p.rows_max = plan[4], p.label_words = plan[5], p.smem_bytes = plan[6];
  if (p.xc < 1 || p.yb < 1 || p.threads < 32 || p.threads % 32 || p.threads > kFwdMaxThreads ||
      p.xc > p.threads || p.cols_max < 1 || p.rows_max < 1 ||
      p.label_words != label_buffer_words(p.xc) ||
      fwd_smem_words(p, CP).total * 4 != p.smem_bytes)
    return -4;
  if (p.smem_bytes > kMaxSmem) return -2;
  const dim3 grid((a.W + p.xc - 1) / p.xc, (a.H + p.yb - 1) / p.yb, n);
  const long long slots = static_cast<long long>(grid.x) * grid.y * n;
  if (slots * 6 > partials_cap) return -3;
  auto kernel = fwd_walk_kernel<C1, CV, CH>;
  if (p.smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  kernel<<<grid, p.threads, p.smem_bytes, stream>>>(a, p, make_tables(host_tables, C1, CV, CH,
                                                                      cid_v, cid_h),
                                                    make_masks<CV, CH>(host_tables), partials,
                                                    dec, l1dec);
  sum_partials<<<1, kSumThreads, 0, stream>>>(partials, static_cast<int>(slots), sums);
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
  if (p.jc < 1 || p.ib < 1 || p.threads < 32 || p.threads % 32 || p.threads > kBwdMaxThreads ||
      p.px_max < 1 ||
      p.jc * ((Ct + 3) / 4) > bwd_units(Ct) * p.threads ||
      p.cols_max < 1 || p.rows_max < 1 || p.taps_max < 1 ||
      p.label_words != label_buffer_words(p.px_max) ||
      bwd_smem_words(p, CP, bwd_stride(Ct)).total * 4 != p.smem_bytes)
    return -4;
  if (p.smem_bytes > kMaxSmem) return -2;
  auto kernel = p.px_max > p.threads ? bwd_walk_kernel<C1, CV, CH, true>
                                     : bwd_walk_kernel<C1, CV, CH, false>;
  if (p.smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  const dim3 grid((a.w + p.jc - 1) / p.jc, (a.h + p.ib - 1) / p.ib, n);
  kernel<<<grid, p.threads, p.smem_bytes, stream>>>(a, p, make_masks<CV, CH>(host_tables), cid_v,
                                                    cid_h, g3, dl1, dveh, dhum);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* l1, const float* veh, const float* hum, const int* pp_l1,
               const int* pp_veh, const int* pp_hum, const float* weak, const int* itab,
               const float* ftab, const int* skews, int n, int n_pp, int h, int w, int H, int W) {
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
  for (int k = 0; k < 4; ++k) a.skew[k] = skews[k];
  a.pp_words = static_cast<long long>(n_pp) * H * W;
  a.weak_words = static_cast<long long>(n - n_pp) * H * W * kWeak;
  a.n_pp = n_pp;
  a.h = h;
  a.w = w;
  a.H = H;
  a.W = W;
  return a;
}

bool skews_ok(const int* skews) {
  for (int k = 0; k < 4; ++k)
    if (skews[k] < 0 || skews[k] > 3) return false;
  return true;
}

}  // namespace

// The head widths the kernels are compiled for: Cityscapes (14, 7, 3) and
// Vistas (53, 12, 5). Others return -1.
#define IV_DISPATCH(C1, CV, CH, CALL)                      \
  if (c1 == C1 && cv == CV && ch == CH) return CALL<C1, CV, CH>

// The label tensors' pointers (pp_l1, pp_veh, pp_hum, weak) are their
// addresses rounded down to 16 bytes and ``skews`` (4 ints, 0-3) the words
// between that and each tensor's start. plan: the seven ints of FwdPlan, from
// ops/fused_loss.py::_fwd_plan. -4: the plan disagrees with the kernel's
// layout (or a skew is out of range); -2: it is over the shared memory; -3:
// the partial-sum buffer holds fewer than 6 floats per block.
extern "C" int iv_fused_loss_fwd(const float* l1, const float* veh, const float* hum,
                                 const int* pp_l1, const int* pp_veh, const int* pp_hum,
                                 const float* weak, const int* itab, const float* ftab,
                                 const int* host_tables, const int* skews, const int* plan,
                                 float* partials, long long partials_cap, float* sums, int* dec,
                                 int* l1dec, int n, int n_pp, int h, int w, int H, int W, int c1,
                                 int cv, int ch, int cid_v, int cid_h, cudaStream_t stream) {
  if (c1 > kMaxClasses || cv > kMaxClasses || ch > kMaxClasses) return -1;
  if (!skews_ok(skews)) return -4;
  const Args a = make_args(l1, veh, hum, pp_l1, pp_veh, pp_hum, weak, itab, ftab, skews, n, n_pp,
                           h, w, H, W);
  IV_DISPATCH(14, 7, 3, launch_fwd)(a, host_tables, n, plan, cid_v, cid_h, partials, partials_cap,
                                    sums, dec, l1dec, stream);
  IV_DISPATCH(53, 12, 5, launch_fwd)(a, host_tables, n, plan, cid_v, cid_h, partials,
                                     partials_cap, sums, dec, l1dec, stream);
  return -1;
}

// Label pointers and skews as for iv_fused_loss_fwd. plan: the nine ints of
// WalkPlan, from ops/fused_loss.py::_bwd_plan. -4: the plan disagrees with the
// kernel's layout (or a skew is out of range); -2: it is over the shared
// memory.
extern "C" int iv_fused_loss_bwd(const float* l1, const float* veh, const float* hum,
                                 const int* pp_l1, const int* pp_veh, const int* pp_hum,
                                 const float* weak, const int* itab, const float* ftab,
                                 const int* host_tables, const int* skews, const float* g3,
                                 const int* plan, float* dl1, float* dveh, float* dhum, int n,
                                 int n_pp, int h, int w, int H, int W, int c1, int cv, int ch,
                                 int cid_v, int cid_h, cudaStream_t stream) {
  if (c1 > kMaxClasses || cv > kMaxClasses || ch > kMaxClasses) return -1;
  if (!skews_ok(skews)) return -4;
  const Args a = make_args(l1, veh, hum, pp_l1, pp_veh, pp_hum, weak, itab, ftab, skews, n, n_pp,
                           h, w, H, W);
  IV_DISPATCH(14, 7, 3, launch_bwd)(a, host_tables, n, plan, cid_v, cid_h, g3, dl1, dveh, dhum,
                                    stream);
  IV_DISPATCH(53, 12, 5, launch_bwd)(a, host_tables, n, plan, cid_v, cid_h, g3, dl1, dveh, dhum,
                                     stream);
  return -1;
}
