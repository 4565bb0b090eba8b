// Weight gradient of the stride-2 root convolution (conv2d_same), for sm_90a.
//
// Replaces the Pallas TPU kernel ``_wgrad_kernel_impl`` of
// iv2019_tpu/ops/pallas_wgrad.py (called through ``root_conv_wgrad``):
//
//     dW[o, c, kh, kw] = sum_{n, oh, ow} x[n, 2 oh + kh - p, 2 ow + kw - p, c] * dy[n, oh, ow, o]
//
// with p = (K - 1) / 2, zero padding, bf16 operands and f32 accumulation. x
// and dy are NHWC bf16; dW is written OIHW f32 (the port's weight layout).
//
// What bounds it on the H100: bytes. At the flagship train step x is 50 MB
// and dy 268 MB, for 39.5 GFLOP (147 taps x 64 outputs x 2.1M pixels): 124
// operations per byte, below the bf16 tensor cores' ~295, so the least time
// is the 318.8 MB over 3.35 TB/s (0.095 ms). The design streams dy once,
// 16 bytes a thread, and keeps every other operand on chip:
//
// - It is one GEMM, dW^T (taps x Cout) = A (taps x pixels) . dy (pixels x
//   Cout), with A the im2row of x. The pixels (the GEMM's depth) go in chunks
//   of 64 consecutive output pixels of one output row. For a chunk a block
//   stages the K input rows it touches (2*64 + K - 1 columns, all channels,
//   zero outside the image) and the chunk's dy rows in shared memory, forms
//   the im2row tile from the staged rows there, and runs WMMA bf16 16x16x16
//   products with f32 accumulators: warp w owns taps 16w..16w+15 against all
//   Cout columns (taps padded 147 -> 160 with zero rows, so 10 warps).
// - The next chunk's x and dy are loaded into registers while the block
//   forms the current chunk's im2row tile and multiplies it.
// - The TPU kernel pairs W pixels into i32 lanes and writes 8-row junk
//   blocks to satisfy Mosaic's layout rules; none of that is needed here.
//
// The Pallas kernel adds every tile's product into one output block that
// stays resident across its sequential grid. CUDA blocks run in parallel and
// in no order, so each block owns a contiguous range of chunks and writes its
// own (taps_pad x cout_pad) f32 partial; a second kernel adds the partials in
// block order. No atomics: the result is the same from run to run.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// iv2019_tpu_torch/ops/root_wgrad.py. Returns cudaGetLastError(), or a
// negative code for a shape the kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kThreads = 320;
constexpr int kWarps = kThreads / 32;
constexpr int kKP = 64;                  // output pixels per chunk (GEMM depth)
constexpr int kMaxTaps = 16 * kWarps;    // 160: K*K*C padded to whole 16-row tiles
constexpr int kMaxCout = 64;
constexpr int kLd = 72;                  // row stride of As and Bs in bf16 (16 B skew)
constexpr int kXPer = 9;                 // staged x values per thread and chunk
constexpr int kMaxXs = kXPer * kThreads; // K * C * (2*kKP + K - 1) must fit
constexpr int kDyVecPer = (kKP * kMaxCout / 8 + kThreads - 1) / kThreads;  // 2 x 16 B
constexpr int kDyPer = (kKP * kMaxCout + kThreads - 1) / kThreads;         // 13 x 2 B

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Shape {
  int h, w, c, oh, ow, cout, k;
  int taps, taps_pad, cout_pad;
  int chunks_per_row, chunks_per_block, total_chunks;
};

// One chunk's operands in flight between global memory and shared memory.
template <bool kVec>
struct Regs {
  unsigned short x[kXPer];
  uint4 dyv[kVec ? kDyVecPer : 1];
  unsigned short dys[kVec ? 1 : kDyPer];
};

__device__ __forceinline__ void chunk_origin(const Shape& s, int chunk, int& n, int& r, int& ow0) {
  const int row = chunk / s.chunks_per_row;
  ow0 = (chunk % s.chunks_per_row) * kKP;
  n = row / s.oh;
  r = row % s.oh;
}

template <bool kVec, bool kRoot>
__device__ __forceinline__ void fetch(const Shape& s, const unsigned short* __restrict__ x,
                                      const unsigned short* __restrict__ dy, int chunk,
                                      Regs<kVec>& g) {
  const int K = kRoot ? 7 : s.k, C = kRoot ? 3 : s.c;
  int n, r, ow0;
  chunk_origin(s, chunk, n, r, ow0);
  // x: K input rows 2r - pad + kh; columns 2*ow0 - pad + j, j < xs_w; (j, c)
  // is contiguous in NHWC, so consecutive threads read consecutive values
  const int row_elems = (2 * kKP + K - 1) * C;
  const int col0 = 2 * ow0 - (K - 1) / 2;
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    unsigned short v = 0;
    if (e < K * row_elems) {
      const int kh = e / row_elems, rem = e % row_elems;
      const int ih = 2 * r - (K - 1) / 2 + kh, iw = col0 + rem / C;
      if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w)
        v = x[((static_cast<long long>(n) * s.h + ih) * s.w + iw) * C + rem % C];
    }
    g.x[i] = v;
  }
  // dy: the chunk's pixels are contiguous in NHWC
  const int cout = kRoot ? kMaxCout : s.cout;
  const int valid = min(kKP, s.ow - ow0) * cout;
  const unsigned short* src = dy + ((static_cast<size_t>(n) * s.oh + r) * s.ow + ow0) * cout;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kDyVecPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      g.dyv[i] = (e * 8 < valid) ? reinterpret_cast<const uint4*>(src)[e] : make_uint4(0, 0, 0, 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kDyPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      g.dys[i] = e < valid ? src[e] : 0;
    }
  }
}

template <bool kVec, bool kRoot>
__device__ __forceinline__ void stage(const Shape& s, const Regs<kVec>& g, unsigned short* xs,
                                      unsigned short* bs) {
  const int K = kRoot ? 7 : s.k, C = kRoot ? 3 : s.c;
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < K * (2 * kKP + K - 1) * C) xs[e] = g.x[i];
  }
  // Bs rows are pixels, columns outputs; pixels past the row end are zero
  if (kVec) {
    const int per_row = (kRoot ? kMaxCout : s.cout) / 8;
#pragma unroll
    for (int i = 0; i < kDyVecPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kKP * per_row) {
        const int p = e / per_row, q = e % per_row;
        *reinterpret_cast<uint4*>(bs + p * kLd + q * 8) = g.dyv[i];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kDyPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kKP * s.cout) bs[(e / s.cout) * kLd + e % s.cout] = g.dys[i];
    }
  }
}

// kRoot: the root conv's K = 7, C = 3 and Cout = 64 at compile time, which
// turns the index arithmetic into multiplies and shifts; else read from ``s``.
template <bool kVec, bool kRoot>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ dy,
                     float* __restrict__ partial, Shape s) {
  __shared__ __align__(128) unsigned short As[kMaxTaps * kLd];
  __shared__ __align__(128) unsigned short Bs[kKP * kLd];
  __shared__ __align__(16) unsigned short Xs[kMaxXs];
  const int warp = threadIdx.x / 32;

  // rows of As past the last tap and columns of Bs past the last output
  // stay zero; the chunks never write them
  for (int i = threadIdx.x; i < kMaxTaps * kLd; i += kThreads) As[i] = 0;
  for (int i = threadIdx.x; i < kKP * kLd; i += kThreads) Bs[i] = 0;

  FragC acc[kMaxCout / 16];
#pragma unroll
  for (int j = 0; j < kMaxCout / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  const int first = blockIdx.x * s.chunks_per_block;
  const int last = min(first + s.chunks_per_block, s.total_chunks);
  const int K = kRoot ? 7 : s.k, C = kRoot ? 3 : s.c;
  const int row_elems = (2 * kKP + K - 1) * C;
  Regs<kVec> g;
  if (first < last) fetch<kVec, kRoot>(s, x, dy, first, g);
  for (int chunk = first; chunk < last; ++chunk) {
    __syncthreads();  // the previous chunk's products have read As and Bs
    stage<kVec, kRoot>(s, g, Xs, Bs);
    // the registers are free again: the next chunk's loads fly during the
    // im2row build and the products
    if (chunk + 1 < last) fetch<kVec, kRoot>(s, x, dy, chunk + 1, g);
    __syncthreads();
    // im2row: item (kh, c, p) writes taps (kh, 0..K-1, c) of pixel p,
    // tap index t = (kh*K + kw)*C + c (HWIO order)
    for (int i = threadIdx.x; i < K * C * kKP; i += kThreads) {
      const int p = i % kKP, kc = i / kKP;
      const int kh = kc / C, c = kc % C;
      const unsigned short* src = Xs + kh * row_elems + 2 * p * C + c;
      unsigned short* dst = As + (kh * K * C + c) * kLd + p;
#pragma unroll 7
      for (int kw = 0; kw < K; ++kw) dst[kw * C * kLd] = src[kw * C];
    }
    __syncthreads();
    if (warp * 16 < s.taps_pad) {
#pragma unroll
      for (int ks = 0; ks < kKP; ks += 16) {
        FragA a;
        wmma::load_matrix_sync(a, reinterpret_cast<const __nv_bfloat16*>(As) + warp * 16 * kLd + ks,
                               kLd);
#pragma unroll
        for (int j = 0; j < kMaxCout / 16; ++j) {
          if (j * 16 < s.cout_pad) {
            FragB b;
            wmma::load_matrix_sync(b, reinterpret_cast<const __nv_bfloat16*>(Bs) + ks * kLd + j * 16,
                                   kLd);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
      }
    }
  }
  if (warp * 16 < s.taps_pad) {
    float* out = partial + (static_cast<size_t>(blockIdx.x) * s.taps_pad + warp * 16) * s.cout_pad;
#pragma unroll
    for (int j = 0; j < kMaxCout / 16; ++j)
      if (j * 16 < s.cout_pad)
        wmma::store_matrix_sync(out + j * 16, acc[j], s.cout_pad, wmma::mem_row_major);
  }
}

// dW[o, c, kh, kw] = sum over blocks, in block order, of partial[b, t, o]
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                    int blocks, Shape s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s.taps * s.cout) return;
  const int t = i / s.cout, o = i % s.cout;
  const size_t stride = static_cast<size_t>(s.taps_pad) * s.cout_pad;
  const float* p = partial + static_cast<size_t>(t) * s.cout_pad + o;
  float sum = 0.0f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) sum += p[b * stride];
  const int c = t % s.c, kw = (t / s.c) % s.k, kh = t / (s.c * s.k);
  dw[((static_cast<size_t>(o) * s.c + c) * s.k + kh) * s.k + kw] = sum;
}

}  // namespace

extern "C" {

// Scratch floats for ``blocks`` partials of the given shape.
long long iv_root_wgrad_scratch(int c, int cout, int k, int blocks) {
  const int taps_pad = (k * k * c + 15) / 16 * 16, cout_pad = (cout + 15) / 16 * 16;
  return static_cast<long long>(blocks) * taps_pad * cout_pad;
}

// x (n, h, w, c) and dy (n, oh, ow, cout) bf16 NHWC, contiguous; dw (cout,
// c, k, k) f32; partial >= iv_root_wgrad_scratch floats. -1: taps or
// outputs over the kernel's tile (K*K*C > 160 or Cout > 64); -2: the staged
// x rows over their buffer (K*C*(127+K) > 2880), or 2^31 chunks or more.
int iv_root_wgrad(const void* x, const void* dy, void* dw, void* partial, int n, int h, int w,
                  int c, int oh, int ow, int cout, int k, int blocks, void* stream) {
  Shape s;
  s.h = h, s.w = w, s.c = c, s.oh = oh, s.ow = ow, s.cout = cout, s.k = k;
  s.taps = k * k * c;
  s.taps_pad = (s.taps + 15) / 16 * 16;
  s.cout_pad = (cout + 15) / 16 * 16;
  if (s.taps_pad > kMaxTaps || s.cout_pad > kMaxCout) return -1;
  if (k * c * (2 * kKP + k - 1) > kMaxXs) return -2;
  s.chunks_per_row = (ow + kKP - 1) / kKP;
  const long long chunks = static_cast<long long>(n) * oh * s.chunks_per_row;
  if (chunks >= (1LL << 31) - blocks) return -2;
  s.total_chunks = static_cast<int>(chunks);
  s.chunks_per_block = (s.total_chunks + blocks - 1) / blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = cout % 8 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  auto xp = static_cast<const unsigned short*>(x);
  auto dyp = static_cast<const unsigned short*>(dy);
  auto pp = static_cast<float*>(partial);
  if (vec && k == 7 && c == 3 && cout == kMaxCout)
    wgrad_partial_kernel<true, true><<<blocks, kThreads, 0, st>>>(xp, dyp, pp, s);
  else if (vec)
    wgrad_partial_kernel<true, false><<<blocks, kThreads, 0, st>>>(xp, dyp, pp, s);
  else
    wgrad_partial_kernel<false, false><<<blocks, kThreads, 0, st>>>(xp, dyp, pp, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = s.taps * cout;
  wgrad_reduce_kernel<<<(outputs + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                            static_cast<float*>(dw), blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
