// Probe: where the time of the WMMA root-conv wgrad kernel goes.
//
// This is the kernel that csrc/root_wgrad.cu held before its redesign (64
// output pixels per chunk, operands staged through registers, im2row from
// 2-byte shared-memory moves, WMMA products), with one more argument:
// ``skip`` is a bit mask that leaves a phase out of every chunk, so that
// tools/probe_wgrad_phases.py can time the phases apart by removing one at a
// time. 1: the global loads (the registers hold zeros); 2: the stores that
// stage x and dy in shared memory; 4: the im2row build; 8: the products.
// The results of a run with a phase left out are not a gradient.

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
                     float* __restrict__ partial, Shape s, int skip) {
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
  for (int i = 0; i < kXPer; ++i) g.x[i] = 0;
  for (int i = 0; i < (kVec ? kDyVecPer : 1); ++i) g.dyv[i] = make_uint4(0, 0, 0, 0);
  for (int i = 0; i < (kVec ? 1 : kDyPer); ++i) g.dys[i] = 0;
  if (first < last && !(skip & 1)) fetch<kVec, kRoot>(s, x, dy, first, g);
  for (int chunk = first; chunk < last; ++chunk) {
    __syncthreads();  // the previous chunk's products have read As and Bs
    if (!(skip & 2)) stage<kVec, kRoot>(s, g, Xs, Bs);
    // the registers are free again: the next chunk's loads fly during the
    // im2row build and the products
    if (chunk + 1 < last && !(skip & 1)) fetch<kVec, kRoot>(s, x, dy, chunk + 1, g);
    __syncthreads();
    // im2row: item (kh, c, p) writes taps (kh, 0..K-1, c) of pixel p,
    // tap index t = (kh*K + kw)*C + c (HWIO order)
    for (int i = threadIdx.x; i < ((skip & 4) ? 0 : K * C * kKP); i += kThreads) {
      const int p = i % kKP, kc = i / kKP;
      const int kh = kc / C, c = kc % C;
      const unsigned short* src = Xs + kh * row_elems + 2 * p * C + c;
      unsigned short* dst = As + (kh * K * C + c) * kLd + p;
#pragma unroll 7
      for (int kw = 0; kw < K; ++kw) dst[kw * C * kLd] = src[kw * C];
    }
    __syncthreads();
    if (warp * 16 < s.taps_pad && !(skip & 8)) {
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
long long iv_probe_wgrad_scratch(int c, int cout, int k, int blocks) {
  const int taps_pad = (k * k * c + 15) / 16 * 16, cout_pad = (cout + 15) / 16 * 16;
  return static_cast<long long>(blocks) * taps_pad * cout_pad;
}

// x (n, h, w, c) and dy (n, oh, ow, cout) bf16 NHWC, contiguous; dw (cout,
// c, k, k) f32; partial >= iv_probe_wgrad_scratch floats. -1: taps or
// outputs over the kernel's tile (K*K*C > 160 or Cout > 64); -2: the staged
// x rows over their buffer (K*C*(127+K) > 2880), or 2^31 chunks or more.
int iv_probe_wgrad(const void* x, const void* dy, void* dw, void* partial, int n, int h, int w,
                  int c, int oh, int ow, int cout, int k, int blocks, int skip, void* stream) {
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
    wgrad_partial_kernel<true, true><<<blocks, kThreads, 0, st>>>(xp, dyp, pp, s, skip);
  else if (vec)
    wgrad_partial_kernel<true, false><<<blocks, kThreads, 0, st>>>(xp, dyp, pp, s, skip);
  else
    wgrad_partial_kernel<false, false><<<blocks, kThreads, 0, st>>>(xp, dyp, pp, s, skip);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = s.taps * cout;
  wgrad_reduce_kernel<<<(outputs + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                            static_cast<float*>(dw), blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
