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
// is the 318.8 MB over 3.35 TB/s (0.095 ms). So dy is streamed once by TMA,
// x comes mostly from L2, and everything between them and the tensor cores
// stays on chip.
//
// The root conv's own shape (K = 7, C = 3, Cout = 64, W a multiple of 8)
// runs ``wgrad_root_kernel``: one GEMM with the outputs as M,
//
//     D[o][t] = sum_p dy[p][o] * im2row[p][t],   M = 64, N = 160, depth = pixels,
//
// in chunks of 128 consecutive output pixels of one output row, so that a
// whole chunk is eight ``wgmma.m64n160k16`` with the accumulators (80
// registers a thread) resident over all of a block's chunks:
//   - A = dy. One TMA box (64 channels x 128 pixels) of the (N*OH, OW, 64)
//     view lands as an M-major tile in the 128-byte swizzle, which wgmma
//     reads transposed. Pixels past the row's end come back as zeros, and
//     zero dy rows cancel whatever the im2row holds there: no masking.
//   - The x slab: the 7 input rows of the chunk, 800 values each from input
//     column 2 ow0 - 8, as one TMA box of the (N, H, W*3/4) view in 8-byte
//     elements (a box holds at most 256 elements; its rows must start on
//     16 bytes in device memory, which column 2 ow0 - 8 does and 2 ow0 - 3
//     would not, and the row stride W*6 must be a multiple of 16, that is W
//     of 8). Rows and columns outside the image come back as zeros, which
//     is the SAME padding: no bounds checks.
//   - B = im2row, formed on chip. For one (kh, pixel) the 21 taps (kw, c)
//     are 21 consecutive values of a slab row, 6 values further per pixel.
//     Eight copy warps move them as 4-byte words into the N-major tile
//     (128-byte swizzle, three boxes of 64 columns): column kh * 22 + e
//     holds slab value 6 p + 14 + e of row kh, e < 22, so that source and
//     destination words are both aligned; tap (kh, kw, c) is column
//     kh * 22 + 1 + 3 kw + c and column kh * 22 is a stray value whose
//     products nobody reads. A warp writes 8 pixels x 4 words at a time,
//     which the swizzle spreads over all 32 banks.
//   - One TMA thread keeps a ring of four (dy, slab) stages in flight; the copy
//     warps fill a ring of two im2row tiles; one consumer warpgroup
//     issues the products asynchronously and releases a stage when the
//     next chunk's products are queued. mbarriers all the way; only the
//     TMA thread's waits trap, and it ends by waiting for the last stages'
//     release, so a lost arrival anywhere ends in its trap.
// Every other shape the gate takes (other K, C, Cout, or a W whose row
// stride TMA does not take) runs ``wgrad_general_kernel``: chunks of 64
// pixels staged through registers, the im2row tile built from 2-byte moves,
// WMMA 16x16x16 products, taps as M.
//
// The Pallas kernel adds every tile's product into one output block that
// stays resident across its sequential grid. CUDA blocks run in parallel and
// in no order, so each block owns a contiguous range of chunks and writes its
// own f32 partial; a second kernel adds the partials in block order. No
// atomics: the result is the same from run to run. The TPU kernel's i32
// pairing of W pixels and its 8-row junk blocks answer Mosaic's layout rules
// and have no counterpart here.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// iv2019_tpu_torch/ops/root_wgrad.py, whose ``_plan`` decides the route and
// the number of blocks. Returns cudaGetLastError(), or a negative code for a
// shape the kernels do not take.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is reached via the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

// ---- the root conv's kernel: wgmma fed by TMA -------------------------------

constexpr int kP = 128;                      // output pixels per chunk (GEMM depth)
constexpr int kCout = 64;                    // M
constexpr int kN = 160;                      // 7 x 22 = 154 columns, padded
constexpr int kTapRow = 22;                  // columns per kh: a stray one, then 21 taps
constexpr int kRootThreads = 128 + 256 + 32; // consumer warpgroup, copy warps, TMA warp
constexpr int kCopyWarps = 8;
constexpr int kRawStages = 4;
constexpr int kTileStages = 2;
constexpr int kDyBytes = kP * 128;           // 128 pixels x 64 bf16
constexpr int kSlabRowBytes = 1600;          // 800 bf16: 6 * 127 + 14 + 22 = 798 are read
constexpr int kSlabFirst = 14;               // slab value of pixel 0's stray column
constexpr int kSlabBytes = 7 * kSlabRowBytes;
constexpr int kRawStride = (kDyBytes + kSlabBytes + 1023) / 1024 * 1024;
constexpr int kBoxBytes = kP * 128;          // one 64-column box of the im2row tile
constexpr int kTileBytes = 3 * kBoxBytes;
constexpr int kRootSmem =
    1024 + kRawStages * kRawStride + kTileStages * kTileBytes + 8 * (2 * kRawStages + 2 * kTileStages);

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
// Waits for the phase of parity `parity` to complete; the loop lives in the
// PTX so that the compiler sees no divergent path around products in flight.
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}
// The same, but a wait of more than 2^32 cycles traps, so that a fault ends
// the launch with an error instead of hanging the card.
__device__ inline void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4294967296;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}
__device__ inline void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(bar), "r"((uint32_t)pred) : "memory");
}
__device__ inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ inline void tma_3d(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0, int c1,
                              int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor for an MN-major tile in the 128-byte
// swizzle: boxes of 64 columns `lbo` bytes apart, eight depth rows 1024 apart.
__device__ inline uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 160 f32; 80 per thread) += A^T (16 x 64, M-major) @ B (16 x 160, N-major).
__device__ inline void wgmma_n160(float (&d)[80], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79 "
      "}, %80, %81, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(1));
}
__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

struct RootShape {
  int oh, chunks_per_row, chunks_per_block, total_chunks;
};

// The two rings and their barriers. Chunk i of a block uses raw stage
// i % kRawStages (dy tile, then the slab) and im2row tile i % kTileStages.
struct Rings {
  uint32_t raw, tiles, bars;
  __device__ uint32_t dy(int i) const { return raw + (i % kRawStages) * kRawStride; }
  __device__ uint32_t slab(int i) const { return dy(i) + kDyBytes; }
  __device__ uint32_t tile(int i) const { return tiles + (i % kTileStages) * kTileBytes; }
  __device__ uint32_t raw_full(int i) const { return bars + (i % kRawStages) * 8; }
  __device__ uint32_t raw_empty(int i) const { return bars + (kRawStages + i % kRawStages) * 8; }
  __device__ uint32_t tile_full(int i) const {
    return bars + (2 * kRawStages + i % kTileStages) * 8;
  }
  __device__ uint32_t tile_empty(int i) const {
    return bars + (2 * kRawStages + kTileStages + i % kTileStages) * 8;
  }
  __device__ static uint32_t raw_round(int i) { return (i / kRawStages) & 1; }
  __device__ static uint32_t tile_round(int i) { return (i / kTileStages) & 1; }
};

__global__ void __launch_bounds__(kRootThreads, 1)
wgrad_root_kernel(const __grid_constant__ CUtensorMap dymap, const __grid_constant__ CUtensorMap xmap,
                  float* __restrict__ partial, RootShape s) {
  extern __shared__ unsigned char smem[];
  Rings r;
  r.raw = (smem_u32(smem) + 1023) & ~1023u;
  r.tiles = r.raw + kRawStages * kRawStride;
  r.bars = r.tiles + kTileStages * kTileBytes;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRawStages; ++i) {
      mbar_init(r.raw_full(i), 1);
      mbar_init(r.raw_empty(i), kCopyWarps + 4);
    }
    for (int i = 0; i < kTileStages; ++i) {
      mbar_init(r.tile_full(i), kCopyWarps);
      mbar_init(r.tile_empty(i), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int first = blockIdx.x * s.chunks_per_block;
  const int count = max(0, min(first + s.chunks_per_block, s.total_chunks) - first);
  // this thread's warp through a shuffle, so that the role branch is
  // warp-uniform to the compiler (else it serializes the wgmma products)
  const int warp = __shfl_sync(0xffffffff, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (warp == 4 + kCopyWarps) {
    // ---- the TMA thread
    if (lane == 0) {
      for (int i = 0; i < count; ++i) {
        const int q = first + i;
        const int row = q / s.chunks_per_row, ow0 = (q % s.chunks_per_row) * kP;
        const int n = row / s.oh, oh = row % s.oh;
        if (i >= kRawStages) mbar_wait_or_trap(r.raw_empty(i), Rings::raw_round(i) ^ 1);
        mbar_expect_tx(r.raw_full(i), kDyBytes + kSlabBytes);
        tma_3d(r.dy(i), dymap, r.raw_full(i), 0, ow0, row);
        tma_3d(r.slab(i), xmap, r.raw_full(i), 3 * ow0 / 2 - 6, 2 * oh - 3, n);
      }
      for (int i = max(0, count - kRawStages); i < count; ++i)
        mbar_wait_or_trap(r.raw_empty(i), Rings::raw_round(i));
    }
  } else if (warp >= 4) {
    // ---- the copy warps: slab -> im2row tile, 16 pixels per warp and chunk
    const int pl = lane / 4, w4 = lane % 4;
    // source byte of this lane's word in each 16-byte chunk of a tile row,
    // relative to the pixel's window; word 4 c8 + w4 of the row is word
    // (.. % 11) of kh = .. / 11, and words 77.. are the zero padding
    int soff[kN / 8];
#pragma unroll
    for (int c8 = 0; c8 < kN / 8; ++c8) {
      const int word = 4 * c8 + w4;
      soff[c8] = word < 7 * (kTapRow / 2) ? word / (kTapRow / 2) * kSlabRowBytes +
                                                2 * kSlabFirst + 4 * (word % (kTapRow / 2))
                                          : -1;
    }
    for (int i = 0; i < count; ++i) {
      mbar_wait(r.raw_full(i), Rings::raw_round(i));
      if (i >= kTileStages) mbar_wait(r.tile_empty(i), Rings::tile_round(i) ^ 1);
      const uint32_t slab = r.slab(i), tile = r.tile(i);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int p = (warp - 4) * 16 + g * 8 + pl;
        const uint32_t src = slab + 12 * p, dst = tile + p * 128 + w4 * 4;
#pragma unroll
        for (int c8 = 0; c8 < kN / 8; ++c8) {
          uint32_t v = 0;
          if (soff[c8] >= 0)
            asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(src + soff[c8]) : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n"
                       :: "r"(dst + (c8 / 8) * kBoxBytes + (((c8 % 8) ^ pl) << 4)), "r"(v)
                       : "memory");
        }
      }
      // the tile's generic stores must be visible to wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      mbar_arrive_if(r.tile_full(i), lane == 0);
      mbar_arrive_if(r.raw_empty(i), lane == 0);
    }
  } else {
    // ---- the consumer warpgroup
    float d[80];
#pragma unroll
    for (int k = 0; k < 80; ++k) d[k] = 0.0f;
    for (int i = 0; i < count; ++i) {
      mbar_wait(r.raw_full(i), Rings::raw_round(i));
      mbar_wait(r.tile_full(i), Rings::tile_round(i));
      const uint32_t a = r.dy(i), b = r.tile(i);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk)
        wgmma_n160(d, desc(a + kk * 2048, kDyBytes), desc(b + kk * 2048, kBoxBytes));
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done with its stages
      if (i > 0) {
        __syncwarp();
        mbar_arrive_if(r.raw_empty(i - 1), lane == 0);
        mbar_arrive_if(r.tile_empty(i - 1), lane == 0);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < 80; ++k) asm volatile("" : "+f"(d[k]) :: "memory");
    if (count > 0) {
      __syncwarp();
      mbar_arrive_if(r.raw_empty(count - 1), lane == 0);
      mbar_arrive_if(r.tile_empty(count - 1), lane == 0);
    }
    // partial[block][o][column]: rows 16 warp + lane / 4 (+ 8), column pairs
    float* out = partial + static_cast<size_t>(blockIdx.x) * kCout * kN;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 16 * warp + lane / 4 + 8 * h, col = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(out + o * kN + col) =
            make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
  }
}

// dW[o, c, kh, kw] = sum over blocks, in block order, of partial[b, o, column(kh, kw, c)]
__global__ void wgrad_root_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ dw, int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kCout * 147) return;
  const int o = i / 147, t = i % 147;
  const int kh = t / 21, kw = t % 21 / 3, c = t % 3;
  const float* p = partial + o * kN + kh * kTapRow + 1 + t % 21;
  float sum = 0.0f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) sum += p[static_cast<size_t>(b) * kCout * kN];
  dw[((o * 3 + c) * 7 + kh) * 7 + kw] = sum;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rank-3 tensor map, dims innermost first, strides in bytes for dims 1 and
// 2; elements outside the tensor read as zero.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                CUtensorMapSwizzle swizzle) {
  const cuuint32_t elem[3] = {1, 1, 1};
  EncodeTiled fn = encode_tiled();
  return fn && fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- every other shape: WMMA, operands staged through registers -------------

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

template <bool kVec>
__device__ __forceinline__ void fetch(const Shape& s, const unsigned short* __restrict__ x,
                                      const unsigned short* __restrict__ dy, int chunk,
                                      Regs<kVec>& g) {
  const int K = s.k, C = s.c;
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
  const int valid = min(kKP, s.ow - ow0) * s.cout;
  const unsigned short* src = dy + ((static_cast<size_t>(n) * s.oh + r) * s.ow + ow0) * s.cout;
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

template <bool kVec>
__device__ __forceinline__ void stage(const Shape& s, const Regs<kVec>& g, unsigned short* xs,
                                      unsigned short* bs) {
  const int K = s.k, C = s.c;
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < K * (2 * kKP + K - 1) * C) xs[e] = g.x[i];
  }
  // Bs rows are pixels, columns outputs; pixels past the row end are zero
  if (kVec) {
    const int per_row = s.cout / 8;
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

// dW^T (taps x Cout) = A (taps x pixels) . dy (pixels x Cout): warp w owns
// taps 16w..16w+15 against all Cout columns. kVec: dy rows load 16 bytes a
// thread (Cout a multiple of 8, dy 16-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
wgrad_general_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ dy,
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
  const int K = s.k, C = s.c;
  const int row_elems = (2 * kKP + K - 1) * C;
  Regs<kVec> g;
  if (first < last) fetch<kVec>(s, x, dy, first, g);
  for (int chunk = first; chunk < last; ++chunk) {
    __syncthreads();  // the previous chunk's products have read As and Bs
    stage<kVec>(s, g, Xs, Bs);
    // the registers are free again: the next chunk's loads fly during the
    // im2row build and the products
    if (chunk + 1 < last) fetch<kVec>(s, x, dy, chunk + 1, g);
    __syncthreads();
    // im2row: item (kh, c, p) writes taps (kh, 0..K-1, c) of pixel p,
    // tap index t = (kh*K + kw)*C + c (HWIO order)
    for (int i = threadIdx.x; i < K * C * kKP; i += kThreads) {
      const int p = i % kKP, kc = i / kKP;
      const int kh = kc / C, c = kc % C;
      const unsigned short* src = Xs + kh * row_elems + 2 * p * C + c;
      unsigned short* dst = As + (kh * K * C + c) * kLd + p;
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
__global__ void wgrad_general_reduce_kernel(const float* __restrict__ partial,
                                            float* __restrict__ dw, int blocks, Shape s) {
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

int run_root(const void* x, const void* dy, float* dw, float* partial, int n, int h, int w, int oh,
             int ow, int blocks, cudaStream_t st) {
  RootShape s;
  s.oh = oh;
  s.chunks_per_row = (ow + kP - 1) / kP;
  const long long chunks = static_cast<long long>(n) * oh * s.chunks_per_row;
  if (chunks >= (1LL << 31) - blocks) return -2;
  s.total_chunks = static_cast<int>(chunks);
  s.chunks_per_block = (s.total_chunks + blocks - 1) / blocks;
  CUtensorMap dymap, xmap;
  // dy as (N*OH, OW, 64) bf16, x as (N, H, W*3/4) 8-byte elements
  const cuuint64_t dyd[3] = {kCout, (cuuint64_t)ow, (cuuint64_t)n * oh};
  const cuuint64_t dys[2] = {kCout * 2, (cuuint64_t)ow * kCout * 2};
  const cuuint32_t dyb[3] = {kCout, kP, 1};
  const cuuint64_t xd[3] = {(cuuint64_t)w * 3 / 4, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t xs[2] = {(cuuint64_t)w * 6, (cuuint64_t)h * w * 6};
  const cuuint32_t xb[3] = {kSlabRowBytes / 8, 7, 1};
  if (!tensor_map(&dymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dy, dyd, dys, dyb,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT64, x, xd, xs, xb, CU_TENSOR_MAP_SWIZZLE_NONE))
    return -5;
  cudaError_t e = cudaFuncSetAttribute(wgrad_root_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kRootSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgrad_root_kernel<<<blocks, kRootThreads, kRootSmem, st>>>(dymap, xmap, partial, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wgrad_root_reduce_kernel<<<(kCout * 147 + 255) / 256, 256, 0, st>>>(partial, dw, blocks);
  return static_cast<int>(cudaGetLastError());
}

int run_general(const void* x, const void* dy, float* dw, float* partial, int n, int h, int w,
                int c, int oh, int ow, int cout, int k, int blocks, cudaStream_t st) {
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
  const bool vec = cout % 8 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  auto xp = static_cast<const unsigned short*>(x);
  auto dyp = static_cast<const unsigned short*>(dy);
  if (vec)
    wgrad_general_kernel<true><<<blocks, kThreads, 0, st>>>(xp, dyp, partial, s);
  else
    wgrad_general_kernel<false><<<blocks, kThreads, 0, st>>>(xp, dyp, partial, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = s.taps * cout;
  wgrad_general_reduce_kernel<<<(outputs + 255) / 256, 256, 0, st>>>(partial, dw, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scratch floats for ``blocks`` partials of the given shape, on either route
// (the root kernel's 64 x 160 partial is the general one's 160 x 64).
long long iv_root_wgrad_scratch(int c, int cout, int k, int blocks) {
  const int taps_pad = (k * k * c + 15) / 16 * 16, cout_pad = (cout + 15) / 16 * 16;
  return static_cast<long long>(blocks) * taps_pad * cout_pad;
}

// x (n, h, w, c) and dy (n, oh, ow, cout) bf16 NHWC, contiguous; dw (cout,
// c, k, k) f32; partial >= iv_root_wgrad_scratch floats. root: 1 runs the
// root conv's wgmma kernel, 0 the general one (ops/root_wgrad.py::_plan
// decides, by the rule repeated here). -1: taps or outputs over the general
// kernel's tile (K*K*C > 160 or Cout > 64); -2: the staged x rows over their
// buffer (K*C*(127+K) > 2880), or 2^31 chunks or more; -4: ``root`` set for
// a shape the root kernel does not take; -5: a tensor map cannot be encoded.
int iv_root_wgrad(const void* x, const void* dy, void* dw, void* partial, int n, int h, int w,
                  int c, int oh, int ow, int cout, int k, int blocks, int root, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (root) {
    if (k != 7 || c != 3 || cout != kCout || w % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(dy) % 16)
      return -4;
    return run_root(x, dy, static_cast<float*>(dw), static_cast<float*>(partial), n, h, w, oh, ow,
                    blocks, st);
  }
  return run_general(x, dy, static_cast<float*>(dw), static_cast<float*>(partial), n, h, w, c, oh,
                     ow, cout, k, blocks, st);
}

}  // extern "C"
