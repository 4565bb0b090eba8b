// Fused eval-mode identity bottleneck for Hopper (sm_90a), BatchNorm folded.
//
//   y1  = relu(x @ w1 + b1)_bf16                       (N, H, W, M) scratch
//   y2  = relu(conv3x3_rate(y1) + b2)_bf16, SAME zero padding of y1
//   out = relu(x + y2 @ w3 + b3)_bf16, residual added in f32
//
// Replaces the TPU kernels of iv2019_tpu/ops/pallas_block.py:
//   iv_fused_bottleneck    <- _kernel     (fused_bottleneck, block2/block3)
//   iv_fused_bottleneck_ct <- _ct_kernel  (fused_bottleneck_ct, block4)
// Both entry points run the same two kernels.
//
// What bounds it on the H100. block3 and block4 units are bound by
// tensor-core operations: block4 is 73.0 GFLOP against 67 MB of x and out
// (74 us of operations, 28 us of bytes even with y1 written and read back),
// block3 18.3 GFLOP against 34 MB. block2 (5.4 GFLOP, 17 MB) is bound by
// bytes.
//
// Design: two kernels per unit, conv1 computed once.
//   conv1_kernel   y1 = relu(x @ w1 + b1) over all N*H*W pixels, tiles of
//                  128 (or 64) pixels x 128 channels, into a bf16 scratch
//                  the wrapper allocates. Only pixels inside the image are
//                  computed, so nothing is masked.
//   conv23_kernel  one block per 8x8 output tile. conv2 is an implicit GEMM
//                  over K = 9*M: the A tile of tap (ti, tj) and K step k0 is
//                  one TMA box of the y1 scratch, (1, 8, 8, 64) at
//                  (n, h0 + (ti-1)*rate, w0 + (tj-1)*rate, k0); TMA fills
//                  the part outside the image with zeros, which is conv2's
//                  SAME padding. y2 = relu(acc + b2), rounded to bf16, stays
//                  in shared memory as conv3's A operand; conv3 runs over C
//                  in chunks of NC output channels, and its epilogue adds b3
//                  and the residual x and stores bf16.
// Why y1 goes through device memory: the Pallas kernels keep y1 in VMEM
// because the TPU was short of HBM bandwidth. Keeping it on chip here costs
// recomputing conv1 on every tile's dilated halo (x2 at block2, x3 at
// block3, x4.5 at block4; conv1 is 23% of a unit's products) or a halo
// exchange. Writing y1 and reading it back adds 25% to the unit's bytes
// (M = C/4), which leaves block3 and block4 bound by operations, and at
// batch 1 y1 (4 MB at block3, 8 MB at block4) stays in the 50 MB L2.
//
// Machinery, the same in both kernels: 384 threads, two consumer
// warpgroups and one producer warpgroup (setmaxnreg moves registers from
// the producer to the consumers). One producer thread walks the kernel's K
// steps of 64 and fills a ring of shared-memory stages with TMA; each stage
// has a "full" mbarrier (the copies' bytes arrived) and an "empty" one (all
// eight consumer warps are done with it). The consumers multiply with wgmma
// m64nNk16, bf16 operands, f32 accumulators in registers: A K-major and B
// MN-major, both straight from the TMA boxes in the 128-byte swizzle, so the
// weights are read in the (K, N) layouts the wrappers take. One K step's
// products stay in flight while the next step's are issued. conv23 runs
// conv2's and conv3's steps as one sequence, so the ring keeps loading
// across chunk and phase boundaries. Every epilogue works straight from the
// accumulators. Each staged weight byte feeds 64 (conv2, conv3) or 128
// (conv1) pixel rows.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached via the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBK = 64;                        // K step: one 128-byte row of bf16
constexpr int kBox = 64 * kBK * 2;             // bytes of one 64-row box
constexpr int kMaxStages = 6;
constexpr int kTile = 8;                       // conv23 output tile side
constexpr int kP2 = kTile * kTile;

// Shared-memory bytes of each kernel: 1024 for aligning the ring to the
// swizzle's 1024-byte period, the ring, y2 (conv23), two mbarriers per
// stage. ops/fused_block.py::_plan repeats this and hands its result over,
// which run() checks.
__host__ __device__ constexpr size_t conv1_stage(int bm) { return (size_t)bm * 128 + 2 * kBox; }
__host__ __device__ constexpr size_t conv23_stage(int nc) { return (size_t)kP2 * 128 + nc * 128; }
__host__ __device__ constexpr size_t conv1_smem(int bm, int stages) {
  return 1024 + stages * (conv1_stage(bm) + 16);
}
__host__ __device__ constexpr size_t conv23_smem(int nc, int m, int stages) {
  return 1024 + stages * (conv23_stage(nc) + 16) + (size_t)kP2 * m * 2;
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ---------------------------------------------------

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
// Waits for the phase of parity `parity` to complete. The loop lives in
// the PTX: a spin loop the compiler sees is a divergent path, and wgmma
// products in flight across one get serialized.
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
// The same, but a wait of more than 2^32 cycles (a lost arrival or missing
// bytes) traps, so that a fault ends the launch with an error instead of
// hanging the card. Only the producer waits so (see produce()): a trap
// path on the consumers' side slows their K loop.
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
// Arrives on `bar` from the threads with pred != 0, without a branch.
__device__ inline void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(bar), "r"((uint32_t)pred) : "memory");
}
__device__ inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ inline void tma_2d(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ inline void tma_4d(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0, int c1,
                              int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

// The ring: `stages` stages of `bytes` each from `base`, then the full and
// the empty barriers. Step s uses stage s % stages in round s / stages.
struct Ring {
  uint32_t base, bytes, bars;
  int stages;
  __device__ uint32_t stage(int s) const { return base + (s % stages) * bytes; }
  __device__ uint32_t full(int s) const { return bars + (s % stages) * 8; }
  __device__ uint32_t empty(int s) const { return bars + (stages + s % stages) * 8; }
  __device__ uint32_t round(int s) const { return (s / stages) & 1; }
};

// Carve the ring out of dynamic shared memory (aligned up to 1024) and
// initialize its barriers: full waits for the producer's one arrival plus
// the bytes, empty for one arrival from each consumer warp.
__device__ inline Ring make_ring(unsigned char* smem, uint32_t bytes, int stages, uint32_t extra) {
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  Ring r{base, bytes, base + stages * bytes + extra, stages};
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(r.bars + i * 8, 1);
      mbar_init(r.bars + (stages + i) * 8, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. For a K-major tile of
// 64-element rows, sbo = 1024 (eight rows) and lbo is unused; for an
// MN-major tile made of 64-column boxes, lbo is the stride between boxes
// and sbo = 1024 (eight K rows).
__device__ inline uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 64 f32; 32 per thread) += A (64 x 16) @ B (16 x 64); scale_d == 0 overwrites d.
__device__ inline void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 f32; 64 per thread) += A (64 x 16) @ B (16 x 128); scale_d == 0 overwrites d.
__device__ inline void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving the epilogue's accumulator reads above
// the wait for the products. (Not used while products are in flight: a
// use there makes the compiler insert a wait of its own.)
template <int N>
__device__ inline void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A[64 x 64] @ B[64 x WN]: A K-major at a, B MN-major at b (WN / 64
// boxes of 64 K rows, kBox apart).
template <int WN>
__device__ inline void mma_k64(float (&d)[WN / 2], uint32_t a, uint32_t b, bool first) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t da = desc(a + kk * 32, 16, 1024);
    const uint64_t db = desc(b + kk * 16 * 128, kBox, 1024);
    if constexpr (WN == 64) wgmma_n64(d, da, db, first && kk == 0 ? 0 : 1);
    else wgmma_n128(d, da, db, first && kk == 0 ? 0 : 1);
  }
}

// Calls f(row, col, v0, v1) for each pair of a warpgroup's accumulators:
// row of the 64, even col of the WN.
template <int WN, typename F>
__device__ inline void for_each_pair(float (&d)[WN / 2], F&& f) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(16 * warp + lane / 4 + 8 * h, 8 * j + 2 * (lane % 4), d[4 * j + 2 * h],
        d[4 * j + 2 * h + 1]);
}

__device__ inline void release(const Ring& r, int s) {
  __syncwarp();
  mbar_arrive_if(r.empty(s), threadIdx.x % 32 == 0);
}

// The consumer side of the ring over `steps` K steps, split into output
// chunks: chunk_steps(s) is the length of the chunk that starts at step s,
// operands(s, stage, a, b) names step s's A and B addresses, and after a
// chunk's last step epilogue(s0, d) reads the accumulators of the chunk
// that started at s0. The K loop has no branch around the products: a
// chunk-end test inside it makes the compiler wait for every step's
// products before the next step's are issued.
template <int WN, typename ChunkSteps, typename Operands, typename Epilogue>
__device__ inline void consume(const Ring& r, int steps, ChunkSteps&& chunk_steps,
                               Operands&& operands, Epilogue&& epilogue) {
  float d[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) d[i] = 0.0f;
  for (int s0 = 0; s0 < steps;) {
    const int len = chunk_steps(s0);
    for (int s = s0; s < s0 + len; ++s) {
      uint32_t a, b;
      operands(s, r.stage(s), a, b);
      mbar_wait(r.full(s), r.round(s));
      wgmma_fence();
      mma_k64<WN>(d, a, b, s == s0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done with its stage
      if (s > s0) release(r, s - 1);
    }
    wgmma_wait<0>();
    fence_operands(d);
    release(r, s0 + len - 1);
    epilogue(s0, d);
    s0 += len;
  }
}

// The producer side: one thread, issue(s, stage, full barrier) per step
// once the stage is empty; then it waits until the consumers have released
// the last stages. Every consumer wait is on a stage the producer later
// waits for, so a lost arrival anywhere ends in the producer's trap.
template <typename Issue>
__device__ inline void produce(const Ring& r, int steps, Issue&& issue) {
  for (int s = 0; s < steps; ++s) {
    if (s >= r.stages) mbar_wait_or_trap(r.empty(s), r.round(s) ^ 1);
    issue(s, r.stage(s), r.full(s));
  }
  for (int s = steps > r.stages ? steps - r.stages : 0; s < steps; ++s)
    mbar_wait_or_trap(r.empty(s), r.round(s));
}

// This thread's warpgroup, through a shuffle so that the compiler sees a
// warp-uniform value: a role branch it cannot prove uniform makes it
// serialize the wgmma instructions.
__device__ inline int warpgroup() { return __shfl_sync(0xffffffff, threadIdx.x / 128, 0); }

__device__ inline __nv_bfloat162 relu2(float a, float b) {
  return __floats2bfloat162_rn(fmaxf(a, 0.0f), fmaxf(b, 0.0f));
}

// ---- kernels -------------------------------------------------------------

// y1[p, n0 : n0+128] = relu(x[p, :] @ w1[:, n0 : n0+128] + b1) for the BM
// pixels p of this block. BM = 128: each consumer warpgroup owns 64 pixels
// and all 128 channels; BM = 64: all pixels and 64 channels.
template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
conv1_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
             const float* __restrict__ b1, bf16* __restrict__ y1, int P, int C, int M,
             int stages) {
  constexpr int WN = BM == 128 ? 128 : 64;
  constexpr uint32_t kA = BM * 128;
  extern __shared__ unsigned char smem[];
  const Ring r = make_ring(smem, conv1_stage(BM), stages, 0);
  const int p0 = blockIdx.x * BM, n0 = blockIdx.y * 128;
  const int steps = C / kBK;
  const int wg = warpgroup();
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kConsumers)
      produce(r, steps, [&](int s, uint32_t st, uint32_t full) {
        mbar_expect_tx(full, conv1_stage(BM));
        tma_2d(st, xmap, full, s * kBK, p0);
        tma_2d(st + kA, w1map, full, n0, s * kBK);
        tma_2d(st + kA + kBox, w1map, full, n0 + 64, s * kBK);
      });
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int row0 = BM == 128 ? 64 * wg : 0, col0 = BM == 128 ? 0 : 64 * wg;
    consume<WN>(
        r, steps, [&](int) { return steps; },
        [&](int, uint32_t st, uint32_t& a, uint32_t& b) {
          a = st + row0 * 128;
          b = st + kA + col0 * 128;
        },
        [&](int, float (&d)[WN / 2]) {
          for_each_pair<WN>(d, [&](int row, int col, float v0, float v1) {
            const int p = p0 + row0 + row, ch = n0 + col0 + col;
            const __nv_bfloat162 v = relu2(v0 + b1[ch], v1 + b1[ch + 1]);
            if (p < P) *reinterpret_cast<__nv_bfloat162*>(y1 + (size_t)p * M + ch) = v;
          });
        });
  }
}

// conv2 + conv3 + residual for one 8x8 output tile; y2 in shared memory.
// Output chunks of NC = 2 * WN channels, WN per consumer warpgroup.
template <int WN>
__global__ void __launch_bounds__(kThreads, 1)
conv23_kernel(const __grid_constant__ CUtensorMap y1map, const __grid_constant__ CUtensorMap w2map,
              const __grid_constant__ CUtensorMap w3map, const bf16* __restrict__ x,
              const float* __restrict__ b2, const float* __restrict__ b3, bf16* __restrict__ out,
              int H, int W, int C, int M, int rate, int stages) {
  constexpr int NC = 2 * WN;
  constexpr uint32_t kA = kP2 * 128;
  extern __shared__ unsigned char smem[];
  // y2 sits between the ring and the barriers: M / 64 K-major 64x64 boxes
  const Ring r = make_ring(smem, conv23_stage(NC), stages, kP2 * M * 2);
  const uint32_t y2 = r.base + stages * r.bytes;

  const int tiles_w = (W + kTile - 1) / kTile, tiles_h = (H + kTile - 1) / kTile;
  const int img = blockIdx.x / (tiles_h * tiles_w);
  const int h0 = (blockIdx.x / tiles_w % tiles_h) * kTile;
  const int w0 = (blockIdx.x % tiles_w) * kTile;

  const int ksteps = M / kBK;
  const int chunk2 = 9 * ksteps;               // steps of one conv2 chunk
  const int steps2 = (M / NC) * chunk2;
  const int steps = steps2 + (C / NC) * ksteps;
  const int wg = warpgroup();
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kConsumers)
      produce(r, steps, [&](int s, uint32_t st, uint32_t full) {
        if (s < steps2) {
          const int chunk = s / chunk2, tap = s % chunk2 / ksteps, k0 = s % ksteps * kBK;
          mbar_expect_tx(full, conv23_stage(NC));
          tma_4d(st, y1map, full, k0, w0 + (tap % 3 - 1) * rate, h0 + (tap / 3 - 1) * rate, img);
          for (int b = 0; b < NC / 64; ++b)
            tma_2d(st + kA + b * kBox, w2map, full, chunk * NC + 64 * b, tap * M + k0);
        } else {
          const int t = s - steps2;
          mbar_expect_tx(full, NC * 128);
          for (int b = 0; b < NC / 64; ++b)
            tma_2d(st + kA + b * kBox, w3map, full, t / ksteps * NC + 64 * b, t % ksteps * kBK);
        }
      });
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const size_t xoff = (size_t)img * H * W * C;
    consume<WN>(
        r, steps, [&](int s) { return s < steps2 ? chunk2 : ksteps; },
        [&](int s, uint32_t st, uint32_t& a, uint32_t& b) {
          // conv2 takes A from the stage, conv3 from y2
          a = s < steps2 ? st : y2 + (s - steps2) % ksteps * kBox;
          b = st + kA + wg * WN * 128;
        },
        [&](int s, float (&d)[WN / 2]) {
          if (s < steps2) {  // y2[:, chunk] = relu(acc + b2), bf16, K-major swizzled
            const int cb = s / chunk2 * NC + wg * WN;
            for_each_pair<WN>(d, [&](int row, int col, float v0, float v1) {
              const int ch = cb + col, c = ch % 64;
              const uint32_t addr = y2 + ch / 64 * kBox + row * 128 +
                                    ((c / 8) ^ (row % 8)) * 16 + c % 8 * 2;
              const __nv_bfloat162 v = relu2(v0 + b2[ch], v1 + b2[ch + 1]);
              asm volatile("st.shared.b32 [%0], %1;\n"
                           :: "r"(addr), "r"(*reinterpret_cast<const uint32_t*>(&v)) : "memory");
            });
            if (s + chunk2 == steps2) {
              // y2 complete: make the generic stores visible to wgmma (the
              // async proxy) and wait for the other consumer warpgroup
              asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
              asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kConsumers) : "memory");
            }
          } else {  // out[:, chunk] = relu(acc + b3 + x)
            const int cb = (s - steps2) / ksteps * NC + wg * WN;
            for_each_pair<WN>(d, [&](int row, int col, float v0, float v1) {
              const int ih = h0 + row / kTile, iw = w0 + row % kTile, ch = cb + col;
              const bool inside = ih < H && iw < W;
              const size_t off = xoff + ((size_t)ih * W + iw) * C + ch;
              const float2 xr = inside ? __bfloat1622float2(
                                             *reinterpret_cast<const __nv_bfloat162*>(x + off))
                                       : make_float2(0.0f, 0.0f);
              const __nv_bfloat162 v = relu2(v0 + b3[ch] + xr.x, v1 + b3[ch + 1] + xr.y);
              if (inside) *reinterpret_cast<__nv_bfloat162*>(out + off) = v;
            });
          }
        });
  }
}

// ---- host ----------------------------------------------------------------

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

// A bf16 tensor map with the 128-byte swizzle; dims innermost first,
// strides in bytes for dims 1.., out-of-bounds elements read as zero.
bool tensor_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  EncodeTiled fn = encode_tiled();
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Returns 0, a CUDA error code, -3 for channels that are not multiples of
// 128, -4 when the launch plan disagrees with the kernels' layout, -5 when
// a tensor map cannot be encoded. kernels: bit 0 launches conv1_kernel,
// bit 1 conv23_kernel.
int run(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
        const void* w3, const void* b3, void* y1, void* out, int n, int h, int w, int c,
        int m, int rate, int tile1, int stages1, int nc, int stages2, int smem1, int smem2,
        int kernels, void* stream) {
  if (c % 128 || m % 128 || rate < 1) return -3;
  if ((tile1 != 64 && tile1 != 128) || (nc != 128 && nc != 256) || m % nc || c % nc ||
      stages1 < 2 || stages1 > kMaxStages || stages2 < 2 || stages2 > kMaxStages ||
      (size_t)smem1 != conv1_smem(tile1, stages1) || (size_t)smem2 != conv23_smem(nc, m, stages2))
    return -4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cuuint64_t C = c, M = m, P = (cuuint64_t)n * h * w;
  cudaError_t e = cudaSuccess;
  if (kernels & 1) {
    CUtensorMap xmap, w1map;
    const cuuint64_t xd[2] = {C, P}, xs[1] = {C * 2}, wd[2] = {M, C}, ws[1] = {M * 2};
    const cuuint32_t xb[2] = {64, (cuuint32_t)tile1}, wb[2] = {64, 64};
    if (!tensor_map(&xmap, x, 2, xd, xs, xb) || !tensor_map(&w1map, w1, 2, wd, ws, wb)) return -5;
    const dim3 grid((unsigned)((P + tile1 - 1) / tile1), m / 128);
    auto k = tile1 == 128 ? conv1_kernel<128> : conv1_kernel<64>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
    if (e != cudaSuccess) return static_cast<int>(e);
    k<<<grid, kThreads, smem1, s>>>(xmap, w1map, static_cast<const float*>(b1),
                                    static_cast<bf16*>(y1), (int)P, c, m, stages1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (kernels & 2) {
    CUtensorMap y1map, w2map, w3map;
    const cuuint64_t yd[4] = {M, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
    const cuuint64_t ys[3] = {M * 2, M * 2 * w, M * 2 * w * h};
    const cuuint64_t w2d[2] = {M, 9 * M}, w2s[1] = {M * 2}, w3d[2] = {C, M}, w3s[1] = {C * 2};
    const cuuint32_t yb[4] = {64, kTile, kTile, 1}, wb[2] = {64, 64};
    if (!tensor_map(&y1map, y1, 4, yd, ys, yb) || !tensor_map(&w2map, w2, 2, w2d, w2s, wb) ||
        !tensor_map(&w3map, w3, 2, w3d, w3s, wb))
      return -5;
    const int grid = n * ((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile);
    auto k = nc == 256 ? conv23_kernel<128> : conv23_kernel<64>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
    if (e != cudaSuccess) return static_cast<int>(e);
    k<<<grid, kThreads, smem2, s>>>(y1map, w2map, w3map, static_cast<const bf16*>(x),
                                    static_cast<const float*>(b2), static_cast<const float*>(b3),
                                    static_cast<bf16*>(out), h, w, c, m, rate, stages2);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

int iv_fused_bottleneck(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* w3, const void* b3, void* y1, void* out,
                        int n, int h, int w, int c, int m, int rate, int tile1, int stages1,
                        int nc, int stages2, int smem1, int smem2, int kernels, void* stream) {
  return run(x, w1, b1, w2, b2, w3, b3, y1, out, n, h, w, c, m, rate, tile1, stages1, nc,
             stages2, smem1, smem2, kernels, stream);
}

int iv_fused_bottleneck_ct(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* w3, const void* b3, void* y1, void* out,
                           int n, int h, int w, int c, int m, int rate, int tile1, int stages1,
                           int nc, int stages2, int smem1, int smem2, int kernels, void* stream) {
  return run(x, w1, b1, w2, b2, w3, b3, y1, out, n, h, w, c, m, rate, tile1, stages1, nc,
             stages2, smem1, smem2, kernels, stream);
}

}  // extern "C"
