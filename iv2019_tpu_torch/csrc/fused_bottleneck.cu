// Fused eval-mode identity bottleneck for Hopper (sm_90a), BatchNorm folded.
//
//   out = relu(x + relu(conv3x3_r(y1) + b2)_bf16 @ w3 + b3)
//   y1  = relu(x @ w1 + b1)_bf16, zero outside the image (SAME padding of
//         conv2 applies to y1, so relu(b1) never leaks from padded x)
//
// Replaces the TPU kernels of iv2019_tpu/ops/pallas_block.py:
//   iv_fused_bottleneck    <- _kernel     (fused_bottleneck, block2/block3)
//   iv_fused_bottleneck_ct <- _ct_kernel  (fused_bottleneck_ct, block4)
//
// What bounds it on the H100: tensor-core operations. A block3 unit is
// 18.3 GFLOP against 34 MB of x/out traffic (~540 FLOP/B, above the card's
// ~295 FLOP/B ridge), block4 73 GFLOP against 67 MB.
//
// Design. The Pallas kernels walk a sequential grid: B4 prefetches the next
// stripe's halo across grid steps, B5 carries a y1 ring buffer and y2 from
// one step to the next. CUDA blocks run concurrently and in no order, and a
// block has at most 227 KB of shared memory instead of a 14 MiB VMEM budget.
// So here every block owns one TH x TW output tile and recomputes conv1 on
// the tile's dilated halo:
//   phase 1  y1[halo] = relu(x[halo] @ w1 + b1), masked, bf16 -> smem
//   phase 2  y2[tile] = relu(sum_taps y1[tap rows] @ w2[tap] + b2), bf16 -> smem
//   phase 3  out[tile] = relu(y2 @ w3 + b3 + x[tile]) -> global, bf16
// y1 and y2 never reach device memory. The halo holds only the rows and
// columns the nine taps read: with s = min(rate, tile side) the band is
// tile + 2s wide, so a tile smaller than the rate skips the gap between taps.
// The two entry points differ only in tile shape: block4's M=512 y1 halo
// must fit in shared memory, so its tile is 16x2 (144 halo pixels, 150 KB);
// block2/block3 use 8x4. All products are bf16 WMMA 16x16x16 with f32
// accumulation; operands are staged through shared memory in K chunks of 32,
// two stages deep with cp.async so the next chunk loads during the MMAs.
// The cost of this simplicity is the conv1 recompute on halo pixels (x2.25 at
// block2, x3 at block3, x4.5 at block4) and every tile streaming all three
// weight matrices from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNc = 128;        // output-channel chunk: one 16-wide column tile per warp
constexpr int kKc = 32;         // reduction chunk staged in shared memory
constexpr int kApad = kKc + 8;  // staged A row stride (elements), breaks bank conflicts
constexpr int kBpad = kNc + 8;  // staged B row stride (elements)

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Geometry {
  int sh, sw;     // halo band step along H and W: min(rate, TH), min(rate, TW)
  int hr, hw;     // halo rows and columns
  int halo;       // hr * hw
  int halo_pad;   // halo rounded up to whole 16-row tiles
};

__host__ __device__ inline Geometry geometry(int th, int tw, int rate) {
  Geometry g;
  g.sh = rate < th ? rate : th;
  g.sw = rate < tw ? rate : tw;
  g.hr = th + 2 * g.sh;
  g.hw = tw + 2 * g.sw;
  g.halo = g.hr * g.hw;
  g.halo_pad = (g.halo + 15) / 16 * 16;
  return g;
}

// Halo index k along one axis -> offset from the tile origin. Bands of s
// entries sit at -rate, 0 and +rate; for s == rate they touch and the map is
// simply k - rate.
__host__ __device__ inline int halo_offset(int k, int s, int rate) {
  return (k / s - 1) * rate + k % s;
}

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) / 128 * 128; }

struct SmemLayout {
  size_t y1, y2, a, b, scratch, total;
  size_t a_stage, b_stage;  // elements per stage of the A and B buffers
};

__host__ __device__ inline SmemLayout smem_layout(int th, int tw, int rate, int m) {
  const Geometry g = geometry(th, tw, rate);
  const int p = th * tw;
  const int arows = g.halo_pad > p ? g.halo_pad : p;
  SmemLayout s;
  size_t off = 0;
  s.y1 = off;      off = align128(off + (size_t)g.halo_pad * (m + 8) * 2);
  s.y2 = off;      off = align128(off + (size_t)p * (m + 8) * 2);
  s.a = off;       off = align128(off + (size_t)2 * arows * kApad * 2);  // two stages
  s.b = off;       off = align128(off + (size_t)2 * kKc * kBpad * 2);
  s.scratch = off; off = align128(off + (size_t)kWarps * 256 * 4);
  s.total = off;
  s.a_stage = (size_t)arows * kApad;
  s.b_stage = (size_t)kKc * kBpad;
  return s;
}

__device__ inline uint4 pack8(const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return r;
}

__device__ inline void unpack8(uint4 u, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 16-byte global -> shared copy that bypasses registers; zero-fills when
// !valid (src is then not read).
__device__ inline void cp_async16(void* smem, const void* src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// Start copying a kKc x kNc block of a row-major (K, ld) weight matrix into Bs.
__device__ inline void stage_b(__nv_bfloat16* Bs, const __nv_bfloat16* src, int ld) {
  constexpr int vecs = kNc / 8;
  for (int i = threadIdx.x; i < kKc * vecs; i += kThreads) {
    const int r = i / vecs, v = i % vecs;
    cp_async16(Bs + r * kBpad + v * 8, src + (size_t)r * ld + v * 8, true);
  }
}

// Two-stage software pipeline over n reduction steps: stage(buf, step)
// starts the copies of one step into buffer buf and commits one cp.async
// group; compute(buf, step) consumes one. Step k+1 loads while step k runs.
template <typename Stage, typename Compute>
__device__ inline void pipelined(int n, Stage&& stage, Compute&& compute) {
  __syncthreads();
  stage(0, 0);
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) {
      stage((k + 1) & 1, k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(k & 1, k);
    __syncthreads();
  }
}

// acc[t] += A[t*16 : t*16+16, 0:kKc] @ Bs[:, warp*16 : warp*16+16] for t < nrt.
template <int RT>
__device__ inline void mma_chunk(FragC (&acc)[RT], int nrt, const __nv_bfloat16* A, int lda,
                                 const __nv_bfloat16* Bs, int warp) {
#pragma unroll
  for (int ks = 0; ks < kKc; ks += 16) {
    FragB b;
    wmma::load_matrix_sync(b, Bs + ks * kBpad + warp * 16, kBpad);
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      if (t < nrt) {
        FragA a;
        wmma::load_matrix_sync(a, A + t * 16 * lda + ks, lda);
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
  }
}

template <int RT>
__device__ inline void zero(FragC (&acc)[RT]) {
#pragma unroll
  for (int t = 0; t < RT; ++t) wmma::fill_fragment(acc[t], 0.0f);
}

// Hands each lane 8 accumulator values of row tile t: row (lane / 2) of the
// tile, columns (lane % 2) * 8 .. +8 of the warp's 16-column slice.
template <int RT, typename F>
__device__ inline void epilogue(FragC (&acc)[RT], int nrt, float* scratch, int lane, F&& f) {
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    if (t < nrt) {
      wmma::store_matrix_sync(scratch, acc[t], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = lane / 2, col = (lane % 2) * 8;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = scratch[row * 16 + col + e];
      f(t * 16 + row, col, v);
      __syncwarp();
    }
  }
}

template <int TH, int TW, int RT>
__global__ void __launch_bounds__(kThreads)
fused_unit_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                  const __nv_bfloat16* __restrict__ w3, const float* __restrict__ b3,
                  __nv_bfloat16* __restrict__ out, int H, int W, int C, int M, int rate) {
  constexpr int P = TH * TW;
  constexpr int PRT = P / 16;
  static_assert(P % 16 == 0 && PRT <= RT, "tile must be whole 16-pixel row tiles");

  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry g = geometry(TH, TW, rate);
  const SmemLayout L = smem_layout(TH, TW, rate, M);
  __nv_bfloat16* y1 = reinterpret_cast<__nv_bfloat16*>(smem + L.y1);
  __nv_bfloat16* y2 = reinterpret_cast<__nv_bfloat16*>(smem + L.y2);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + L.a);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + L.b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(smem + L.scratch) + warp * 256;

  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const __nv_bfloat16* xn = x + (size_t)blockIdx.y * H * W * C;
  __nv_bfloat16* on = out + (size_t)blockIdx.y * H * W * C;
  const int halo_rt = g.halo_pad / 16;
  const int ldy = M + 8;  // y1/y2 row stride: 16 B skew per row against bank conflicts

  // image pixel index of halo pixel hp, or -1 outside the image / padding
  auto halo_pixel = [&](int hp) -> int {
    if (hp >= g.halo) return -1;
    const int ih = h0 + halo_offset(hp / g.hw, g.sh, rate);
    const int iw = w0 + halo_offset(hp % g.hw, g.sw, rate);
    return (ih >= 0 && ih < H && iw >= 0 && iw < W) ? ih * W + iw : -1;
  };

  // ---- phase 1: y1 over the halo ---------------------------------------
  for (int nc0 = 0; nc0 < M; nc0 += kNc) {
    FragC acc[RT];
    zero(acc);
    pipelined(
        C / kKc,
        [&](int buf, int step) {
          const int kc0 = step * kKc;
          __nv_bfloat16* A = As + buf * L.a_stage;
          for (int i = threadIdx.x; i < g.halo_pad * (kKc / 8); i += kThreads) {
            const int hp = i / (kKc / 8), v = i % (kKc / 8);
            const int pix = halo_pixel(hp);
            cp_async16(A + hp * kApad + v * 8,
                       xn + (pix >= 0 ? (size_t)pix * C + kc0 + v * 8 : 0), pix >= 0);
          }
          stage_b(Bs + buf * L.b_stage, w1 + (size_t)kc0 * M + nc0, M);
          cp_async_commit();
        },
        [&](int buf, int) {
          mma_chunk(acc, halo_rt, As + buf * L.a_stage, kApad, Bs + buf * L.b_stage, warp);
        });
    const int cb = nc0 + warp * 16;
    epilogue(acc, halo_rt, scratch, lane, [&](int hp, int col, const float* v) {
      float r[8];
      const bool inside = halo_pixel(hp) >= 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] = inside ? fmaxf(v[e] + b1[cb + col + e], 0.0f) : 0.0f;
      *reinterpret_cast<uint4*>(y1 + (size_t)hp * ldy + cb + col) = pack8(r);
    });
  }
  __syncthreads();

  // ---- phase 2: dilated 3x3 over y1 -> y2 -------------------------------
  const int ksteps = M / kKc;
  for (int nc0 = 0; nc0 < M; nc0 += kNc) {
    FragC acc[PRT];
    zero(acc);
    pipelined(
        9 * ksteps,
        [&](int buf, int step) {
          const int tap = step / ksteps, kc0 = (step % ksteps) * kKc;
          const int ti = tap / 3, tj = tap % 3;
          __nv_bfloat16* A = As + buf * L.a_stage;
          // gather the tap's y1 rows (shared -> shared, plain stores)
          for (int i = threadIdx.x; i < P * (kKc / 8); i += kThreads) {
            const int p = i / (kKc / 8), v = i % (kKc / 8);
            const int hp = (p / TW + ti * g.sh) * g.hw + (p % TW + tj * g.sw);
            *reinterpret_cast<uint4*>(A + p * kApad + v * 8) =
                *reinterpret_cast<const uint4*>(y1 + (size_t)hp * ldy + kc0 + v * 8);
          }
          stage_b(Bs + buf * L.b_stage, w2 + ((size_t)tap * M + kc0) * M + nc0, M);
          cp_async_commit();
        },
        [&](int buf, int) {
          mma_chunk(acc, PRT, As + buf * L.a_stage, kApad, Bs + buf * L.b_stage, warp);
        });
    const int cb = nc0 + warp * 16;
    epilogue(acc, PRT, scratch, lane, [&](int p, int col, const float* v) {
      float r[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] = fmaxf(v[e] + b2[cb + col + e], 0.0f);
      *reinterpret_cast<uint4*>(y2 + (size_t)p * ldy + cb + col) = pack8(r);
    });
  }
  __syncthreads();

  // ---- phase 3: conv3 + bias + residual + relu -> out ------------------
  for (int nc0 = 0; nc0 < C; nc0 += kNc) {
    FragC acc[PRT];
    zero(acc);
    pipelined(
        ksteps,
        [&](int buf, int step) {
          stage_b(Bs + buf * L.b_stage, w3 + (size_t)step * kKc * C + nc0, C);
          cp_async_commit();
        },
        [&](int buf, int step) {
          mma_chunk(acc, PRT, y2 + step * kKc, ldy, Bs + buf * L.b_stage, warp);
        });
    const int cb = nc0 + warp * 16;
    epilogue(acc, PRT, scratch, lane, [&](int p, int col, const float* v) {
      const int ih = h0 + p / TW, iw = w0 + p % TW;
      if (ih >= H || iw >= W) return;
      const size_t off = ((size_t)ih * W + iw) * C + cb + col;
      float xr[8], r[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(xn + off)), xr);
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] = fmaxf(v[e] + b3[cb + col + e] + xr[e], 0.0f);
      *reinterpret_cast<uint4*>(on + off) = pack8(r);
    });
  }
}

// Returns 0, a CUDA error code, or a negative code for a shape this tile
// configuration cannot take: -1 halo needs more row tiles than compiled,
// -2 shared memory over the device limit, -3 channels not multiples of 128.
template <int TH, int TW, int RT>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, void* out, int n, int h, int w, int c, int m,
           int rate, void* stream) {
  if (c % kNc || m % kNc || rate < 1) return -3;
  const Geometry g = geometry(TH, TW, rate);
  if (g.halo_pad / 16 > RT) return -1;
  const SmemLayout L = smem_layout(TH, TW, rate, m);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (L.total > (size_t)max_smem) return -2;
  auto kernel = fused_unit_kernel<TH, TW, RT>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  const dim3 grid(((h + TH - 1) / TH) * ((w + TW - 1) / TW), n);
  kernel<<<grid, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(w3),
      static_cast<const float*>(b3), static_cast<__nv_bfloat16*>(out), h, w, c, m, rate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The dispatch rule also sends block4 units here on small feature maps
// (W <= 24 at M=512, rate 4); their 8x4 halo outgrows shared memory, so such
// a unit runs on the 16x2 tiles instead.
int iv_fused_bottleneck(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* w3, const void* b3, void* out, int n,
                        int h, int w, int c, int m, int rate, void* stream) {
  int err = launch<8, 4, 9>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, m, rate, stream);
  if (err == -1 || err == -2)
    err = launch<16, 2, 9>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, m, rate, stream);
  return err;
}

int iv_fused_bottleneck_ct(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* w3, const void* b3, void* out, int n,
                           int h, int w, int c, int m, int rate, void* stream) {
  return launch<16, 2, 9>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, m, rate, stream);
}

}  // extern "C"
