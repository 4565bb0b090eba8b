// Fused SGD(M) + weight decay + EMA update over flat f32 vectors, for sm_90a.
//
// Replaces the Pallas TPU kernel ``_kernel`` of iv2019_tpu/ops/pallas_update.py
// (called through ``fused_update_pallas``). One pass over the flat parameter
// vector computes, element by element,
//
//     g' = g + wd * (mask * w)
//     m' = g' + mu * m
//     w' = w - lr * (g' + mu * m')    (Nesterov)   |   w - lr * m'   (plain)
//     s' = s - (1 - decay) * (s - w')
//
// and reg = sum(mask * w * w) over the pre-update weights.
//
// What bounds it on the H100: bytes. Five vectors are read (w, g, m, s, mask)
// and three written (w', m', s'): 32 bytes per parameter, no reuse, so the
// least time is 32 N / 3.35 TB/s (0.25 ms at the model's 26.2M parameters).
// The design does nothing but stream: 16-byte loads and stores per thread
// (float4), a grid-stride loop over a fixed grid of one wave of resident
// blocks, and no shared memory beyond the reduction.
//
// The Pallas kernel accumulates reg across its sequential grid in one SMEM
// cell. CUDA blocks run in no order, so each block writes its partial sum
// (f64) to its own slot and a second, one-block kernel adds the slots in a
// fixed order: the result is the same from run to run. The element-wise
// arithmetic uses the round-to-nearest intrinsics so that no multiply-add is
// contracted into an FMA, which makes w', m' and s' bit-equal to the plain
// PyTorch version (one rounding per operation, as its separate tensor ops).
//
// The outputs may alias the inputs (w' onto w, m' onto m, s' onto s): each
// thread reads its elements before it writes them.
//
// Plain C interface (no PyTorch headers), loaded with ctypes by
// iv2019_tpu_torch/ops/fused_update.py. Returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Coeffs {
  float lr, one_minus_decay, mu, wd;
};

template <bool kNesterov>
__device__ __forceinline__ float step_one(float w, float g, float m, float s, float mask,
                                          const Coeffs& k, float* m_out, float* s_out,
                                          double& reg) {
  const float wd_w = __fmul_rn(mask, w);
  const float gd = __fadd_rn(g, __fmul_rn(k.wd, wd_w));
  const float m_new = __fadd_rn(gd, __fmul_rn(k.mu, m));
  const float upd = kNesterov ? __fadd_rn(gd, __fmul_rn(k.mu, m_new)) : m_new;
  const float w_new = __fsub_rn(w, __fmul_rn(k.lr, upd));
  *s_out = __fsub_rn(s, __fmul_rn(k.one_minus_decay, __fsub_rn(s, w_new)));
  *m_out = m_new;
  reg += static_cast<double>(__fmul_rn(wd_w, w));
  return w_new;
}

template <bool kNesterov>
__global__ void __launch_bounds__(kThreads)
update_kernel(const float* w, const float* g, const float* m, const float* s,
              const float* mask, const float* lr, const float* decay, float* w_out,
              float* m_out, float* s_out, double* partials, long long n, float mu,
              float wd) {
  Coeffs k;
  k.lr = *lr;
  k.one_minus_decay = __fsub_rn(1.0f, *decay);
  k.mu = mu;
  k.wd = wd;
  double reg = 0.0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n4 = n / 4;
  for (long long i = first; i < n4; i += stride) {
    const float4 wv = reinterpret_cast<const float4*>(w)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    const float4 mv = reinterpret_cast<const float4*>(m)[i];
    const float4 sv = reinterpret_cast<const float4*>(s)[i];
    const float4 kv = reinterpret_cast<const float4*>(mask)[i];
    float4 wn, mn, sn;
    wn.x = step_one<kNesterov>(wv.x, gv.x, mv.x, sv.x, kv.x, k, &mn.x, &sn.x, reg);
    wn.y = step_one<kNesterov>(wv.y, gv.y, mv.y, sv.y, kv.y, k, &mn.y, &sn.y, reg);
    wn.z = step_one<kNesterov>(wv.z, gv.z, mv.z, sv.z, kv.z, k, &mn.z, &sn.z, reg);
    wn.w = step_one<kNesterov>(wv.w, gv.w, mv.w, sv.w, kv.w, k, &mn.w, &sn.w, reg);
    reinterpret_cast<float4*>(w_out)[i] = wn;
    reinterpret_cast<float4*>(m_out)[i] = mn;
    reinterpret_cast<float4*>(s_out)[i] = sn;
  }
  // the ragged tail (n % 4 elements)
  for (long long i = n4 * 4 + first; i < n; i += stride) {
    w_out[i] = step_one<kNesterov>(w[i], g[i], m[i], s[i], mask[i], k, &m_out[i], &s_out[i], reg);
  }
  __shared__ double sh[kThreads];
  sh[threadIdx.x] = reg;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sh[threadIdx.x] += sh[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = sh[0];
}

// One block: the partial sums in a fixed order.
__global__ void __launch_bounds__(kThreads)
sum_partials(const double* partials, int count, float* reg) {
  __shared__ double sh[kThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) acc += partials[i];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sh[threadIdx.x] += sh[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) *reg = static_cast<float>(sh[0]);
}

}  // namespace

extern "C" int iv_fused_update(const float* w, const float* g, const float* m, const float* s,
                               const float* mask, const float* lr, const float* decay,
                               float* w_out, float* m_out, float* s_out, double* partials,
                               float* reg, long long n, float momentum, float weight_decay,
                               int nesterov, int max_blocks, cudaStream_t stream) {
  long long want = (n / 4 + kThreads - 1) / kThreads;
  if (want < 1) want = 1;
  const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
  if (nesterov) {
    update_kernel<true><<<blocks, kThreads, 0, stream>>>(
        w, g, m, s, mask, lr, decay, w_out, m_out, s_out, partials, n, momentum, weight_decay);
  } else {
    update_kernel<false><<<blocks, kThreads, 0, stream>>>(
        w, g, m, s, mask, lr, decay, w_out, m_out, s_out, partials, n, momentum, weight_decay);
  }
  sum_partials<<<1, kThreads, 0, stream>>>(partials, blocks, reg);
  return static_cast<int>(cudaGetLastError());
}
