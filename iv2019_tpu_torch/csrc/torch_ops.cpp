// The fused-unit kernels (B4, B5) as operators registered with PyTorch.
//
//   iv2019::fused_bottleneck(x, w1, b1, w2, b2, w3, b3, rate, plan) -> out
//   iv2019::fused_bottleneck_ct(...)                                 -> out
//
// x (N, H, W, C) bf16, w1 (C, M), w2 (3, 3, M, M), w3 (M, C) bf16, biases
// f32; plan = (tile1, stages1, nc, stages2, smem1, smem2), the launch plan
// that ops/fused_block.py::_plan computes. An exported program carries
// these calls as graph nodes with the plan as constants, and a process with
// no Python (serving/aoti_loader.cc) runs them after a dlopen of this
// library, so the schema and the CUDA implementation are registered here,
// in C++.
//
// One source, two builds (ops/_build.py::build_ops):
// - everywhere: the schema alone, which needs only the torch wheel's headers;
//   Python registers the fake implementation (for export) and the CPU one
//   (the plain version, bottleneck_plain) on it;
// - where CUDA is (-DIV2019_CUDA): also the CUDA implementation, linked
//   against the kernels' library built from csrc/fused_bottleneck.cu. It
//   checks what the ctypes route checks, allocates y1 and out with ATen,
//   calls iv_fused_bottleneck / iv_fused_bottleneck_ct on the current
//   stream and raises on a non-zero return. It counts its launches, read
//   through iv_op_launches, so that a process with no Python can report
//   them.

#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>

#ifdef IV2019_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" {
int iv_fused_bottleneck(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* w3, const void* b3, void* y1, void* out,
                        int n, int h, int w, int c, int m, int rate, int tile1, int stages1,
                        int nc, int stages2, int smem1, int smem2, int kernels, void* stream);
int iv_fused_bottleneck_ct(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, const void* w3, const void* b3, void* y1, void* out,
                           int n, int h, int w, int c, int m, int rate, int tile1, int stages1,
                           int nc, int stages2, int smem1, int smem2, int kernels, void* stream);
}
#endif

namespace {

// launches of fused_bottleneck (0) and fused_bottleneck_ct (1)
std::atomic<int64_t> g_launches[2];

#ifdef IV2019_CUDA
using Entry = int (*)(const void*, const void*, const void*, const void*, const void*,
                      const void*, const void*, void*, void*, int, int, int, int, int, int, int,
                      int, int, int, int, int, int, void*);

const char* error_text(int err) {
  switch (err) {
    case -3: return "channels must be multiples of 128";
    case -4: return "the launch plan disagrees with the kernels' layout";
    case -5: return "a TMA tensor map could not be encoded";
    default: return "CUDA error";
  }
}

void check(const char* op, const char* name, const at::Tensor& t, at::ScalarType dtype,
           at::IntArrayRef shape, const at::Device& device) {
  TORCH_CHECK(t.scalar_type() == dtype && t.sizes() == shape && t.device() == device, op, ": ",
              name, " must be ", dtype, " ", shape, " on ", device, ", got ", t.scalar_type(),
              " ", t.sizes(), " on ", t.device());
  TORCH_CHECK(t.is_contiguous() && reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, op,
              ": ", name, " must be contiguous and 16-byte aligned");
}

template <int Which>
at::Tensor run(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& b1,
               const at::Tensor& w2, const at::Tensor& b2, const at::Tensor& w3,
               const at::Tensor& b3, int64_t rate, at::IntArrayRef plan) {
  const char* op = Which == 0 ? "iv2019::fused_bottleneck" : "iv2019::fused_bottleneck_ct";
  TORCH_CHECK(x.dim() == 4 && w1.dim() == 2, op, ": x must be (N, H, W, C), w1 (C, M)");
  TORCH_CHECK(plan.size() == 6, op, ": plan must hold 6 ints, got ", plan.size());
  const int64_t n = x.size(0), h = x.size(1), w = x.size(2), c = x.size(3), m = w1.size(1);
  const auto bf = at::kBFloat16, f32 = at::kFloat;
  const at::Device dev = x.device();
  check(op, "x", x, bf, {n, h, w, c}, dev);
  check(op, "w1", w1, bf, {c, m}, dev);
  check(op, "b1", b1, f32, {m}, dev);
  check(op, "w2", w2, bf, {3, 3, m, m}, dev);
  check(op, "b2", b2, f32, {m}, dev);
  check(op, "w3", w3, bf, {m, c}, dev);
  check(op, "b3", b3, f32, {c}, dev);
  const c10::cuda::CUDAGuard guard(dev);
  at::Tensor y1 = at::empty({n, h, w, m}, x.options());
  at::Tensor out = at::empty_like(x);
  const Entry entry = Which == 0 ? iv_fused_bottleneck : iv_fused_bottleneck_ct;
  const int err = entry(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), y1.data_ptr(),
                        out.data_ptr(), n, h, w, c, m, rate, plan[0], plan[1], plan[2], plan[3],
                        plan[4], plan[5], /*kernels=*/3,
                        c10::cuda::getCurrentCUDAStream(dev.index()).stream());
  TORCH_CHECK(err == 0, op, " (n,h,w,c,m,rate)=(", n, ",", h, ",", w, ",", c, ",", m, ",", rate,
              "): ", error_text(err), " ", err);
  g_launches[Which] += 1;
  return out;
}
#endif

}  // namespace

TORCH_LIBRARY(iv2019, m) {
  m.def("fused_bottleneck(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor w3, "
        "Tensor b3, int rate, int[] plan) -> Tensor");
  m.def("fused_bottleneck_ct(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor w3, "
        "Tensor b3, int rate, int[] plan) -> Tensor");
}

#ifdef IV2019_CUDA
TORCH_LIBRARY_IMPL(iv2019, CUDA, m) {
  m.impl("fused_bottleneck", &run<0>);
  m.impl("fused_bottleneck_ct", &run<1>);
}
#endif

extern "C" {

// 1 where this build carries the CUDA implementation, else 0.
int iv_op_has_cuda() {
#ifdef IV2019_CUDA
  return 1;
#else
  return 0;
#endif
}

// Launches of the CUDA implementation: which 0 is fused_bottleneck, 1 its _ct twin.
int64_t iv_op_launches(int which) {
  return which == 0 || which == 1 ? g_launches[which].load() : -1;
}

}  // extern "C"
