// The fused-unit kernels (B4, B5) and eval-mode BatchNorm (N3) as operators
// registered with PyTorch.
//
//   iv2019::fused_bottleneck(x, w1, b1, w2, b2, w3, b3, rate, plan) -> out
//   iv2019::fused_bottleneck_ct(...)                                 -> out
//   iv2019::bn_eval(x, mean, var, scale, bias, epsilon, residual, relu) -> y
//   iv2019::bn_eval.folded(x, table, residual, relu)                  -> y
//
// x (N, H, W, C) bf16, w1 (C, M), w2 (3, 3, M, M), w3 (M, C) bf16, biases
// f32; plan = (tile1, stages1, nc, stages2, smem1, smem2), the launch plan
// that ops/fused_block.py::_plan computes. bn_eval: x NCHW in channels_last
// memory, f32 or bf16; the running mean and var, scale and bias f32 (C),
// the per-channel factor rsqrt(var + epsilon) * scale formed in the kernel;
// bn_eval.folded, what an exported program holds: table f32 (3, C), rows
// mean, that factor and bias, evaluated once at export
// (tools/export_model.py::fold_weights); residual None or x's type, shape
// and layout; y has x's type and strides (ops/fused_bn.py). An exported
// program carries these calls as graph nodes with the plan and the table
// as constants, and a process with no Python (serving/aoti_loader.cc) runs
// them after a dlopen of this library, so the schemas and the CUDA
// implementations are registered here, in C++.
//
// One source, two builds (ops/_build.py::build_ops):
// - everywhere: the schemas alone, which need only the torch wheel's
//   headers; Python registers the fake implementations (for export) and
//   the fused units' CPU one (the plain version, bottleneck_plain). A CPU
//   tensor never reaches bn_eval: Norm runs the plain chain there;
// - where CUDA is (-DIV2019_CUDA): also the CUDA implementations, linked
//   against the kernels' libraries built from csrc/fused_bottleneck.cu and
//   csrc/fused_bn.cu. They check what the ctypes route checks, allocate
//   their outputs (and B4/B5's y1) with ATen, call iv_fused_bottleneck /
//   iv_fused_bottleneck_ct / iv_bn_eval on the current stream and raise on
//   a non-zero return. They count their launches, read through
//   iv_op_launches, so that a process with no Python can report them.

#include <ATen/ATen.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>
#include <optional>

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
int iv_bn_eval(int dtype, const void* x, const float* mean, const float* var, const float* scale,
               const float* bias, float eps, const void* residual, int relu, void* y, long long m,
               int c, void* stream);
}
#endif

namespace {

// launches of fused_bottleneck (0), fused_bottleneck_ct (1) and bn_eval (2)
std::atomic<int64_t> g_launches[3];

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

void check_x(const at::Tensor& x) {
  TORCH_CHECK(x.dim() == 4 &&
                  (x.scalar_type() == at::kFloat || x.scalar_type() == at::kBFloat16) &&
                  x.is_contiguous(at::MemoryFormat::ChannelsLast),
              "iv2019::bn_eval: x must be float32 or bfloat16 NCHW in channels_last memory, ",
              "got ", x.scalar_type(), " ", x.sizes(), " strides ", x.strides());
  TORCH_CHECK(x.size(1) > 0, "iv2019::bn_eval: x has no channels");
}

// A per-channel operand of x: f32, contiguous, on x's device; (C,), or
// (rows, C) for the folded table.
void check_param(const char* name, const at::Tensor& t, const at::Tensor& x, int64_t rows) {
  const bool shape = rows ? t.dim() == 2 && t.size(0) == rows && t.size(1) == x.size(1)
                          : t.dim() == 1 && t.size(0) == x.size(1);
  TORCH_CHECK(t.scalar_type() == at::kFloat && shape && t.is_contiguous() &&
                  t.device() == x.device(),
              "iv2019::bn_eval: ", name, " must be float32 of ", rows ? rows : 1, " x ",
              x.size(1), " contiguous on ", x.device(), ", got ", t.scalar_type(), " ",
              t.sizes(), " on ", t.device());
}

// Both forms of bn_eval: var null when ``scale`` holds the factor already.
at::Tensor bn_eval_launch(const at::Tensor& x, const float* mean, const float* var,
                          const float* scale, const float* bias, double epsilon,
                          const std::optional<at::Tensor>& residual, bool relu) {
  const char* op = "iv2019::bn_eval";
  if (residual) {
    const at::Tensor& r = *residual;
    TORCH_CHECK(r.scalar_type() == x.scalar_type() && r.sizes() == x.sizes() &&
                    r.device() == x.device() && r.is_contiguous(at::MemoryFormat::ChannelsLast),
                op, ": residual must be ", x.scalar_type(), " ", x.sizes(),
                " channels_last on ", x.device(), ", got ", r.scalar_type(), " ", r.sizes(),
                " strides ", r.strides(), " on ", r.device());
  }
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor y = at::empty_like(x);
  const int64_t c = x.size(1);
  const int err = iv_bn_eval(
      x.scalar_type() == at::kFloat ? 0 : 1, x.data_ptr(), mean, var, scale, bias,
      static_cast<float>(epsilon), residual ? residual->data_ptr() : nullptr, relu ? 1 : 0,
      y.data_ptr(), x.numel() / c, static_cast<int>(c),
      c10::cuda::getCurrentCUDAStream(x.device().index()).stream());
  TORCH_CHECK(err == 0, op, " ", x.sizes(), " ", x.scalar_type(), ": CUDA error ", err);
  g_launches[2] += 1;
  return y;
}

at::Tensor bn_eval_cuda(const at::Tensor& x, const at::Tensor& mean, const at::Tensor& var,
                        const at::Tensor& scale, const at::Tensor& bias, double epsilon,
                        const std::optional<at::Tensor>& residual, bool relu) {
  check_x(x);
  check_param("mean", mean, x, 0);
  check_param("var", var, x, 0);
  check_param("scale", scale, x, 0);
  check_param("bias", bias, x, 0);
  return bn_eval_launch(x, mean.data_ptr<float>(), var.data_ptr<float>(),
                        scale.data_ptr<float>(), bias.data_ptr<float>(), epsilon, residual, relu);
}

at::Tensor bn_eval_folded_cuda(const at::Tensor& x, const at::Tensor& table,
                               const std::optional<at::Tensor>& residual, bool relu) {
  check_x(x);
  check_param("table", table, x, 3);
  const float* rows = table.data_ptr<float>();
  const int64_t c = x.size(1);
  return bn_eval_launch(x, rows, nullptr, rows + c, rows + 2 * c, 0.0, residual, relu);
}
#endif

}  // namespace

TORCH_LIBRARY(iv2019, m) {
  m.def("fused_bottleneck(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor w3, "
        "Tensor b3, int rate, int[] plan) -> Tensor");
  m.def("fused_bottleneck_ct(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor w3, "
        "Tensor b3, int rate, int[] plan) -> Tensor");
  m.def("bn_eval(Tensor x, Tensor mean, Tensor var, Tensor scale, Tensor bias, float epsilon, "
        "Tensor? residual, bool relu) -> Tensor");
  m.def("bn_eval.folded(Tensor x, Tensor table, Tensor? residual, bool relu) -> Tensor");
}

#ifdef IV2019_CUDA
TORCH_LIBRARY_IMPL(iv2019, CUDA, m) {
  m.impl("fused_bottleneck", &run<0>);
  m.impl("fused_bottleneck_ct", &run<1>);
  m.impl("bn_eval", &bn_eval_cuda);
  m.impl("bn_eval.folded", &bn_eval_folded_cuda);
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

// Launches of the CUDA implementations: which 0 is fused_bottleneck, 1 its _ct
// twin, 2 bn_eval (both forms).
int64_t iv_op_launches(int which) {
  return which >= 0 && which <= 2 ? g_launches[which].load() : -1;
}

}  // extern "C"
