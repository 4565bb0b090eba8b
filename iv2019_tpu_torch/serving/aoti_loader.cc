// C++ serving loader: an AOTInductor package -> libtorch -> device, no Python.
//
// Port of iv2019_tpu/serving/pjrt_loader.cc. The JAX package serves its
// exported StableHLO through a PJRT plugin; the port serves the AOTInductor
// package that iv2019_tpu_torch/tools/export_model.py writes
// (forward.aoti.pt2) through libtorch's AOTIModelPackageLoader, the same
// runtime torch._inductor.aoti_load_package sits on, with no Python in the
// serving process.
//
//   aoti_serve PACKAGE.pt2 N,H,W,C[:u8] [iters|--stream] [device=cuda|cpu] [ops=LIB.so]
//
// * ops=LIB.so is dlopened before the package is loaded: the operator
//   library of csrc/torch_ops.cpp, which registers iv2019::fused_bottleneck
//   and its _ct twin (B4/B5), which a --fused_block program calls. Its
//   launch counter is reported (op_launches).
// * device (default cuda) must be the package's (it is compiled for one);
//   device=cuda with no CUDA device is refused: no fallback to the CPU.
// * The frame's dtype (":u8" for a program exported with --wire_u8, else
//   f32) and shape must be the package's (metadata the export writes).
// * It feeds the synthetic frame of pjrt_loader.cc (u8 (i * 2654435761) %
//   256; f32 -1 + 2 * ((i * 2654435761) % 1000) / 1000), runs one untimed
//   warm-up, then times `iters` executes, each with the readback of output
//   0 to the host (the completion barrier), and prints a one-line JSON
//   report: p50 `value`, detail.p90_ms, iters, outputs, output0_bytes,
//   output0_fnv (of the last readback), op_launches.
//
// --stream turns the process into a persistent server: after the warm-up
// (its report goes to stderr), it reads fixed-size NHWC frames from stdin
// and writes, per frame, an 8-byte little-endian size and output 0's bytes
// to stdout; diagnostics go to stderr. A reader thread overlaps the next
// frame's stdin read with the current execute. EOF on stdin ends the
// process cleanly, with the op library's launches on stderr.
//
// Built on demand by iv2019_tpu_torch/serving/__init__.py.

#include <dlfcn.h>

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

[[noreturn]] void Die(const std::string& msg) {
  std::fprintf(stderr, "aoti_serve: %s\n", msg.c_str());
  std::exit(1);
}

using LaunchesFn = int64_t (*)(int);

struct Launches {
  LaunchesFn fn = nullptr;
  std::string json() const {
    if (!fn) return "null";
    char buf[96];
    std::snprintf(buf, sizeof(buf), "{\"fused_bottleneck\": %lld, \"fused_bottleneck_ct\": %lld}",
                  static_cast<long long>(fn(0)), static_cast<long long>(fn(1)));
    return buf;
  }
};

std::string Lookup(const std::unordered_map<std::string, std::string>& meta,
                   const std::string& key) {
  auto it = meta.find(key);
  return it == meta.end() ? std::string() : it->second;
}

int Run(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: %s PACKAGE.pt2 N,H,W,C[:u8] [iters|--stream] [device=cuda|cpu] "
                 "[ops=LIB.so]\n",
                 argv[0]);
    return 2;
  }
  const std::string package_path = argv[1];

  std::vector<int64_t> dims;
  bool u8_input = false;
  std::string shape_text;
  {
    std::string shape_arg = argv[2];
    size_t colon = shape_arg.find(':');
    if (colon != std::string::npos) {
      std::string dt = shape_arg.substr(colon + 1);
      if (dt == "u8") u8_input = true;
      else if (dt != "f32") Die("bad dtype suffix (want :u8 or :f32): " + dt);
      shape_arg.resize(colon);
    }
    shape_text = shape_arg;
    std::stringstream ss(shape_arg);
    std::string tok;
    while (std::getline(ss, tok, ',')) {
      char* end = nullptr;
      long long d = std::strtoll(tok.c_str(), &end, 10);
      if (tok.empty() || *end != '\0' || d < 1) Die("bad shape (want N,H,W,C): " + shape_arg);
      dims.push_back(d);
    }
  }
  int next = 3;
  bool stream = false;
  int iters = 10;
  if (argc > next && std::strchr(argv[next], '=') == nullptr) {
    stream = std::strcmp(argv[next], "--stream") == 0;
    iters = stream ? 1 : std::atoi(argv[next]);
    ++next;
  }
  if (iters < 1) iters = 1;  // the percentile report needs a sample

  std::string device_name = "cuda", ops_path;
  for (int i = next; i < argc; ++i) {
    const char* eq = std::strchr(argv[i], '=');
    if (!eq) Die(std::string("bad option (want key=val): ") + argv[i]);
    std::string key(argv[i], eq - argv[i]), val(eq + 1);
    if (key == "device") device_name = val;
    else if (key == "ops") ops_path = val;
    else Die("unknown option: " + key);
  }
  if (device_name != "cuda" && device_name != "cpu")
    Die("bad device (want cuda or cpu): " + device_name);
  const bool cuda = device_name == "cuda";
  if (cuda && !at::hasCUDA()) Die("device=cuda but no CUDA device is present");
  if (!std::ifstream(package_path)) Die("cannot read " + package_path);

  Launches launches;
  if (!ops_path.empty()) {
    void* handle = dlopen(ops_path.c_str(), RTLD_NOW | RTLD_GLOBAL);
    if (!handle) Die(std::string("dlopen failed: ") + dlerror());
    launches.fn = reinterpret_cast<LaunchesFn>(dlsym(handle, "iv_op_launches"));
    if (!launches.fn) Die("iv_op_launches not found in " + ops_path);
  }

  auto meta = torch::inductor::AOTIModelPackageLoader::load_metadata_from_package(package_path,
                                                                                   "model");
  const std::string pkg_device = Lookup(meta, "AOTI_DEVICE_KEY");
  if (pkg_device != device_name)
    Die("the package is compiled for device " + pkg_device + ", not " + device_name);
  const std::string pkg_dtype = Lookup(meta, "iv2019.input_dtype");
  const std::string want_dtype = u8_input ? "uint8" : "float32";
  if (!pkg_dtype.empty() && pkg_dtype != want_dtype)
    Die("the package takes " + pkg_dtype + " frames, not " + want_dtype +
        (pkg_dtype == "uint8" ? " (give the shape a :u8 suffix)" : ""));
  const std::string pkg_shape = Lookup(meta, "iv2019.input_shape");
  if (!pkg_shape.empty() && pkg_shape != shape_text)
    Die("the package takes frames of shape " + pkg_shape + ", not " + shape_text);

  auto t_load = std::chrono::steady_clock::now();
  torch::inductor::AOTIModelPackageLoader loader(package_path);
  std::fprintf(stderr, "loaded %s (%s) in %.1f s\n", package_path.c_str(), device_name.c_str(),
               std::chrono::duration<double>(std::chrono::steady_clock::now() - t_load).count());

  const at::ScalarType in_type = u8_input ? at::kByte : at::kFloat;
  const at::Device device = cuda ? at::Device(at::kCUDA) : at::Device(at::kCPU);

  // ---- input: the synthetic frame ([-1, 1) f32 or raw u8) ----
  int64_t elems = 1;
  for (int64_t d : dims) elems *= d;
  at::Tensor host_in = at::empty(dims, at::TensorOptions().dtype(in_type));
  if (u8_input) {
    uint8_t* p = host_in.data_ptr<uint8_t>();
    for (size_t i = 0; i < static_cast<size_t>(elems); ++i)
      p[i] = static_cast<uint8_t>((i * 2654435761u) % 256);
  } else {
    float* f = host_in.data_ptr<float>();
    for (int64_t i = 0; i < elems; ++i)
      f[i] = -1.0f + 2.0f * static_cast<float>((i * 2654435761u) % 1000) / 1000.0f;
  }
  const at::Tensor in_dev = host_in.to(device);

  // ---- execute: iteration -1 is the untimed warm-up ----
  std::vector<double> lat_ms;
  at::Tensor host_out;
  size_t num_outputs = 0;
  for (int it = -1; it < iters; ++it) {
    auto t0 = std::chrono::steady_clock::now();
    std::vector<at::Tensor> outs = loader.run({in_dev});
    // the readback of output 0 is the completion barrier: serving latency
    // is execute + the transfer of the decisions to the host
    host_out = outs.at(0).to(at::kCPU).contiguous();
    auto t1 = std::chrono::steady_clock::now();
    num_outputs = outs.size();
    if (it >= 0) lat_ms.push_back(std::chrono::duration<double, std::milli>(t1 - t0).count());
  }

  // ---- checksum of the last iteration's output 0 ----
  uint64_t checksum = 0;
  const size_t out_bytes = host_out.nbytes();
  const uint8_t* bytes = static_cast<const uint8_t*>(host_out.data_ptr());
  for (size_t i = 0; i < out_bytes; ++i) checksum = checksum * 1099511628211ull + bytes[i];

  std::sort(lat_ms.begin(), lat_ms.end());
  const double p50 = lat_ms[lat_ms.size() / 2];
  const double p90 = lat_ms[static_cast<size_t>(lat_ms.size() * 0.9)];
  std::fprintf(stream ? stderr : stdout,
               "{\"metric\": \"aoti_serve_p50_latency_ms\", \"value\": %.4f, \"unit\": \"ms\", "
               "\"detail\": {\"p90_ms\": %.4f, \"iters\": %d, \"outputs\": %zu, "
               "\"output0_bytes\": %zu, \"output0_fnv\": \"%016llx\", \"device\": \"%s\", "
               "\"op_launches\": %s}}\n",
               p50, p90, iters, num_outputs, out_bytes,
               static_cast<unsigned long long>(checksum), device_name.c_str(),
               launches.json().c_str());
  if (!stream) return 0;

  // ---- persistent streaming server ----
  const size_t frame_bytes = static_cast<size_t>(elems) * (u8_input ? 1 : sizeof(float));
  std::fprintf(stderr, "streaming: frame=%zu bytes (%s), ready\n", frame_bytes,
               u8_input ? "u8" : "f32");
  std::fflush(stderr);
  size_t served = 0;

  std::vector<uint8_t> frames[2] = {std::vector<uint8_t>(frame_bytes),
                                    std::vector<uint8_t>(frame_bytes)};
  std::mutex mu;
  std::condition_variable cv_full, cv_free;
  int ready_slot = -1;      // slot holding an unconsumed frame
  bool reader_eof = false;  // stdin closed / short frame
  int free_slot = 0;        // next slot the reader may fill

  std::thread reader([&] {
    for (;;) {
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return ready_slot == -1 || reader_eof; });
        if (reader_eof) return;
        slot = free_slot;
      }
      size_t got = std::fread(frames[slot].data(), 1, frame_bytes, stdin);
      std::unique_lock<std::mutex> lk(mu);
      if (got != frame_bytes) {
        if (got != 0) std::fprintf(stderr, "short frame on stdin\n");
        reader_eof = true;
        cv_full.notify_one();
        return;
      }
      ready_slot = slot;
      free_slot = 1 - slot;
      cv_full.notify_one();
    }
  });

  for (;;) {
    int slot;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [&] { return ready_slot != -1 || reader_eof; });
      if (ready_slot == -1) break;  // EOF and no pending frame
      slot = ready_slot;
    }
    auto t0 = std::chrono::steady_clock::now();
    // a copy out of the frame slot (to the device, or a CPU clone), after
    // which the slot goes back to the reader: its next stdin read overlaps
    // this execute and readback
    at::Tensor frame = at::from_blob(frames[slot].data(), dims,
                                     at::TensorOptions().dtype(in_type));
    at::Tensor request = cuda ? frame.to(device) : frame.clone();
    {
      std::unique_lock<std::mutex> lk(mu);
      ready_slot = -1;
      cv_free.notify_one();
    }
    std::vector<at::Tensor> outs = loader.run({request});
    at::Tensor out = outs.at(0).to(at::kCPU).contiguous();
    auto t1 = std::chrono::steady_clock::now();

    uint64_t size_le = static_cast<uint64_t>(out.nbytes());
    if (std::fwrite(&size_le, sizeof(size_le), 1, stdout) != 1 ||
        (out.nbytes() && std::fwrite(out.data_ptr(), 1, out.nbytes(), stdout) != out.nbytes())) {
      Die("stdout write failed");
    }
    std::fflush(stdout);
    ++served;
    std::fprintf(stderr, "request %zu: %.4f ms\n", served,
                 std::chrono::duration<double, std::milli>(t1 - t0).count());
  }
  {
    std::unique_lock<std::mutex> lk(mu);
    reader_eof = true;
    cv_free.notify_one();
  }
  reader.join();
  std::fprintf(stderr, "streaming done: %zu requests, op_launches %s\n", served,
               launches.json().c_str());
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return Run(argc, argv);
  } catch (const c10::Error& e) {
    Die(e.what_without_backtrace());
  } catch (const std::exception& e) {
    Die(e.what());
  }
}
