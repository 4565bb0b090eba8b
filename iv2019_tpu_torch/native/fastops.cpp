// Native host-side input-pipeline kernels (C++, exposed via ctypes).
//
// The TPU does the training math; the host pipeline must decode + transform
// fast enough to feed it. These kernels replace the two numpy hot spots
// measured at 0.45 s and 0.79 s per image (TF1-exact resize and bbox
// rasterization) with ~10-30 ms C++ implementations. Called through ctypes,
// so the GIL is released for the duration — the pipeline's thread pool
// scales across cores.
//
// Semantics mirror ops/resize.py (TF r1.12 resize kernels) and
// ops/rasterize.py (corner-delta + prefix-sum rasterization) exactly; the
// Python implementations remain as oracle + fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// TF1 scale: (in-1)/(out-1) when align_corners and out > 1, else in/out.
// float (not double): TF computes scale and coordinates in float32, and
// float64 differs at exact integer boundaries (off-by-one indices).
static inline float tf1_scale(int in_size, int out_size, int align) {
  if (align && out_size > 1) {
    return static_cast<float>(in_size - 1) / (out_size - 1);
  }
  return static_cast<float>(in_size) / out_size;
}

// Bilinear resize, NHWC single image (H, W, C) f32 -> (OH, OW, C) f32.
void resize_bilinear_f32(const float* src, int h, int w, int c, float* dst,
                         int oh, int ow, int align) {
  const float ys = tf1_scale(h, oh, align);
  const float xs = tf1_scale(w, ow, align);

  std::vector<int> xlo(ow), xhi(ow);
  std::vector<float> xf(ow);
  for (int x = 0; x < ow; ++x) {
    float sx = x * xs;
    int lo = std::min(static_cast<int>(std::floor(sx)), w - 1);
    if (lo < 0) lo = 0;
    xlo[x] = lo;
    xhi[x] = std::min(lo + 1, w - 1);
    xf[x] = static_cast<float>(sx - lo);
  }

  std::vector<float> row(static_cast<size_t>(ow) * c);
  std::vector<float> row2(static_cast<size_t>(ow) * c);
  for (int y = 0; y < oh; ++y) {
    float sy = y * ys;
    int ylo = std::min(static_cast<int>(std::floor(sy)), h - 1);
    if (ylo < 0) ylo = 0;
    int yhi = std::min(ylo + 1, h - 1);
    float fy = static_cast<float>(sy - ylo);

    const float* top = src + static_cast<size_t>(ylo) * w * c;
    const float* bot = src + static_cast<size_t>(yhi) * w * c;
    float* out = dst + static_cast<size_t>(y) * ow * c;
    for (int x = 0; x < ow; ++x) {
      const float fx = xf[x];
      const float* tl = top + static_cast<size_t>(xlo[x]) * c;
      const float* tr = top + static_cast<size_t>(xhi[x]) * c;
      const float* bl = bot + static_cast<size_t>(xlo[x]) * c;
      const float* br = bot + static_cast<size_t>(xhi[x]) * c;
      for (int k = 0; k < c; ++k) {
        float t = tl[k] + (tr[k] - tl[k]) * fx;
        float b = bl[k] + (br[k] - bl[k]) * fx;
        out[static_cast<size_t>(x) * c + k] = t + (b - t) * fy;
      }
    }
  }
}

// Nearest-neighbor resize over the two leading spatial dims of an
// element-size-agnostic array: (H, W, E) bytes -> (OH, OW, E).
void resize_nearest_bytes(const uint8_t* src, int h, int w, int elem_bytes,
                          uint8_t* dst, int oh, int ow, int align) {
  const float ys = tf1_scale(h, oh, align);
  const float xs = tf1_scale(w, ow, align);
  std::vector<int> xi(ow);
  for (int x = 0; x < ow; ++x) {
    float sx = x * xs;
    int idx = align ? static_cast<int>(std::lround(sx))
                    : static_cast<int>(std::floor(sx));
    xi[x] = std::min(std::max(idx, 0), w - 1);
  }
  for (int y = 0; y < oh; ++y) {
    float sy = y * ys;
    int yi = align ? static_cast<int>(std::lround(sy))
                   : static_cast<int>(std::floor(sy));
    yi = std::min(std::max(yi, 0), h - 1);
    const uint8_t* srow = src + static_cast<size_t>(yi) * w * elem_bytes;
    uint8_t* drow = dst + static_cast<size_t>(y) * ow * elem_bytes;
    for (int x = 0; x < ow; ++x) {
      std::memcpy(drow + static_cast<size_t>(x) * elem_bytes,
                  srow + static_cast<size_t>(xi[x]) * elem_bytes, elem_bytes);
    }
  }
}

// Bounding-box rasterization into a per-pixel multinomial.
// cids: (n,) int32 (-1 = skip); boxes: (n, 4) f32 normalized
// (xmin, xmax, ymin, ymax); out: (h, w, ncls) f32. Reference semantics:
// integer extents via truncation, max edge inclusive, per-pixel counts
// normalized when > 0.5 else one-hot void (last class).
void rasterize_bboxes(const int32_t* cids, const float* boxes, int n, int h,
                      int w, int ncls, float* out) {
  // corner-delta accumulation per class on an (h+1, w+1) grid
  std::vector<float> delta(static_cast<size_t>(h + 1) * (w + 1) * ncls, 0.f);
  auto at = [&](int y, int x, int k) -> float& {
    return delta[(static_cast<size_t>(y) * (w + 1) + x) * ncls + k];
  };
  for (int i = 0; i < n; ++i) {
    int cid = cids[i];
    if (cid < 0 || cid >= ncls) continue;
    int xmin = static_cast<int>(boxes[i * 4 + 0] * w);
    int xmax = static_cast<int>(boxes[i * 4 + 1] * w);
    int ymin = static_cast<int>(boxes[i * 4 + 2] * h);
    int ymax = static_cast<int>(boxes[i * 4 + 3] * h);
    int y0 = std::min(std::max(ymin, 0), h);
    int y1 = std::min(std::max(ymax + 1, 0), h);
    int x0 = std::min(std::max(xmin, 0), w);
    int x1 = std::min(std::max(xmax + 1, 0), w);
    if (y1 <= y0 || x1 <= x0) continue;
    at(y0, x0, cid) += 1.f;
    at(y1, x0, cid) -= 1.f;
    at(y0, x1, cid) -= 1.f;
    at(y1, x1, cid) += 1.f;
  }
  // 2-D inclusive prefix sum (row pass then column pass), normalize on the fly
  // column pass uses a running row accumulator
  std::vector<float> acc(static_cast<size_t>(w) * ncls, 0.f);
  for (int y = 0; y < h; ++y) {
    // row prefix into counts for this row
    float* out_row = out + static_cast<size_t>(y) * w * ncls;
    std::vector<float> rowsum(ncls, 0.f);
    for (int x = 0; x < w; ++x) {
      float* a = &acc[static_cast<size_t>(x) * ncls];
      float* o = out_row + static_cast<size_t>(x) * ncls;
      float total = 0.f;
      for (int k = 0; k < ncls; ++k) {
        rowsum[k] += at(y, x, k);
        a[k] += rowsum[k];
        o[k] = a[k];
        total += a[k];
      }
      if (total > 0.5f) {
        // divide, as the numpy and on-device rasterizers do: k * (1/t)
        // differs from k / t in the last bit for some counts (5/6, 3/7)
        for (int k = 0; k < ncls; ++k) o[k] /= total;
      } else {
        for (int k = 0; k < ncls; ++k) o[k] = 0.f;
        o[ncls - 1] = 1.f;
      }
    }
  }
}

// uint8 HWC -> float32 in [0,1) (convert_image_dtype), fused with the
// optional [-1,1) centering used by every pipeline.
void u8_to_f32(const uint8_t* src, int64_t count, float* dst, int center) {
  const float scale = 1.f / 255.f;
  if (center) {
    for (int64_t i = 0; i < count; ++i) dst[i] = src[i] * scale * 2.f - 1.f;
  } else {
    for (int64_t i = 0; i < count; ++i) dst[i] = src[i] * scale;
  }
}

// int32 lookup-table map: out[i] = table[src[i]] (lids2cids gather).
void map_lut_i32(const uint8_t* src, int64_t count, const int32_t* table,
                 int table_len, int32_t* dst) {
  for (int64_t i = 0; i < count; ++i) {
    int v = src[i];
    dst[i] = table[v < table_len ? v : table_len - 1];
  }
}

// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of n bytes,
// continuing from crc: crc32c_extend(0, "123456789", 9) == 0xE3069283, as
// TF's crc32c::Extend (utils/tf_checkpoint.py checks checkpoints with it).
// Slicing by 8: eight table lookups per 8 bytes.
static uint32_t crc_tables[8][256];
static bool crc_tables_init = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
    crc_tables[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    for (int t = 1; t < 8; ++t) {
      uint32_t c = crc_tables[t - 1][i];
      crc_tables[t][i] = (c >> 8) ^ crc_tables[0][c & 0xFF];
    }
  }
  return true;
}();

uint32_t crc32c_extend(uint32_t crc, const uint8_t* data, int64_t n) {
  uint32_t c = ~crc;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data + i, 4);
    std::memcpy(&hi, data + i + 4, 4);
    lo ^= c;  // little-endian host: the low byte is the first
    c = crc_tables[7][lo & 0xFF] ^ crc_tables[6][(lo >> 8) & 0xFF] ^
        crc_tables[5][(lo >> 16) & 0xFF] ^ crc_tables[4][lo >> 24] ^
        crc_tables[3][hi & 0xFF] ^ crc_tables[2][(hi >> 8) & 0xFF] ^
        crc_tables[1][(hi >> 16) & 0xFF] ^ crc_tables[0][hi >> 24];
  }
  for (; i < n; ++i) c = (c >> 8) ^ crc_tables[0][(c ^ data[i]) & 0xFF];
  return ~c;
}

}  // extern "C"
