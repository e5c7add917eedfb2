// Dihedral transforms of training rows: the port's C++ counterpart of
// the numpy functions apply_symmetry_planes_plain and
// apply_symmetry_policy_plain of katago_torch/dataio/native.py, built at
// first use by katago_torch/ops/_hostbuild.py and called through ctypes.
//
// A symmetry is (transpose << 2) | (flip_y << 1) | flip_x, the
// reference's convention (nninputs.h): rows are flipped first, then
// columns, then the board is transposed. Elements are copied as raw
// bytes of the given size, so every dtype transforms exactly.

#include <cstdint>
#include <cstring>

namespace {

// out[i, j] of one plane: out is [W, H] when transposed, else [H, W].
template <typename T>
void plane(const T *in, T *out, int64_t h, int64_t w, int sym) {
  const bool fx = sym & 1, fy = sym & 2, tr = sym & 4;
  if (!tr) {
    for (int64_t i = 0; i < h; i++) {
      const T *row = in + (fy ? h - 1 - i : i) * w;
      T *o = out + i * w;
      if (!fx) {
        std::memcpy(o, row, w * sizeof(T));
      } else {
        for (int64_t j = 0; j < w; j++) o[j] = row[w - 1 - j];
      }
    }
    return;
  }
  for (int64_t i = 0; i < w; i++) {
    const int64_t x = fx ? w - 1 - i : i;
    T *o = out + i * h;
    for (int64_t j = 0; j < h; j++) o[j] = in[(fy ? h - 1 - j : j) * w + x];
  }
}

// count planes of [h, w] elements, each one followed by `tail` elements
// copied as they are (a policy row's pass slot).
template <typename T>
void planes(const T *in, T *out, int64_t count, int64_t h, int64_t w,
            int64_t tail, int sym) {
  const int64_t stride = h * w + tail;
  for (int64_t p = 0; p < count; p++) {
    plane(in + p * stride, out + p * stride, h, w, sym);
    for (int64_t k = 0; k < tail; k++)
      out[p * stride + h * w + k] = in[p * stride + h * w + k];
  }
}

int run(const void *in, void *out, int64_t count, int64_t h, int64_t w,
        int64_t tail, int64_t elem, int sym) {
  if (sym < 0 || sym > 7 || count < 0 || h < 0 || w < 0 || tail < 0)
    return 1;
  switch (elem) {
    case 1:
      planes(static_cast<const uint8_t *>(in), static_cast<uint8_t *>(out),
             count, h, w, tail, sym);
      return 0;
    case 2:
      planes(static_cast<const uint16_t *>(in), static_cast<uint16_t *>(out),
             count, h, w, tail, sym);
      return 0;
    case 4:
      planes(static_cast<const uint32_t *>(in), static_cast<uint32_t *>(out),
             count, h, w, tail, sym);
      return 0;
    case 8:
      planes(static_cast<const uint64_t *>(in), static_cast<uint64_t *>(out),
             count, h, w, tail, sym);
      return 0;
    default:
      return 2;
  }
}

}  // namespace

extern "C" {

// x: [n, c, h, w] C-contiguous; out: [n, c, w, h] when sym & 4, else
// [n, c, h, w]. elem: bytes per element (1, 2, 4 or 8). Returns 0, or
// non-zero for an argument it does not take.
int kt_symmetry_planes(const void *x, void *out, int64_t n, int64_t c,
                       int64_t h, int64_t w, int64_t elem, int sym) {
  return run(x, out, n * c, h, w, 0, elem, sym);
}

// p: [n, y_size * x_size + 1] rows, each a [y_size, x_size] board then the
// pass slot, which is kept.
int kt_symmetry_policy(const void *p, void *out, int64_t n, int64_t x_size,
                       int64_t y_size, int64_t elem, int sym) {
  return run(p, out, n, y_size, x_size, 1, elem, sym);
}

}  // extern "C"
