// The ragged-List packer of the Arrow interop layer, on the host.
//
// A List embedding column's values are gathered row by row into a dense
// row-major (n_rows, dim) matrix before the upload; this loop is the hot
// host step for List-typed inputs.  Built with g++ at first use
// (``interop/native.py``) and bound with ctypes.  The JAX package's
// ``pmm_pack_list_f32`` / ``_f64``, with one change: the validity bitmap
// is Arrow's own, read at a bit offset (row i is bit ``validity_offset +
// i``, least significant bit first), so a sliced column's bitmap needs no
// repacking.
#include <cstdint>
#include <cstring>

extern "C" {

// Null rows become 0.0.  Returns 0 on success, -1 if a valid row has
// length != dim (dimension mismatch).
#define DEFINE_PACK(NAME, T)                                                 \
  int NAME(const T* values, const int64_t* offsets, const uint8_t* validity, \
           int64_t validity_offset, int64_t n_rows, int64_t dim, T* out) {   \
    for (int64_t i = 0; i < n_rows; ++i) {                                   \
      T* dst = out + i * dim;                                                \
      const int64_t bit = validity_offset + i;                               \
      if (validity && !(validity[bit >> 3] & (1 << (bit & 7)))) {            \
        std::memset(dst, 0, sizeof(T) * dim);                                \
        continue;                                                            \
      }                                                                      \
      int64_t s = offsets[i], e = offsets[i + 1];                            \
      if (e - s != dim) return -1;                                           \
      std::memcpy(dst, values + s, sizeof(T) * dim);                         \
    }                                                                        \
    return 0;                                                                \
  }

DEFINE_PACK(pmm_pack_list_f32, float)
DEFINE_PACK(pmm_pack_list_f64, double)

}  // extern "C"
