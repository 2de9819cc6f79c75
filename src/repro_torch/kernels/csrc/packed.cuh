// The packed-word layout of src/repro_torch/sql/storage.py, decoded in
// registers; shared by ssb_fused.cu, select_scan.cu and unpack.cu.
//
// Value r of a stream packed at `phys` bits (1, 2, 4, 8, 16 or 32) lives
// in word r / c at bit (r % c) * phys, c = 32 / phys.  With lg = log2(c)
// and mask = 2^phys - 1 (all ones at phys 32), one decode serves plain and
// packed streams with no branch: a plain int32 column is phys 32, lg 0.
// Shifts are on `unsigned`, as the reference's logical shift.
#pragma once

#include <cuda_runtime.h>

namespace {

// log2 of the values a word holds at `phys` bits, or -1 for a width the
// layout does not have.
inline int lanes_log2(int phys) {
  switch (phys) {
    case 1: return 5;
    case 2: return 4;
    case 4: return 3;
    case 8: return 2;
    case 16: return 1;
    case 32: return 0;
    default: return -1;
  }
}

inline unsigned lane_mask(int phys) {
  return phys == 32 ? 0xffffffffu : (1u << phys) - 1u;
}

// The raw (encoded) value of row r.
__device__ __forceinline__ unsigned packed_lane(const unsigned* words,
                                                long long r, int lg,
                                                int phys, unsigned mask) {
  const unsigned w = __ldg(words + (r >> lg));
  const unsigned sh = (static_cast<unsigned>(r) & ((1u << lg) - 1u)) *
                      static_cast<unsigned>(phys);
  return (w >> sh) & mask;
}

}  // namespace
