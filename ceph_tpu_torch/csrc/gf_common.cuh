// Shared device helpers of the GF(2^8) kernels (gf_bitmatmul.cu,
// gf_encode_crc.cu).
//
// A GF(2^8) matrix apply out[i] = XOR_j c[i][j] * in[j] is done with
// per-coefficient 256-byte product tables staged in shared memory: the
// table of coefficient (i, j) lives at tab[(i*k + j)*256], so one
// lookup multiplies one byte.  Output rows are processed in groups of
// at most kMaxRows so every accumulator index is a compile-time
// constant and stays in registers.
#pragma once

#include <cstdint>

namespace ctt {

constexpr int kMaxRows = 8;

// Copy `nbytes` (a multiple of 16) from global to shared memory with
// 16-byte loads; every thread of the block takes part.
__device__ inline void copy_to_shared16(uint8_t* dst, const uint8_t* src,
                                        int nbytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x) d[i] = s[i];
}

// acc[i] ^= tab[i][j][byte] for each of the 4 bytes of `word`, rows
// i0 .. i0+nrows-1 of the group, one output word per row.
__device__ inline void gf_mac_word(uint32_t (&acc)[kMaxRows],
                                   const uint8_t* tab, int k, int j,
                                   int i0, int nrows, uint32_t word) {
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i < nrows) {
      const uint8_t* t = tab + ((i0 + i) * k + j) * 256;
      acc[i] ^= static_cast<uint32_t>(t[word & 0xFF]) |
                (static_cast<uint32_t>(t[(word >> 8) & 0xFF]) << 8) |
                (static_cast<uint32_t>(t[(word >> 16) & 0xFF]) << 16) |
                (static_cast<uint32_t>(t[word >> 24]) << 24);
    }
  }
}

}  // namespace ctt
