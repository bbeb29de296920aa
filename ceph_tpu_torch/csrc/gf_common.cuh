// Shared device helpers of the GF(2^8) kernels (gf_bitmatmul.cu,
// gf_bitmatmul_stream.cu, gf_encode_crc_acc.cu).
//
// A GF(2^8) matrix apply out[i] = XOR_j c[i][j] * in[j] takes its
// coefficients as per-coefficient 256-byte product tables: the table of
// coefficient (i, j) lives at tab[(i*k + j)*256], so one lookup
// multiplies one byte.  K1's branch for k > 227 looks them up directly
// (gf_mac_word, rows in groups of at most kMaxRows so every accumulator
// index is a compile-time constant and stays in registers).  K1 and K4
// build packed tables from them instead (gf_packed.cuh), K2 and K3
// nibble tables: one 32-bit lookup for four output rows, then one 4x4
// byte transpose a word (transpose4).
#pragma once

#include <cstdint>

namespace ctt {

constexpr int kMaxRows = 8;
constexpr uint32_t kCrcPoly = 0x82F63B78u;  // crc32c, reflected

// The 16-byte column strips [begin, end) a block walks, `step` apart:
// with tile_vec > 0 block b owns strips [b*tile_vec, (b+1)*tile_vec);
// with 0 the grid strides over all of them.  `per_pass` strips are
// taken by the block's threads at once.
struct Span {
  int64_t begin, end, step;
};

__device__ inline Span block_span(int64_t nvec, int64_t tile_vec,
                                  int per_pass) {
  Span s;
  if (tile_vec > 0) {
    s.begin = static_cast<int64_t>(blockIdx.x) * tile_vec;
    s.end = s.begin + tile_vec < nvec ? s.begin + tile_vec : nvec;
    s.step = per_pass;
  } else {
    s.begin = static_cast<int64_t>(blockIdx.x) * per_pass;
    s.end = nvec;
    s.step = static_cast<int64_t>(gridDim.x) * per_pass;
  }
  return s;
}

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

// In place: byte t of a[b] becomes byte b of a[t].
__device__ inline void transpose4(uint32_t (&a)[4]) {
  const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140);
  const uint32_t t1 = __byte_perm(a[0], a[1], 0x7362);
  const uint32_t t2 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t t3 = __byte_perm(a[2], a[3], 0x7362);
  a[0] = __byte_perm(t0, t2, 0x5410);
  a[1] = __byte_perm(t0, t2, 0x7632);
  a[2] = __byte_perm(t1, t3, 0x5410);
  a[3] = __byte_perm(t1, t3, 0x7632);
}

}  // namespace ctt
