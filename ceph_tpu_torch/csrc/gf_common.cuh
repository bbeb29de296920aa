// Shared device helpers of the GF(2^8) kernels (gf_bitmatmul.cu,
// gf_bitmatmul_stream.cu, gf_encode_crc.cu, gf_encode_crc_acc.cu).
//
// A GF(2^8) matrix apply out[i] = XOR_j c[i][j] * in[j] is done with
// per-coefficient 256-byte product tables staged in shared memory: the
// table of coefficient (i, j) lives at tab[(i*k + j)*256], so one
// lookup multiplies one byte.  Output rows are processed in groups of
// at most kMaxRows so every accumulator index is a compile-time
// constant and stays in registers.
//
// The fused encode+crc kernels (K2, K3) share one per-block body:
// stage a B-byte column of the k data rows in shared memory, compute
// the m parity rows into shared memory (and device memory), then take
// the crc32c linear part L = crc(block, 0) of every shard row, one
// warp per row.  Lane l runs the byte table over its own B/32-byte
// piece from state 0, and the warp folds the 32 partials pairwise with
// L(P1 || P2) = A_|P2| . L(P1) ^ L(P2), the identity the JAX package's
// crc matrices rest on (ceph_tpu/ops/crc32c_linear.py:5-16).  The
// operators A_{(B/32) * 2^j} come from the host as 32 uint32 columns
// each: levels 0-4 serve the warp fold, K3 uses the higher ones to
// advance a block's L over the blocks after it in its run.
//
// Shared-memory layout of a staged row: each lane's piece is followed
// by one pad word, so a row takes B + 128 bytes.  Without it the 32
// lanes' word t of a 64-byte piece sit 16 words apart, in 2 of the 32
// banks: a 16-way bank conflict on every load of the crc loop.  With
// the pad, lane l's word t is in bank (l * (B/128 + 1) + t) % 32, all
// distinct at B = 2 KiB.
#pragma once

#include <cstdint>

namespace ctt {

constexpr int kMaxRows = 8;
constexpr uint32_t kCrcPoly = 0x82F63B78u;  // crc32c, reflected
constexpr int kWarpFoldLevels = 5;          // operator levels of the fold

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

// Blocks of a launch over nvec strips: ceil(nvec / tile_vec) with a
// tile, else enough for one strip per `per_pass` slot, at most 4096.
inline long long span_blocks(long long nvec, long long tile_vec,
                             int per_pass) {
  long long blocks = tile_vec > 0 ? (nvec + tile_vec - 1) / tile_vec
                                  : (nvec + per_pass - 1) / per_pass;
  if (tile_vec <= 0 && blocks > 4096) blocks = 4096;
  return blocks < 1 ? 1 : blocks;
}

// 16 bytes at p as 4 little-endian words; `vec` rows are 16-byte
// aligned and whole, otherwise only the first `rem` bytes are read.
__device__ inline void load16(const uint8_t* p, int64_t rem, int vec,
                              uint32_t (&w)[4]) {
  if (vec) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0;
  for (int b = 0; b < 16 && b < rem; ++b)
    w[b >> 2] |= static_cast<uint32_t>(p[b]) << (8 * (b & 3));
}

__device__ inline void store16(uint8_t* p, int64_t rem, int vec,
                               uint32_t w0, uint32_t w1, uint32_t w2,
                               uint32_t w3) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w0, w1, w2, w3);
    return;
  }
  const uint32_t w[4] = {w0, w1, w2, w3};
  for (int b = 0; b < 16 && b < rem; ++b)
    p[b] = static_cast<uint8_t>(w[b >> 2] >> (8 * (b & 3)));
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

// A . x for an operator of 32 uint32 columns, by one thread.
__device__ inline uint32_t apply_op(const uint32_t* op, uint32_t x) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) r ^= op[b] & (0u - ((x >> b) & 1u));
  return r;
}

// A . x by a whole warp whose lanes all hold the same x: lane b takes
// column b, five xor-shuffles sum the columns; every lane gets A . x.
__device__ inline uint32_t warp_apply_op(const uint32_t* op, uint32_t x,
                                         int lane) {
  uint32_t v = op[lane] & (0u - ((x >> lane) & 1u));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// Word w of a block row, in the padded row (one pad word per piece of
// `wpp` words).
__device__ inline int padded_word(int w, int wpp) { return w + w / wpp; }

// Shared memory of the fused kernels, carved from one dynamic buffer:
// product tables, the crc byte table, `nadv` operator levels, then the
// k staged data rows and the m parity rows (padded rows of S words).
struct CrcSmem {
  uint8_t* tab;
  uint32_t* ctab;
  uint32_t* adv;
  uint32_t* data;
  uint32_t* par;
  int S;
};

// Bytes of shared memory the fused kernels take (the host mirrors it).
__host__ __device__ inline int crc_smem_bytes(int m, int k, int B,
                                              int nadv) {
  return m * k * 256 + 256 * 4 + nadv * 32 * 4 + (k + m) * (B + 128);
}

__device__ inline CrcSmem carve_crc_smem(uint8_t* smem, int m, int k, int B,
                                         int nadv) {
  CrcSmem s;
  s.tab = smem;
  s.ctab = reinterpret_cast<uint32_t*>(smem + m * k * 256);
  s.adv = s.ctab + 256;
  s.data = s.adv + nadv * 32;
  s.S = B / 4 + 32;
  s.par = s.data + k * s.S;
  return s;
}

// Stage the product tables and operators, build the crc byte table.
__device__ inline void load_crc_tables(const CrcSmem& s,
                                       const uint8_t* tables,
                                       const uint32_t* adv, int m, int k,
                                       int nadv) {
  copy_to_shared16(s.tab, tables, m * k * 256);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = static_cast<uint32_t>(i);
    for (int t = 0; t < 8; ++t) c = (c >> 1) ^ (kCrcPoly & (0u - (c & 1u)));
    s.ctab[i] = c;
  }
  for (int i = threadIdx.x; i < nadv * 32; i += blockDim.x) s.adv[i] = adv[i];
}

// Stage the B-byte column at col0 of the k data rows, compute the m
// parity rows into shared memory and write them to `parity`.  Starts
// and ends with a block-wide barrier, so the caller may reuse the
// staged rows right after and the previous block's crcs are done.
__device__ inline void encode_block(const CrcSmem& s, const uint8_t* in,
                                    uint8_t* parity, int m, int k, int64_t n,
                                    int64_t col0, int B) {
  const int wpp = B / 128;  // words per lane's piece
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    const uint4* src = reinterpret_cast<const uint4*>(in + j * n + col0);
    uint32_t* dst = s.data + j * s.S;
    for (int i = threadIdx.x; i < B / 16; i += blockDim.x) {
      const uint4 v = src[i];
      dst[padded_word(4 * i, wpp)] = v.x;
      dst[padded_word(4 * i + 1, wpp)] = v.y;
      dst[padded_word(4 * i + 2, wpp)] = v.z;
      dst[padded_word(4 * i + 3, wpp)] = v.w;
    }
  }
  __syncthreads();

  // parity: one 4-byte word of every parity row per thread and step
  for (int w = threadIdx.x; w < B / 4; w += blockDim.x) {
    const int pw = padded_word(w, wpp);
    for (int i0 = 0; i0 < m; i0 += kMaxRows) {
      const int nrows = min(kMaxRows, m - i0);
      uint32_t acc[kMaxRows] = {0};
      for (int j = 0; j < k; ++j)
        gf_mac_word(acc, s.tab, k, j, i0, nrows, s.data[j * s.S + pw]);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < nrows) {
          s.par[(i0 + i) * s.S + pw] = acc[i];
          *reinterpret_cast<uint32_t*>(parity + (i0 + i) * n + col0 +
                                       4 * w) = acc[i];
        }
      }
    }
  }
  __syncthreads();
}

// L of the staged block of shard row `row` (data rows first), by one
// warp; the result is valid in lane 0.
__device__ inline uint32_t warp_row_crc(const CrcSmem& s, int row, int k,
                                        int B, int lane) {
  const int wpp = B / 128;
  const uint32_t* p =
      (row < k ? s.data + row * s.S : s.par + (row - k) * s.S) +
      lane * (wpp + 1);
  uint32_t crc = 0;
  for (int t = 0; t < wpp; ++t) {
    uint32_t w = p[t];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      crc = s.ctab[(crc ^ w) & 0xFFu] ^ (crc >> 8);
      w >>= 8;
    }
  }
#pragma unroll
  for (int lv = 0; lv < kWarpFoldLevels; ++lv) {
    const int d = 1 << lv;
    const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, crc, d);
    const uint32_t left = apply_op(s.adv + lv * 32, crc);
    if ((lane & (2 * d - 1)) == 0) crc = left ^ right;
  }
  return crc;
}

}  // namespace ctt
