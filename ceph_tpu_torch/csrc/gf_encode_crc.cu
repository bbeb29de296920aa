// K2 gf_encode_crc: parity (m, n) = C (m, k) x data (k, n) over
// GF(2^8), AND the crc32c linear part L = crc(block, 0) of every
// B-byte block of all k+m shard rows, from one launch.
//
// Replaces two Pallas kernels that compute the same function and
// differ only in how the TPU's VMEM forced the crc matrix to be split:
//   #1 `_make_gf_crc_kernel_w32_hier` (ceph_tpu/ops/bitsliced.py:523,
//      via `_fused_hier_call` :586): L per 4*wb-byte sub-block;
//   #2 `_make_gf_crc_kernel_w32` (bitsliced.py:437, via
//      `gf_encode_with_crc_pallas_w32` :459): L per 2 KiB tile.
// Both entries launch this kernel with their block size B.
//
// What bounds it on the H100: bytes.  The floor is reading the k data
// rows and writing the m parity rows once (the L output is 8 bytes per
// B-byte block per shard, ~0.4% at B = 2 KiB).  The design keeps the
// fusion the TPU kernel exists for: each thread block stages one
// B-byte column of all k data rows in shared memory, computes the m
// parity rows into shared memory with the product tables (shared
// memory too), writes parity to device memory once, and takes the
// parity rows' crcs from shared memory — parity never makes a round
// trip through device memory before its crc.
//
// The crc of a block is split across one warp: lane l runs the byte
// table over its own B/32-byte piece from state 0, and the warp folds
// the 32 partials pairwise with L(P1 || P2) = A_|P2| . L(P1) ^ L(P2),
// the identity the JAX package's crc matrices rest on
// (ceph_tpu/ops/crc32c_linear.py:5-16).  The five operators
// A_{piece * 2^j} come from the host as 32 uint32 columns each.
//
// Shared-memory layout: each lane's piece is followed by one pad word,
// so a row takes B + 128 bytes.  Without it the 32 lanes' word t of a
// 64-byte piece sit 16 words apart, in 2 of the 32 banks: a 16-way
// bank conflict on every load of the crc loop.  With the pad, lane l's
// word t is in bank (l * (B/128 + 1) + t) % 32, all distinct at
// B = 2 KiB.
#include <cuda_runtime.h>

#include <cstdint>

#include "gf_common.cuh"

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // crc32c, reflected

__device__ inline uint32_t apply_op(const uint32_t* op, uint32_t x) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) r ^= op[b] & (0u - ((x >> b) & 1u));
  return r;
}

// Word w of a block row, in the padded row (one pad word per piece of
// `wpp` words).
__device__ inline int padded_word(int w, int wpp) { return w + w / wpp; }

__global__ void gf_encode_crc_kernel(const uint8_t* __restrict__ tables,
                                     const uint8_t* __restrict__ in,
                                     uint8_t* __restrict__ parity,
                                     uint64_t* __restrict__ lout,
                                     const uint32_t* __restrict__ adv,
                                     int m, int k, int64_t n, int B) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_tab = smem;                                     // m*k*256
  uint32_t* s_ctab = reinterpret_cast<uint32_t*>(s_tab + m * k * 256);
  uint32_t* s_adv = s_ctab + 256;                            // 5*32
  uint32_t* s_data = s_adv + 160;                            // k*(B+128)
  const int S = B / 4 + 32;                         // padded row, words
  uint32_t* s_par = s_data + k * S;                          // m*(B+128)

  ctt::copy_to_shared16(s_tab, tables, m * k * 256);
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = static_cast<uint32_t>(i);
    for (int t = 0; t < 8; ++t) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
    s_ctab[i] = c;
  }
  for (int i = threadIdx.x; i < 160; i += blockDim.x) s_adv[i] = adv[i];

  const int64_t nblocks = n / B;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int wpp = B / 128;  // words per lane's piece
  for (int64_t blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const int64_t col0 = blk * B;
    __syncthreads();  // previous block's crcs are done with s_data/s_par
    for (int j = 0; j < k; ++j) {
      const uint4* src = reinterpret_cast<const uint4*>(in + j * n + col0);
      uint32_t* dst = s_data + j * S;
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
      for (int i0 = 0; i0 < m; i0 += ctt::kMaxRows) {
        const int nrows = min(ctt::kMaxRows, m - i0);
        uint32_t acc[ctt::kMaxRows] = {0};
        for (int j = 0; j < k; ++j)
          ctt::gf_mac_word(acc, s_tab, k, j, i0, nrows, s_data[j * S + pw]);
#pragma unroll
        for (int i = 0; i < ctt::kMaxRows; ++i) {
          if (i < nrows) {
            s_par[(i0 + i) * S + pw] = acc[i];
            *reinterpret_cast<uint32_t*>(parity + (i0 + i) * n + col0 +
                                         4 * w) = acc[i];
          }
        }
      }
    }
    __syncthreads();

    // crc32c linear part of this block of every shard row, one warp
    // per row
    for (int row = warp; row < k + m; row += nwarps) {
      const uint32_t* p =
          (row < k ? s_data + row * S : s_par + (row - k) * S) +
          lane * (wpp + 1);
      uint32_t crc = 0;
      for (int t = 0; t < wpp; ++t) {
        uint32_t w = p[t];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          crc = s_ctab[(crc ^ w) & 0xFFu] ^ (crc >> 8);
          w >>= 8;
        }
      }
#pragma unroll
      for (int lv = 0; lv < 5; ++lv) {
        const int d = 1 << lv;
        const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, crc, d);
        const uint32_t left = apply_op(s_adv + lv * 32, crc);
        if ((lane & (2 * d - 1)) == 0) crc = left ^ right;
      }
      if (lane == 0) lout[row * nblocks + blk] = crc;  // zero-extended
    }
  }
}

}  // namespace

// tables (m, k, 256) uint8; in (k, n) uint8; parity (m, n) uint8;
// lout (k+m, n/B) uint64 holding each uint32 L zero-extended (so the
// wrapper hands it out as an int64 tensor without a conversion pass);
// adv (5, 32) uint32 = A_{(B/32) * 2^j}.
// All contiguous on the device, 16-byte aligned; n % B == 0 and
// B % 128 == 0.  Returns the CUDA error of the launch.
extern "C" int ctt_gf_encode_crc(const void* tables, const void* in,
                                 void* parity, void* lout, const void* adv,
                                 int m, int k, long long n, int B,
                                 void* stream) {
  const int threads = 256;
  const int smem = m * k * 256 + 256 * 4 + 160 * 4 + (k + m) * (B + 128);
  long long blocks = n / B;
  if (blocks > 2048) blocks = 2048;
  if (blocks < 1) blocks = 1;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(gf_encode_crc_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gf_encode_crc_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(parity), static_cast<uint64_t*>(lout),
      static_cast<const uint32_t*>(adv), m, k, static_cast<int64_t>(n), B);
  return static_cast<int>(cudaGetLastError());
}
