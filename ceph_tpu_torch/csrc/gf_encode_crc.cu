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
// trip through device memory before its crc.  The per-block body
// (staging, parity, the warp crc and its bank-conflict pad) lives in
// gf_common.cuh, shared with K3.
#include <cuda_runtime.h>

#include <cstdint>

#include "gf_common.cuh"

namespace {

__global__ void gf_encode_crc_kernel(const uint8_t* __restrict__ tables,
                                     const uint8_t* __restrict__ in,
                                     uint8_t* __restrict__ parity,
                                     uint64_t* __restrict__ lout,
                                     const uint32_t* __restrict__ adv,
                                     int m, int k, int64_t n, int B) {
  extern __shared__ __align__(16) uint8_t smem[];
  const ctt::CrcSmem s =
      ctt::carve_crc_smem(smem, m, k, B, ctt::kWarpFoldLevels);
  ctt::load_crc_tables(s, tables, adv, m, k, ctt::kWarpFoldLevels);

  const int64_t nblocks = n / B;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int64_t blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    ctt::encode_block(s, in, parity, m, k, n, blk * B, B);
    // crc32c linear part of this block of every shard row, one warp
    // per row
    for (int row = warp; row < k + m; row += nwarps) {
      const uint32_t crc = ctt::warp_row_crc(s, row, k, B, lane);
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
  const int smem = ctt::crc_smem_bytes(m, k, B, ctt::kWarpFoldLevels);
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
