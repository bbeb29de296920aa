// K3 gf_encode_crc_acc: parity (m, n) = C (m, k) x data (k, n) over
// GF(2^8), AND one crc32c linear part L = crc(run, 0) per (run, shard
// row) of all k+m rows, from one launch.  The n columns are a drain's
// runs laid end to end, each front-padded with zeros to a multiple of
// the block B = 4*wb; a zero prefix leaves L unchanged
// (L(0^p || X) = L(X)) and encodes to zero parity, so each run's L
// covers its every byte and the host folds no tail.
//
// Replaces the Pallas kernel `_make_gf_crc_kernel_w32_hier_acc`
// (ceph_tpu/ops/bitsliced.py:539, via `_fused_hier_acc_call` :626).
// That kernel walks a sequential grid and keeps each run's L in an
// output block that stays resident in VMEM, folding
// acc <- A_tile . acc ^ L(tile) step by step.  Thread blocks on the
// H100 run in no order, so the design rests on the fold being
// XOR-linear instead:
//
//     L(run) = XOR_b  A_{B * d_b} . L(block b),
//
// d_b = the number of the run's blocks after block b.  Every thread
// block computes parity and the L of its block exactly as K2 does
// (gf_common.cuh), advances each L by its own d_b — composing the
// operators A_{B * 2^j} for the set bits of d_b, one warp-wide 32x32
// GF(2) matvec each (levels 5.. of the host operator table, which
// holds A_{(B/32) * 2^i}) — and XORs it into the (run, row) slot with
// atomicXor.  XOR is associative and commutative, so the result does
// not depend on the order the blocks land in and is bit-exact; no
// block waits for another, and a 512 KiB run keeps its 256 blocks of
// 2 KiB in flight instead of being handed to one block the way the
// TPU's sequential grid does.  (The other design, a per-run counter
// whose last block folds, would serialise each run's fold behind its
// slowest block and need a second pass over the partial Ls.)
//
// Each block finds its run by a binary search over the per-run
// cumulative block ends (`run_ends`, nruns int64 on the device, staged
// by the wrapper with a pinned non-blocking copy).  The L output must
// be zero before the atomics run: the wrapper zero-fills it on the
// same stream.
//
// What bounds it on the H100: bytes, as K2 — read the k data rows,
// write the m parity rows; the L output is 8 bytes per (run, row).
// The advance adds at most popcount(d_b) warp matvecs (8 for a 512
// KiB run of 2 KiB blocks) per row and block.
#include <cuda_runtime.h>

#include <cstdint>

#include "gf_common.cuh"

namespace {

__global__ void gf_encode_crc_acc_kernel(
    const uint8_t* __restrict__ tables, const uint8_t* __restrict__ in,
    uint8_t* __restrict__ parity, unsigned long long* __restrict__ lacc,
    const uint32_t* __restrict__ adv, const int64_t* __restrict__ run_ends,
    int nruns, int m, int k, int64_t n, int B, int nadv) {
  extern __shared__ __align__(16) uint8_t smem[];
  const ctt::CrcSmem s = ctt::carve_crc_smem(smem, m, k, B, nadv);
  ctt::load_crc_tables(s, tables, adv, m, k, nadv);

  const int64_t nblocks = n / B;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int64_t blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    ctt::encode_block(s, in, parity, m, k, n, blk * B, B);
    // the run of this block: the first whose end lies past it (empty
    // runs share their end with the run before and are skipped)
    int lo = 0, hi = nruns - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (run_ends[mid] > blk) hi = mid;
      else lo = mid + 1;
    }
    const int64_t dist = run_ends[lo] - 1 - blk;  // blocks after this one
    for (int row = warp; row < k + m; row += nwarps) {
      uint32_t crc = ctt::warp_row_crc(s, row, k, B, lane);
      crc = __shfl_sync(0xFFFFFFFFu, crc, 0);
      for (int j = 0; (dist >> j) != 0; ++j)
        if ((dist >> j) & 1)
          crc = ctt::warp_apply_op(s.adv + (ctt::kWarpFoldLevels + j) * 32,
                                   crc, lane);
      if (lane == 0)
        atomicXor(lacc + static_cast<int64_t>(lo) * (k + m) + row,
                  static_cast<unsigned long long>(crc));
    }
  }
}

}  // namespace

// tables (m, k, 256) uint8; in (k, n) uint8; parity (m, n) uint8;
// lacc (nruns, k+m) uint64, ZERO on entry, each uint32 L zero-extended;
// adv (nadv, 32) uint32 = A_{(B/32) * 2^j}, nadv > 5 + log2(blocks of
// the longest run); run_ends (nruns,) int64, non-decreasing, the last
// == n / B.  All contiguous on the device, 16-byte aligned; n % B == 0
// and B % 128 == 0.  Returns the CUDA error of the launch.
extern "C" int ctt_gf_encode_crc_acc(const void* tables, const void* in,
                                     void* parity, void* lacc,
                                     const void* adv, const void* run_ends,
                                     int nruns, int m, int k, long long n,
                                     int B, int nadv, void* stream) {
  const int threads = 256;
  const int smem = ctt::crc_smem_bytes(m, k, B, nadv);
  long long blocks = n / B;
  if (blocks > 2048) blocks = 2048;
  if (blocks < 1) blocks = 1;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(gf_encode_crc_acc_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gf_encode_crc_acc_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(parity), static_cast<unsigned long long*>(lacc),
      static_cast<const uint32_t*>(adv),
      static_cast<const int64_t*>(run_ends), nruns, m, k,
      static_cast<int64_t>(n), B, nadv);
  return static_cast<int>(cudaGetLastError());
}
