// K1 gf_bitmatmul: out (r, n) = C (r, k) x in (k, n) over GF(2^8).
//
// Replaces the Pallas kernel `_make_gf_kernel_w32` reached through
// `gf_bitmatmul_pallas_w32` (ceph_tpu/ops/bitsliced.py:227, :294): the
// plain GF(2^8) matrix apply that serves every decode (inverted
// recovery matrix) and the plain encode of overwrite extents.  The TPU
// kernel word-packs bytes and runs a (32r, 32k) 0/1 bit-matrix on the
// MXU; here the contract is kept (bytes in, bytes out, same values)
// and the TPU layout is not.
//
// What bounds it on the H100: bytes.  Per output byte it does k table
// lookups per row and reads k input bytes; with k=8, r=3 that is well
// under the card's shared-memory lookup rate, so the floor is reading
// k*n and writing r*n bytes of device memory.  The design therefore
// reads every input byte exactly once with 16-byte loads (each thread
// owns 16 consecutive columns of all k rows), keeps the r*k*256-byte
// product tables resident in shared memory (6 KiB at k=8, m=3), and
// writes each output byte once with a 16-byte store.  Ragged or
// unaligned widths take a byte-masked path through the same loop.
//
// Grid: by default at most 4096 blocks of 256 threads stride over the
// width; a `tile` (bytes of each row per block, a multiple of 16) gives
// block b the columns [b*tile, (b+1)*tile) instead — the launch
// parameter tools/w32_sweep sweeps, as the TPU sweep did its tiles.
// load16/store16 live in gf_common.cuh, shared with K4.
#include <cuda_runtime.h>

#include <cstdint>

#include "gf_common.cuh"

namespace {

__global__ void gf_bitmatmul_kernel(const uint8_t* __restrict__ tables,
                                    const uint8_t* __restrict__ in,
                                    uint8_t* __restrict__ out, int r, int k,
                                    int64_t n, int vec, int64_t tile_vec) {
  extern __shared__ __align__(16) uint8_t s_tab[];
  ctt::copy_to_shared16(s_tab, tables, r * k * 256);
  __syncthreads();
  const ctt::Span sp = ctt::block_span((n + 15) / 16, tile_vec, blockDim.x);
  for (int64_t v = sp.begin + threadIdx.x; v < sp.end; v += sp.step) {
    const int64_t col = v * 16;
    const int64_t rem = n - col;
    for (int i0 = 0; i0 < r; i0 += ctt::kMaxRows) {
      const int nrows = min(ctt::kMaxRows, r - i0);
      uint32_t a0[ctt::kMaxRows] = {0}, a1[ctt::kMaxRows] = {0};
      uint32_t a2[ctt::kMaxRows] = {0}, a3[ctt::kMaxRows] = {0};
      for (int j = 0; j < k; ++j) {
        uint32_t w[4];
        ctt::load16(in + j * n + col, rem, vec, w);
        ctt::gf_mac_word(a0, s_tab, k, j, i0, nrows, w[0]);
        ctt::gf_mac_word(a1, s_tab, k, j, i0, nrows, w[1]);
        ctt::gf_mac_word(a2, s_tab, k, j, i0, nrows, w[2]);
        ctt::gf_mac_word(a3, s_tab, k, j, i0, nrows, w[3]);
      }
#pragma unroll
      for (int i = 0; i < ctt::kMaxRows; ++i)
        if (i < nrows)
          ctt::store16(out + (i0 + i) * n + col, rem, vec, a0[i], a1[i],
                       a2[i], a3[i]);
    }
  }
}

}  // namespace

// tables (r, k, 256) uint8, in (k, n) uint8, out (r, n) uint8, all
// contiguous on the device and 16-byte aligned; tile = bytes of each
// row per block (a multiple of 16), 0 for the grid-stride launch.
// Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int ctt_gf_bitmatmul(const void* tables, const void* in, void* out,
                                int r, int k, long long n, long long tile,
                                void* stream) {
  const int threads = 256;
  const int smem = r * k * 256;
  const long long nvec = (n + 15) / 16;
  const long long blocks = ctt::span_blocks(nvec, tile / 16, threads);
  const int vec = (n % 16 == 0) ? 1 : 0;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(gf_bitmatmul_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gf_bitmatmul_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(out), r, k, static_cast<int64_t>(n), vec,
      static_cast<int64_t>(tile / 16));
  return static_cast<int>(cudaGetLastError());
}
