// K4 gf_bitmatmul_stream: out (r, n) = C (r, k) x in (k, n) over
// GF(2^8), bit-identical to K1, with the contraction split into G
// groups whose partial products are XOR-reduced.
//
// Replaces the Pallas kernel `_make_gf_kernel_w32_stream` reached
// through `gf_bitmatmul_pallas_w32(stream=True)` (ceph_tpu/ops/
// bitsliced.py:245, :294, :320-344), whose only caller is the
// ceph_tpu/tools/w32_sweep.py A/B against the all-planes kernel.  On
// the TPU the groups were bit planes: the MXU's 128-row contraction
// block and VMEM set their size, and a grid axis carried the XOR
// accumulator in scratch.  K1 has no bit planes — one table lookup
// covers all 8 planes of a byte — so its contraction axis is the k
// source rows, and K4 splits those.  The output contract is #7's; the
// layout and the `128 % (4k) == 0` rule of `_stream_group` are not
// (that rule is Mosaic's): K4 serves every k <= 32 and every width,
// ragged widths included, as K1 does.
//
// What bounds it on the H100: bytes, as for K1 (read k*n, write r*n).
// K1 measured the same time at 8 x 128 KiB as at 8 x 512 KiB: the
// chain of k*16*r dependent shared-memory lookups per thread sets its
// time, not device memory.  K4 puts G threads on each 16-byte column
// strip: the G lanes of a strip are adjacent in one warp, lane g takes
// the source rows j with j % G == g (groups of unequal size when G
// does not divide k, handled by the stride), builds the partial parity
// of all r rows from its rows, and G-1 rounds of __shfl_xor_sync leave
// the XOR of all partials in every lane of the strip.  Lane g then
// stores the rows i with i % G == g, so the stores spread over the
// group.  No shared memory is spent on the reduction: the only shared
// operand is the r*k*256-byte product table (6 KiB at k=8, m=3), as in
// K1, so the SMEM_LIMIT check is K1's.  16-byte loads and stores are
// kept on aligned widths; a warp-uniform loop keeps every lane at the
// shuffles, lanes past the edge reading nothing and storing nothing.
//
// G is chosen at launch by the wrapper (ops/bitsliced.stream_groups):
// the largest power of two <= min(8, k/2), so every lane owns at least
// two rows — with one row a lane spends as many shuffles on the
// reduction as lookups on its row.  k=8 gives G=4: a quarter of K1's
// lookup chain per thread, four times K1's threads per column.
#include <cuda_runtime.h>

#include <cstdint>

#include "gf_common.cuh"

namespace {

__global__ void gf_bitmatmul_stream_kernel(const uint8_t* __restrict__ tables,
                                           const uint8_t* __restrict__ in,
                                           uint8_t* __restrict__ out, int r,
                                           int k, int64_t n, int vec,
                                           int64_t tile_vec, int G) {
  extern __shared__ __align__(16) uint8_t s_tab[];
  ctt::copy_to_shared16(s_tab, tables, r * k * 256);
  __syncthreads();
  const int g = threadIdx.x & (G - 1);      // this lane's group
  const int strip = threadIdx.x / G;        // its strip within a pass
  const int per_pass = blockDim.x / G;      // strips a pass covers
  const int warp_first = (threadIdx.x & ~31) / G;  // the warp's first strip
  const ctt::Span sp = ctt::block_span((n + 15) / 16, tile_vec, per_pass);
  // warp-uniform: every lane of the warp takes the same trips, so all
  // 32 reach each shuffle
  for (int64_t base = sp.begin; base + warp_first < sp.end;
       base += sp.step) {
    const int64_t v = base + strip;
    const bool active = v < sp.end;
    const int64_t col = v * 16;
    const int64_t rem = active ? n - col : 0;
    for (int i0 = 0; i0 < r; i0 += ctt::kMaxRows) {
      const int nrows = min(ctt::kMaxRows, r - i0);
      uint32_t a0[ctt::kMaxRows] = {0}, a1[ctt::kMaxRows] = {0};
      uint32_t a2[ctt::kMaxRows] = {0}, a3[ctt::kMaxRows] = {0};
      if (active) {
        for (int j = g; j < k; j += G) {
          uint32_t w[4];
          ctt::load16(in + j * n + col, rem, vec, w);
          ctt::gf_mac_word(a0, s_tab, k, j, i0, nrows, w[0]);
          ctt::gf_mac_word(a1, s_tab, k, j, i0, nrows, w[1]);
          ctt::gf_mac_word(a2, s_tab, k, j, i0, nrows, w[2]);
          ctt::gf_mac_word(a3, s_tab, k, j, i0, nrows, w[3]);
        }
      }
      // XOR-reduce the G partials of the strip: the lanes of a group
      // differ only in their low log2(G) bits
      for (int o = 1; o < G; o <<= 1) {
#pragma unroll
        for (int i = 0; i < ctt::kMaxRows; ++i) {
          if (i < nrows) {
            a0[i] ^= __shfl_xor_sync(0xFFFFFFFFu, a0[i], o);
            a1[i] ^= __shfl_xor_sync(0xFFFFFFFFu, a1[i], o);
            a2[i] ^= __shfl_xor_sync(0xFFFFFFFFu, a2[i], o);
            a3[i] ^= __shfl_xor_sync(0xFFFFFFFFu, a3[i], o);
          }
        }
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < ctt::kMaxRows; ++i)
          if (i < nrows && (i & (G - 1)) == g)
            ctt::store16(out + (i0 + i) * n + col, rem, vec, a0[i], a1[i],
                         a2[i], a3[i]);
      }
    }
  }
}

}  // namespace

// tables (r, k, 256) uint8, in (k, n) uint8, out (r, n) uint8, all
// contiguous on the device and 16-byte aligned; tile = bytes of each
// row per block (a multiple of 16), 0 for the grid-stride launch;
// G = lanes per strip, a power of two in [1, 32].  Returns the CUDA
// error of the launch (0 = cudaSuccess).
extern "C" int ctt_gf_bitmatmul_stream(const void* tables, const void* in,
                                       void* out, int r, int k, long long n,
                                       long long tile, int G, void* stream) {
  if (G < 1 || G > 32 || (G & (G - 1))) return cudaErrorInvalidValue;
  const int threads = 256;
  const int smem = r * k * 256;
  const long long nvec = (n + 15) / 16;
  const long long blocks = ctt::span_blocks(nvec, tile / 16, threads / G);
  const int vec = (n % 16 == 0) ? 1 : 0;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(gf_bitmatmul_stream_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gf_bitmatmul_stream_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(out), r, k, static_cast<int64_t>(n), vec,
      static_cast<int64_t>(tile / 16), G);
  return static_cast<int>(cudaGetLastError());
}
