// K1 gf_bitmatmul: out (r, n) = C (r, k) x in (k, n) over GF(2^8).
//
// Replaces the Pallas kernel `_make_gf_kernel_w32` reached through
// `gf_bitmatmul_pallas_w32` (ceph_tpu/ops/bitsliced.py:227, :294) and its
// byte-layout twin `_gf_kernel` (:122): the plain GF(2^8) matrix apply
// that serves every decode (inverted recovery matrix), the plain encode
// of overwrite extents and the plugin's device-resident entries.  The
// TPU kernel word-packs bytes and runs a (32r, 32k) 0/1 bit-matrix on
// the MXU; here the contract is kept (bytes in, bytes out, same values)
// and the TPU layout is not.
//
// What bounds it on the H100 (times in PERF.md).  Device memory would
// allow k*n + r*n bytes in 13.8 us at 8 x 4 MiB -> 3 and in 0.43 us at
// 8 x 128 KiB, but two other costs come first:
//  * At wide rows, the wavefronts of the shared-memory table lookups:
//    32 random indices into a 256-entry table of words meet about
//    3.15-way bank conflicts, so 8 x 4 MiB at one lookup a byte needs
//    about 25k wavefront cycles an SM, some 14 us.  The first design took
//    one lookup a byte and output row (384 a 16-byte strip at m=3).
//  * At narrow rows, launch plus the block's table staging plus one
//    thread's chain of loads and lookups.  The first design's grid of one
//    16-byte strip a thread left 100-128 of the 132 SMs idle up to 512 KiB a
//    row, so the chain of 384 lookups set its time at every width.
//
// The design against each:
//  * One 32-bit lookup per input byte for up to four output rows.  For
//    source row j and output rows i0..i0+3 (a "group"), the packed table
//    P[g][j][x] is the uint32 whose byte t is C[i0+t][j] * x (0 past the
//    last row).  A thread XORs P[g][j][byte b of its input word] into
//    accumulator b over all j, so accumulator b holds the four rows'
//    products of column b; one 4x4 byte transpose (8 __byte_perm) per
//    word and group then gives the four rows' output words.  At m=3 that
//    is 128 lookups a 16-byte strip, not 384, and at r=2 (a decode of
//    two shards) 128, not 256.  P takes k KiB a group (8 KiB at k=8,
//    r <= 4); every block builds it at its start straight from the
//    (r, k, 256) byte tables in device memory (they sit in L2), so the
//    operand is unchanged and nothing is cached between launches.
//  * A grid sized by the width (ops/bitsliced.k1_launch, a pure Python
//    function that passes `thread_bytes` and `blocks` in): a thread takes
//    4 bytes of every row where 16 would give too few threads to fill
//    the card (below 3 KiB of each row an SM), 16 otherwise, and the
//    grid is at most one wave of the blocks the launch bounds keep
//    resident, striding over the rest.  A `tile` (bytes of each row per
//    block, the launch parameter tools/w32_sweep sweeps) gives block b
//    the columns [b*tile, (b+1)*tile) instead.
//
// Shared memory (ops/bitsliced.k1_smem, the host's mirror of this layout):
// all ceil(r/4) groups' P at once when they fit in one block's 227 KB;
// otherwise passes of one group (k KiB), staged in turn between two
// barriers; where even one group does not fit (k > 227), the first
// design's loop over the r*k*256-byte byte tables, one lookup per byte
// and row, as a branch of the same kernel.  Rows are read with 16-byte
// (or 4-byte) loads and written with stores of the same width where the
// width keeps them aligned; a ragged width takes a byte-masked path,
// compiled apart (kVec) so it costs the aligned path no registers.
#include <cuda_runtime.h>

#include <cstdint>

#include "gf_common.cuh"
#include "gf_packed.cuh"

namespace {

constexpr int kThreads = 256;
// Resident blocks an SM that the launch bounds guarantee, by words a
// thread (ops/bitsliced.K1_BLOCKS_PER_SM sizes a wave by them): at most
// 64 registers a thread at 4 bytes, 128 at 16.
template <int W>
constexpr int kMinBlocks = W == 1 ? 4 : 2;
constexpr int kSmemLimit = 232448;  // one block's shared memory on sm_90

// W = words of each row a thread takes (1 or 4), 4W bytes a unit; kVec:
// n % 4W == 0.  stage_groups > 0: the packed path, that many groups' P
// staged a pass; 0: the byte-table loop (k > 227).
template <int W, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks<W>)
gf_bitmatmul_kernel(const uint8_t* __restrict__ tables,
                    const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int r, int k, int64_t n, int64_t tile_units,
                    int stage_groups) {
  extern __shared__ __align__(16) uint32_t s_mem[];
  constexpr int unit = 4 * W;
  const ctt::Span sp =
      ctt::block_span((n + unit - 1) / unit, tile_units, blockDim.x);
  if (stage_groups == 0) {
    uint8_t* s_tab = reinterpret_cast<uint8_t*>(s_mem);
    ctt::copy_to_shared16(s_tab, tables, r * k * 256);
    __syncthreads();
    for (int64_t v = sp.begin + threadIdx.x; v < sp.end; v += sp.step) {
      const int64_t col = v * unit;
      const int64_t rem = n - col;
      for (int i0 = 0; i0 < r; i0 += ctt::kMaxRows) {
        const int nrows = min(ctt::kMaxRows, r - i0);
        uint32_t a[W][ctt::kMaxRows] = {};
        for (int j = 0; j < k; ++j) {
          uint32_t x[W];
          ctt::load_words<W, kVec>(in + j * n + col, rem, x);
#pragma unroll
          for (int w = 0; w < W; ++w)
            ctt::gf_mac_word(a[w], s_tab, k, j, i0, nrows, x[w]);
        }
#pragma unroll
        for (int i = 0; i < ctt::kMaxRows; ++i) {
          if (i < nrows) {
            uint32_t row[W];
#pragma unroll
            for (int w = 0; w < W; ++w) row[w] = a[w][i];
            ctt::store_words<W, kVec>(out + (i0 + i) * n + col, rem, row);
          }
        }
      }
    }
    return;
  }
  const int ngroups = (r + 3) / 4;
  for (int g0 = 0; g0 < ngroups; g0 += stage_groups) {
    const int ng = min(stage_groups, ngroups - g0);
    if (g0 > 0) __syncthreads();        // the last pass's lookups are done
    ctt::build_packed(s_mem, tables, r, k, g0, ng, 0, k);
    __syncthreads();
    for (int64_t v = sp.begin + threadIdx.x; v < sp.end; v += sp.step) {
      const int64_t col = v * unit;
      const int64_t rem = n - col;
      for (int gl = 0; gl < ng; ++gl) {
        const int i0 = 4 * (g0 + gl);
        ctt::apply_group<W, kVec>(s_mem + gl * k * 256, in, out, k, n, col,
                                  rem, i0, min(4, r - i0));
      }
    }
  }
}

template <int W, bool kVec>
int launch(const void* tables, const void* in, void* out, int r, int k,
           long long n, long long tile, long long blocks, int stage_groups,
           int smem, cudaStream_t stream) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(gf_bitmatmul_kernel<W, kVec>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gf_bitmatmul_kernel<W, kVec><<<static_cast<unsigned>(blocks), kThreads,
                                 smem, stream>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(out), r, k, static_cast<int64_t>(n),
      static_cast<int64_t>(tile / (4 * W)), stage_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables (r, k, 256) uint8, in (k, n) uint8, out (r, n) uint8, all
// contiguous on the device and 16-byte aligned; tile = bytes of each row
// per block (a multiple of 16), 0 for the grid-stride launch;
// thread_bytes = 4 or 16; blocks >= 1 (ops/bitsliced.k1_launch);
// stage_groups = groups of four rows whose packed tables a pass stages,
// 0 for the byte-table branch (ops/bitsliced.k1_smem).  Returns the CUDA
// error of the launch (0 = cudaSuccess).
extern "C" int ctt_gf_bitmatmul(const void* tables, const void* in, void* out,
                                int r, int k, long long n, long long tile,
                                int thread_bytes, long long blocks,
                                int stage_groups, void* stream) {
  const long long smem = stage_groups > 0
                             ? 1024LL * stage_groups * k
                             : 256LL * r * k;
  if ((thread_bytes != 4 && thread_bytes != 16) || blocks < 1 ||
      blocks >= (1LL << 31) || stage_groups < 0 || smem > kSmemLimit ||
      tile % 16)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  const bool vec = n % thread_bytes == 0;
  if (thread_bytes == 16)
    return vec ? launch<4, true>(tables, in, out, r, k, n, tile, blocks,
                                 stage_groups, sm, s)
               : launch<4, false>(tables, in, out, r, k, n, tile, blocks,
                                  stage_groups, sm, s);
  return vec ? launch<1, true>(tables, in, out, r, k, n, tile, blocks,
                               stage_groups, sm, s)
             : launch<1, false>(tables, in, out, r, k, n, tile, blocks,
                                stage_groups, sm, s);
}
