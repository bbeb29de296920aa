// K4 gf_bitmatmul_stream: out (r, n) = C (r, k) x in (k, n) over
// GF(2^8), bit-identical to K1, with the contraction (the k source rows)
// split into passes whose partial products are XOR-accumulated.
//
// Replaces the Pallas kernel `_make_gf_kernel_w32_stream` reached
// through `gf_bitmatmul_pallas_w32(stream=True)` (ceph_tpu/ops/
// bitsliced.py:245, :320-344).  On the TPU the contraction groups were
// bit planes: VMEM set their size, the group index was the innermost
// grid axis and a VMEM scratch carried the XOR accumulator.  Here one
// table lookup covers all 8 planes of a byte, so the contraction axis
// is the k source rows, and the resource a group must fit is one
// block's shared memory (227 KB): K4 splits the source rows into
// contiguous passes whose packed tables fit it.  That is the one shape
// class K1 does not serve (K1 raises where r*k*256 > 227 KB): the CLAY
// repair matrices of parallel/mesh.ClayRepairPlan, 64 x 176 at k=8 m=4
// d=11 and 81 x 270 at k=8 m=3 d=10.  The output contract is #7's; the
// `128 % (4k) == 0` rule of `_stream_group` is Mosaic's and is not kept:
// K4 serves every r, every k and every width, ragged widths included.
//
// What bounds it on the H100.  Device memory would move the k*n + r*n
// bytes in 18.8 us at 64 x 176 over 256 KiB (32 CLAY objects) and in
// 1.7 us at 8 x 512 KiB -> 3.  But every output group of four rows takes
// one shared-memory lookup per input byte, ceil(r/4)*k*n lookups in all,
// and 32 random lookups into a 256-word table meet about 3.15-way bank
// conflicts: the lookups' wavefronts bound K4 at every CLAY shape, some
// 25-40x above the bytes bound (PERF.md), and at narrow rows launch plus
// the blocks' table builds do, as for K1.
//
// The design (its launch is ops/bitsliced.k4_plan, a pure Python
// function whose values the entry takes and never re-chooses):
//  * K1's packed lookup (gf_packed.cuh): one 32-bit lookup per input
//    byte serves four output rows, then one 4x4 byte transpose a word.
//  * A block owns `groups_per_block` groups of four output rows
//    (blockIdx.y) and a column range (blockIdx.x, a tile or K1's grid
//    stride); it builds only its own groups' packed tables.  Where all
//    groups' tables over all k rows fit, that is every group in one pass
//    and K4 is K1's launch.
//  * Passes: source rows [jb, jb + rows_per_pass) at a time, the tables
//    of the pass built between two barriers.  The accumulator is the
//    block's own output columns in device memory (L2): the first pass
//    stores, later passes load, XOR and store.  Each thread reloads only
//    the words it stored itself, so no atomics and no fence are needed.
//    Registers were the alternative, with the next pass's tables staged
//    by cp.async into a second buffer; but then a thread must hold its
//    columns' accumulators over the whole block, which ties the column
//    range to the block's threads (4 KiB at 16 bytes a thread) and makes
//    the table build, k KiB a group, cost as much as the lookups it
//    serves, and two 135 KiB tables of 81 x 270 do not fit twice.  The
//    extra traffic of the global accumulator, 2*r*n bytes a later pass,
//    stays far below the lookups' time.
//  * One block an SM at the CLAY shapes (176 and 135 KiB of tables):
//    ceil(r/4) group blocks share a wave of 132, so a block's column
//    range is n / (132 / groups) wide and its table build a few percent
//    of its lookups.
#include <cuda_runtime.h>

#include <cstdint>

#include "gf_common.cuh"
#include "gf_packed.cuh"

namespace {

constexpr int kThreads = 256;
// Resident blocks an SM that the launch bounds guarantee, by words a
// thread (ops/bitsliced.K1_BLOCKS_PER_SM): 64 registers at 4 bytes, 128
// at 16.
template <int W>
constexpr int kMinBlocks = W == 1 ? 4 : 2;
constexpr int kSmemLimit = 232448;     // one block's shared memory on sm_90
constexpr int kTableBytesPerRow = 1024;  // a group's packed table, a row
constexpr int kMaxGroupBlocks = 65535;   // gridDim.y

// W = words of each row a thread takes (1 or 4), 4W bytes a unit; kVec:
// n % 4W == 0.  Block (x, y) applies groups [y*gpb, y*gpb + gpb) to its
// columns, rows_per_pass source rows a pass.
template <int W, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks<W>)
gf_bitmatmul_stream_kernel(const uint8_t* __restrict__ tables,
                           const uint8_t* __restrict__ in,
                           uint8_t* __restrict__ out, int r, int k,
                           int64_t n, int64_t tile_units, int gpb,
                           int rows_per_pass) {
  extern __shared__ __align__(16) uint32_t s_mem[];
  constexpr int unit = 4 * W;
  const ctt::Span sp =
      ctt::block_span((n + unit - 1) / unit, tile_units, blockDim.x);
  const int g0 = static_cast<int>(blockIdx.y) * gpb;
  const int ng = min(gpb, (r + 3) / 4 - g0);
  for (int jb = 0; jb < k; jb += rows_per_pass) {
    const int kp = min(rows_per_pass, k - jb);
    if (jb > 0) __syncthreads();        // the last pass's lookups are done
    ctt::build_packed(s_mem, tables, r, k, g0, ng, jb, kp);
    __syncthreads();
    const uint8_t* src = in + jb * n;
    for (int64_t v = sp.begin + threadIdx.x; v < sp.end; v += sp.step) {
      const int64_t col = v * unit;
      const int64_t rem = n - col;
      for (int gl = 0; gl < ng; ++gl) {
        const int i0 = 4 * (g0 + gl);
        const uint32_t* P = s_mem + gl * kp * 256;
        if (jb == 0)
          ctt::apply_group<W, kVec, false>(P, src, out, kp, n, col, rem, i0,
                                           min(4, r - i0));
        else
          ctt::apply_group<W, kVec, true>(P, src, out, kp, n, col, rem, i0,
                                          min(4, r - i0));
      }
    }
  }
}

template <int W, bool kVec>
int launch(const void* tables, const void* in, void* out, int r, int k,
           long long n, long long tile, long long col_blocks,
           int group_blocks, int gpb, int rows_per_pass, int smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(gf_bitmatmul_stream_kernel<W, kVec>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(static_cast<unsigned>(col_blocks),
                  static_cast<unsigned>(group_blocks));
  gf_bitmatmul_stream_kernel<W, kVec><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(out), r, k, static_cast<int64_t>(n),
      static_cast<int64_t>(tile / (4 * W)), gpb, rows_per_pass);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables (r, k, 256) uint8, in (k, n) uint8, out (r, n) uint8, all
// contiguous on the device and 16-byte aligned, r >= 1, n >= 1; tile =
// bytes of each row per block (a multiple of 16), 0 for the grid-stride
// launch; thread_bytes = 4 or 16; groups_per_block = groups of four
// output rows a block owns; rows_per_pass = source rows a pass;
// col_blocks = blocks along the columns (ops/bitsliced.k4_plan gives all
// four).  The grid is col_blocks x ceil(ceil(r/4) / groups_per_block).
// Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int ctt_gf_bitmatmul_stream(const void* tables, const void* in,
                                       void* out, int r, int k, long long n,
                                       long long tile, int thread_bytes,
                                       int groups_per_block,
                                       int rows_per_pass,
                                       long long col_blocks, void* stream) {
  if (r < 1 || k < 1 || n < 1 || 256LL * r * k >= (1LL << 31) ||
      groups_per_block < 1 || rows_per_pass < 1 || rows_per_pass > k)
    return cudaErrorInvalidValue;
  const long long smem =
      1LL * kTableBytesPerRow * groups_per_block * rows_per_pass;
  const long long group_blocks =
      ((r + 3) / 4 + groups_per_block - 1) / groups_per_block;
  if ((thread_bytes != 4 && thread_bytes != 16) || col_blocks < 1 ||
      col_blocks >= (1LL << 31) || group_blocks > kMaxGroupBlocks ||
      smem > kSmemLimit || tile % 16 || tile < 0)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  const int gb = static_cast<int>(group_blocks);
  const bool vec = n % thread_bytes == 0;
  if (thread_bytes == 16)
    return vec ? launch<4, true>(tables, in, out, r, k, n, tile, col_blocks,
                                 gb, groups_per_block, rows_per_pass, sm, s)
               : launch<4, false>(tables, in, out, r, k, n, tile, col_blocks,
                                  gb, groups_per_block, rows_per_pass, sm, s);
  return vec ? launch<1, true>(tables, in, out, r, k, n, tile, col_blocks,
                               gb, groups_per_block, rows_per_pass, sm, s)
             : launch<1, false>(tables, in, out, r, k, n, tile, col_blocks,
                                gb, groups_per_block, rows_per_pass, sm, s);
}
