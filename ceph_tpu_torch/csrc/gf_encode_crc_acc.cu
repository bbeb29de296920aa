// K2 gf_encode_crc and K3 gf_encode_crc_acc: parity (m, n) = C (m, k) x
// data (k, n) over GF(2^8) and crc32c linear parts L of all k+m shard
// rows, from one launch.  K2 runs one per-block body, the kernel template
// below, instantiated twice (the shape branches of kLaneTables).  K3
// walks contiguous ranges of blocks (k3_walk_kernel, at the end of the
// file).  K5 crc32c_rows runs the same crc machinery with no parity, one
// warp a range of blocks.  The three share the tables, the lane crc
// chains and the fold.
//
// K2 writes L = crc(block, 0) of every B-byte block of every shard row.
// It replaces three Pallas kernels that compute that function and
// differ only in how the TPU's VMEM split the crc matrix or laid out
// the bytes:
//   #1 `_make_gf_crc_kernel_w32_hier` (ceph_tpu/ops/bitsliced.py:523,
//      via `_fused_hier_call` :586): L per 4*wb-byte sub-block;
//   #2 `_make_gf_crc_kernel_w32` (:437, via
//      `gf_encode_with_crc_pallas_w32` :459): L per 2 KiB tile;
//   #6 `_gf_crc_kernel` (:385, via `gf_encode_with_crc_pallas` :411):
//      the same on the byte layout.
// All three entries launch it with their block size B.  A block's L
// goes straight to its slot: no run search, no advance, no atomics and
// no zero-fill.
//
// K3 writes one L = crc(run, 0) per (run, shard row).  The n columns
// are a drain's runs laid end to end, each front-padded with zeros to
// a multiple of the block B = 4*wb; a zero prefix leaves L unchanged
// (L(0^p || X) = L(X)) and encodes to zero parity, so each run's L
// covers its every byte and the host folds no tail.  It replaces the
// Pallas kernel `_make_gf_crc_kernel_w32_hier_acc`
// (ceph_tpu/ops/bitsliced.py:539, via `_fused_hier_acc_call` :626),
// which walks a sequential grid and keeps each run's L in an output
// block resident in VMEM, folding acc <- A_tile . acc ^ L(tile) step by
// step.  Its design is at k3_walk_kernel.
//
// What bounds K2's body on the H100.  Device memory would allow the k
// data rows in and the m parity rows out in 1.7 us at 8+3 x 512 KiB,
// but a 512 KiB row is 256 blocks of 2 KiB, about two an SM, so the
// time is one block's chain of steps, each bound by its latency or by
// the instructions and shared-memory wavefronts of the blocks on its SM
// (tools/k3_phases.py stamped the steps of the same body in K3).  The
// body shortens each:
//  * Staging: every word of the k rows is queued at once with a 4-byte
//    cp.async into rows padded after each lane's piece, so the crc's
//    reads hit 32 distinct banks.  The tables' gathers from device
//    memory go out before the copies, so they do not queue behind them;
//    the tables are built while the copies fly.
//  * Parity by packed nibble tables: one lookup serves four parity
//    rows (byte t of the entry is row t's product, as K1's packed
//    table), two lookups a byte, each into 16 consecutive words, so a
//    warp's lookups never meet in a bank; one 4x4 byte transpose a word
//    (gf_common.cuh transpose4) gives the rows' words.
//  * crc without bank conflicts: every lane has its own copy of the
//    256-entry crc table, entry e of lane l at word 32*e + l (32 KiB,
//    built in the block from one computed entry a lane and 32
//    shuffles), and runs four independent chains over the quarters of
//    its piece, their lookups interleaved.
//  * A fold of one matvec a lane, by nibble tables (8 lookups of 16
//    entries, no bit loop): the quarters join by the chain operators
//    A_{(B/128) * j}, then lane l applies its own A_{(B/32) * (31 - l)}
//    and five xor-shuffles sum the warp:
//    L(block) = XOR_l A_{(B/32)(31-l)} . L_l.
//  * 12 warps, so up to 12 shard rows each take one warp.
// Shared memory (ops/bitsliced._crc_smem_bytes, the host's mirror): the
// parity's nibble tables (1 KiB a group of four parity rows at k = 8),
// the lane crc tables (32 KiB), the fold's nibble tables (17.5 KiB), k+m
// staged rows and 16 bytes: the layout of a one-stage K3 walk, whose run
// slot K2 leaves unused.  Where that does not fit one block (k+m rows of
// 4-8 KiB), K2 takes its narrow branch, chosen by the shape alone
// (ops/bitsliced.k2_lane_tables): one crc table the lanes share (its
// lookups meet in banks) and no fold tables, the lane and chain
// operators applied bit by bit from their columns in device memory
// (through L1).  The grid (ops/bitsliced.k3_launch with acc=False) is at
// most one wave of the blocks the launch bounds and the shared memory
// keep resident; blocks stride over the rest, building their tables
// once.
#include <cuda_runtime.h>

#include <cstdint>

#include "gf_common.cuh"

namespace {

constexpr int kThreads = 384;           // K2: 12 warps
constexpr int kMinBlocks = 3;           // K2 blocks an SM by the launch bounds
constexpr int kMaxThreadsPerSm = 2048;
constexpr int kSmSmem = 233472;         // shared memory of one SM
constexpr int kSmemReserved = 1024;     // kept by the card for each block
constexpr int kSmemLimit = 232448;      // one block's shared memory
constexpr int kDigitBits = 8;           // the advance table's base: 256
constexpr int kMaxDigits = 4;
constexpr int kMaxChains = 4;           // interleaved crc chains a lane
constexpr int kOpCols = 32 * 32 + (kMaxChains - 1) * 32;  // fold + chain ops
// nibble tables of the fold: 8 x 16 words per operator, a copy per lane
// (word (16*i + v)*32 + lane) for the lane operators, one for each chain
// operator
constexpr int kNibWords = 8 * 16 * 32 + (kMaxChains - 1) * 8 * 16;

// Pad words after each lane's piece of a staged row: one, or two where
// the piece has an odd number of words, so that wpp + pad is odd and
// lane l's word t, at l*(wpp+pad) + t, lies in a bank of its own.
__host__ __device__ inline int k3_pad(int B) { return (B / 128) & 1 ? 2 : 1; }

__host__ __device__ inline int k3_row_words(int B) {
  return B / 4 + 32 * k3_pad(B);
}

// Independent crc chains a lane runs over its piece (B/128 words): 4,
// 2 or 1, whichever divides the piece.
__host__ __device__ inline int k3_chains(int B) {
  const int wpp = B / 128;
  return wpp % 4 == 0 ? 4 : wpp % 2 == 0 ? 2 : 1;
}

// Bytes of shared memory of one K2 block: with the lane crc tables and
// the fold's nibble tables (a one-stage K3 walk's layout), or the narrow
// one with one crc table and no fold tables.
inline long long block_smem_bytes(int m, int k, int B, bool lane_tables) {
  const long long groups = (m + 3) / 4;
  return 4LL * (groups * k * 32 + (lane_tables ? 256 * 32 + kNibWords : 256) +
                static_cast<long long>(k + m) * k3_row_words(B)) + 16;
}

#ifdef CTT_K3_PHASES
// Phase probe (tools/k3_phases.py builds this file with CTT_K3_PHASES):
// thread 0 of every thread block of K3 or K5 stamps clock64() and
// %globaltimer at the points listed at each kernel, into the buffer the
// probe's entry sets.
constexpr int kPhases = 9;
__device__ unsigned long long* g_k3_phases;
__device__ inline unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_STAMP(i, v)                                                 \
  do {                                                                    \
    if (threadIdx.x == 0 && g_k3_phases)                                  \
      g_k3_phases[blockIdx.x * kPhases + (i)] = (v);                      \
  } while (0)
#define PROBE_SYNC() __syncthreads()
#else
#define PHASE_STAMP(i, v) do {} while (0)
#define PROBE_SYNC() do {} while (0)
#endif

__device__ inline void cp_async4(unsigned dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Queue the copy of the B-byte column at col0 of the k data rows into
// the padded rows: one 4-byte cp.async a word, all in flight at once;
// a thread takes one column word of every row at a time.
__device__ inline void stage_rows_async(uint32_t* rows, const uint8_t* in,
                                        int k, int64_t n, int64_t col0,
                                        int B, int S, int wpp, int pad) {
  const uint32_t* src0 = reinterpret_cast<const uint32_t*>(in + col0);
  const int64_t rs = n / 4;                   // words of a data row
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(rows));
  for (int w = threadIdx.x; w < B / 4; w += blockDim.x) {
    const unsigned dst = base + 4u * (w + (w / wpp) * pad);
    const uint32_t* src = src0 + w;
    for (int j = 0; j < k; ++j)
      cp_async4(dst + 4u * j * S, src + j * rs);
  }
}

// Nibble tables of the packed parity: for group g of four rows and
// source row j, T[(g*k + j)*32 + 16*h + v] is the word whose byte t is
// C[4g+t][j] * (v << 4h) (0 past the last row).  A byte x then costs two
// lookups, T[x & 15] ^ T[16 + (x >> 4)], each into 16 consecutive words,
// so 32 lanes' lookups never meet in a bank.  Entry `it` of T, gathered
// from the (m, k, 256) byte tables in device memory:
__device__ inline uint32_t nibble_packed_word(const uint8_t* tables, int m,
                                              int k, int it) {
  const int gj = it >> 5, e = it & 31;
  const int g = gj / k, j = gj - g * k;
  const int x = e < 16 ? e : (e - 16) << 4;
  uint32_t word = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = 4 * g + t;
    if (i < m)
      word |= static_cast<uint32_t>(__ldg(tables + (i * k + j) * 256 + x))
              << (8 * t);
  }
  return word;
}

// Entry e of the crc32c byte table.
__device__ inline uint32_t crc_table_entry(uint32_t c) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
    c = (c >> 1) ^ (ctt::kCrcPoly & (0u - (c & 1u)));
  return c;
}

// The lane crc tables: entry e of lane l at ltab[32*e + l].  A warp
// computes 32 entries, one a lane, and writes each to its 32 lanes'
// words with a shuffle, so every store is one conflict-free wavefront.
__device__ inline void build_lane_crc_table(uint32_t* ltab, int lane,
                                            int warp, int nwarps) {
  for (int e0 = 32 * warp; e0 < 256; e0 += 32 * nwarps) {
    const uint32_t c = crc_table_entry(static_cast<uint32_t>(e0 + lane));
#pragma unroll 8
    for (int i = 0; i < 32; ++i)
      ltab[(e0 + i) * 32 + lane] = __shfl_sync(0xFFFFFFFFu, c, i);
  }
}

// Nibble tables of the fold's operators from their 32 columns (ops):
// entry v of table i of an operator is A . (v << 4i), the XOR of
// columns 4i .. 4i+3 that v selects.  Item `it` < kFoldItems is one
// table: for it < 256, table it >> 5 of lane it & 31's operator (column
// b of lane l at ops[32*b + l]), to nib[(16*i + v)*32 + l], a copy per
// lane; then table (it - 256) & 7 of chain operator (it - 256) >> 3
// (ops[1024 + 32*(j-1) + b]), to nib[4096 + 128*(j-1) + 16*i + v].  Its
// four columns are loaded by fold_item_load, its 16 entries stored by
// fold_item_store.
constexpr int kFoldItems = 32 * 8 + (kMaxChains - 1) * 8;
static_assert(kFoldItems <= kThreads, "one fold item a thread");

__device__ inline void fold_item_load(const uint32_t* ops, int it,
                                      uint32_t (&c)[4]) {
  if (it < 256) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      c[b] = __ldg(ops + 32 * (4 * (it >> 5) + b) + (it & 31));
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      c[b] = __ldg(ops + 32 * 32 + 32 * ((it - 256) >> 3) +
                   4 * ((it - 256) & 7) + b);
  }
}

__device__ inline void fold_item_store(uint32_t* nib, int it,
                                       const uint32_t (&c)[4]) {
  uint32_t* dst;
  int stride;
  if (it < 256) {
    dst = nib + 16 * (it >> 5) * 32 + (it & 31);
    stride = 32;
  } else {
    dst = nib + 8 * 16 * 32 + 128 * ((it - 256) >> 3) + 16 * ((it - 256) & 7);
    stride = 1;
  }
#pragma unroll
  for (int v = 0; v < 16; ++v)
    dst[v * stride] = ((v & 1) ? c[0] : 0u) ^ ((v & 2) ? c[1] : 0u) ^
                      ((v & 4) ? c[2] : 0u) ^ ((v & 8) ? c[3] : 0u);
}

// A . x by an operator's nibble tables (8 tables of 16 entries, entry v
// of table i at t[(16*i + v) * stride]).
__device__ inline uint32_t apply_nibbles(const uint32_t* t, int stride,
                                         uint32_t x) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r ^= t[(16 * i + ((x >> (4 * i)) & 15u)) * stride];
  return r;
}

// A . x by an operator's 32 columns in device memory (column b at
// col[b * stride]), bit by bit: K2's narrow branch, which has no room
// for the nibble tables.
__device__ inline uint32_t apply_columns(const uint32_t* col, int stride,
                                         uint32_t x) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b)
    r ^= __ldg(col + b * stride) & (0u - ((x >> b) & 1u));
  return r;
}

// Parity of the staged column: one 4-byte word of every parity row per
// thread and step, two nibble lookups per data byte and group of four
// rows, one 4x4 byte transpose a word and group; into the staged parity
// rows and to `parity`.
__device__ inline void encode_staged(uint32_t* rows, const uint32_t* T,
                                     uint8_t* parity, int m, int k,
                                     int64_t n, int64_t col0, int B, int S,
                                     int wpp, int pad) {
  const int groups = (m + 3) / 4;
  for (int w = threadIdx.x; w < B / 4; w += blockDim.x) {
    const int pw = w + (w / wpp) * pad;
    for (int g = 0; g < groups; ++g) {
      const uint32_t* Tg = T + g * k * 32;
      uint32_t acc[4] = {0u, 0u, 0u, 0u};
      for (int j0 = 0; j0 < k; j0 += 4) {
        uint32_t x[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          x[jj] = j0 + jj < k ? rows[(j0 + jj) * S + pw] : 0u;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (j0 + jj < k) {
            const uint32_t* Tj = Tg + (j0 + jj) * 32;
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[b] ^= Tj[(x[jj] >> (8 * b)) & 15u] ^
                        Tj[16 + ((x[jj] >> (8 * b + 4)) & 15u)];
          }
        }
      }
      ctt::transpose4(acc);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 4 * g + t;
        if (i < m) {
          rows[(k + i) * S + pw] = acc[t];
          reinterpret_cast<uint32_t*>(parity + i * n + col0)[w] = acc[t];
        }
      }
    }
  }
}

// L of lane l's piece (wpp words at p, from state `seed`, 0 but for
// K5's lane 0) by its crc table
// (entry e at lt[32*e] with lane tables, else lt[e]): `chains`
// independent chains over consecutive sub-pieces of wpp/chains words,
// their lookups interleaved, each word XORed in whole before its four
// byte steps; then joined by the chain operators A_{(B/32/chains) * j},
// j = 1.. (with lane tables their nibble tables at `chain`, 128 words
// each; else their columns, 32 words each).
template <bool kLaneTables>
__device__ inline uint32_t lane_piece_crc(const uint32_t* p,
                                          const uint32_t* lt,
                                          const uint32_t* chain, int wpp,
                                          int chains, uint32_t seed = 0u) {
  constexpr int kShift = kLaneTables ? 5 : 0;
  const int wpc = wpp / chains;
  uint32_t crc[kMaxChains] = {seed, 0u, 0u, 0u};
  for (int t = 0; t < wpc; ++t) {
    uint32_t x[kMaxChains];
#pragma unroll
    for (int c = 0; c < kMaxChains; ++c)
      x[c] = c < chains ? p[c * wpc + t] ^ crc[c] : 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < kMaxChains; ++c)
        if (c < chains) x[c] = lt[(x[c] & 0xFFu) << kShift] ^ (x[c] >> 8);
#pragma unroll
    for (int c = 0; c < kMaxChains; ++c) crc[c] = x[c];
  }
  uint32_t l = 0;
#pragma unroll
  for (int c = 0; c < kMaxChains; ++c) {
    if (c < chains) {
      const int j = chains - 1 - c;        // sub-pieces after chain c
      if (j == 0)
        l ^= crc[c];
      else if constexpr (kLaneTables)
        l ^= apply_nibbles(chain + 128 * (j - 1), 1, crc[c]);
      else
        l ^= apply_columns(chain + 32 * (j - 1), 1, crc[c]);
    }
  }
  return l;
}

// K2: one thread block's walk over its B-byte blocks, striding by the
// grid; each block's L goes to slot (row, block) of `lout`.
// kLaneTables: the lane crc tables and the fold's nibble tables; else
// the narrow branch (one crc table, the operators' columns read from
// `ops`).
template <bool kLaneTables>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gf_encode_crc_kernel(const uint8_t* __restrict__ tables,
                     const uint8_t* __restrict__ in,
                     uint8_t* __restrict__ parity,
                     unsigned long long* __restrict__ lout,
                     const uint32_t* __restrict__ ops, int m, int k,
                     int64_t n, int B) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int groups = (m + 3) / 4;
  const int S = k3_row_words(B);
  uint32_t* T = smem;                          // groups * k * 32 words
  uint32_t* ltab = T + groups * k * 32;        // 256 * 32 words, or 256
  uint32_t* nib = ltab + (kLaneTables ? 256 * 32 : 256);  // kNibWords, or 0
  uint32_t* rows = nib + (kLaneTables ? kNibWords : 0);   // k + m rows of S

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int wpp = B / 128;                     // words of a lane's piece
  const int pad = k3_pad(B);
  const int chains = k3_chains(B);
  // the crc table a lane reads, the chain and the lane fold operators
  const uint32_t* lt = kLaneTables ? ltab + lane : ltab;
  const uint32_t* chain = kLaneTables ? nib + 8 * 16 * 32 : ops + 32 * 32;

  const int nT = groups * k * 32;               // entries of T
  const int64_t nblocks = n / B;
  for (int64_t blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const bool first_tile = blk == blockIdx.x;
    // the previous block's crcs have read the rows
    if (!first_tile) __syncthreads();
    // the first block's table gathers go out before the staging copies,
    // so they do not queue behind them
    uint32_t tword = 0, fcol[4];
    const bool fold_item =
        kLaneTables && first_tile && threadIdx.x < kFoldItems;
    if (first_tile && threadIdx.x < nT)
      tword = nibble_packed_word(tables, m, k, threadIdx.x);
    if (fold_item) fold_item_load(ops, threadIdx.x, fcol);
    stage_rows_async(rows, in, k, n, blk * B, B, S, wpp, pad);
    if (first_tile) {
      // the copies are in flight: build the tables (the lane crc tables
      // by warps 0-7)
      if (kLaneTables)
        build_lane_crc_table(ltab, lane, warp, nwarps);
      else if (threadIdx.x < 256)
        ltab[threadIdx.x] = crc_table_entry(threadIdx.x);
      if (threadIdx.x < nT) T[threadIdx.x] = tword;
      for (int it = threadIdx.x + blockDim.x; it < nT; it += blockDim.x)
        T[it] = nibble_packed_word(tables, m, k, it);
      if (fold_item) fold_item_store(nib, threadIdx.x, fcol);
    }
    cp_async_wait_all();
    __syncthreads();
    encode_staged(rows, T, parity, m, k, n, blk * B, B, S, wpp, pad);
    __syncthreads();
    for (int row = warp; row < k + m; row += nwarps) {
      const uint32_t lcrc = lane_piece_crc<kLaneTables>(
          rows + row * S + lane * (wpp + pad), lt, chain, wpp, chains);
      // lane l's A_{(B/32)(31-l)}, then the warp's sum: L of the block
      uint32_t crc;
      if constexpr (kLaneTables)
        crc = apply_nibbles(nib + lane, 32, lcrc);
      else
        crc = apply_columns(ops + lane, 32, lcrc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        crc ^= __shfl_xor_sync(0xFFFFFFFFu, crc, o);
      if (lane == 0) lout[row * nblocks + blk] = crc;   // zero-extended
    }
  }
}

// Launch one K2 instantiation with `smem` bytes of shared memory on a
// grid of at most one wave (ops/bitsliced.k3_launch with acc=False);
// returns the CUDA error.
template <bool kLaneTables>
int launch(const void* tables, const void* in, void* parity, void* lout,
           const void* ops, int m, int k, long long n, int B,
           long long smem, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long per_sm = kMinBlocks;
  if (per_sm > kMaxThreadsPerSm / kThreads)
    per_sm = kMaxThreadsPerSm / kThreads;
  if (per_sm > kSmSmem / (smem + kSmemReserved))
    per_sm = kSmSmem / (smem + kSmemReserved);
  if (per_sm < 1) per_sm = 1;
  long long blocks = n / B;
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  if (blocks < 1) blocks = 1;
  // granted once for the largest size seen (a first call with a shape
  // runs before any CUDA-graph capture of it, so capture sees no
  // attribute call)
  static int granted = 48 * 1024;
  const int sm = static_cast<int>(smem);
  if (sm > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        gf_encode_crc_kernel<kLaneTables>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = sm;
  }
  gf_encode_crc_kernel<kLaneTables>
      <<<static_cast<unsigned>(blocks), kThreads, sm,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(tables),
          static_cast<const uint8_t*>(in), static_cast<uint8_t*>(parity),
          static_cast<unsigned long long*>(lout),
          static_cast<const uint32_t*>(ops), m, k, static_cast<int64_t>(n),
          B);
  return static_cast<int>(cudaGetLastError());
}

// K5 crc32c_rows: one L = crc(body, 0) per row of many byte rows of
// different lengths, the deep-scrub verify (ceph_tpu_torch/osd/scrub.py).
// It replaces the jitted jnp program `_rows_l` of `crc32c_rows_device`
// (ceph_tpu/ops/crc32c_linear.py:189, :202), which front-pads the rows
// to pow2 buckets, computes one L per 2 KiB block by the tile matrix and
// folds them with the log-depth combine, one launch per bucket.
//
// Here the rows' bodies (whole B-byte blocks; the host folds the tails)
// are laid end to end with no padding, and row_ends holds each row's
// cumulative block end.  Scrub rows share no block grid (a chunk mixes
// objects and shard widths), so K2's one warp per shard row of a
// column would idle most warps.  Instead each warp takes one
// contiguous range of the concatenation's blocks, the ranges balanced
// to within one block, and walks it in order with a running L of the
// row it is in:
//
//     L <- A_B . L ^ L(block)
//
// which costs nothing beyond the block's own L: lane 0 seeds its first
// chain with L instead of 0 (lane_piece_crc, scrub_piece_crc), and the
// chain and lane fold operators that carry that chain to the block's
// end advance L by B bytes with it; the map is linear, so the result is
// exact.  At a row end inside the range the warp XORs L into the row's
// slot as it is and restarts from 0; at the range's end inside a row
// it advances L once by the row's blocks after the range (the base-256
// digit tables of k3_ops) and XORs it.  The row is searched once, at
// the range's start; the walk then steps to the next row with a body
// as it crosses a row end, the next row's end loaded ahead.  Rows that
// span several ranges get one XOR from each, in any order, into the
// slot that the wrapper zero-fills on the same stream.
//
// What bounds it on the H100.  The bytes take 20.7 us at a 64 MiB chunk
// (3.35 TB/s).  K5's first design (one block at a time a warp,
// grid-strided) took 72 us: tools/k3_phases.py --kernel k5 stamped its
// first block at ~4.2k SM cycles of staging through registers, ~3.5k
// of row search (8 dependent loads), ~5.9k of chains and fold and ~1.3k
// of advance and atomic, paid again for each of a warp's ~11 blocks
// with nothing in flight.  The redesign:
//  * One row search and at most one digit advance a range, one atomic
//    a row end met and one at the range's end (~warps + rows a launch,
//    not one a block).  The search is the warp's (warp_row_search):
//    32 probes a round, 2 rounds at 132 rows.
//  * Two rows a warp and the bytes two blocks ahead: the range's first
//    two blocks are queued at its start, and block i+2 into the row
//    that block i leaves, so a block's copy flies while two blocks
//    compute (cp.async.wait_group 1).
//  * The scrub block compiles apart (kB = kScrubB): staging, chains and
//    fold unrolled; its rows laid out with 4 pad words a lane piece, so
//    16-byte cp.async fills them and each lane reads its piece in four
//    16-byte loads that a quarter-warp takes from 32 distinct banks;
//    kScrubChains = 2 chains of 8 words a lane (8 join lookups instead
//    of 24; 1 chain ran as fast, 4 chains 6% slower).  Any other B runs
//    K3's layout (k3_pad) and lane_piece_crc, B at run time.
//  * Fewer, longer-lived thread blocks: one block of 32 warps an SM
//    (two rows a warp and the tables fill its shared memory), so the
//    lane crc tables and the fold's nibble tables are built once an SM
//    instead of three times (3.1% of the first design's block time; left
//    as they are).  The fold operators' gathers go out first, then the
//    search, then the first copies; the tables are built while they
//    fly.
// After it the probe puts the first block staged at ~12.7k cycles and
// the walk at ~5.5k cycles a block a warp, ~172 an SM: 2 KiB an SM in
// that time is ~3.06 TB/s over 132 SMs, so the walk is bound by device
// memory and the rest is the start.
// rows_warps and rows_smem_bytes (ops/bitsliced.k5_warps and k5_smem,
// the host's mirror) size the block by B; offsets are 64-bit.
constexpr int kRowsMaxWarps = 32;       // one 1024-thread block an SM
constexpr int kRowsMinBlocks = 1;
constexpr long long kRowsTableBytes = 4LL * (256 * 32 + kNibWords);
// The scrub block (crc32c_linear.SCRUB_BLOCK), which K5 compiles apart:
// lane l's 16-word piece at word kScrubStride * l, 4 pad words after it,
// so that a quarter-warp's 16-byte loads of their pieces hit 32
// distinct banks (80-byte strides) and 16-byte cp.async fills them.
constexpr int kScrubB = 2048;
constexpr int kScrubStride = 20;
constexpr int kScrubChains = 2;         // chains a lane, 8 words each

// Words of one of a K5 warp's staged rows: the scrub block's layout, or
// K3's (k3_row_words) at any other B.
__host__ __device__ inline int rows_row_words(int B) {
  return B == kScrubB ? 32 * kScrubStride : k3_row_words(B);
}

// Warps of a K5 block: as many as one block's shared memory holds two
// staged rows of B bytes each beside the tables, at most kRowsMaxWarps
// (0: none fits).
inline int rows_warps(int B) {
  const long long w =
      (kSmemLimit - kRowsTableBytes) / (8LL * rows_row_words(B));
  return static_cast<int>(w < kRowsMaxWarps ? w : kRowsMaxWarps);
}

inline long long rows_smem_bytes(int B) {
  return kRowsTableBytes + 8LL * rows_warps(B) * rows_row_words(B);
}

__device__ inline void cp_async16(unsigned dst, const uint4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// Queue the copy of one scrub block (128 16-byte chunks at src) into a
// warp's row at shared address dst: chunk v (words 4v .. 4v+3, in lane
// v/4's piece) to word kScrubStride * (v/4) + 4 * (v%4), lane l taking
// chunks l, l+32, l+64, l+96.
__device__ inline void stage_scrub_block_async(unsigned dst,
                                               const uint4* src, int lane) {
#pragma unroll
  for (int j = 0; j < kScrubB / 16 / 32; ++j) {
    const int v = lane + 32 * j;
    cp_async16(dst + 16u * ((v >> 2) * (kScrubStride / 4) + (v & 3)),
               src + v);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The word at byte address `a` of the block's shared window, for loads
// from tables that stay unchanged once built.
__device__ inline uint32_t lds32(unsigned a) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// lane_piece_crc at the scrub block, its 16 words read 16 bytes at a
// time: kScrubChains chains of consecutive words, the first from state
// `seed`, joined by k3_ops's chain operators (A_{16 j} bytes: chain c
// has (kC-1-c) * 64/kC bytes after it, so j = (kC-1-c) * 4/kC).
template <int kC>
__device__ inline uint32_t scrub_piece_crc(const uint32_t* p,
                                           const uint32_t* lt,
                                           const uint32_t* chain,
                                           uint32_t seed) {
  constexpr int kW = 16 / kC;
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[i];
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
  uint32_t crc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) crc[c] = c == 0 ? seed : 0u;
  // entry e of this lane's table at byte 128 e of lt, addressed in the
  // shared window directly: a byte step is an AND, one address op, the
  // load, a shift and an XOR
  const unsigned lb = static_cast<unsigned>(__cvta_generic_to_shared(lt));
#pragma unroll
  for (int t = 0; t < kW; ++t) {
#pragma unroll
    for (int c = 0; c < kC; ++c) crc[c] ^= w[c * kW + t];
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        crc[c] = lds32(lb + ((crc[c] & 0xFFu) << 7)) ^ (crc[c] >> 8);
  }
  uint32_t l = crc[kC - 1];
#pragma unroll
  for (int c = 0; c < kC - 1; ++c)
    l ^= apply_nibbles(chain + 128 * ((kC - 1 - c) * (4 / kC) - 1), 1,
                       crc[c]);
  return l;
}

// Queue the copy of one B-byte block (W = B/4 words at src) into a
// warp's row in K3's layout at shared address dst: word w to w +
// (w/wpp)*pad, a 4-byte cp.async a word, lane l taking words l, l+32,
// ...; w/wpp is __umulhi(w, magic) (magic = 0xFFFFFFFF/wpp + 1, exact
// for these w), or w itself where wpp == 1.
__device__ inline void stage_block_async(unsigned dst, const uint32_t* src,
                                         int lane, int W, int wpp, int pad,
                                         unsigned magic) {
  for (int j = 0; j < W / 32; ++j) {         // W is a multiple of 32
    const unsigned w = static_cast<unsigned>(lane + 32 * j);
    const unsigned q = wpp == 1 ? w : __umulhi(w, magic);
    cp_async4(dst + 4u * (w + q * pad), src + w);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The row of block b: the first whose end lies past it (rows with no
// body share their end with the row before and are skipped), by a
// 32-way search of the warp: each round its lanes load 32 ends spread
// over the interval at once and a ballot keeps the first segment whose
// last end lies past b, so 132 rows take 2 rounds of one load instead
// of 8 dependent loads.  Every lane gets the row and its end (the last
// round's probe, shuffled).
__device__ inline int warp_row_search(const int64_t* row_ends, int nrows,
                                      int64_t b, int lane,
                                      int64_t& row_end) {
  int lo = 0, n = nrows;                       // the row is in [lo, lo+n)
  while (true) {
    const int step = (n + 31) / 32;
    const int probe = (lane + 1) * step < n ? (lane + 1) * step : n;
    const int64_t end = row_ends[lo + probe - 1];
    const unsigned past = __ballot_sync(0xFFFFFFFFu, end > b);
    const int f = __ffs(past) - 1;             // the last probe is past b
    if (step == 1) {
      row_end = __shfl_sync(0xFFFFFFFFu, end, f);
      return lo + f;
    }
    lo += f * step;
    n = (f + 1) * step < n ? step : n - f * step;
  }
}

// Probe stamps (CTT_K3_PHASES; thread 0, so warp 0's range): 0/6 start
// (clock64 / %globaltimer), 3 the row searched, 1 the tables built, 2
// the first block staged, 4 its chains and fold, 5 the range's advance
// and atomic, 7/8 the end after a barrier.
//
// kB: kScrubB, the scrub block in its own layout (16-byte copies and
// loads, kScrubChains chains, all unrolled), or 0: B at run time in
// K3's layout.
template <int kB>
__global__ void __launch_bounds__(kRowsMaxWarps * 32, kRowsMinBlocks)
crc32c_rows_kernel(const uint8_t* __restrict__ in,
                   unsigned long long* __restrict__ lout,
                   const uint32_t* __restrict__ ops,
                   const int64_t* __restrict__ row_ends, int nrows,
                   int64_t nblocks, int B_, int ndigits) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int B = kB ? kB : B_;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int W = B / 4;
  const int wpp = B / 128;
  const int pad = k3_pad(B);
  const int chains = k3_chains(B);
  const int S = rows_row_words(B);
  const unsigned magic = 0xFFFFFFFFu / static_cast<unsigned>(wpp) + 1u;
  uint32_t* ltab = smem;                       // 256 * 32 words
  uint32_t* nib = ltab + 256 * 32;             // kNibWords
  uint32_t* rows = nib + kNibWords + warp * 2 * S;   // this warp's two
  const unsigned srows =
      static_cast<unsigned>(__cvta_generic_to_shared(rows));
  const uint32_t* src = reinterpret_cast<const uint32_t*>(in);
  const uint32_t* digits = ops + kOpCols;
  PHASE_STAMP(0, clock64());
  PHASE_STAMP(6, global_ns());
  // the fold operators' columns go out first, so they do not queue
  // behind the copies
  uint32_t fcol[4];
  const bool fold_item = threadIdx.x < kFoldItems;
  if (fold_item) fold_item_load(ops, threadIdx.x, fcol);
  // this warp's range [b0, b1): nblocks split over the grid's warps,
  // the first `rem` ranges one block longer
  const int64_t all = static_cast<int64_t>(gridDim.x) * nwarps;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * nwarps + warp;
  const int64_t per = nblocks / all, rem = nblocks % all;
  const int64_t b0 = gw * per + (gw < rem ? gw : rem);
  const int64_t b1 = b0 + per + (gw < rem ? 1 : 0);
  // queue block blk's copy into this warp's row r (0 or 1)
  auto stage = [&](int r, int64_t blk) {
    const unsigned dst = srows + 4u * S * static_cast<unsigned>(r);
    if constexpr (kB == kScrubB)
      stage_scrub_block_async(
          dst, reinterpret_cast<const uint4*>(src + blk * W), lane);
    else
      stage_block_async(dst, src + blk * W, lane, W, wpp, pad, magic);
  };
  int lo = 0;
  int64_t row_end = 0;
  if (b0 < b1) {
    lo = warp_row_search(row_ends, nrows, b0, lane, row_end);
    // the range's first two blocks, one into each row
    for (int64_t blk = b0; blk < b1 && blk < b0 + 2; ++blk)
      stage(static_cast<int>(blk - b0), blk);
  }
  PHASE_STAMP(3, clock64());
  // the tables, while the first blocks' copies fly
  build_lane_crc_table(ltab, lane, warp, nwarps);
  if (fold_item) fold_item_store(nib, threadIdx.x, fcol);
  for (int it = threadIdx.x + blockDim.x; it < kFoldItems;
       it += blockDim.x) {
    uint32_t c[4];
    fold_item_load(ops, it, c);
    fold_item_store(nib, it, c);
  }
  __syncthreads();
  PHASE_STAMP(1, clock64());
  if (b0 < b1) {
    const uint32_t* lt = ltab + lane;
    const uint32_t* chain = nib + 8 * 16 * 32;
    int64_t next_end = lo + 1 < nrows ? row_ends[lo + 1] : row_end;
    uint32_t L = 0;                            // the running L of row lo
    for (int64_t blk = b0; blk < b1; ++blk) {
      const int cur = static_cast<int>((blk - b0) & 1);
      // this block's copies are done; block i+1's may still fly
      if (blk + 1 < b1)
        cp_async_wait_group<1>();
      else
        cp_async_wait_group<0>();
      __syncwarp();
      if (blk == b0) PHASE_STAMP(2, clock64());
      uint32_t lcrc;
      if constexpr (kB == kScrubB)
        lcrc = scrub_piece_crc<kScrubChains>(
            rows + cur * S + lane * kScrubStride, lt, chain,
            lane == 0 ? L : 0u);
      else
        lcrc = lane_piece_crc<true>(rows + cur * S + lane * (wpp + pad), lt,
                                    chain, wpp, chains, lane == 0 ? L : 0u);
      L = apply_nibbles(nib + lane, 32, lcrc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        L ^= __shfl_xor_sync(0xFFFFFFFFu, L, o);
      if (blk == b0) PHASE_STAMP(4, clock64());
      __syncwarp();          // every lane has read the row
      if (blk + 2 < b1) stage(cur, blk + 2);   // into the row it left
      if (blk + 1 == row_end) {
        // the row ends here: its L needs no advance
        if (lane == 0)
          atomicXor(lout + lo, static_cast<unsigned long long>(L));
        L = 0;
        if (blk + 1 < b1) {
          // on to the next row with a body
          ++lo;
          row_end = next_end;
          while (row_end <= blk + 1) row_end = row_ends[++lo];
          next_end = lo + 1 < nrows ? row_ends[lo + 1] : row_end;
        }
      }
    }
    if (b1 < row_end) {
      // the range ends inside row lo: advance L by the row's blocks
      // after the range, one operator a nonzero base-256 digit
      const int64_t dist = row_end - b1;
      uint32_t dcol[kMaxDigits];
#pragma unroll
      for (int i = 0; i < kMaxDigits; ++i) {
        const int c = static_cast<int>((dist >> (kDigitBits * i)) & 255);
        dcol[i] = i < ndigits && c != 0
                      ? __ldg(digits + (i * 256 + c) * 32 + lane) : 0u;
      }
#pragma unroll
      for (int i = 0; i < kMaxDigits; ++i) {
        if (i < ndigits && ((dist >> (kDigitBits * i)) & 255) != 0) {
          uint32_t v = dcol[i] & (0u - ((L >> lane) & 1u));
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v ^= __shfl_xor_sync(0xFFFFFFFFu, v, o);
          L = v;
        }
      }
      if (lane == 0)
        atomicXor(lout + lo, static_cast<unsigned long long>(L));
    }
    PHASE_STAMP(5, clock64());
  }
  PROBE_SYNC();
  PHASE_STAMP(7, global_ns());
  PHASE_STAMP(8, clock64());
}

// Launch one instantiation of K5 (its shared memory granted once for
// the largest size seen, as launch() does).
template <int kB>
int launch_rows(unsigned blocks, int threads, int smem, const void* in,
                void* lout, const void* ops, const void* row_ends, int nrows,
                long long nblocks, int B, int ndigits, void* stream) {
  static int granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        crc32c_rows_kernel<kB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  crc32c_rows_kernel<kB><<<blocks, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in),
      static_cast<unsigned long long*>(lout),
      static_cast<const uint32_t*>(ops),
      static_cast<const int64_t*>(row_ends), nrows,
      static_cast<int64_t>(nblocks), B, ndigits);
  return static_cast<int>(cudaGetLastError());
}

// K3 gf_encode_crc_acc: the walk.  The grid's thread blocks split the
// n/B column blocks ("tiles") into contiguous ranges, balanced to within
// one tile (ops/bitsliced.k3_ranges), and each walks its range in order
// with a running L of each of the k+m shard rows, as K5's warps do:
//
//     L <- A_B . L ^ L(tile)
//
// which costs nothing beyond the tile's own L: lane 0 seeds its first
// chain with L.  At a run end inside the range the rows' L go as they
// are into the run's slots (atomicXor) and restart from 0; at the
// range's end inside a run each is advanced once by the run's tiles
// after the range (the base-256 digit tables of k3_ops) and XORed in.
// A run spread over several ranges gets one XOR from each, in any
// order, into slots the wrapper zero-fills on the same stream:
//
//     L(run) = XOR_ranges  A_{B * d_r} . L(the run's part in range r),
//
// d_r the run's tiles after range r.  The run of the range's first tile
// is searched once (warp_row_search, by the last warp); the walk then
// steps over run ends with the next end loaded ahead.
//
// What bounds it on the H100, at the write path's 8+3 and B = 2 KiB.
// Device memory: a tile is 16 KiB in and 6 KiB of parity out, so 8,192
// tiles (32 objects of 4 MiB) take 55 us at 3.35 TB/s; the walk with its
// parity and crc cut out runs in 54 us.  The lookups: a tile costs ~58k
// lane lookups (32,768 for the parity, two nibble lookups a data byte
// for one packed group of four rows; 22,528 for the crc, one a shard
// byte; 2,816 for the lane fold), ~2.45k shared-memory wavefronts with
// the staged rows' reads and writes, against one a cycle an SM; and
// the lookups' integer work (index, address, shift, XOR) runs on the
// integer pipe at two warp instructions a cycle an SM.  At 62 tiles an
// SM both come to ~2.3-2.5k cycles a tile, ~75 us, on other units than
// the bytes.  K3's per-block design (today K2's body) reached neither:
// each block staged a tile, waited, encoded, then crc'd it, with no copy
// in flight while it computed and an advance and 11 atomics a tile
// (~7.9k cycles a tile an SM, 247 us a call).  The walk:
//  * Copies ahead: a ring of `depth` stages of the k data rows; tile
//    i + depth - 1 is queued (one commit group a tile) as soon as every
//    warp has left the stage tile i - 1 used, so with two stages tile
//    i+1's copies fly while tile i is encoded and crc'd, with three
//    tiles i+1 and i+2.  Two barriers a tile: the staged tile is
//    complete; the parity rows are written.
//  * The scrub block's layout at B = 2 KiB (kB = kScrubB, compiled
//    apart as K5's): lane pieces 20 words apart, filled by 16-byte
//    cp.async and read by the crc in 16-byte loads; the parity's
//    threads take their words so that each warp's 4-byte reads and
//    writes of a row meet no bank twice (walk_word).  Any other B runs
//    K2's row layout (k3_pad), 4-byte copies and lane_piece_crc.
//  * Few instructions a lookup: the parity's tables sit at an address
//    the warp shares, so a lookup is one PRMT (the byte offset of a
//    nibble's entry) and a load [offset + uniform base]; a crc byte step
//    addresses the lane's table in the shared window directly (lds32).
//  * Running L in registers: warp w takes rows w, w + 16, ..., the
//    same every tile, and lane j of the warp keeps its j-th row's L
//    (k + m <= 512).  Atomics fall to k+m a run end and a range end.
//  * One grid of at most one resident wave and one table build a block.
// tools/k3_phases.py stamps it: the first tile staged at ~6k SM cycles,
// then ~8.1k cycles a tile a block with two blocks an SM (~4.1k a tile an
// SM, 154 us a call): the shared-memory pipe ~60% busy, the rest the
// crc chains' latency.  A crc by binary tensor-core products instead
// (mma m16n8k256 b1 AND-popc against the 2 KiB block's crc matrix, held
// in registers by 16 warps of a 32-warp block while the other 16
// encode: 24 cycles a product, 0.665 a cycle an SM on this card) ran
// exact at 148 us: the parity's own lookups keep the same queue full,
// so its loads and the encode each took half again their time alone.
// The shape rule (walk_shape, ops/bitsliced.k3_walk the host's mirror):
// the first of kWalkShapes (blocks an SM, stages) whose layout fits, in
// the scrub block's layout where B is the scrub block and it fits, else
// K2's; at 8+3 x 2 KiB two blocks of 16 warps an SM, two stages each
// (100,368 B a block: 50.5 KiB of tables, 2 x 20 KiB of data rows, 7.5
// KiB of parity rows), which ran 183 us against 208 us for one block
// with three stages and 194 us for two blocks with one.  One stage of
// K2's layout is K2's own block, so every shape K2's layout admits is
// admitted.
constexpr int kWalkThreads = 512;       // 16 warps
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kWalkMinBlocks = 2;       // resident an SM by the launch bounds
constexpr int kWalkMaxRows = 32 * kWalkWarps;   // a lane's L a row
// (blocks an SM, stages of the ring), in the order the walk takes them
constexpr int kWalkShapes[][2] = {{2, 2}, {1, 3}, {1, 2}, {1, 1}};
static_assert(kFoldItems <= kWalkThreads, "one fold item a thread");
static_assert(kWalkThreads - 32 >= 256, "the last warp builds no lane table");

// Words of a staged row: the scrub block's layout, or K2's (k3_row_words).
__host__ __device__ inline int walk_row_words(int B, bool scrub) {
  return scrub ? 32 * kScrubStride : k3_row_words(B);
}

// Bytes of one walk block: the parity's nibble tables, the lane crc
// tables, the fold's nibble tables, `depth` stages of k data rows, m
// parity rows and the run slot (16 bytes).
inline long long walk_smem_bytes(int m, int k, int B, int depth,
                                 bool scrub) {
  const long long groups = (m + 3) / 4;
  return 4LL * (groups * k * 32 + 256 * 32 + kNibWords +
                static_cast<long long>(depth * k + m) *
                    walk_row_words(B, scrub)) + 16;
}

struct WalkShape {
  int per_sm, depth;
  bool scrub;
  long long smem;
};

// The walk's shape for (m, k, B); false where not even one stage of
// K2's layout fits one block.
inline bool walk_shape(int m, int k, int B, WalkShape& out) {
  for (const auto& c : kWalkShapes) {
    for (int scrub = B == kScrubB ? 1 : 0; scrub >= 0; --scrub) {
      const long long smem = walk_smem_bytes(m, k, B, c[1], scrub);
      if (smem <= kSmemLimit && c[0] * (smem + kSmemReserved) <= kSmSmem) {
        out = {c[0], c[1], scrub != 0, smem};
        return true;
      }
    }
  }
  return false;
}

// Item w (0 .. W-1) of a group's parity words in the scrub block's
// layout: the warp of 32 items takes 8 lane pieces a (8 apart by the
// warp) and 4 words c of each, so that its staged indices 20a + c fill
// 32 distinct banks (20a mod 32 over 8 consecutive a is 0, 20, 8, 28,
// 16, 4, 24, 12).  Returns the word of the tile; *pw its staged index.
__device__ inline int walk_word(int w, int* pw) {
  const int a = 8 * ((w >> 5) & 3) + ((w & 31) >> 2);
  const int c = 4 * (w >> 7) + (w & 3);
  *pw = kScrubStride * a + c;
  return 16 * a + c;
}

// Probe stamps (CTT_K3_PHASES; thread 0, so warp 0's rows): 0/6 start
// (clock64 / %globaltimer), 1 tables built and run searched, 2 the first
// tile staged, 3 its parity written, 4 warp 0's crcs of it, 5 warp 0's
// crcs of the range's last tile, 8/7 the end after the range's flush
// and a barrier.
template <int kB>
__global__ void __launch_bounds__(kWalkThreads, kWalkMinBlocks)
k3_walk_kernel(const uint8_t* __restrict__ tables,
               const uint8_t* __restrict__ in,
               uint8_t* __restrict__ parity,
               unsigned long long* __restrict__ lout,
               const uint32_t* __restrict__ ops,
               const int64_t* __restrict__ run_ends, int nruns, int m,
               int k, int64_t n, int B_, int ndigits, int depth) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr bool kScrub = kB == kScrubB;
  const int B = kB ? kB : B_;
  const int W = B / 4;
  const int wpp = B / 128;
  const int pad = k3_pad(B);
  const int chains = k3_chains(B);
  const int S = walk_row_words(B, kScrub);
  const int groups = (m + 3) / 4;
  const int rtot = k + m;
  uint32_t* T = smem;                          // groups * k * 32 words
  uint32_t* ltab = T + groups * k * 32;        // 256 * 32 words
  uint32_t* nib = ltab + 256 * 32;             // kNibWords
  uint32_t* ring = nib + kNibWords;            // depth stages of k rows
  uint32_t* par = ring + depth * k * S;        // m parity rows
  int64_t* s_run = reinterpret_cast<int64_t*>(par + m * S);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint32_t* digits = ops + kOpCols;
  const uint32_t* lt = ltab + lane;
  const uint32_t* chain = nib + 8 * 16 * 32;
  PHASE_STAMP(0, clock64());
  PHASE_STAMP(6, global_ns());
  // this block's range [t0, t1): the tiles split over the grid, the
  // first `rem` ranges one tile longer
  const int64_t ntiles = n / B;
  const int64_t per = ntiles / gridDim.x, rem = ntiles % gridDim.x;
  const int64_t bx = blockIdx.x;
  const int64_t t0 = bx * per + (bx < rem ? bx : rem);
  const int64_t t1 = t0 + per + (bx < rem ? 1 : 0);
  // queue tile t's k data rows into stage s (one commit group a call of
  // commit(), empty ones included, so that the group count stays fixed)
  auto queue = [&](int s, int64_t t) {
    uint32_t* dst = ring + s * k * S;
    if constexpr (kScrub) {
      const unsigned base =
          static_cast<unsigned>(__cvta_generic_to_shared(dst));
      const uint4* src = reinterpret_cast<const uint4*>(in + t * B);
      const int64_t rs = n / 16;               // 16-byte chunks of a row
      for (int q = threadIdx.x; q < k * (kScrubB / 16); q += blockDim.x) {
        const int j = q / (kScrubB / 16), v = q % (kScrubB / 16);
        cp_async16(
            base + 4u * (j * S + kScrubStride * (v >> 2) + 4 * (v & 3)),
            src + j * rs + v);
      }
    } else {
      stage_rows_async(dst, in, k, n, t * B, B, S, wpp, pad);
    }
  };
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::); };
  // the table gathers go out first, so they do not queue behind the
  // copies; then the first tiles' copies, then the search
  const int nT = groups * k * 32;
  uint32_t tword = 0, fcol[4];
  const bool fold_item = threadIdx.x < kFoldItems;
  if (threadIdx.x < nT) tword = nibble_packed_word(tables, m, k, threadIdx.x);
  if (fold_item) fold_item_load(ops, threadIdx.x, fcol);
  for (int d = 0; d < depth - 1; ++d) {
    if (t0 + d < t1) queue(d, t0 + d);
    commit();
  }
  if (warp == nwarps - 1) {
    int64_t end;
    const int run = warp_row_search(run_ends, nruns, t0, lane, end);
    if (lane == 0) {
      s_run[0] = run;
      s_run[1] = end;
    }
  }
  // the tables, while the copies fly (the lane crc tables by warps 0-7)
  build_lane_crc_table(ltab, lane, warp, nwarps);
  if (threadIdx.x < nT) T[threadIdx.x] = tword;
  for (int it = threadIdx.x + blockDim.x; it < nT; it += blockDim.x)
    T[it] = nibble_packed_word(tables, m, k, it);
  if (fold_item) fold_item_store(nib, threadIdx.x, fcol);
  __syncthreads();
  PHASE_STAMP(1, clock64());
  int run = static_cast<int>(s_run[0]);
  int64_t run_end = s_run[1];
  int64_t next_end = run + 1 < nruns ? run_ends[run + 1] : run_end;
  uint32_t held = 0;          // lane j: the running L of this warp's row j
  for (int64_t t = t0; t < t1; ++t) {
    const int i = static_cast<int>(t - t0);
    const int s = i % depth;
    if (depth == 1) {
      if (i > 0) __syncthreads();              // every warp left the stage
      queue(0, t);
      commit();
    }
    // tile t's copies are done: depth - 2 groups were queued after it
    if (depth == 3)
      cp_async_wait_group<1>();
    else
      cp_async_wait_group<0>();
    __syncthreads();
    if (t == t0) PHASE_STAMP(2, clock64());
    if (depth > 1) {
      // into the stage that tile t - 1 left
      if (t + depth - 1 < t1) queue((i + depth - 1) % depth, t + depth - 1);
      commit();
    }
    // parity: a word of every parity row of a group a thread and word,
    // into the staged parity rows and to `parity`
    const uint32_t* rows = ring + s * k * S;
    for (int g = 0; g < groups; ++g) {
      // the group's tables, at an address the warp shares
      const char* Tg = reinterpret_cast<const char*>(T + g * k * 32);
      for (int item = threadIdx.x; item < W; item += blockDim.x) {
        int w, pw;
        if constexpr (kScrub) {
          w = walk_word(item, &pw);
        } else {
          w = item;
          pw = w + (w / wpp) * pad;
        }
        uint32_t acc[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; j < k; ++j) {
          const uint32_t x = rows[j * S + pw];
          // the byte offsets of each byte's two entries: 4 x its low
          // nibble, and 64 + 4 x its high one, one PRMT a lookup
          const uint32_t lo = (x << 2) & 0x3C3C3C3Cu;
          const uint32_t hi = (x >> 2) & 0x3C3C3C3Cu;
          const char* Tj = Tg + 128 * j;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[b] ^= *reinterpret_cast<const uint32_t*>(
                          Tj + __byte_perm(lo, 0, 0x4440 | b)) ^
                      *reinterpret_cast<const uint32_t*>(
                          Tj + 64 + __byte_perm(hi, 0, 0x4440 | b));
        }
        ctt::transpose4(acc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * g + r;
          if (row < m) {
            par[row * S + pw] = acc[r];
            reinterpret_cast<uint32_t*>(parity + row * n + t * B)[w] =
                acc[r];
          }
        }
      }
    }
    __syncthreads();
    if (t == t0) PHASE_STAMP(3, clock64());
    // the crcs: this warp's rows, each L carried from the tile before
    const bool run_ends_here = t + 1 == run_end;
    for (int row = warp, j = 0; row < rtot; row += nwarps, ++j) {
      const uint32_t* p = row < k ? rows + row * S : par + (row - k) * S;
      const uint32_t seed = __shfl_sync(0xFFFFFFFFu, held, j);
      uint32_t lcrc;
      if constexpr (kScrub)
        lcrc = scrub_piece_crc<kScrubChains>(p + lane * kScrubStride, lt,
                                             chain, lane == 0 ? seed : 0u);
      else
        lcrc = lane_piece_crc<true>(p + lane * (wpp + pad), lt, chain, wpp,
                                    chains, lane == 0 ? seed : 0u);
      uint32_t L = apply_nibbles(nib + lane, 32, lcrc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        L ^= __shfl_xor_sync(0xFFFFFFFFu, L, o);
      if (run_ends_here) {
        // the run ends here: its L needs no advance
        if (lane == 0)
          atomicXor(lout + static_cast<int64_t>(run) * rtot + row,
                    static_cast<unsigned long long>(L));
        L = 0;
      }
      if (lane == j) held = L;
    }
    if (t == t0) PHASE_STAMP(4, clock64());
    if (run_ends_here && t + 1 < t1) {
      // on to the next run with a body
      ++run;
      run_end = next_end;
      while (run_end <= t + 1) run_end = run_ends[++run];
      next_end = run + 1 < nruns ? run_ends[run + 1] : run_end;
    }
  }
  PHASE_STAMP(5, clock64());
  if (t1 < run_end) {
    // the range ends inside the run: advance each row's L by the run's
    // tiles after the range, one operator a nonzero base-256 digit
    const int64_t dist = run_end - t1;
    uint32_t dcol[kMaxDigits];
#pragma unroll
    for (int i = 0; i < kMaxDigits; ++i) {
      const int c = static_cast<int>((dist >> (kDigitBits * i)) & 255);
      dcol[i] = i < ndigits && c != 0
                    ? __ldg(digits + (i * 256 + c) * 32 + lane) : 0u;
    }
    for (int row = warp, j = 0; row < rtot; row += nwarps, ++j) {
      uint32_t L = __shfl_sync(0xFFFFFFFFu, held, j);
#pragma unroll
      for (int i = 0; i < kMaxDigits; ++i) {
        if (i < ndigits && ((dist >> (kDigitBits * i)) & 255) != 0) {
          uint32_t v = dcol[i] & (0u - ((L >> lane) & 1u));
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v ^= __shfl_xor_sync(0xFFFFFFFFu, v, o);
          L = v;
        }
      }
      if (lane == 0)
        atomicXor(lout + static_cast<int64_t>(run) * rtot + row,
                  static_cast<unsigned long long>(L));
    }
  }
  PHASE_STAMP(8, clock64());
  PROBE_SYNC();
  PHASE_STAMP(7, global_ns());
}

// Launch one instantiation of the walk (its shared memory granted once
// for the largest size seen, as launch() does).
template <int kB>
int launch_walk(unsigned blocks, int smem, const void* tables,
                const void* in, void* parity, void* lacc, const void* ops,
                const void* run_ends, int nruns, int m, int k, long long n,
                int B, int ndigits, int depth, void* stream) {
  static int granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        k3_walk_kernel<kB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  k3_walk_kernel<kB><<<blocks, kWalkThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(parity), static_cast<unsigned long long*>(lacc),
      static_cast<const uint32_t*>(ops),
      static_cast<const int64_t*>(run_ends), nruns, m, k,
      static_cast<int64_t>(n), B, ndigits, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2.  tables (m, k, 256) uint8; in (k, n) uint8; parity (m, n) uint8;
// lout (k+m, n/B) uint64 holding each uint32 L zero-extended (so the
// wrapper hands it out as an int64 tensor without a conversion pass);
// ops uint32: the first kOpCols words of K3's operators (the fold and
// chain operators of block B; ops/bitsliced.k3_ops).  The branch is the
// shape's: K3's layout where it fits one block, else the narrow one
// (ops/bitsliced.k2_lane_tables).  All contiguous on the device, 16-byte
// aligned; n % B == 0 and B % 128 == 0.  Returns the CUDA error of the
// launch.
extern "C" int ctt_gf_encode_crc(const void* tables, const void* in,
                                 void* parity, void* lout, const void* ops,
                                 int m, int k, long long n, int B,
                                 void* stream) {
  if (B % 128 || B <= 0 || n % B) return cudaErrorInvalidValue;
  const long long wide = block_smem_bytes(m, k, B, true);
  if (wide <= kSmemLimit)
    return launch<true>(tables, in, parity, lout, ops, m, k, n, B, wide,
                        stream);
  const long long narrow = block_smem_bytes(m, k, B, false);
  if (narrow > kSmemLimit) return cudaErrorInvalidValue;
  return launch<false>(tables, in, parity, lout, ops, m, k, n, B, narrow,
                       stream);
}

// K3.  tables (m, k, 256) uint8; in (k, n) uint8; parity (m, n) uint8;
// lacc (nruns, k+m) uint64, ZERO on entry, each uint32 L zero-extended;
// ops uint32: 32 x 32 fold operators (column b of lane l's
// A_{(B/32)(31-l)} at 32*b + l), 3 chain operators of 32 columns
// (A_{(B/32/chains) * j}, j = 1, 2, 3; k3_chains), then `ndigits` <= 4
// tables of 256 operators of 32 columns, operator c of table i =
// A_{B * c * 256^i}; every block's distance to its run's end <
// 256^ndigits (ops/bitsliced.k3_ops builds them); run_ends
// (nruns,) int64, non-decreasing, the last == n / B.  All contiguous
// on the device, 16-byte aligned; n % B == 0 and B % 128 == 0.
// Returns the CUDA error of the launch.
extern "C" int ctt_gf_encode_crc_acc(const void* tables, const void* in,
                                     void* parity, void* lacc,
                                     const void* ops, const void* run_ends,
                                     int nruns, int m, int k, long long n,
                                     int B, int ndigits, void* stream) {
  WalkShape ws;
  if (B % 128 || B <= 0 || n % B || nruns < 1 || ndigits < 1 ||
      ndigits > kMaxDigits || k + m > kWalkMaxRows ||
      !walk_shape(m, k, B, ws))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // at most one resident wave, and no range empty
  long long blocks = n / B;
  if (blocks > static_cast<long long>(ws.per_sm) * sms)
    blocks = static_cast<long long>(ws.per_sm) * sms;
  if (blocks < 1) blocks = 1;
  const unsigned grid = static_cast<unsigned>(blocks);
  const int sm = static_cast<int>(ws.smem);
  if (ws.scrub)
    return launch_walk<kScrubB>(grid, sm, tables, in, parity, lacc, ops,
                                run_ends, nruns, m, k, n, B, ndigits,
                                ws.depth, stream);
  return launch_walk<0>(grid, sm, tables, in, parity, lacc, ops, run_ends,
                        nruns, m, k, n, B, ndigits, ws.depth, stream);
}

// K5.  in (nblocks * B,) uint8: the rows' bodies laid end to end; lout
// (nrows,) uint64, ZERO on entry, each uint32 L zero-extended; ops:
// k3_ops(B) (the fold and chain operators, then `ndigits` <= 4 digit
// tables; every row < 256^ndigits blocks); row_ends (nrows,) int64,
// non-decreasing, the last == nblocks.  All contiguous on the device,
// 16-byte aligned; B % 128 == 0 and nblocks > 0.  Returns the CUDA
// error of the launch.
extern "C" int ctt_crc32c_rows(const void* in, void* lout, const void* ops,
                               const void* row_ends, int nrows,
                               long long nblocks, int B, int ndigits,
                               void* stream) {
  if (B % 128 || B <= 0 || nblocks < 1 || nrows < 1 || ndigits < 1 ||
      ndigits > kMaxDigits || rows_warps(B) < 1)
    return cudaErrorInvalidValue;
  const int warps = rows_warps(B);
  const long long smem = rows_smem_bytes(B);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long per_sm = kRowsMinBlocks;
  if (per_sm > kSmSmem / (smem + kSmemReserved))
    per_sm = kSmSmem / (smem + kSmemReserved);
  if (per_sm < 1) per_sm = 1;
  // enough warps for one block each, at most one resident wave
  long long blocks = (nblocks + warps - 1) / warps;
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  const unsigned grid = static_cast<unsigned>(blocks);
  const int sm = static_cast<int>(smem);
  if (B == kScrubB)
    return launch_rows<kScrubB>(grid, warps * 32, sm, in, lout, ops, row_ends,
                             nrows, nblocks, B, ndigits, stream);
  return launch_rows<0>(grid, warps * 32, sm, in, lout, ops, row_ends,
                        nrows, nblocks, B, ndigits, stream);
}

#ifdef CTT_K3_PHASES
// The probe's buffer: (grid, kPhases) uint64 on the device, or null.
extern "C" int ctt_k3_set_phase_buffer(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_k3_phases, &buf, sizeof(buf)));
}
#endif
