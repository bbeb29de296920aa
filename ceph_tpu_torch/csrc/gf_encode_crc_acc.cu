// K2 gf_encode_crc and K3 gf_encode_crc_acc: parity (m, n) = C (m, k) x
// data (k, n) over GF(2^8) and crc32c linear parts L of all k+m shard
// rows, from one launch, by one per-block body: the kernel template
// below, instantiated once for K3 (kAcc) and twice for K2 (the shape
// branches of kLaneTables).  K5 crc32c_rows, at the end of the file,
// runs the same crc machinery with no parity, one warp a range of
// blocks.
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
// covers its every byte and the host folds no tail.
//
// K3 replaces the Pallas kernel `_make_gf_crc_kernel_w32_hier_acc`
// (ceph_tpu/ops/bitsliced.py:539, via `_fused_hier_acc_call` :626).
// That kernel walks a sequential grid and keeps each run's L in an
// output block that stays resident in VMEM, folding
// acc <- A_tile . acc ^ L(tile) step by step.  Thread blocks on the
// H100 run in no order, so the design rests on the fold being
// XOR-linear instead:
//
//     L(run) = XOR_b  A_{B * d_b} . L(block b),
//
// d_b = the number of the run's blocks after block b.  Each B-byte
// block (a "tile" of the grid walk) computes its parity and the L of
// its block, advances that L by d_b and XORs it into the (run, row)
// slot with atomicXor: the result does not depend on the order the
// blocks land in and is bit-exact, and a 512 KiB run keeps its 256
// blocks of 2 KiB in flight.  The L output must be zero before the
// atomics run: the wrapper zero-fills it on the same stream.
//
// What bounds both on the H100.  Device memory would allow the k data
// rows in and the m parity rows out in 1.7 us at 8+3 x 512 KiB, but a
// 512 KiB run is 256 blocks of 2 KiB, about two an SM, so the time is
// one block's chain of steps, each bound by its latency or by the
// instructions and shared-memory wavefronts of the two blocks on its
// SM (K3's first design, K2's old body plus an advance, took 20.7 us;
// tools/k3_phases.py stamps the steps).  The body shortens each:
//  * Staging: every word of the k rows is queued at once with a 4-byte
//    cp.async into rows padded after each lane's piece, so the crc's
//    reads hit 32 distinct banks.  The tables' gathers from device
//    memory go out before the copies, so they do not queue behind them;
//    the tables are built while the copies fly, and
//    K3's run is searched once per block, by the one warp that builds
//    no lane table.
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
//  * K3's advance by d as one warp matvec a base-256 digit of d (one
//    for a run of up to 256 blocks): the host's table holds
//    A_{B * c * 256^i} for every digit value c and position i, and each
//    lane loads its columns before the chains start.
//  * 12 warps, so up to 12 shard rows each take one warp.
// Shared memory (ops/bitsliced.k3_smem, the host's mirror): the parity's
// nibble tables (1 KiB a group of four parity rows at k = 8), the lane
// crc tables (32 KiB), the fold's nibble tables (17.5 KiB), k+m staged
// rows, 16 bytes of run and distance.  Where that does not fit one
// block (k+m rows of 4-8 KiB), K2 takes its narrow branch, chosen by
// the shape alone (ops/bitsliced.k2_lane_tables and _crc_smem_bytes):
// one crc table the lanes share (its lookups meet in banks) and no fold
// tables, the lane and chain operators applied bit by bit from their
// columns in device memory (through L1).  The grid
// (ops/bitsliced.k3_launch) is at most one wave of the blocks the
// launch bounds and the shared memory keep resident; blocks stride over
// the rest, building their tables once.
#include <cuda_runtime.h>

#include <cstdint>

#include "gf_common.cuh"

namespace {

constexpr int kThreads = 384;           // 12 warps
constexpr int kMinBlocks = 3;           // resident an SM by the launch bounds
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

// Bytes of shared memory of one block: K3's layout with the lane crc
// tables and the fold's nibble tables, or K2's narrow one with one crc
// table and no fold tables.
inline long long block_smem_bytes(int m, int k, int B, bool lane_tables) {
  const long long groups = (m + 3) / 4;
  return 4LL * (groups * k * 32 + (lane_tables ? 256 * 32 + kNibWords : 256) +
                static_cast<long long>(k + m) * k3_row_words(B)) + 16;
}

#ifdef CTT_K3_PHASES
// Phase probe (tools/k3_phases.py builds this file with CTT_K3_PHASES):
// thread 0 of every block stamps clock64() at its start, after its own
// share of the table builds, after each block-wide step of its first
// tile and after warp 0's first row, and %globaltimer at its start and
// end, into the buffer the probe's entry sets.  K5's stamps are listed
// at its kernel.
constexpr int kPhases = 9;
__device__ unsigned long long* g_k3_phases;
__device__ inline unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K3_STAMP(i, v)                                                    \
  do {                                                                    \
    if (threadIdx.x == 0 && first && g_k3_phases)                         \
      g_k3_phases[blockIdx.x * kPhases + (i)] = (v);                      \
  } while (0)
#define K3_PROBE_SYNC() __syncthreads()
#define K5_STAMP(i, v)                                                    \
  do {                                                                    \
    if (threadIdx.x == 0 && g_k3_phases)                                  \
      g_k3_phases[blockIdx.x * kPhases + (i)] = (v);                      \
  } while (0)
#else
#define K3_STAMP(i, v) do {} while (0)
#define K3_PROBE_SYNC() do {} while (0)
#define K5_STAMP(i, v) do {} while (0)
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
// fold_item_store.  kThreads - 32 >= 256: the last warp builds no lane
// crc table and searches the run.
constexpr int kFoldItems = 32 * 8 + (kMaxChains - 1) * 8;
static_assert(kFoldItems <= kThreads, "one fold item a thread");
static_assert(kThreads - 32 >= 256, "the last warp builds no lane table");

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

// One thread block's walk over its B-byte blocks.  kAcc (K3): advance
// each block's L to its run's end and XOR it into the (run, row) slot
// of `lout`; else (K2) write it to slot (row, block).  kLaneTables:
// K3's layout; else K2's narrow branch (one crc table, the operators'
// columns read from `ops`).
template <bool kAcc, bool kLaneTables>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gf_encode_crc_kernel(const uint8_t* __restrict__ tables,
                     const uint8_t* __restrict__ in,
                     uint8_t* __restrict__ parity,
                     unsigned long long* __restrict__ lout,
                     const uint32_t* __restrict__ ops,
                     const int64_t* __restrict__ run_ends, int nruns, int m,
                     int k, int64_t n, int B, int ndigits) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int groups = (m + 3) / 4;
  const int S = k3_row_words(B);
  uint32_t* T = smem;                          // groups * k * 32 words
  uint32_t* ltab = T + groups * k * 32;        // 256 * 32 words, or 256
  uint32_t* nib = ltab + (kLaneTables ? 256 * 32 : 256);  // kNibWords, or 0
  uint32_t* rows = nib + (kLaneTables ? kNibWords : 0);   // k + m rows of S
  int64_t* s_run = reinterpret_cast<int64_t*>(rows + (k + m) * S);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int wpp = B / 128;                     // words of a lane's piece
  const int pad = k3_pad(B);
  const int chains = k3_chains(B);
  const uint32_t* digits = ops + kOpCols;      // ndigits x 256 operators
  // the crc table a lane reads, the chain and the lane fold operators
  const uint32_t* lt = kLaneTables ? ltab + lane : ltab;
  const uint32_t* chain = kLaneTables ? nib + 8 * 16 * 32 : ops + 32 * 32;
#ifdef CTT_K3_PHASES
  bool first = true;
  K3_STAMP(0, clock64());
  K3_STAMP(6, global_ns());
#endif

  const int nT = groups * k * 32;               // entries of T
  const int64_t nblocks = n / B;
  for (int64_t blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const bool first_tile = blk == blockIdx.x;
    // the previous block's crcs have read the rows and the run
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
    if (kAcc && threadIdx.x == blockDim.x - 32) {
      // the run of this block, by the last warp, which builds no lane
      // table: the first run whose end lies past it (empty runs share
      // their end with the run before and are skipped)
      int lo = 0, hi = nruns - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (run_ends[mid] > blk) hi = mid;
        else lo = mid + 1;
      }
      s_run[0] = lo;
      s_run[1] = run_ends[lo] - 1 - blk;       // blocks after this one
    }
    K3_STAMP(4, clock64());
    cp_async_wait_all();
    __syncthreads();
    K3_STAMP(1, clock64());
    encode_staged(rows, T, parity, m, k, n, blk * B, B, S, wpp, pad);
    __syncthreads();
    K3_STAMP(2, clock64());
    const int64_t run = kAcc ? s_run[0] : 0;
    const int64_t dist = kAcc ? s_run[1] : 0;
    // this lane's column of the advance operator of each digit of the
    // distance, loaded ahead of the crc chains
    uint32_t dcol[kMaxDigits];
#pragma unroll
    for (int i = 0; i < kMaxDigits; ++i) {
      const int c = static_cast<int>((dist >> (kDigitBits * i)) & 255);
      dcol[i] = kAcc && i < ndigits && c != 0
                    ? __ldg(digits + (i * 256 + c) * 32 + lane) : 0u;
    }
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
#ifdef CTT_K3_PHASES
      if (row == 0) K3_STAMP(5, clock64());
#endif
      if (kAcc) {
#pragma unroll
        for (int i = 0; i < kMaxDigits; ++i) {
          if (i < ndigits && ((dist >> (kDigitBits * i)) & 255) != 0) {
            uint32_t v = dcol[i] & (0u - ((crc >> lane) & 1u));
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              v ^= __shfl_xor_sync(0xFFFFFFFFu, v, o);
            crc = v;
          }
        }
        if (lane == 0)
          atomicXor(lout + run * (k + m) + row,
                    static_cast<unsigned long long>(crc));
      } else if (lane == 0) {
        lout[row * nblocks + blk] = crc;       // zero-extended
      }
    }
#ifdef CTT_K3_PHASES
    K3_PROBE_SYNC();
    K3_STAMP(3, clock64());
    K3_STAMP(7, global_ns());
    first = false;
#endif
  }
}

// Launch one instantiation with `smem` bytes of shared memory on a grid
// of at most one wave (ops/bitsliced.k3_launch); returns the CUDA error.
template <bool kAcc, bool kLaneTables>
int launch(const void* tables, const void* in, void* parity, void* lout,
           const void* ops, const void* run_ends, int nruns, int m, int k,
           long long n, int B, int ndigits, long long smem, void* stream) {
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
        gf_encode_crc_kernel<kAcc, kLaneTables>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = sm;
  }
  gf_encode_crc_kernel<kAcc, kLaneTables>
      <<<static_cast<unsigned>(blocks), kThreads, sm,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(tables),
          static_cast<const uint8_t*>(in), static_cast<uint8_t*>(parity),
          static_cast<unsigned long long*>(lout),
          static_cast<const uint32_t*>(ops),
          static_cast<const int64_t*>(run_ends), nruns, m, k,
          static_cast<int64_t>(n), B, ndigits);
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
// objects and shard widths), so K3's one warp per shard row of a
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
#pragma unroll
  for (int t = 0; t < kW; ++t) {
#pragma unroll
    for (int c = 0; c < kC; ++c) crc[c] ^= w[c * kW + t];
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        crc[c] = lt[(crc[c] & 0xFFu) << 5] ^ (crc[c] >> 8);
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
  K5_STAMP(0, clock64());
  K5_STAMP(6, global_ns());
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
  K5_STAMP(3, clock64());
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
  K5_STAMP(1, clock64());
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
      if (blk == b0) K5_STAMP(2, clock64());
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
      if (blk == b0) K5_STAMP(4, clock64());
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
    K5_STAMP(5, clock64());
  }
  K3_PROBE_SYNC();
  K5_STAMP(7, global_ns());
  K5_STAMP(8, clock64());
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
    return launch<false, true>(tables, in, parity, lout, ops, nullptr, 1, m,
                               k, n, B, 0, wide, stream);
  const long long narrow = block_smem_bytes(m, k, B, false);
  if (narrow > kSmemLimit) return cudaErrorInvalidValue;
  return launch<false, false>(tables, in, parity, lout, ops, nullptr, 1, m,
                              k, n, B, 0, narrow, stream);
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
  const long long smem = block_smem_bytes(m, k, B, true);
  if (smem > kSmemLimit || B % 128 || B <= 0 || n % B || nruns < 1 ||
      ndigits < 1 || ndigits > kMaxDigits)
    return cudaErrorInvalidValue;
  return launch<true, true>(tables, in, parity, lacc, ops, run_ends, nruns,
                            m, k, n, B, ndigits, smem, stream);
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
