// K2 gf_encode_crc and K3 gf_encode_crc_acc: parity (m, n) = C (m, k) x
// data (k, n) over GF(2^8) and crc32c linear parts L of all k+m shard
// rows, from one launch, by one per-block body: the kernel template
// below, instantiated once for K3 (kAcc) and twice for K2 (the shape
// branches of kLaneTables).
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
// end, into the buffer the probe's entry sets.
constexpr int kPhases = 8;
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
#else
#define K3_STAMP(i, v) do {} while (0)
#define K3_PROBE_SYNC() do {} while (0)
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

// L of lane l's piece (wpp words at p, from state 0) by its crc table
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
                                          int chains) {
  constexpr int kShift = kLaneTables ? 5 : 0;
  const int wpc = wpp / chains;
  uint32_t crc[kMaxChains] = {0u, 0u, 0u, 0u};
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

#ifdef CTT_K3_PHASES
// The probe's buffer: (grid, 8) uint64 on the device, or null.
extern "C" int ctt_k3_set_phase_buffer(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_k3_phases, &buf, sizeof(buf)));
}
#endif
