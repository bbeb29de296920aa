// The packed-lookup GF(2^8) apply shared by K1 (gf_bitmatmul.cu) and
// K4 (gf_bitmatmul_stream.cu).
//
// For source row j and output rows i0..i0+3 (a "group"), the packed
// table P[g][j][x] is the uint32 whose byte t is C[i0+t][j] * x (0 past
// the last row), 1 KiB a source row.  A thread XORs P[g][j][byte b of
// its input word] into accumulator b over the source rows, so
// accumulator b holds the four rows' products of column b; one 4x4
// byte transpose (transpose4) a word then gives the rows' output words.
//
// Which source rows a group reads and where its rows land is a policy
// of the apply: DenseRows, the k rows in order and four consecutive
// output rows (K1, and K4 on a dense matrix), or ListedRows, K4's
// support layout (a group's listed source rows and its mapped output
// rows).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "gf_common.cuh"

namespace ctt {

// W words (4W bytes) at p, little-endian.  kVec: the rows are aligned to
// 4W bytes and whole; otherwise only the first `rem` bytes are read.
template <int W, bool kVec>
__device__ inline void load_words(const uint8_t* p, int64_t rem,
                                  uint32_t (&w)[W]) {
  if constexpr (kVec) {
    if constexpr (W == 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      w[i] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * i + b < rem)
          w[i] |= static_cast<uint32_t>(p[4 * i + b]) << (8 * b);
    }
  }
}

template <int W, bool kVec>
__device__ inline void store_words(uint8_t* p, int64_t rem,
                                   const uint32_t (&w)[W]) {
  if constexpr (kVec) {
    if constexpr (W == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * i + b < rem)
          p[4 * i + b] = static_cast<uint8_t>(w[i] >> (8 * b));
  }
}

// P of groups g0 .. g0+ng-1 and source rows jb .. jb+kp-1 into s_p (kp*256
// words a group) from the (r, k, 256) byte tables in device memory.  One
// work item is 4 consecutive entries x of one (group, j): a 4-byte load
// from each of the group's rows, one transpose, one 16-byte store.  A
// thread issues the loads of two items before it stores either, so their
// latencies overlap.
__device__ inline void build_packed(uint32_t* s_p, const uint8_t* tables,
                                    int r, int k, int g0, int ng, int jb,
                                    int kp) {
  const int items = ng * kp * 64;
  for (int it0 = threadIdx.x; it0 < items; it0 += 2 * blockDim.x) {
    uint32_t u[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int it = it0 + h * blockDim.x;
      const int gj = it >> 6;           // gl * kp + (j - jb)
      const int gl = gj / kp;
      const int i0 = 4 * (g0 + gl);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          tables + (i0 * k + jb + gj - gl * kp) * 256) + (it & 63);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        u[h][t] = it < items && i0 + t < r ? __ldg(src + t * k * 64) : 0u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int it = it0 + h * blockDim.x;
      if (it < items) {
        transpose4(u[h]);
        reinterpret_cast<uint4*>(s_p)[it] =
            make_uint4(u[h][0], u[h][1], u[h][2], u[h][3]);
      }
    }
  }
}

// P of one group under K4's support layout: its output rows `rows` (-1
// none) and the kp listed source rows at `src` (device memory), kp*256
// words into s_p, by build_packed's work items.
__device__ inline void build_packed_listed(uint32_t* s_p,
                                           const uint8_t* tables, int k,
                                           const int (&rows)[4],
                                           const int* src, int kp) {
  const int items = kp * 64;
  for (int it0 = threadIdx.x; it0 < items; it0 += 2 * blockDim.x) {
    uint32_t u[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int it = it0 + h * blockDim.x;
      const int j = it < items ? __ldg(src + (it >> 6)) : 0;
      const uint32_t* col =
          reinterpret_cast<const uint32_t*>(tables) + j * 64 + (it & 63);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        u[h][t] = it < items && rows[t] >= 0
                      ? __ldg(col + static_cast<int64_t>(rows[t]) * k * 64)
                      : 0u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int it = it0 + h * blockDim.x;
      if (it < items) {
        transpose4(u[h]);
        reinterpret_cast<uint4*>(s_p)[it] =
            make_uint4(u[h][0], u[h][1], u[h][2], u[h][3]);
      }
    }
  }
}

// The source rows of a group and its output rows: source row j of the
// contraction is `in + j*n`, output row t is i0 + t while t < nrows.
struct DenseRows {
  const uint8_t* in;
  uint8_t* out;
  int64_t n;
  int i0, nrows;
  __device__ const uint8_t* src(int j) const { return in + j * n; }
  __device__ bool has(int t) const { return t < nrows; }
  __device__ uint8_t* dst(int t) const { return out + (i0 + t) * n; }
};

// K4's support layout: source row j of the pass is idx[j] (its list in
// device memory), output row t is rows[t], none where it is -1.
struct ListedRows {
  const uint8_t* in;
  uint8_t* out;
  int64_t n;
  const int* idx;
  int rows[4];
  __device__ const uint8_t* src(int j) const {
    return in + __ldg(idx + j) * n;
  }
  __device__ bool has(int t) const { return rows[t] >= 0; }
  __device__ uint8_t* dst(int t) const { return out + rows[t] * n; }
};

// The output rows of one group (`io.has`) at the W words of `col`, by
// lookups in the group's packed table P (k*256 words) over its k source
// rows (`io.src`).  The loads of kJ source rows are issued before their
// lookups.  kAcc: XOR the result into what the output holds (a later
// pass of a contraction split into passes); otherwise store it.
template <int W, bool kVec, bool kAcc, class Rows>
__device__ inline void apply_rows(const uint32_t* P, const Rows& io, int k,
                                  int64_t col, int64_t rem) {
  constexpr int kJ = W == 1 ? 8 : 4;
  uint32_t acc[W][4];
#pragma unroll
  for (int w = 0; w < W; ++w)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[w][b] = 0;
  for (int j0 = 0; j0 < k; j0 += kJ) {
    uint32_t x[kJ][W];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
      if (j0 + jj < k)
        load_words<W, kVec>(io.src(j0 + jj) + col, rem, x[jj]);
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      if (j0 + jj < k) {
        const uint32_t* Pj = P + (j0 + jj) * 256;
#pragma unroll
        for (int w = 0; w < W; ++w)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[w][b] ^= Pj[(x[jj][w] >> (8 * b)) & 0xFFu];
      }
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) transpose4(acc[w]);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (io.has(t)) {
      uint8_t* dst = io.dst(t) + col;
      uint32_t row[W];
#pragma unroll
      for (int w = 0; w < W; ++w) row[w] = acc[w][t];
      if constexpr (kAcc) {
        uint32_t prev[W];
        load_words<W, kVec>(dst, rem, prev);
#pragma unroll
        for (int w = 0; w < W; ++w) row[w] ^= prev[w];
      }
      store_words<W, kVec>(dst, rem, row);
    }
  }
}

// The rows i0 .. i0+nrows-1 (one group, nrows <= 4) of the W words at
// `col` over the k source rows at `in`: apply_rows on DenseRows.
template <int W, bool kVec, bool kAcc = false>
__device__ inline void apply_group(const uint32_t* P, const uint8_t* in,
                                   uint8_t* out, int k, int64_t n,
                                   int64_t col, int64_t rem, int i0,
                                   int nrows) {
  apply_rows<W, kVec, kAcc>(P, DenseRows{in, out, n, i0, nrows}, k, col,
                            rem);
}

}  // namespace ctt
