// Hamming best-2 search for Hopper (sm_90a): two kernels, one source.
//
// Both replace the TPU kernel `masked_best2_fused` of
// openmavis_tpu/frontend/matcher_pallas.py (wrapper :94-153, body `_kernel`
// :37-82, pl.pallas_call at :123): for each query descriptor row, the best
// and second-best Hamming distance over the admissible target columns, and
// the argmin column, without ever storing the [N, M] distance matrix.
//
//   hamming_best2     admissibility given as a bool mask [N, M], any strides
//                     (match_nn: stereo and temporal spawn, mutual pass);
//   projection_best2  admissibility given by its O(N + M) factors, tested in
//                     the kernel (match_projection: map -> frame search);
//                     no [N, M] array exists anywhere on this route.
//
// Semantics (held exactly against the plain versions in
// openmavis_tpu_torch/frontend/matcher_cuda.py):
//   * descriptors are {0,1} int8 planes [*, 256]; the kernels pack them
//     themselves, bit i of word j = plane 32*j + i, which is
//     orb.pack_bits' order; distance is popcount(a ^ b) over 8 words.
//     Planes and mask bytes must be 0 or 1 (torch's bool is); the packing
//     reads their lowest bit;
//   * an inadmissible pair has distance INVALID = 300 (> 256);
//   * each column's key is (dist << 20) | col, unique per column, so a min
//     over keys is the argmin with ties to the smallest column, exact for
//     M < 2^20 (the TPU kernel's f32 packing capped M at 32768);
//   * second-best is over a different column; a row with no admissible
//     target returns (0, 300, 300);
//   * projection_best2 admits (n, m) iff valid_query[n] && feat_valid[m]
//     && |x_n - x_m| < r_n && |y_n - y_m| < r_n (float32, one rounded
//     subtraction, strict compare: NaN or inf admits nothing)
//     && level_m in [level_n - 1, level_n + 1].
//
// What bounds them. At the main-path shape (16,384 landmarks x 512
// features) the mask form must read 8.4 MB of mask, 4.2 MB of query planes
// and 0.13 MB of target planes and write 0.2 MB: 12.9 MB, 3.9 us at
// 3.35 TB/s. The factor form reads no mask and, of the query rows, only the
// live ones: at most 16,384 x 273 B + 512 x 269 B + 16,384 x 12 B = 4.8 MB,
// 1.4 us. Both are bound by bytes, and both bounds lie below the cost of a
// launch plus one round trip to device memory, so the design is about
// latency: few dependent steps, many independent loads in flight, and no
// byte read that the result does not need.
//
// Design.
//   * Persistent grid: one block of 32 warps per SM (fewer when N is
//     small); a block stages a tile of up to 512 targets ONCE and then
//     walks all its query rows, one warp per row.
//   * Staging packs the target planes in the kernel: a warp instruction
//     loads two rows, 16 bytes per lane; a mask and one multiply turn 4
//     bytes into 4 bits; one shuffle joins two lanes' halves to a word.
//     Targets that already are words (launch_packed) are copied with
//     16-byte loads.
//   * Shared layout (padding AND a column permutation): word w of column c
//     lives at s_w[w * 513 + perm(c)], perm(c) = (c % 16) * 32 + c / 16.
//     The odd row stride spreads the 8 words of one column over 8 banks
//     (the staging store is conflict-free); the permutation makes lanes
//     that own 16 contiguous columns each (the mask's 16-byte vectors) hit
//     32 different banks when they all look at their k-th column.
//   * Mask streaming: a lane reads 16 contiguous mask bytes with one
//     16-byte load from the 16-byte-aligned address at or below its
//     columns (an unaligned or sliced mask only shifts which bits count),
//     so one warp instruction covers 512 columns. The loads of 4 rows are
//     started before the first is looked at. 16 bytes become 16 hit bits; a
//     row whose bits are all zero touches neither its descriptor nor the
//     targets. Only on a hit does the warp load and pack the query row
//     (one 8-byte load per lane) and the hit lanes pop 8 words.
//   * A mask whose ROW stride is 1 (the transposed view of the mutual
//     pass) is read along its contiguous axis: each thread loads 16 rows
//     of one column with one 16-byte load, the block transposes a 32-row x
//     512-column tile through shared memory, and the warps then read their
//     rows from there exactly as above. A mask with neither stride 1 takes
//     a byte-gather path (correct, slow).
//   * The factor form stages the features' xy, level and validity beside
//     the words (6.5 KB at M = 512). A block reads its rows' validity
//     coalesced, writes (0, 300, 300) for dead rows at once, and compacts
//     the live rows into a shared list that its warps share out, so dead
//     rows cost one byte each and live rows are spread evenly.
//   * Lanes keep a private (best, second) key pair; a warp folds them with
//     two `__reduce_min_sync` using the TPU kernel's fold (`_kernel`:71-75),
//     and a row without a hit skips the fold. With more
//     than 512 targets the tiles are walked outermost and a row's keys
//     rest in the output arrays between tiles (the same warp of the same
//     block owns a row in every tile).
//
// Resources (nvcc 12.8 -Xptxas=-v, sm_90a; 1,024 threads a block allow 64
// registers, nothing spills): hamming_best2 from planes 64 registers
// (mask rows contiguous), 54 (transposed), 63 (gather); from words 57, 32,
// 43; shared memory 16,416 B, 33,312 B with the transposed tile.
// projection_best2 61 registers, 27,172 B. One block is resident per SM.
//
// What is left of the time (H100, kernels alone in a CUDA graph): a launch
// costs 1.3 us; staging costs every block one round trip to L2 for the
// same 128 KB of target planes; then a row needs its mask vector or its
// factors, then its query planes, then its store: three dependent trips
// to memory. A dense mask turns the kernel into XOR/POPC work (POPC runs
// at a quarter of the integer rate), and a small N (512 rows are 16
// blocks) leaves most SMs idle. PERF.md has the numbers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WORDS = 8;             // 256 bits per descriptor
constexpr int TILE_M = 512;          // target columns staged per tile
constexpr int TS = TILE_M + 1;       // padded stride of a word row
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;  // query rows per block pass
constexpr int UNROLL = 4;            // rows whose mask loads are in flight
constexpr int MS = TILE_M + 16;      // stride of a transposed mask row
constexpr int COL_BITS = 20;
constexpr int COL_MASK = (1 << COL_BITS) - 1;
constexpr int INVALID = 300;
constexpr int KEY_INIT = (INVALID << COL_BITS) | COL_MASK;
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS == 2 * TILE_M, "staging maps two threads per column");
static_assert(TILE_M == 16 * 32, "a warp's 16-byte vectors cover one tile");

// mask layouts
constexpr int COLS_CONTIG = 0;   // stride_m == 1
constexpr int ROWS_CONTIG = 1;   // stride_n == 1 (transposed view)
constexpr int GATHER = 2;        // neither

__device__ __forceinline__ int perm(int c) {
  return ((c & 15) << 5) | (c >> 4);
}

// 4 bytes, each 0 or 1 -> 4 bits (bit k = byte k). The multiply moves
// byte k's bit to position 24 + k; no two partial products meet, so there
// is no carry, and what passes bit 31 drops out.
__device__ __forceinline__ unsigned nib(unsigned x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned bits16(const uint4& x) {
  return nib(x.x) | (nib(x.y) << 4) | (nib(x.z) << 8) | (nib(x.w) << 12);
}

__device__ __forceinline__ void push(int& best, int& second, int key) {
  if (key < best) {
    second = best;
    best = key;
  } else if (key < second) {
    second = key;
  }
}

__device__ __forceinline__ void fold(int& b0, int& s0, int b1, int s1) {
  const int lo = min(b0, b1);
  const int hi = max(b0, b1);
  s0 = min(min(s0, s1), hi);
  b0 = lo;
}

// The 8 words of one query row, in every lane of the warp. All 32 lanes
// call it together.
template <bool PACKED>
__device__ __forceinline__ void load_query(const void* q, long long stride_q,
                                           int row, int lane,
                                           unsigned (&qw)[WORDS]) {
  if (PACKED) {
    const int* w = static_cast<const int*>(q) +
                   static_cast<long long>(row) * WORDS;
#pragma unroll
    for (int j = 0; j < WORDS; ++j) qw[j] = static_cast<unsigned>(w[j]);
    return;
  }
  const unsigned char* p = static_cast<const unsigned char*>(q) +
                           static_cast<long long>(row) * stride_q;
  if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    // one 8-byte load per lane: planes 8*lane .. 8*lane+7, a quarter word
    const uint2 x = *reinterpret_cast<const uint2*>(p + 8 * lane);
    unsigned v = (nib(x.x) | (nib(x.y) << 4)) << (8 * (lane & 3));
    v |= __shfl_xor_sync(FULL, v, 1);
    v |= __shfl_xor_sync(FULL, v, 2);
#pragma unroll
    for (int j = 0; j < WORDS; ++j) qw[j] = __shfl_sync(FULL, v, 4 * j);
  } else {
#pragma unroll
    for (int j = 0; j < WORDS; ++j)
      qw[j] = __ballot_sync(FULL, (p[32 * j + lane] & 1) != 0);
  }
}

// Pack (or copy) the targets j0 .. j0+tile-1 into s_w. The whole block
// calls it; the caller synchronizes before and after.
template <bool PACKED>
__device__ __forceinline__ void stage_targets(const void* t,
                                              long long stride_t, int j0,
                                              int tile, int* s_w) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (PACKED) {
    // thread = (shared position, half of the row): consecutive lanes store
    // to consecutive banks and load 16 bytes each
    const int pos = threadIdx.x & (TILE_M - 1);
    const int h = threadIdx.x >> 9;
    const int c = ((pos & 31) << 4) | (pos >> 5);   // perm(c) == pos
    if (c < tile) {
      const uint4 x = *(reinterpret_cast<const uint4*>(
                            static_cast<const int*>(t) +
                            static_cast<long long>(j0 + c) * WORDS) + h);
      s_w[(4 * h + 0) * TS + pos] = static_cast<int>(x.x);
      s_w[(4 * h + 1) * TS + pos] = static_cast<int>(x.y);
      s_w[(4 * h + 2) * TS + pos] = static_cast<int>(x.z);
      s_w[(4 * h + 3) * TS + pos] = static_cast<int>(x.w);
    }
    return;
  }
  const unsigned char* base = static_cast<const unsigned char*>(t) +
                              static_cast<long long>(j0) * stride_t;
  if (((reinterpret_cast<uintptr_t>(base) |
        static_cast<unsigned long long>(stride_t)) & 15) == 0) {
    // lanes 0-15 take row c, lanes 16-31 row c + 256 (16 banks apart)
    constexpr int ITERS = TILE_M / 2 / WARPS;
    const int sub = lane & 15;
    const int c0 = warp + (lane >> 4) * (TILE_M / 2);
    uint4 x[ITERS];
#pragma unroll
    for (int u = 0; u < ITERS; ++u) {
      const int c = c0 + u * WARPS;
      x[u] = make_uint4(0u, 0u, 0u, 0u);
      if (c < tile)
        x[u] = *reinterpret_cast<const uint4*>(
            base + static_cast<long long>(c) * stride_t + 16 * sub);
    }
#pragma unroll
    for (int u = 0; u < ITERS; ++u) {
      const int c = c0 + u * WARPS;
      unsigned v = bits16(x[u]) << (16 * (lane & 1));
      v |= __shfl_xor_sync(FULL, v, 1);
      if ((lane & 1) == 0 && c < tile)
        s_w[(sub >> 1) * TS + perm(c)] = static_cast<int>(v);
    }
  } else {
    for (int c = warp; c < tile; c += WARPS) {
      const unsigned char* p = base + static_cast<long long>(c) * stride_t;
      unsigned mine = 0u;
#pragma unroll
      for (int j = 0; j < WORDS; ++j) {
        const unsigned w = __ballot_sync(FULL, (p[32 * j + lane] & 1) != 0);
        if (lane == j) mine = w;
      }
      if (lane < WORDS) s_w[lane * TS + perm(c)] = static_cast<int>(mine);
    }
  }
}

__device__ __forceinline__ int hamming(const unsigned (&qw)[WORDS],
                                       const int* s_w, int pos) {
  int acc = 0;
#pragma unroll
  for (int w = 0; w < WORDS; ++w)
    acc += __popc(qw[w] ^ static_cast<unsigned>(s_w[w * TS + pos]));
  return acc;
}

// One lane's 16 hit bits of one row: bit k stands for tile column
// cbase + k. All 32 lanes call it together (the query row is loaded by the
// whole warp, once, at the row's first hit).
template <bool PACKED>
__device__ __forceinline__ void consume(unsigned hits, int cbase, int tile,
                                        int j0, const int* s_w, const void* q,
                                        long long stride_q, int row, int lane,
                                        bool& have_q, unsigned (&qw)[WORDS],
                                        int& best, int& second) {
  const int lo = max(0, -cbase);
  const int hi = min(16, tile - cbase);
  hits = hi > lo ? hits & ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
  if (!__any_sync(FULL, hits != 0u)) return;
  if (!have_q) {
    load_query<PACKED>(q, stride_q, row, lane, qw);
    have_q = true;
  }
  while (hits) {
    const int c = cbase + __ffs(hits) - 1;
    hits &= hits - 1u;
    const int dist = hamming(qw, s_w, perm(c));
    push(best, second, (dist << COL_BITS) | (j0 + c));
  }
}

// Fold the warp's lanes and store the row; all 32 lanes call it together.
// `any_hit` (warp-uniform) says whether any lane pushed a key: a row
// without one skips the fold. The fold is the TPU kernel's, over 32 lanes
// at once: keys are unique per column, so the best is the warp's minimum,
// and the second is the minimum of what is left when the lane that owns
// the best puts forward its second. Between tiles the raw keys rest in
// out_best / out_second; the last tile decodes them.
__device__ __forceinline__ void finish_row(int best, int second, bool any_hit,
                                           bool first, bool last, int lane,
                                           int row, int* out_idx,
                                           int* out_best, int* out_second) {
  if (!first) {
    if (!any_hit && !last) return;   // the keys at rest stay as they are
    if (lane == 0) fold(best, second, out_best[row], out_second[row]);
    any_hit = true;
  }
  if (any_hit) {
    const int lo = __reduce_min_sync(FULL, best);
    second = __reduce_min_sync(FULL, best == lo ? second : best);
    best = lo;
  }
  int v = second >> COL_BITS;
  int* dst = out_second;
  if (last) {
    const int d = best >> COL_BITS;
    if (lane == 0) {
      v = d >= INVALID ? 0 : (best & COL_MASK);
      dst = out_idx;
    } else if (lane == 1) {
      v = d;
      dst = out_best;
    }
    if (lane < 3) dst[row] = v;
  } else {
    if (lane == 1) {
      v = best;
      dst = out_best;
    } else {
      v = second;
    }
    if (lane == 1 || lane == 2) dst[row] = v;
  }
}

__device__ __forceinline__ unsigned byte_of(const uint4& x, int k) {
  const unsigned w = (k >> 2) == 0 ? x.x : (k >> 2) == 1 ? x.y
                   : (k >> 2) == 2 ? x.z : x.w;
  return (w >> (8 * (k & 3))) & 0xffu;
}

template <int MODE, bool PACKED>
__global__ void __launch_bounds__(THREADS)
hamming_best2_kernel(const void* __restrict__ q, long long stride_q,
                     const void* __restrict__ t, long long stride_t,
                     const unsigned char* __restrict__ mask,
                     long long stride_n, long long stride_m, int N, int M,
                     int* __restrict__ out_idx, int* __restrict__ out_best,
                     int* __restrict__ out_second) {
  __shared__ int s_w[WORDS * TS];
  __shared__ __align__(16) unsigned char
      s_m[MODE == ROWS_CONTIG ? WARPS * MS : 16];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = (N + WARPS - 1) / WARPS;   // 32 rows each

  for (int j0 = 0; j0 < M; j0 += TILE_M) {
    const int tile = min(TILE_M, M - j0);
    const bool first = j0 == 0;
    const bool last = j0 + TILE_M >= M;
    __syncthreads();   // the previous tile is fully consumed
    stage_targets<PACKED>(t, stride_t, j0, tile, s_w);
    __syncthreads();

    if (MODE == ROWS_CONTIG) {
      for (int g = blockIdx.x; g < groups; g += gridDim.x) {
        const int r0 = g * WARPS;
        {
          // thread = (column, 16 of the group's 32 rows)
          const int c = threadIdx.x & (TILE_M - 1);
          const int r16 = (threadIdx.x >> 9) * 16;
          if (c < tile) {
            const unsigned char* src =
                mask + static_cast<long long>(j0 + c) * stride_m + r0 + r16;
            uint4 x = make_uint4(0u, 0u, 0u, 0u);
            if (r0 + r16 + 16 <= N &&
                (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
              x = *reinterpret_cast<const uint4*>(src);
#pragma unroll
              for (int k = 0; k < 16; ++k)
                s_m[(r16 + k) * MS + c] =
                    static_cast<unsigned char>(byte_of(x, k));
            } else {
#pragma unroll
              for (int k = 0; k < 16; ++k)
                s_m[(r16 + k) * MS + c] = static_cast<unsigned char>(
                    (r0 + r16 + k < N) ? src[k] : 0);
            }
          }
        }
        __syncthreads();
        const int row = r0 + warp;
        if (row < N) {
          const uint4 x =
              *reinterpret_cast<const uint4*>(s_m + warp * MS + 16 * lane);
          int best = KEY_INIT, second = KEY_INIT;
          bool have_q = false;
          unsigned qw[WORDS];
          consume<PACKED>(bits16(x), 16 * lane, tile, j0, s_w, q, stride_q,
                          row, lane, have_q, qw, best, second);
          finish_row(best, second, have_q, first, last, lane, row, out_idx,
                     out_best, out_second);
        }
        __syncthreads();   // s_m is rewritten by the next group
      }
    } else {
      for (int g0 = blockIdx.x; g0 < groups; g0 += gridDim.x * UNROLL) {
        uint4 mk[UNROLL];
        int off[UNROLL];
        // start the first mask vector of UNROLL rows before using any
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int g = g0 + u * gridDim.x;
          const int row = g * WARPS + warp;
          mk[u] = make_uint4(0u, 0u, 0u, 0u);
          off[u] = 0;
          if (g < groups && row < N) {
            if (MODE == COLS_CONTIG) {
              const unsigned char* rp =
                  mask + static_cast<long long>(row) * stride_n + j0;
              off[u] = static_cast<int>(reinterpret_cast<uintptr_t>(rp) & 15);
              if (16 * lane < off[u] + tile)
                mk[u] = *reinterpret_cast<const uint4*>(rp - off[u] +
                                                        16 * lane);
            } else {
              const unsigned char* rp =
                  mask + static_cast<long long>(row) * stride_n +
                  static_cast<long long>(j0) * stride_m;
              unsigned bits = 0u;
#pragma unroll
              for (int k = 0; k < 16; ++k) {
                const int c = 16 * lane + k;
                if (c < tile && rp[static_cast<long long>(c) * stride_m])
                  bits |= 1u << k;
              }
              mk[u].x = bits;   // already hit bits
            }
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int g = g0 + u * gridDim.x;
          const int row = g * WARPS + warp;
          if (g >= groups || row >= N) continue;
          int best = KEY_INIT, second = KEY_INIT;
          bool have_q = false;
          unsigned qw[WORDS];
          const unsigned hits =
              MODE == COLS_CONTIG ? bits16(mk[u]) : mk[u].x;
          consume<PACKED>(hits, 16 * lane - off[u], tile, j0, s_w, q,
                          stride_q, row, lane, have_q, qw, best, second);
          if (MODE == COLS_CONTIG && off[u] + tile > 16 * 32) {
            // an unaligned row of a full tile spills into a 33rd vector
            const unsigned char* a0 =
                mask + static_cast<long long>(row) * stride_n + j0 - off[u];
            unsigned more = 0u;
            if (lane == 0)
              more = bits16(*reinterpret_cast<const uint4*>(a0 + 16 * 32));
            consume<PACKED>(more, 16 * (32 + lane) - off[u], tile, j0, s_w, q,
                            stride_q, row, lane, have_q, qw, best, second);
          }
          finish_row(best, second, have_q, first, last, lane, row, out_idx,
                     out_best, out_second);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
projection_best2_kernel(const float* __restrict__ proj_xy,       // [N, 2]
                        const int* __restrict__ pred_level,      // [N]
                        const float* __restrict__ radius,        // or null
                        long long stride_r, float radius_all,
                        const unsigned char* __restrict__ d_query,
                        long long stride_q,
                        const unsigned char* __restrict__ valid_query,
                        const float* __restrict__ feat_xy,       // [M, 2]
                        const int* __restrict__ feat_level,      // [M]
                        const unsigned char* __restrict__ feat_desc,
                        long long stride_t,
                        const unsigned char* __restrict__ feat_valid,
                        int N, int M, int rows_per_block,
                        int* __restrict__ out_idx, int* __restrict__ out_best,
                        int* __restrict__ out_second) {
  __shared__ int s_w[WORDS * TS];
  __shared__ float s_x[TILE_M];
  __shared__ float s_y[TILE_M];
  __shared__ int s_lv[TILE_M];
  __shared__ unsigned char s_ok[TILE_M];
  __shared__ int s_live[THREADS];
  __shared__ int s_nlive;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * rows_per_block;
  const int b1 = min(N, b0 + rows_per_block);

  for (int j0 = 0; j0 < M; j0 += TILE_M) {
    const int tile = min(TILE_M, M - j0);
    const bool first = j0 == 0;
    const bool last = j0 + TILE_M >= M;
    __syncthreads();   // the previous tile is fully consumed
    stage_targets<false>(feat_desc, stride_t, j0, tile, s_w);
    for (int c = threadIdx.x; c < TILE_M; c += THREADS) {
      const int pos = perm(c);
      const bool in = c < tile;
      s_x[pos] = in ? feat_xy[2 * (j0 + c)] : 0.0f;
      s_y[pos] = in ? feat_xy[2 * (j0 + c) + 1] : 0.0f;
      s_lv[pos] = in ? feat_level[j0 + c] : 0;
      s_ok[pos] = in ? feat_valid[j0 + c] : static_cast<unsigned char>(0);
    }

    for (int base = b0; base < b1; base += THREADS) {
      if (threadIdx.x == 0) s_nlive = 0;
      __syncthreads();   // also publishes the staged tile
      const int r = base + threadIdx.x;
      if (r < b1) {
        if (valid_query[r]) {
          s_live[atomicAdd(&s_nlive, 1)] = r;
        } else if (first) {
          // a dead row reads neither its descriptor nor any feature, and
          // no later tile touches it again
          out_idx[r] = 0;
          out_best[r] = INVALID;
          out_second[r] = INVALID;
        }
      }
      __syncthreads();
      const int nlive = s_nlive;
      for (int i = warp; i < nlive; i += WARPS) {
        const int row = s_live[i];
        const float px = proj_xy[2 * row];
        const float py = proj_xy[2 * row + 1];
        const float rad = radius ? radius[row * stride_r] : radius_all;
        const int l1 = pred_level[row];
        // int32 arithmetic that wraps, as the plain version's does
        const int lv_lo = static_cast<int>(static_cast<unsigned>(l1) - 1u);
        const int lv_hi = static_cast<int>(static_cast<unsigned>(l1) + 1u);
        int best = KEY_INIT, second = KEY_INIT;
        bool have_q = false;
        unsigned qw[WORDS];
        // bit k: the lane's k-th column, 16 * lane + k, is admissible
        unsigned hits = 0u;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int pos = k * 32 + lane;           // perm(16 * lane + k)
          const int l2 = s_lv[pos];
          const bool hit = s_ok[pos] &&
                           fabsf(__fsub_rn(px, s_x[pos])) < rad &&
                           fabsf(__fsub_rn(py, s_y[pos])) < rad &&
                           l2 >= lv_lo && l2 <= lv_hi;
          hits |= static_cast<unsigned>(hit) << k;
        }
        consume<false>(hits, 16 * lane, tile, j0, s_w, d_query, stride_q, row,
                       lane, have_q, qw, best, second);
        finish_row(best, second, have_q, first, last, lane, row, out_idx,
                   out_best, out_second);
      }
      __syncthreads();   // s_live is rewritten by the next piece
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    return 1;
  return sms;
}

template <bool PACKED>
int launch_mask(const void* q, long long stride_q, const void* t,
                long long stride_t, const void* mask, long long stride_n,
                long long stride_m, int N, int M, void* out_idx,
                void* out_best, void* out_second, void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  const int groups = (N + WARPS - 1) / WARPS;
  const dim3 grid(std::min(groups, sm_count()));
  const dim3 block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  int* oi = static_cast<int*>(out_idx);
  int* ob = static_cast<int*>(out_best);
  int* os = static_cast<int*>(out_second);
  if (stride_m == 1)
    hamming_best2_kernel<COLS_CONTIG, PACKED><<<grid, block, 0, s>>>(
        q, stride_q, t, stride_t, mk, stride_n, stride_m, N, M, oi, ob, os);
  else if (stride_n == 1)
    hamming_best2_kernel<ROWS_CONTIG, PACKED><<<grid, block, 0, s>>>(
        q, stride_q, t, stride_t, mk, stride_n, stride_m, N, M, oi, ob, os);
  else
    hamming_best2_kernel<GATHER, PACKED><<<grid, block, 0, s>>>(
        q, stride_q, t, stride_t, mk, stride_n, stride_m, N, M, oi, ob, os);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d1 [N, 256], d2 [M, 256] int8 planes with row strides in bytes.
extern "C" int hamming_best2_launch(const void* d1, long long stride1,
                                    const void* d2, long long stride2,
                                    const void* mask, long long stride_n,
                                    long long stride_m, int N, int M,
                                    void* out_idx, void* out_best,
                                    void* out_second, void* stream) {
  return launch_mask<false>(d1, stride1, d2, stride2, mask, stride_n,
                            stride_m, N, M, out_idx, out_best, out_second,
                            stream);
}

// q [N, 8], t [M, 8] int32 words, contiguous, 16-byte aligned.
extern "C" int hamming_best2_packed_launch(const void* q, const void* t,
                                           const void* mask,
                                           long long stride_n,
                                           long long stride_m, int N, int M,
                                           void* out_idx, void* out_best,
                                           void* out_second, void* stream) {
  return launch_mask<true>(q, 0, t, 0, mask, stride_n, stride_m, N, M,
                           out_idx, out_best, out_second, stream);
}

// radius: [N] float32 with element stride `stride_r` (0 broadcasts one
// value), or null to use `radius_all` for every row.
extern "C" int projection_best2_launch(
    const void* proj_xy, const void* pred_level, const void* radius,
    long long stride_r, float radius_all, const void* d_query,
    long long stride_q, const void* valid_query, const void* feat_xy,
    const void* feat_level, const void* feat_desc, long long stride_t,
    const void* feat_valid, int N, int M, void* out_idx, void* out_best,
    void* out_second, void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = std::min((N + WARPS - 1) / WARPS, sm_count());
  const int rows_per_block = (N + blocks - 1) / blocks;
  projection_best2_kernel<<<dim3(blocks), dim3(THREADS), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(proj_xy),
      static_cast<const int*>(pred_level), static_cast<const float*>(radius),
      stride_r, radius_all, static_cast<const unsigned char*>(d_query),
      stride_q, static_cast<const unsigned char*>(valid_query),
      static_cast<const float*>(feat_xy), static_cast<const int*>(feat_level),
      static_cast<const unsigned char*>(feat_desc), stride_t,
      static_cast<const unsigned char*>(feat_valid), N, M, rows_per_block,
      static_cast<int*>(out_idx), static_cast<int*>(out_best),
      static_cast<int*>(out_second));
  return static_cast<int>(cudaGetLastError());
}
