// L1 distance tiles and their gradients (Hopper, sm_90a).
//
// Replaces five Pallas TPU kernels of besskge_tpu/ops/pallas_distance.py:
//   * l1_scores_chunkmax (B7): s[i, j] = -sum_k |a[i, k] - b[j, k]| + bad * (1 - valid[j])
//     together with the maximum of s over every 128-column chunk of a row;
//   * l1_distance_matrix (B5) and l1_distance_matrix_batched (B1):
//     out[g, i, j] = sum_k |a[g, i, k] - b[g, j, k]|, stored in a's dtype; B5 is the
//     one-group case of the same kernel;
//   * l1_distance_grads (B6) and l1_distance_grads_batched (B2), the two VJPs of the
//     distance: da[g, i] = sum_j w[g, i, j] * sign(a[g, i] - b[g, j]) and
//     db[g, j] = -sum_i w[g, i, j] * sign(a[g, i] - b[g, j]), sign(0) = 0, in fp32;
//     B6 is the one-group case.
//
// Bound: L1 distance has no matrix-product form, so tensor cores do not
// apply. Each (i, j, k) step costs two fp32 instructions on the CUDA cores
// (a subtract, and an add with an |.| source modifier); at the serving shape
// (512 x 131072 x 128 per window) that is about 30x the time of moving the
// bytes, so the kernels are bound by fp32 instruction issue.
//
// B7: one block of 256 threads computes a 64 x 128 output tile (l1_tile).
// The depth is walked in slices of 32: each slice of a (64 x 32) and b
// (128 x 32) is converted to fp32 on load and staged in shared memory,
// transposed so that every thread reads its 4 rows and its 8 columns as
// float4 vectors. Each thread keeps a 4 x 8 register tile of fp32 sums, so
// every shared-memory value it reads feeds 4 or 8 subtract/add pairs. The 128
// columns of a block are exactly one chunk, so the chunk maximum is a
// reduction over the 16 threads of a half-warp (warp shuffles): no second
// pass and no atomics.
//
// B1 and B5 (l1_distance_small_kernel): 32 (or 16) rows x 48 columns per
// block of 128 threads, the whole depth (up to 128) loaded at once and staged
// in two halves, a 4 (or 2) x 3 register tile; see the section above
// l1_distance_small_kernel below. At the sparse step's (8, 256, 288, 128)
// its 384 blocks divide the shape exactly, where B7's 64 x 128 tile would
// give 96 blocks on 132 SMs and 25 % padding columns. Measured on an H100 it
// also took less time than the 64 x 128 tile at every grid size tried, the
// serving window's included (PERF.md), so it is the one design of the
// distance. Each sum runs over k = 0 ... d - 1 in order in one thread: no
// atomics, and the same bits on a repeat call.
//
// Ragged B, N and d are masked (zero padding adds |0 - 0| = 0 to a sum;
// padded rows and columns are never stored).
//
// Gradients (B2/B6): one launch for both outputs, register-tiled, with the
// stream tiles staged through a cp.async ring; see the section above
// l1_grads_kernel below.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so that a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;    // rows of a per block
constexpr int kTileCols = 128;   // columns (candidates) per block == chunk
constexpr int kDepth = 32;       // depth slice staged in shared memory
constexpr int kThreads = 256;    // 16 column groups x 16 row groups
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = 8;
constexpr int kPad = 4;          // keeps float4 rows 16-byte aligned

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

// Column of the tile that register column j of thread group tx holds:
// two float4 groups, 64 columns apart.
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// acc[i][j] = sum_k |a[row_i, k] - b[col_j, k]| for this thread's 4 x 8 tile.
template <typename T>
__device__ __forceinline__ void l1_tile(const T* __restrict__ a, const T* __restrict__ b,
                                        int B, int N, int d, int row0, long long col0,
                                        float (&acc)[kRowsPerThread][kColsPerThread]) {
  __shared__ __align__(16) float As[kDepth][kTileRows + kPad];
  __shared__ __align__(16) float Bs[kDepth][kTileCols + kPad];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kDepth) {
    // Consecutive threads read consecutive k of one row: coalesced.
    for (int e = tid; e < kTileRows * kDepth; e += kThreads) {
      const int r = e / kDepth, k = e % kDepth;
      const int gr = row0 + r, gk = k0 + k;
      As[k][r] = (gr < B && gk < d) ? to_f32(a[(long long)gr * d + gk]) : 0.f;
    }
    for (int e = tid; e < kTileCols * kDepth; e += kThreads) {
      const int c = e / kDepth, k = e % kDepth;
      const long long gc = col0 + c;
      const int gk = k0 + k;
      Bs[k][c] = (gc < N && gk < d) ? to_f32(b[gc * d + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kDepth; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float ar[kRowsPerThread] = {av.x, av.y, av.z, av.w};
      const float br[kColsPerThread] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[i][j] += fabsf(ar[i] - br[j]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    l1_scores_chunkmax_kernel(const T* __restrict__ a, const T* __restrict__ b,
                              const uint8_t* __restrict__ valid, float* __restrict__ scores,
                              float* __restrict__ cmax, int B, int N, int d, float bad) {
  const int row0 = blockIdx.y * kTileRows;
  const long long col0 = (long long)blockIdx.x * kTileCols;
  float acc[kRowsPerThread][kColsPerThread];
  l1_tile(a, b, B, N, d, row0, col0, acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  bool ok[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) ok[j] = valid[col0 + tile_col(tx, j)] != 0;

  const int n_chunk = N / kTileCols;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = row0 + ty * 4 + i;
    float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      // valid: -dist; invalid: bad - dist (the same fp32 sum as -dist + bad).
      acc[i][j] = ok[j] ? -acc[i][j] : bad - acc[i][j];
      m = fmaxf(m, acc[i][j]);
    }
    // The 16 threads of one row group are the 16 lanes of a half-warp.
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (r < B) {
      float* out = scores + (long long)r * N + col0;
      *reinterpret_cast<float4*>(out + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(out + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      if (tx == 0) cmax[(long long)r * n_chunk + blockIdx.x] = m;
    }
  }
}

dim3 grid_for(int B, int N) {
  return dim3((N + kTileCols - 1) / kTileCols, (B + kTileRows - 1) / kTileRows);
}

// ---------------------------------------------------------------------------
// Gradients (B2/B6): one launch computes both outputs. The grid holds the da
// blocks, then the db blocks; blockIdx.x selects the role. In either role a
// block owns TO rows of the output ("own" rows: rows of a for da, rows of b
// for db) and one kGradDepth-wide slice of the depth, and walks over every row
// of the other operand ("stream" rows) in tiles of kGradStream, in order:
//   out[o, k] = sum_s w(o, s) * sign(x[o, k] - y[s, k]),
// with (x, y) = (a, b) and w(o, s) = w[o, s] for da, and (x, y) = (b, a) and
// w(o, s) = w[s, o] for db (sign(b - a) = -sign(a - b) exactly in fp32).
//
// Bound: each (i, j, k) term needs at least 4 fp32-pipe instructions (a
// subtract, the sign, a multiply-add into da and one into db), 0.009 ms at
// the training shape (8 x 256 x 288 x 128). This design computes each term
// once for da and once for db (no atomics, no reduction across threads), so
// its own floor is about twice that.
//
// Design, against what held the two-launch kernel back (8 own rows x 1 column
// per thread, synchronous staging, 8 warps per SM):
//   * Register tiling: a thread of the 128 (8 row groups x 16 column pairs)
//     holds RO own rows x 2 depth columns of x and of the sums. For each group
//     of four stream rows it reads its 2 x 4 values of y (one 4-byte bf16 pair
//     or 8-byte fp32 pair per row) and its RO x 4 weights (RO=4: four 16-byte
//     reads) from shared memory, and each read feeds RO or 2 terms.
//   * The sign-multiply is a copy of w's magnitude under t's sign bit (t =
//     x - y in fp32: one lop3) added under the predicate t != 0 (setp and a
//     predicated add): 4 instructions per term where the old kernel took 6.
//     Multiplying by +-1 is exact and a +-0 term leaves a sum unchanged, so
//     the value is that of w * sign(t).
//   * Asynchronous staging: stream tiles of y (in the input dtype; widened to
//     fp32 after the shared read and before the subtract, because a bf16
//     subtract can round a small difference to 0 and flip the sign) and of w
//     go through a ring of kGradStages stages in shared memory with 16-byte
//     cp.async copies, two tiles ahead of the arithmetic. The da tile of w
//     is own-major (rows of w are contiguous along the stream axis), the db
//     tile stream-major (contiguous along the own axis): both copy whole
//     16-byte runs. Shapes whose rows are not 16-byte runs (N % 4, or d *
//     sizeof(T) % 16, or an unaligned pointer) stage with plain loads.
//   * The grid: TO = 32 own rows (RO = 4) and 32-column depth slices give
//     544 blocks of 4 warps at the training shape, all resident at once (4-5
//     per SM: the kernel is compiled for 5). Where that grid would hold fewer than two blocks per SM (one
//     group, B6), TO = 8 (RO = 1) quadruples it: 272 blocks at 256 x 288.
// Every (own, depth) sum runs over the stream rows in one fixed order in one
// thread: no atomics, so repeated calls give identical bits.

constexpr int kGradStream = 32;   // stream rows per stage
constexpr int kGradDepth = 32;    // depth columns per block
constexpr int kGradThreads = 128;  // 8 row groups x 16 column pairs
constexpr int kGradStages = 3;
// Resident blocks per SM the kernel is compiled for (at most 102 registers a
// thread): 544 blocks at the training shape then run in one wave on 132 SMs.
constexpr int kGradBlocksPerSM = 5;

template <typename T, int RO>
struct GradTile {
  static constexpr int kOwn = 8 * RO;                // own rows per block
  static constexpr int kWPitch = kGradStream + 4;    // own-major w row, floats
  static constexpr int kYBytes = kGradStream * kGradDepth * sizeof(T);
  static constexpr int kWFloats = kOwn * kWPitch;    // >= kGradStream * kOwn
  static constexpr int kStageBytes = kYBytes + kWFloats * 4;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc + w * sign(t), sign(0) = 0.
__device__ __forceinline__ float add_signed(float acc, float w, float t) {
  const float c = __int_as_float(__float_as_int(w) ^ (__float_as_int(t) & 0x80000000));
  asm("{\n .reg .pred p;\n setp.ne.f32 p, %1, 0f00000000;\n @p add.rn.f32 %0, %0, %2;\n}\n"
      : "+f"(acc)
      : "f"(t), "f"(c));
  return acc;
}

// Two consecutive values of y widened to fp32.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
}
__device__ __forceinline__ float2 load_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// One stream tile (rows s0 ...) of y and w into stage buffers ys and ws.
template <typename T, int RO, bool ALIGNED, bool OWN_MAJOR>
__device__ __forceinline__ void stage_tile(const T* __restrict__ y, const float* __restrict__ w,
                                           T* ys, float* ws, int o0, int s0, int k0, int n_own,
                                           int n_stream, int d, int ld_w) {
  using Tile = GradTile<T, RO>;
  const int tid = threadIdx.x;
  if constexpr (ALIGNED) {
    constexpr int kPerRow = kGradDepth * sizeof(T) / 16;  // 16-byte runs per y row
    constexpr int kVals = 16 / sizeof(T);
    for (int c = tid; c < kGradStream * kPerRow; c += kGradThreads) {
      const int r = c / kPerRow, k = (c % kPerRow) * kVals;
      const bool ok = s0 + r < n_stream && k0 + k < d;
      cp_async16(ys + r * kGradDepth + k, ok ? y + (long long)(s0 + r) * d + k0 + k : y, ok);
    }
    if constexpr (OWN_MAJOR) {  // ws[o][s]: rows of w run along the stream axis
      constexpr int kRuns = kGradStream / 4;
      for (int c = tid; c < Tile::kOwn * kRuns; c += kGradThreads) {
        const int o = c / kRuns, s = (c % kRuns) * 4;
        const bool ok = o0 + o < n_own && s0 + s < n_stream;
        cp_async16(ws + o * Tile::kWPitch + s,
                   ok ? w + (long long)(o0 + o) * ld_w + s0 + s : w, ok);
      }
    } else {  // ws[s][o]: rows of w run along the own axis
      constexpr int kRuns = Tile::kOwn / 4;
      for (int c = tid; c < kGradStream * kRuns; c += kGradThreads) {
        const int s = c / kRuns, o = (c % kRuns) * 4;
        const bool ok = o0 + o < n_own && s0 + s < n_stream;
        cp_async16(ws + s * Tile::kOwn + o,
                   ok ? w + (long long)(s0 + s) * ld_w + o0 + o : w, ok);
      }
    }
  } else {
    for (int e = tid; e < kGradStream * kGradDepth; e += kGradThreads) {
      const int r = e / kGradDepth, k = e % kGradDepth;
      ys[e] = (s0 + r < n_stream && k0 + k < d) ? y[(long long)(s0 + r) * d + k0 + k] : T(0.f);
    }
    for (int e = tid; e < kGradStream * Tile::kOwn; e += kGradThreads) {
      // Neighbouring threads read neighbouring addresses of w in both layouts.
      const int o = OWN_MAJOR ? e / kGradStream : e % Tile::kOwn;
      const int s = OWN_MAJOR ? e % kGradStream : e / Tile::kOwn;
      const bool ok = o0 + o < n_own && s0 + s < n_stream;
      const float v = ok ? (OWN_MAJOR ? w[(long long)(o0 + o) * ld_w + s0 + s]
                                      : w[(long long)(s0 + s) * ld_w + o0 + o])
                         : 0.f;  // padding rows weigh 0
      ws[OWN_MAJOR ? o * Tile::kWPitch + s : s * Tile::kOwn + o] = v;
    }
  }
}

// One block's (own tile, depth slice) of one role. ld_w: row stride of the
// group's (B, N) cotangent, N in both roles.
template <typename T, int RO, bool ALIGNED, bool OWN_MAJOR>
__device__ __forceinline__ void grad_tile(const T* __restrict__ x, const T* __restrict__ y,
                                          const float* __restrict__ w, float* __restrict__ out,
                                          int n_own, int n_stream, int d, int o0, int k0,
                                          unsigned char* smem) {
  using Tile = GradTile<T, RO>;
  const int tr = threadIdx.x >> 4;  // row group: own rows tr * RO ...
  const int tc = threadIdx.x & 15;  // column pair: depth k0 + 2 tc, +1
  const int ld_w = OWN_MAJOR ? n_stream : n_own;
  float xo[RO][2], acc[RO][2];
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int o = o0 + tr * RO + r, k = k0 + 2 * tc + c;
      xo[r][c] = (o < n_own && k < d) ? to_f32(x[(long long)o * d + k]) : 0.f;
      acc[r][c] = 0.f;
    }
  auto ys_of = [&](int st) { return reinterpret_cast<T*>(smem + st * Tile::kStageBytes); };
  auto ws_of = [&](int st) {
    return reinterpret_cast<float*>(smem + st * Tile::kStageBytes + Tile::kYBytes);
  };

  const int n_tiles = (n_stream + kGradStream - 1) / kGradStream;
#pragma unroll
  for (int t = 0; t < kGradStages - 1; ++t) {
    if (t < n_tiles)
      stage_tile<T, RO, ALIGNED, OWN_MAJOR>(y, w, ys_of(t), ws_of(t), o0, t * kGradStream, k0,
                                            n_own, n_stream, d, ld_w);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kGradStages - 2>();  // this thread's copies of tile t have landed
    __syncthreads();                   // everyone's have, and tile t - 1 is consumed
    const int next = t + kGradStages - 1;
    if (next < n_tiles)
      stage_tile<T, RO, ALIGNED, OWN_MAJOR>(y, w, ys_of(next % kGradStages),
                                            ws_of(next % kGradStages), o0, next * kGradStream,
                                            k0, n_own, n_stream, d, ld_w);
    cp_async_commit();
    const T* ys = ys_of(t % kGradStages);
    const float* ws = ws_of(t % kGradStages);
#pragma unroll 2
    for (int s = 0; s < kGradStream; s += 4) {
      float2 yv[4];
      float wv[RO][4];  // [own row][stream row]
#pragma unroll
      for (int q = 0; q < 4; ++q) yv[q] = load_pair(ys + (s + q) * kGradDepth + 2 * tc);
      if constexpr (OWN_MAJOR) {
#pragma unroll
        for (int r = 0; r < RO; ++r) {
          const float4 v =
              *reinterpret_cast<const float4*>(ws + (tr * RO + r) * Tile::kWPitch + s);
          wv[r][0] = v.x;
          wv[r][1] = v.y;
          wv[r][2] = v.z;
          wv[r][3] = v.w;
        }
      } else if constexpr (RO == 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(ws + (s + q) * Tile::kOwn + tr * 4);
          wv[0][q] = v.x;
          wv[1][q] = v.y;
          wv[2][q] = v.z;
          wv[3][q] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int r = 0; r < RO; ++r) wv[r][q] = ws[(s + q) * Tile::kOwn + tr * RO + r];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < RO; ++r) {
          acc[r][0] = add_signed(acc[r][0], wv[r][q], __fsub_rn(xo[r][0], yv[q].x));
          acc[r][1] = add_signed(acc[r][1], wv[r][q], __fsub_rn(xo[r][1], yv[q].y));
        }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int o = o0 + tr * RO + r, k = k0 + 2 * tc + c;
      if (o < n_own && k < d) out[(long long)o * d + k] = acc[r][c];
    }
}

// a (G, B, d), b (G, N, d), w (G, B, N); da (G, B, d), db (G, N, d). Blocks
// [0, blocks_a) compute da, the rest db; each decodes (group, own tile, depth
// slice) from its index, the depth slice fastest.
template <typename T, int RO, bool ALIGNED>
__global__ void __launch_bounds__(kGradThreads, kGradBlocksPerSM)
    l1_grads_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const float* __restrict__ w, float* __restrict__ da,
                    float* __restrict__ db, int B, int N, int d, int blocks_a) {
  using Tile = GradTile<T, RO>;
  __shared__ __align__(16) unsigned char smem[kGradStages * Tile::kStageBytes];
  const bool role_a = static_cast<int>(blockIdx.x) < blocks_a;
  int idx = role_a ? blockIdx.x : blockIdx.x - blocks_a;
  const int slices = (d + kGradDepth - 1) / kGradDepth;
  const int n_own = role_a ? B : N;
  const int own_tiles = (n_own + Tile::kOwn - 1) / Tile::kOwn;
  const int k0 = (idx % slices) * kGradDepth;
  idx /= slices;
  const int o0 = (idx % own_tiles) * Tile::kOwn;
  const long long grp = idx / own_tiles;
  a += grp * B * d;
  b += grp * N * d;
  w += grp * B * N;
  if (role_a)
    grad_tile<T, RO, ALIGNED, true>(a, b, w, da + grp * B * d, B, N, d, o0, k0, smem);
  else
    grad_tile<T, RO, ALIGNED, false>(b, a, w, db + grp * N * d, N, B, d, o0, k0, smem);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <typename T, int RO>
void launch_grads_tiled(const T* a, const T* b, const float* w, float* da, float* db, int G,
                        int B, int N, int d, bool aligned, cudaStream_t s) {
  constexpr int own = GradTile<T, RO>::kOwn;
  const long long slices = (d + kGradDepth - 1) / kGradDepth;
  const long long blocks_a = G * slices * ((B + own - 1) / own);
  const long long blocks = blocks_a + G * slices * ((N + own - 1) / own);
  if (aligned)
    l1_grads_kernel<T, RO, true><<<(unsigned)blocks, kGradThreads, 0, s>>>(a, b, w, da, db, B, N,
                                                                          d, (int)blocks_a);
  else
    l1_grads_kernel<T, RO, false><<<(unsigned)blocks, kGradThreads, 0, s>>>(a, b, w, da, db, B,
                                                                           N, d, (int)blocks_a);
}

template <typename T>
void launch_grads(const void* a, const void* b, const void* w, void* da, void* db, int G, int B,
                  int N, int d, cudaStream_t s) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const float* tw = static_cast<const float*>(w);
  // 16-byte runs: rows of w (N floats) and of a and b (d values), and the bases.
  const bool aligned = N % 4 == 0 && (d * sizeof(T)) % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  // 4-row tiles unless their grid would hold fewer than two blocks per SM.
  constexpr int own = GradTile<T, 4>::kOwn;
  const long long slices = (d + kGradDepth - 1) / kGradDepth;
  const long long wide = G * slices * ((B + own - 1) / own + (N + own - 1) / own);
  if (wide >= 2LL * sm_count())
    launch_grads_tiled<T, 4>(ta, tb, tw, static_cast<float*>(da), static_cast<float*>(db), G, B,
                             N, d, aligned, s);
  else
    launch_grads_tiled<T, 1>(ta, tb, tw, static_cast<float*>(da), static_cast<float*>(db), G, B,
                             N, d, aligned, s);
}

// ---------------------------------------------------------------------------
// The distance (B1, B5). A block of 128 threads computes 8R rows x 48
// columns of one group's output (R = 4: 32 rows, or R = 2: 16 rows where the
// 32-row grid would leave SMs without a block). Against what starved a
// 64 x 128 tile at the training shape:
//   * The grid: at (8, 256, 288) the 32 x 48 tiles divide B and N exactly
//     (no padding; the 64 x 128 grid computed 25 % padding columns) and give
//     384 blocks of 4 warps, 2.9 per SM, all resident at once, where the
//     64 x 128 grid gave 96 blocks on 132 SMs. One group at (256, 288)
//     takes 16 x 48 tiles: 96 blocks where the 64 x 128 grid gave 12.
//   * One load latency: the whole depth (up to kSmallDepth = 128) of the
//     block's rows of a and of b is loaded with every load in flight at once
//     (8 bytes, four bf16 values, or 16 bytes, four fp32 values, a thread)
//     and widened to fp32 in registers. The first half of the depth is
//     stored in shared memory and summed while the second half's loads
//     land; then the second half is stored and summed (two barriers, one
//     load latency, of which the second half's is hidden). Each staged value
//     is read by 16 (a) or 32 (b) threads, so it is widened once here and
//     not after each shared read (4 integer instructions per 4 values read
//     against 24 fp32 ones). Rows whose length is not a multiple of 4
//     values, or an unaligned base, stage one value at a time behind one
//     barrier.
//   * No bank conflicts: staged rows are 132 floats apart (33 16-byte units,
//     odd), so the 8 rows that a quarter-warp reads with one 16-byte access
//     lie in 8 different groups of 4 banks; a thread's rows of a are read by
//     16 threads at once (a broadcast); staging writes consecutive units.
//   * Register tile: a thread holds R rows x 3 columns (tc, tc + 16, tc + 32)
//     of sums; per 4 depth steps it reads R + 3 float4 values for 4 x 3R
//     terms of 2 fp32 instructions each (a subtract, then an add with an
//     |.| source modifier), 24R fp32 instructions per R + 3 shared reads.
// Each sum runs over k = 0 ... d - 1 in order in one thread, as in l1_tile:
// a repeat call gives the same bits.

constexpr int kSmallThreads = 128;      // 8 row groups x 16 column groups
constexpr int kSmallCols = 48;          // columns per block: 16 groups x 3
constexpr int kSmallColsPerThread = 3;  // columns tc, tc + 16, tc + 32
constexpr int kSmallDepth = 128;        // depth staged at once
constexpr int kSmallPitch = kSmallDepth + 4;
constexpr int kHalfQuads = kSmallDepth / 8;  // 4-value runs per row in a depth half
// Resident blocks per SM the kernel is compiled for (at most 168 registers a
// thread): 384 blocks at the training shape then run in one wave on 132 SMs.
constexpr int kSmallBlocksPerSM = 3;

template <int R>
struct SmallTile {
  static constexpr int kRows = 8 * R;                    // rows of a per block
  static constexpr int kStaged = kRows + kSmallCols;     // rows of a, then of b
  // 4-value runs of one depth half that each thread stages, of a and of b
  static constexpr int kAQuads = kRows * kHalfQuads / kSmallThreads;
  static constexpr int kBQuads = kSmallCols * kHalfQuads / kSmallThreads;
  static_assert(kRows * kHalfQuads % kSmallThreads == 0, "a runs split evenly");
  static_assert(kSmallCols * kHalfQuads % kSmallThreads == 0, "b runs split evenly");
};

// Four consecutive values of a row as loaded (Raw), and widened to fp32.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using Raw = float4;
  __device__ __forceinline__ static float4 widen(float4 v) { return v; }
};
template <>
struct Quad<__nv_bfloat16> {
  using Raw = uint2;
  __device__ __forceinline__ static float4 widen(uint2 u) {
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
  }
};
template <>
struct Quad<__half> {
  using Raw = uint2;
  __device__ __forceinline__ static float4 widen(uint2 u) {
    const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

// One depth half's runs of a thread, as loaded.
template <typename T, int R>
struct SmallRuns {
  typename Quad<T>::Raw a[SmallTile<R>::kAQuads], b[SmallTile<R>::kBQuads];
};

// Staged rows [0, kRows) hold rows row0 ... of a, rows [kRows, kStaged) rows
// col0 ... of b, each at depth k0 ... k0 + kSmallDepth - 1; zeros outside
// the arrays (an |0 - 0| term adds 0, and padded rows are never stored).
// With runs of 4 values the depth is staged in two halves: load_small_half
// puts one half's runs of this thread in flight, store_small_half widens
// them to fp32 and stores them.
template <typename T, int R>
__device__ __forceinline__ void load_small_half(const T* __restrict__ a, const T* __restrict__ b,
                                                int B, int N, int d, int row0, int col0, int k0,
                                                int half, SmallRuns<T, R>& v) {
  using Tile = SmallTile<R>;
  using Raw = typename Quad<T>::Raw;
#pragma unroll
  for (int i = 0; i < Tile::kAQuads; ++i) {
    const int q = i * kSmallThreads + threadIdx.x;
    const int r = q / kHalfQuads, k = k0 + (half * kHalfQuads + q % kHalfQuads) * 4;
    v.a[i] = Raw{};
    if (row0 + r < B && k < d)
      v.a[i] = *reinterpret_cast<const Raw*>(a + (long long)(row0 + r) * d + k);
  }
#pragma unroll
  for (int i = 0; i < Tile::kBQuads; ++i) {
    const int q = i * kSmallThreads + threadIdx.x;
    const int c = q / kHalfQuads, k = k0 + (half * kHalfQuads + q % kHalfQuads) * 4;
    v.b[i] = Raw{};
    if (col0 + c < N && k < d)
      v.b[i] = *reinterpret_cast<const Raw*>(b + (long long)(col0 + c) * d + k);
  }
}

template <typename T, int R>
__device__ __forceinline__ void store_small_half(int half, const SmallRuns<T, R>& v, float* s) {
  using Tile = SmallTile<R>;
#pragma unroll
  for (int i = 0; i < Tile::kAQuads; ++i) {
    const int q = i * kSmallThreads + threadIdx.x;
    *reinterpret_cast<float4*>(s + (q / kHalfQuads) * kSmallPitch +
                               (half * kHalfQuads + q % kHalfQuads) * 4) = Quad<T>::widen(v.a[i]);
  }
#pragma unroll
  for (int i = 0; i < Tile::kBQuads; ++i) {
    const int q = i * kSmallThreads + threadIdx.x;
    *reinterpret_cast<float4*>(s + (Tile::kRows + q / kHalfQuads) * kSmallPitch +
                               (half * kHalfQuads + q % kHalfQuads) * 4) = Quad<T>::widen(v.b[i]);
  }
}

// The same staging one value at a time, for rows that are not runs of 4.
template <typename T, int R>
__device__ __forceinline__ void stage_small_values(const T* __restrict__ a,
                                                   const T* __restrict__ b, int B, int N, int d,
                                                   int row0, int col0, int k0, float* s) {
  using Tile = SmallTile<R>;
  for (int e = threadIdx.x; e < Tile::kStaged * kSmallDepth; e += kSmallThreads) {
    const int r = e / kSmallDepth, kk = e % kSmallDepth, k = k0 + kk;
    float v = 0.f;
    if (r < Tile::kRows) {
      if (row0 + r < B && k < d) v = to_f32(a[(long long)(row0 + r) * d + k]);
    } else if (col0 + r - Tile::kRows < N && k < d) {
      v = to_f32(b[(long long)(col0 + r - Tile::kRows) * d + k]);
    }
    s[r * kSmallPitch + kk] = v;
  }
}

// acc[i][j] += the terms of staged depth columns [k_begin, k_end), in order
// (both multiples of 4).
template <int R>
__device__ __forceinline__ void accumulate_small(const float* s, int k_begin, int k_end,
                                                 float (&acc)[R][kSmallColsPerThread]) {
  const float* as = s + (threadIdx.x >> 4) * R * kSmallPitch;
  const float* bs = s + (SmallTile<R>::kRows + (threadIdx.x & 15)) * kSmallPitch;
#pragma unroll 4
  for (int k = k_begin; k < k_end; k += 4) {
    float4 av[R], bv[kSmallColsPerThread];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = *reinterpret_cast<const float4*>(as + i * kSmallPitch + k);
#pragma unroll
    for (int j = 0; j < kSmallColsPerThread; ++j)
      bv[j] = *reinterpret_cast<const float4*>(bs + 16 * j * kSmallPitch + k);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < kSmallColsPerThread; ++j) {
        acc[i][j] += fabsf(av[i].x - bv[j].x);
        acc[i][j] += fabsf(av[i].y - bv[j].y);
        acc[i][j] += fabsf(av[i].z - bv[j].z);
        acc[i][j] += fabsf(av[i].w - bv[j].w);
      }
  }
}

// a (G, B, d), b (G, N, d), out (G, B, N), dense. Block index: the column
// tile fastest, then the row tile, then the group.
template <typename T, int R, bool ALIGNED>
__global__ void __launch_bounds__(kSmallThreads, kSmallBlocksPerSM)
    l1_distance_small_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             T* __restrict__ out, int B, int N, int d) {
  using Tile = SmallTile<R>;
  __shared__ __align__(16) float s[Tile::kStaged * kSmallPitch];
  const int col_tiles = (N + kSmallCols - 1) / kSmallCols;
  const int row_tiles = (B + Tile::kRows - 1) / Tile::kRows;
  int idx = blockIdx.x;
  const int col0 = (idx % col_tiles) * kSmallCols;
  idx /= col_tiles;
  const int row0 = (idx % row_tiles) * Tile::kRows;
  const long long grp = idx / row_tiles;
  a += grp * B * d;
  b += grp * N * d;
  out += grp * B * N;

  float acc[R][kSmallColsPerThread];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < kSmallColsPerThread; ++j) acc[i][j] = 0.f;
  constexpr int kHalf = kSmallDepth / 2;
  for (int k0 = 0; k0 < d; k0 += kSmallDepth) {
    if (k0 > 0) __syncthreads();  // the previous depth slice is consumed
    const int n = d - k0;
    const int n4 = (min(n, kSmallDepth) + 3) & ~3;  // staged zeros fill the last run
    if constexpr (ALIGNED) {
      // Both halves' loads in flight at once; the second lands while the
      // first is summed.
      SmallRuns<T, R> lo, hi;
      load_small_half<T, R>(a, b, B, N, d, row0, col0, k0, 0, lo);
      load_small_half<T, R>(a, b, B, N, d, row0, col0, k0, 1, hi);
      store_small_half<T, R>(0, lo, s);
      __syncthreads();
      if (n >= kSmallDepth)
        accumulate_small<R>(s, 0, kHalf, acc);
      else
        accumulate_small<R>(s, 0, min(n4, kHalf), acc);
      store_small_half<T, R>(1, hi, s);
      __syncthreads();
      if (n >= kSmallDepth)
        accumulate_small<R>(s, kHalf, kSmallDepth, acc);
      else if (n4 > kHalf)
        accumulate_small<R>(s, kHalf, n4, acc);
    } else {
      stage_small_values<T, R>(a, b, B, N, d, row0, col0, k0, s);
      __syncthreads();
      accumulate_small<R>(s, 0, n4, acc);
    }
  }

  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + tr * R + i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < kSmallColsPerThread; ++j) {
      const int c = col0 + tc + 16 * j;
      if (c < N) store(out + (long long)r * N + c, acc[i][j]);
    }
  }
}

template <typename T, int R>
void launch_small_tiled(const T* a, const T* b, T* out, int G, int B, int N, int d,
                        cudaStream_t s) {
  constexpr int rows = SmallTile<R>::kRows;
  const long long blocks =
      (long long)G * ((B + rows - 1) / rows) * ((N + kSmallCols - 1) / kSmallCols);
  // Runs of 4 values: rows of a and b (d values) and the bases.
  const bool aligned =
      d % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % (4 * sizeof(T)) == 0;
  if (aligned)
    l1_distance_small_kernel<T, R, true><<<(unsigned)blocks, kSmallThreads, 0, s>>>(a, b, out, B,
                                                                                   N, d);
  else
    l1_distance_small_kernel<T, R, false><<<(unsigned)blocks, kSmallThreads, 0, s>>>(a, b, out, B,
                                                                                    N, d);
}

// 32-row tiles unless their grid would leave SMs without a block.
template <typename T>
void launch_distance(const void* a, const void* b, void* out, int G, int B, int N, int d,
                     cudaStream_t s) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* tout = static_cast<T*>(out);
  constexpr int rows = SmallTile<4>::kRows;
  const long long tiles =
      (long long)G * ((B + rows - 1) / rows) * ((N + kSmallCols - 1) / kSmallCols);
  if (tiles >= sm_count())
    launch_small_tiled<T, 4>(ta, tb, tout, G, B, N, d, s);
  else
    launch_small_tiled<T, 2>(ta, tb, tout, G, B, N, d, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (a and b alike). N must be a
// multiple of 128.
extern "C" int bess_l1_scores_chunkmax(const void* a, const void* b, const void* valid,
                                       void* scores, void* cmax, int B, int N, int d,
                                       int dtype, float bad, void* stream) {
  if (B > 0 && N > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      l1_scores_chunkmax_kernel<float><<<grid_for(B, N), kThreads, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<const uint8_t*>(valid), static_cast<float*>(scores),
          static_cast<float*>(cmax), B, N, d, bad);
    else if (dtype == 1)
      l1_scores_chunkmax_kernel<__nv_bfloat16><<<grid_for(B, N), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
          static_cast<const uint8_t*>(valid), static_cast<float*>(scores),
          static_cast<float*>(cmax), B, N, d, bad);
    else
      l1_scores_chunkmax_kernel<__half><<<grid_for(B, N), kThreads, 0, s>>>(
          static_cast<const __half*>(a), static_cast<const __half*>(b),
          static_cast<const uint8_t*>(valid), static_cast<float*>(scores),
          static_cast<float*>(cmax), B, N, d, bad);
  }
  return static_cast<int>(cudaGetLastError());
}

// a (G, B, d), b (G, N, d), out (G, B, N), dense. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16; out has a's dtype (an fp16 sum past 65,504 is
// stored as inf, as the Pallas kernel stores it). G = 1 is the unbatched distance (B5).
extern "C" int bess_l1_distance_matrix_batched(const void* a, const void* b, void* out, int G,
                                               int B, int N, int d, int dtype, void* stream) {
  if (G > 0 && B > 0 && N > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch_distance<float>(a, b, out, G, B, N, d, s);
    else if (dtype == 1)
      launch_distance<__nv_bfloat16>(a, b, out, G, B, N, d, s);
    else
      launch_distance<__half>(a, b, out, G, B, N, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// a (G, B, d) and b (G, N, d) in float32 (dtype 0), bfloat16 (1) or float16 (2), w (G, B, N)
// float32; writes da (G, B, d) and db (G, N, d) in float32 in one launch. G = 1 is
// the unbatched gradient (B6).
extern "C" int bess_l1_distance_grads_batched(const void* a, const void* b, const void* w,
                                              void* da, void* db, int G, int B, int N, int d,
                                              int dtype, void* stream) {
  if (G > 0 && B > 0 && N > 0 && d > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch_grads<float>(a, b, w, da, db, G, B, N, d, s);
    else if (dtype == 1)
      launch_grads<__nv_bfloat16>(a, b, w, da, db, G, B, N, d, s);
    else
      launch_grads<__half>(a, b, w, da, db, G, B, N, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}
