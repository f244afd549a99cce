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
// Design: one block of 256 threads computes a 64 x 128 output tile. The
// depth is walked in slices of 32: each slice of a (64 x 32) and b
// (128 x 32) is converted to fp32 on load and staged in shared memory,
// transposed so that every thread reads its 4 rows and its 8 columns as
// float4 vectors. Each thread keeps a 4 x 8 register tile of fp32 sums, so
// every shared-memory value it reads feeds 4 or 8 subtract/add pairs. The
// 128 columns of a block are exactly one chunk, so the chunk maximum is a
// reduction over the 16 threads of a half-warp (warp shuffles): no second
// pass and no atomics. Ragged B, N and d are masked (zero padding adds
// |0 - 0| = 0 to a sum; padded rows and columns are never stored).
//
// Gradients (B2/B6): one kernel computes either output. A block owns 8 rows of
// the output ("own" rows: rows of a for da, rows of b for db) and one 128-wide
// slice of the depth, one thread per column k, and walks over every row of the
// other operand ("stream" rows) in tiles of 32 staged in shared memory together
// with the matching 8 x 32 tile of w. db needs w transposed: the tile is read
// along j (coalesced) and stored stream-major, so both outputs read it the same
// way. Each thread keeps its 8 own values and 8 sums in registers. Every
// (own, stream, k) term is a subtract, a sign (two selects) and an FMA on the
// CUDA cores, summed over stream rows in order: no atomics, so a result does
// not depend on scheduling. Inputs are widened to fp32 on load before the
// subtract, because a bf16 subtract can round a small difference to 0 and flip
// the sign. da and db are two launches, like the two pallas_calls.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so that a refused launch reaches the caller.

#include <cuda_bf16.h>
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// blockIdx.z is the group: a is (G, B, d), b (G, N, d), out (G, B, N), all dense.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    l1_distance_matrix_kernel(const T* __restrict__ a, const T* __restrict__ b,
                              T* __restrict__ out, int B, int N, int d) {
  a += (long long)blockIdx.z * B * d;
  b += (long long)blockIdx.z * N * d;
  out += (long long)blockIdx.z * B * N;
  const int row0 = blockIdx.y * kTileRows;
  const long long col0 = (long long)blockIdx.x * kTileCols;
  float acc[kRowsPerThread][kColsPerThread];
  l1_tile(a, b, B, N, d, row0, col0, acc);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const long long c = col0 + tile_col(tx, j);
      if (c < N) store(out + (long long)r * N + c, acc[i][j]);
    }
  }
}

dim3 grid_for(int B, int N, int G = 1) {
  return dim3((N + kTileCols - 1) / kTileCols, (B + kTileRows - 1) / kTileRows, G);
}

constexpr int kGradOwn = 8;        // output rows per block
constexpr int kGradStream = 32;    // streamed rows per shared-memory tile
constexpr int kGradThreads = 128;  // one thread per depth column of the slice

__device__ __forceinline__ float sign_f32(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// out[o, k] = sum_s w(o, s) * sign(x[o, k] - y[s, k]) over the n_stream rows of y,
// for the block's kGradOwn rows o. w(o, s) = w[o * ld_own + s * ld_stream] of the
// group's (B, N) cotangent: (ld_own, ld_stream) = (N, 1) for da (x = a, y = b) and
// (1, N) for db (x = b, y = a; sign(b - a) = -sign(a - b) exactly in fp32).
// blockIdx.y is the group.
template <typename T>
__global__ void __launch_bounds__(kGradThreads)
    l1_grad_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const float* __restrict__ w, float* __restrict__ out, int n_own,
                   int n_stream, int d, int ld_own, int ld_stream) {
  __shared__ __align__(16) float ys[kGradStream][kGradThreads];
  __shared__ __align__(16) float ws[kGradStream][kGradOwn];
  const long long grp = blockIdx.y;
  x += grp * n_own * d;
  y += grp * n_stream * d;
  w += grp * n_own * n_stream;
  out += grp * n_own * d;
  const int o0 = blockIdx.x * kGradOwn;
  const int tid = threadIdx.x;
  const bool transposed = ld_own == 1;

  for (int k0 = 0; k0 < d; k0 += kGradThreads) {
    const int k = k0 + tid;
    float xo[kGradOwn], acc[kGradOwn];
#pragma unroll
    for (int o = 0; o < kGradOwn; ++o) {
      xo[o] = (o0 + o < n_own && k < d) ? to_f32(x[(long long)(o0 + o) * d + k]) : 0.f;
      acc[o] = 0.f;
    }
    for (int s0 = 0; s0 < n_stream; s0 += kGradStream) {
      __syncthreads();  // the previous tile is consumed
      // Fully unrolled: all 32 loads of a thread are in flight at once (with
      // 4 warps per block, nothing else hides their latency).
#pragma unroll
      for (int s = 0; s < kGradStream; ++s) {
        ys[s][tid] = (s0 + s < n_stream && k < d) ? to_f32(y[(long long)(s0 + s) * d + k]) : 0.f;
      }
      for (int e = tid; e < kGradStream * kGradOwn; e += kGradThreads) {
        // Neighbouring threads read neighbouring addresses of w in both layouts.
        const int o = transposed ? e % kGradOwn : e / kGradStream;
        const int s = transposed ? e / kGradOwn : e % kGradStream;
        ws[s][o] = (o0 + o < n_own && s0 + s < n_stream)
                       ? w[(long long)(o0 + o) * ld_own + (long long)(s0 + s) * ld_stream]
                       : 0.f;  // padding rows weigh 0
      }
      __syncthreads();
#pragma unroll 8
      for (int s = 0; s < kGradStream; ++s) {
        const float yv = ys[s][tid];
        const float4 w0 = *reinterpret_cast<const float4*>(&ws[s][0]);
        const float4 w1 = *reinterpret_cast<const float4*>(&ws[s][4]);
        const float wv[kGradOwn] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int o = 0; o < kGradOwn; ++o) acc[o] = fmaf(wv[o], sign_f32(xo[o] - yv), acc[o]);
      }
    }
    if (k < d) {
#pragma unroll
      for (int o = 0; o < kGradOwn; ++o)
        if (o0 + o < n_own) out[(long long)(o0 + o) * d + k] = acc[o];
    }
  }
}

template <typename T>
void launch_grads(const void* a, const void* b, const void* w, void* da, void* db, int G,
                  int B, int N, int d, cudaStream_t s) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const float* tw = static_cast<const float*>(w);
  dim3 grid_a((B + kGradOwn - 1) / kGradOwn, G);
  l1_grad_kernel<T><<<grid_a, kGradThreads, 0, s>>>(ta, tb, tw, static_cast<float*>(da), B, N,
                                                     d, N, 1);
  dim3 grid_b((N + kGradOwn - 1) / kGradOwn, G);
  l1_grad_kernel<T><<<grid_b, kGradThreads, 0, s>>>(tb, ta, tw, static_cast<float*>(db), N, B,
                                                     d, 1, N);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a and b alike). N must be a multiple of 128.
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
    else
      l1_scores_chunkmax_kernel<__nv_bfloat16><<<grid_for(B, N), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
          static_cast<const uint8_t*>(valid), static_cast<float*>(scores),
          static_cast<float*>(cmax), B, N, d, bad);
  }
  return static_cast<int>(cudaGetLastError());
}

// a (G, B, d), b (G, N, d), out (G, B, N), dense. dtype: 0 = float32,
// 1 = bfloat16; out has a's dtype. G = 1 is the unbatched distance (B5).
extern "C" int bess_l1_distance_matrix_batched(const void* a, const void* b, void* out, int G,
                                               int B, int N, int d, int dtype, void* stream) {
  if (G > 0 && B > 0 && N > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      l1_distance_matrix_kernel<float><<<grid_for(B, N, G), kThreads, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(out), B, N, d);
    else
      l1_distance_matrix_kernel<__nv_bfloat16><<<grid_for(B, N, G), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
          static_cast<__nv_bfloat16*>(out), B, N, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// a (G, B, d) and b (G, N, d) in float32 (dtype 0) or bfloat16 (dtype 1), w (G, B, N)
// float32; writes da (G, B, d) and db (G, N, d) in float32, two launches. G = 1 is
// the unbatched gradient (B6).
extern "C" int bess_l1_distance_grads_batched(const void* a, const void* b, const void* w,
                                              void* da, void* db, int G, int B, int N, int d,
                                              int dtype, void* stream) {
  if (G > 0 && B > 0 && N > 0 && d > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch_grads<float>(a, b, w, da, db, G, B, N, d, s);
    else
      launch_grads<__nv_bfloat16>(a, b, w, da, db, G, B, N, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}
