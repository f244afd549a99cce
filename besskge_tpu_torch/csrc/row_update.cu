// Sparse row reads and in-place row updates of the entity table (Hopper, sm_90a).
//
// Replaces four Pallas TPU kernels:
//   * scatter_rows (B3, besskge_tpu/ops/pallas_scatter.py):
//     table[idx[i] : idx[i] + h] = rows[h * i : h * i + h] for every slot i, in place;
//     with skip_dups, idx is sorted and only the first slot of each run of equal
//     indices writes (the later slots' rows may hold anything);
//   * fused_pair_sgdm (B4, besskge_tpu/ops/pallas_row_sgdm.py): for every sorted
//     slot that starts a run, the [param | momentum] row pair at even physical row
//     phys[i] of a pair-major (2N, D) fp32 table takes
//     m <- momentum * m + g (+ weight_decay * p),  p <- p - lr * m, in place;
//   * scatter_rows_multi (B8, besskge_tpu/ops/pallas_scatter.py): the B3 write with
//     h = 1 into k <= 4 tables in one launch, each table with its own index list
//     (lengths may differ) and its own sorted runs under skip_dups;
//   * gather_rows (B9, besskge_tpu/ops/pallas_scatter.py):
//     out[h * i : h * i + h] = table[idx[i] : idx[i] + h]; with skip_dups only the
//     first slot of each sorted run is read and written, the others are left as
//     they were (the caller reads first-of-run slots only).
//
// Bound: all four move bytes and compute almost nothing. At the training step
// (R = 8,704 slots of 1 KB pairs) B3 reads the unique slots' rows and writes
// them once (about 17.8 MB, 5.3 us at 3.35 TB/s); B4 reads each unique pair
// and its gradient row and writes the pair (about 21.8 MB, 6.5 us). B8 at
// k = 3 (param, mu, nu) reads and writes three 512-byte rows per unique row,
// B9 reads and writes one (h, D) block per unique slot. The TPU kernels were
// bound by issuing one DMA per row from a scalar core, and B8 shares that
// issue loop between the k tables; here the rows are spread over warps, so the
// issue rate is not the limit, and B8's one launch only saves k - 1 launches.
//
// Design: one warp per slot. A slot's h rows are contiguous in both the
// table and the rows buffer, so the warp copies h * row_bytes bytes with
// 16-byte loads and stores (neighbouring lanes on neighbouring addresses).
// The run test (i == 0 || idx[i] != idx[i - 1]) is evaluated by every lane of
// the slot's warp from global memory; no second pass and no atomics. B4 keeps
// the learning rate in device memory (or takes it as an argument), so a
// schedule needs no synchronisation with the host, and it rounds after the
// multiply and after the add as the plain PyTorch update does (no FMA
// contraction), so both give the same bits. B8 is B3 with a second grid axis
// over the k tables: blockIdx.y picks the table, whose pointers and lengths
// come in a small parameter struct, and a block past its table's length
// returns at once. It copies 16-byte or 4-byte words, never narrower, so a
// 32-bit packed table takes the same kernel. B9 is B3 with the roles of the
// table and the rows swapped. An index out of range, or an odd B4 index,
// traps: the access would land outside the table (the plain versions raise
// there).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so that a refused launch reaches the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // slots per block
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ bool starts_run(const int32_t* __restrict__ idx, long long i) {
  return i == 0 || idx[i] != idx[i - 1];
}

// V is the copy unit: uint4 (16 bytes), uint32_t or uint16_t; row_units rows
// of the table are row_units * sizeof(V) bytes.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(V* __restrict__ table, const int32_t* __restrict__ idx,
                        const V* __restrict__ rows, long long R, int h, long long n_rows,
                        int row_units, int skip_dups) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= R) return;
  if (skip_dups && !starts_run(idx, i)) return;
  const long long r = idx[i];
  if (r < 0 || r > n_rows - h) __trap();
  const long long n = (long long)h * row_units;
  V* dst = table + r * row_units;
  const V* src = rows + i * n;
  for (long long u = lane; u < n; u += 32) dst[u] = src[u];
}

__global__ void __launch_bounds__(kThreads)
    fused_pair_sgdm_kernel(float* __restrict__ table, const int32_t* __restrict__ phys,
                           const float* __restrict__ grads, long long R, int D,
                           long long n_rows, const float* __restrict__ lr_ptr, float lr_value,
                           float momentum, float weight_decay) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= R || !starts_run(phys, i)) return;
  const long long r = phys[i];
  if (r < 0 || r > n_rows - 2 || (r & 1)) __trap();
  const float lr = lr_ptr != nullptr ? *lr_ptr : lr_value;
  float* p = table + r * D;
  float* m = p + D;
  const float* g = grads + i * D;
  for (int c = lane * 4; c < D; c += 128) {
    float4 pv = *reinterpret_cast<const float4*>(p + c);
    float4 mv = *reinterpret_cast<const float4*>(m + c);
    float4 gv = *reinterpret_cast<const float4*>(g + c);
    float pa[4] = {pv.x, pv.y, pv.z, pv.w};
    float ma[4] = {mv.x, mv.y, mv.z, mv.w};
    const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float ge = ga[e];
      if (weight_decay != 0.f) ge = __fadd_rn(ge, __fmul_rn(weight_decay, pa[e]));
      ma[e] = __fadd_rn(__fmul_rn(momentum, ma[e]), ge);
      pa[e] = __fsub_rn(pa[e], __fmul_rn(lr, ma[e]));
    }
    *reinterpret_cast<float4*>(p + c) = make_float4(pa[0], pa[1], pa[2], pa[3]);
    *reinterpret_cast<float4*>(m + c) = make_float4(ma[0], ma[1], ma[2], ma[3]);
  }
}

// B8: one table per blockIdx.y; V is uint4 or uint32_t, row_units words a row.
constexpr int kMaxTables = 4;

struct MultiScatter {
  void* table[kMaxTables];
  const int32_t* idx[kMaxTables];
  const void* rows[kMaxTables];
  long long R[kMaxTables];
  long long n_rows[kMaxTables];
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_multi_kernel(MultiScatter s, int row_units, int skip_dups) {
  const int b = blockIdx.y;
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= s.R[b]) return;
  const int32_t* idx = s.idx[b];
  if (skip_dups && !starts_run(idx, i)) return;
  const long long r = idx[i];
  if (r < 0 || r >= s.n_rows[b]) __trap();
  V* dst = static_cast<V*>(s.table[b]) + r * row_units;
  const V* src = static_cast<const V*>(s.rows[b]) + i * row_units;
  for (int u = lane; u < row_units; u += 32) dst[u] = src[u];
}

// B9: the h rows from table[idx[i]] to out[h * i], one warp per slot.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(V* __restrict__ out, const V* __restrict__ table,
                       const int32_t* __restrict__ idx, long long R, int h, long long n_rows,
                       int row_units, int skip_dups) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= R) return;
  if (skip_dups && !starts_run(idx, i)) return;
  const long long r = idx[i];
  if (r < 0 || r > n_rows - h) __trap();
  const long long n = (long long)h * row_units;
  const V* src = table + r * row_units;
  V* dst = out + i * n;
  for (long long u = lane; u < n; u += 32) dst[u] = src[u];
}

unsigned blocks_for(long long R) { return static_cast<unsigned>((R + kWarps - 1) / kWarps); }

}  // namespace

// table: n_rows rows of row_bytes bytes; idx (R,) int32; rows (h * R) rows of the
// table's dtype, dense. unit: 16, 4 or 2, the copy width in bytes, which must
// divide row_bytes and the alignment of both pointers.
extern "C" int bess_scatter_rows(void* table, const void* idx, const void* rows, long long R,
                                 int h, long long n_rows, int row_bytes, int unit,
                                 int skip_dups, void* stream) {
  if (R > 0 && row_bytes > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* i32 = static_cast<const int32_t*>(idx);
    if (unit == 16)
      scatter_rows_kernel<uint4><<<blocks_for(R), kThreads, 0, s>>>(
          static_cast<uint4*>(table), i32, static_cast<const uint4*>(rows), R, h, n_rows,
          row_bytes / 16, skip_dups);
    else if (unit == 4)
      scatter_rows_kernel<uint32_t><<<blocks_for(R), kThreads, 0, s>>>(
          static_cast<uint32_t*>(table), i32, static_cast<const uint32_t*>(rows), R, h,
          n_rows, row_bytes / 4, skip_dups);
    else
      scatter_rows_kernel<uint16_t><<<blocks_for(R), kThreads, 0, s>>>(
          static_cast<uint16_t*>(table), i32, static_cast<const uint16_t*>(rows), R, h,
          n_rows, row_bytes / 2, skip_dups);
  }
  return static_cast<int>(cudaGetLastError());
}

// table (n_rows, D) fp32 pair-major, D a multiple of 4; phys (R,) int32 sorted even
// rows; grads (R, D) fp32. lr is read from lr_ptr when it is not null, else lr_value.
extern "C" int bess_fused_pair_sgdm(void* table, const void* phys, const void* grads,
                                    long long R, int D, long long n_rows, const void* lr_ptr,
                                    float lr_value, float momentum, float weight_decay,
                                    void* stream) {
  if (R > 0 && D > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    fused_pair_sgdm_kernel<<<blocks_for(R), kThreads, 0, s>>>(
        static_cast<float*>(table), static_cast<const int32_t*>(phys),
        static_cast<const float*>(grads), R, D, n_rows, static_cast<const float*>(lr_ptr),
        lr_value, momentum, weight_decay);
  }
  return static_cast<int>(cudaGetLastError());
}

// k tables (1 <= k <= 4) of n_rows[b] rows of row_bytes bytes each; idxs[b] (R[b],)
// int32; rows[b] (R[b]) dense rows of the table's dtype. unit: 16 or 4, the copy
// width in bytes, which must divide row_bytes and the alignment of every pointer.
extern "C" int bess_scatter_rows_multi(int k, void* const* tables, const void* const* idxs,
                                       const void* const* rows, const long long* R,
                                       const long long* n_rows, int row_bytes, int unit,
                                       int skip_dups, void* stream) {
  if (k < 1 || k > kMaxTables || (unit != 16 && unit != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  MultiScatter s = {};
  long long max_r = 0;
  for (int b = 0; b < k; ++b) {
    s.table[b] = tables[b];
    s.idx[b] = static_cast<const int32_t*>(idxs[b]);
    s.rows[b] = rows[b];
    s.R[b] = R[b];
    s.n_rows[b] = n_rows[b];
    if (R[b] > max_r) max_r = R[b];
  }
  if (max_r > 0 && row_bytes > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(blocks_for(max_r), k);
    if (unit == 16)
      scatter_rows_multi_kernel<uint4><<<grid, kThreads, 0, st>>>(s, row_bytes / 16, skip_dups);
    else
      scatter_rows_multi_kernel<uint32_t><<<grid, kThreads, 0, st>>>(s, row_bytes / 4, skip_dups);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (h * R) rows and table n_rows rows, both of row_bytes bytes and one dtype;
// idx (R,) int32. unit as for bess_scatter_rows.
extern "C" int bess_gather_rows(void* out, const void* table, const void* idx, long long R,
                                int h, long long n_rows, int row_bytes, int unit,
                                int skip_dups, void* stream) {
  if (R > 0 && row_bytes > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* i32 = static_cast<const int32_t*>(idx);
    if (unit == 16)
      gather_rows_kernel<uint4><<<blocks_for(R), kThreads, 0, s>>>(
          static_cast<uint4*>(out), static_cast<const uint4*>(table), i32, R, h, n_rows,
          row_bytes / 16, skip_dups);
    else if (unit == 4)
      gather_rows_kernel<uint32_t><<<blocks_for(R), kThreads, 0, s>>>(
          static_cast<uint32_t*>(out), static_cast<const uint32_t*>(table), i32, R, h, n_rows,
          row_bytes / 4, skip_dups);
    else
      gather_rows_kernel<uint16_t><<<blocks_for(R), kThreads, 0, s>>>(
          static_cast<uint16_t*>(out), static_cast<const uint16_t*>(table), i32, R, h, n_rows,
          row_bytes / 2, skip_dups);
  }
  return static_cast<int>(cudaGetLastError());
}
