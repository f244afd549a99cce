// Fused in-place dense AdamW over a whole (M, D) table (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel dense_adamw_update (B10,
// besskge_tpu/ops/pallas_adamw.py), the update of optim.FusedDenseAdamW. For
// every element, with g = grad and p = param widened to fp32:
//   mu <- b1 * mu + (1 - b1) * g
//   nu <- b2 * nu + (1 - b2) * (g * g)
//   p  <- p - lr * ((mu * c1) / (sqrt(nu * c2) + eps) + wd * p)
// where c1 = 1 / (1 - b1^t) and c2 = 1 / (1 - b2^t) are the bias corrections of
// the post-increment step t. param (fp32 or bf16), mu and nu (fp32) are written
// in place; grad is fp32 or bf16.
//
// Bound: bytes. Each element reads g, p, mu and nu and writes p, mu and nu
// once: 28 bytes in fp32, against ~12 floating-point instructions. At the
// biokg table (93,773 x 128 = 12,002,944 elements) that is 336 MB, 0.100 ms
// at 3.35 TB/s; the instructions take 0.004 ms at the fp32 rate.
//
// Design: one launch per update, streaming at the memory's rate.
//   * The kernel computes c1 and c2 itself, in every thread, from the step
//     count it reads from device memory: t = (float)count, then
//     1 / (1 - powf(b, t)), each operation rounded on its own as the plain
//     version's torch.pow, rsub and reciprocal are. A step therefore needs no
//     host synchronisation and no kernel of its own for the corrections. The
//     learning rate is read through its pointer when it is a tensor.
//   * Each thread updates kUnroll groups of four elements, a block's threads
//     kUnroll * 256 consecutive groups: it issues all 8 loads (16 bytes of
//     fp32, 8 of bf16, from each of the four streams) before the first
//     arithmetic, so neighbouring threads read neighbouring addresses and
//     each SM keeps ~128 KB in flight. One block per tile of the table (5,861
//     at the biokg table): the block scheduler starts a new tile wherever one
//     ends, which measured faster on the H100 than a persistent grid of
//     resident blocks walking the table, with contiguous or interleaved
//     shares, and than a ring of TMA bulk copies through shared memory
//     (PERF.md).
//   * Plain 16-byte loads and stores: the streaming hint (ld.global.cs /
//     st.global.cs, evict first), though the four 48 MB streams exceed the
//     50 MB L2 and are touched once per step, measured 1.5 % slower on an
//     H100 (PERF.md).
//   * Each multiply, add, divide and square root is rounded on its own
//     (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no FMA contraction), in
//     the order of the plain PyTorch version: mu and nu are equal to it bit
//     for bit. The param too, as long as this powf and torch.pow's agree to
//     the last bit of b^t; where they differ, c1 or c2 moves by one fp32 ulp
//     and the param by less than one ulp of the update lr * step.
// A table whose pointers are not all 16-byte aligned, and the last n % 4
// elements, take the same arithmetic one element at a time.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so that a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // groups of four elements of each stream in flight per thread

struct Coefficients {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

// Four consecutive elements widened to fp32, and back: one 16-byte access
// for fp32, one 8-byte access for bf16.
__device__ __forceinline__ void load4(const float* src, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ float bf16_bits(unsigned bits) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(bits & 0xFFFFu)));
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float* out) {
  const uint2 x = *reinterpret_cast<const uint2*>(src);
  out[0] = bf16_bits(x.x);
  out[1] = bf16_bits(x.x >> 16);
  out[2] = bf16_bits(x.y);
  out[3] = bf16_bits(x.y >> 16);
}
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned bits_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(bits_bf16(v[0]) | (bits_bf16(v[1]) << 16),
                                              bits_bf16(v[2]) | (bits_bf16(v[3]) << 16));
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// 1 / (1 - b^t), rounded as torch's reciprocal(1 - pow(b, t)) in fp32.
__device__ __forceinline__ float correction(float b, float t) {
  return __frcp_rn(__fsub_rn(1.f, powf(b, t)));
}

// One element: returns the new param; updates m and v.
__device__ __forceinline__ float adamw(float p, float g, float& m, float& v, float c1, float c2,
                                       float lr, const Coefficients& k) {
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(k.one_minus_b2, __fmul_rn(g, g)));
  const float m_hat = __fmul_rn(m, c1);
  const float v_hat = __fmul_rn(v, c2);
  const float step = __fadd_rn(__fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), k.eps)),
                               __fmul_rn(k.wd, p));
  return __fsub_rn(p, __fmul_rn(lr, step));
}

template <typename P, typename G>
__device__ __forceinline__ void adamw_one(P* param, float* mu, float* nu, const G* grad,
                                          long long e, float c1, float c2, float lr,
                                          const Coefficients& k) {
  float m = mu[e], v = nu[e];
  const float p = adamw(widen(param[e]), widen(grad[e]), m, v, c1, c2, lr, k);
  narrow(param + e, p);
  mu[e] = m;
  nu[e] = v;
}

// aligned: every pointer is 16-byte aligned, so groups of four elements are
// read and written whole. count: the post-increment step, int32 (count64 = 0)
// or int64.
template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
    dense_adamw_kernel(P* __restrict__ param, float* __restrict__ mu, float* __restrict__ nu,
                       const G* __restrict__ grad, long long n, const void* __restrict__ count,
                       int count64, const float* __restrict__ lr_ptr, float lr_value,
                       Coefficients k, int aligned) {
  const float t = count64 ? static_cast<float>(*static_cast<const long long*>(count))
                          : static_cast<float>(*static_cast<const int*>(count));
  const float c1 = correction(k.b1, t);
  const float c2 = correction(k.b2, t);
  const float lr = lr_ptr != nullptr ? *lr_ptr : lr_value;
  if (!aligned) {
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (e < n) adamw_one(param, mu, nu, grad, e, c1, c2, lr, k);
    return;
  }
  const long long groups = n / 4;
  const long long q = (long long)blockIdx.x * kUnroll * kThreads + threadIdx.x;
  float pa[kUnroll][4], ga[kUnroll][4], ma[kUnroll][4], va[kUnroll][4];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = (q + u * kThreads) * 4;
    if (q + u * kThreads < groups) {
      load4(param + e, pa[u]);
      load4(grad + e, ga[u]);
      load4(mu + e, ma[u]);
      load4(nu + e, va[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = (q + u * kThreads) * 4;
    if (q + u * kThreads < groups) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[u][j] = adamw(pa[u][j], ga[u][j], ma[u][j], va[u][j], c1, c2, lr, k);
      store4(param + e, pa[u]);
      store4(mu + e, ma[u]);
      store4(nu + e, va[u]);
    }
  }
  // The last n % 4 elements, one thread each.
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < n - groups * 4)
    adamw_one(param, mu, nu, grad, groups * 4 + threadIdx.x, c1, c2, lr, k);
}

template <typename P, typename G>
void launch(void* param, void* mu, void* nu, const void* grad, long long n, const void* count,
            int count64, const float* lr_ptr, float lr_value, const Coefficients& k, int aligned,
            cudaStream_t s) {
  // One block per kUnroll * kThreads groups of four (aligned) or per
  // kThreads elements.
  long long blocks = aligned ? (n / 4 + kUnroll * kThreads - 1) / (kUnroll * kThreads)
                             : (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  dense_adamw_kernel<P, G><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<P*>(param), static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<const G*>(grad), n, count, count64, lr_ptr, lr_value, k, aligned);
}

}  // namespace

// param (n elements, fp32 when param_bf16 is 0, else bf16), mu and nu (n fp32), grad
// (n elements, fp32 when grad_bf16 is 0, else bf16), all dense. count: the
// post-increment step on the device, int32 (count64 = 0) or int64. lr is read from
// lr_ptr (one fp32 on the device) when it is not null, else lr_value. aligned: 1 when
// every pointer is 16-byte aligned.
extern "C" int bess_dense_adamw(void* param, void* mu, void* nu, const void* grad, long long n,
                                int param_bf16, int grad_bf16, const void* count, int count64,
                                const void* lr_ptr, float lr_value, float b1, float b2,
                                float eps, float wd, float one_minus_b1, float one_minus_b2,
                                int aligned, void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Coefficients k = {b1, one_minus_b1, b2, one_minus_b2, eps, wd};
    const float* lr = static_cast<const float*>(lr_ptr);
    if (!param_bf16 && !grad_bf16)
      launch<float, float>(param, mu, nu, grad, n, count, count64, lr, lr_value, k, aligned, s);
    else if (!param_bf16)
      launch<float, __nv_bfloat16>(param, mu, nu, grad, n, count, count64, lr, lr_value, k,
                                   aligned, s);
    else if (!grad_bf16)
      launch<__nv_bfloat16, float>(param, mu, nu, grad, n, count, count64, lr, lr_value, k,
                                   aligned, s);
    else
      launch<__nv_bfloat16, __nv_bfloat16>(param, mu, nu, grad, n, count, count64, lr, lr_value,
                                           k, aligned, s);
  }
  return static_cast<int>(cudaGetLastError());
}
