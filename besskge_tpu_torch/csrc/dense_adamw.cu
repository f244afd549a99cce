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
// once: 28 bytes in fp32, against ~10 floating-point instructions. At the
// biokg table (93,773 x 128 = 12,002,944 elements) that is 336 MB, 0.100 ms
// at 3.35 TB/s; the instructions take 0.004 ms at the fp32 rate.
//
// Design: the TPU kernel streams 512-row tiles through VMEM, one grid step at
// a time. Here the table is one flat array: each thread updates four
// consecutive elements per iteration of a grid-stride loop, with 16-byte
// loads and stores of mu and nu (8-byte ones of a bf16 param), so neighbouring
// threads touch neighbouring addresses and the loads of a warp coalesce. No
// shared memory and no reduction: the pass streams at the memory's rate. The
// ragged tail (fewer than four elements, or a table whose pointers are not
// 16-byte aligned) takes the same code one element at a time. c1, c2 and the
// learning rate are read from device memory (the wrapper computes c1 and c2 on
// the device from the step count there, in fp32 as the JAX package does), so a
// step needs no synchronisation with the host and an lr schedule runs the
// kernel too. Each multiply, add, divide and square root is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no FMA contraction), in the
// order of the plain PyTorch version, which therefore gives the same bits.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so that a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // grid-stride beyond 16 blocks per SM

struct Coefficients {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

// Four consecutive elements widened to fp32, and back: one 16-byte access for
// fp32, one 8-byte access for bf16.
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

// VEC = 4: element groups of four, all pointers 16-byte aligned (8 for bf16).
// VEC = 1: one element at a time.
template <typename P, typename G, int VEC>
__global__ void __launch_bounds__(kThreads)
    dense_adamw_kernel(P* __restrict__ param, float* __restrict__ mu, float* __restrict__ nu,
                       const G* __restrict__ grad, long long n, const float* __restrict__ corr,
                       const float* __restrict__ lr_ptr, float lr_value, Coefficients k) {
  const float c1 = corr[0];
  const float c2 = corr[1];
  const float lr = lr_ptr != nullptr ? *lr_ptr : lr_value;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long groups = n / VEC;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < groups; q += stride) {
    const long long e = q * VEC;
    if constexpr (VEC == 4) {
      float pa[4], ga[4], ma[4], va[4];
      load4(param + e, pa);
      load4(grad + e, ga);
      load4(mu + e, ma);
      load4(nu + e, va);
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[j] = adamw(pa[j], ga[j], ma[j], va[j], c1, c2, lr, k);
      store4(param + e, pa);
      store4(mu + e, ma);
      store4(nu + e, va);
    } else {
      float m = mu[e], v = nu[e];
      const float p = adamw(widen(param[e]), widen(grad[e]), m, v, c1, c2, lr, k);
      narrow(param + e, p);
      mu[e] = m;
      nu[e] = v;
    }
  }
  if constexpr (VEC == 4) {
    // The last n % 4 elements, one thread each.
    if (blockIdx.x == 0 && threadIdx.x < n - groups * 4) {
      const long long e = groups * 4 + threadIdx.x;
      float m = mu[e], v = nu[e];
      const float p = adamw(widen(param[e]), widen(grad[e]), m, v, c1, c2, lr, k);
      narrow(param + e, p);
      mu[e] = m;
      nu[e] = v;
    }
  }
}

template <typename P, typename G>
void launch(void* param, void* mu, void* nu, const void* grad, long long n, const float* corr,
            const float* lr_ptr, float lr_value, const Coefficients& k, int vec,
            cudaStream_t s) {
  const long long groups = vec == 4 ? n / 4 : n;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  P* p = static_cast<P*>(param);
  float* m = static_cast<float*>(mu);
  float* v = static_cast<float*>(nu);
  const G* g = static_cast<const G*>(grad);
  if (vec == 4)
    dense_adamw_kernel<P, G, 4><<<(unsigned)blocks, kThreads, 0, s>>>(p, m, v, g, n, corr, lr_ptr,
                                                                     lr_value, k);
  else
    dense_adamw_kernel<P, G, 1><<<(unsigned)blocks, kThreads, 0, s>>>(p, m, v, g, n, corr, lr_ptr,
                                                                     lr_value, k);
}

}  // namespace

// param (n elements, fp32 when param_bf16 is 0, else bf16), mu and nu (n fp32), grad
// (n elements, fp32 when grad_bf16 is 0, else bf16), all dense. corr: 2 fp32 on the
// device, [1 / (1 - b1^t), 1 / (1 - b2^t)]. lr is read from lr_ptr when it is not
// null, else lr_value. vec: 4 when every pointer is 16-byte aligned (8 for a bf16
// one), else 1.
extern "C" int bess_dense_adamw(void* param, void* mu, void* nu, const void* grad, long long n,
                                int param_bf16, int grad_bf16, const void* corr,
                                const void* lr_ptr, float lr_value, float b1, float b2,
                                float eps, float wd, float one_minus_b1, float one_minus_b2,
                                int vec, void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Coefficients k = {b1, one_minus_b1, b2, one_minus_b2, eps, wd};
    const float* c = static_cast<const float*>(corr);
    const float* lr = static_cast<const float*>(lr_ptr);
    if (!param_bf16 && !grad_bf16)
      launch<float, float>(param, mu, nu, grad, n, c, lr, lr_value, k, vec, s);
    else if (!param_bf16)
      launch<float, __nv_bfloat16>(param, mu, nu, grad, n, c, lr, lr_value, k, vec, s);
    else if (!grad_bf16)
      launch<__nv_bfloat16, float>(param, mu, nu, grad, n, c, lr, lr_value, k, vec, s);
    else
      launch<__nv_bfloat16, __nv_bfloat16>(param, mu, nu, grad, n, c, lr, lr_value, k, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
