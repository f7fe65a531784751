// The fused AdamW update of one leaf: reads p, g, m and v once, writes p,
// m and v in place.
//
// Replaces no Pallas kernel.  The reference's update is plain jnp
// (src/repro/train/optimizer.py:48, `upd`), which XLA fuses into one loop
// per leaf inside the jitted train_step (src/repro/train/trainer.py:150);
// the port's eager chain of the same arithmetic made ~16 passes over the
// f32 leaves.  Its plain version is kernels/ref.py::adamw_leaf_ref.
//
// The bits are those of that eager chain on the card, operation for
// operation, each rounding written out (__fmul_rn and the like, so that
// nvcc's default -fmad=true contracts nothing into an FMA):
//
//   g  = g * scale                   scale: the clip factor, a 0-d f32
//                                    tensor on the card, read here
//   m  = m * b1 + g * (1 - b1)
//   v  = v * b2 + (g * g) * (1 - b2)
//   u  = ((m * inv_c1) / (sqrt(v * inv_c2) + eps)) * lr
//   p  = p * decay - u
//
// `mu / c1` and `nu / c2` divide a CUDA tensor by a CPU 0-d tensor.
// PyTorch's div_true_kernel_cuda runs such a division as a multiplication
// by the reciprocal, computed on the host in float (1.0f / c); so the
// eager chain, and this kernel, multiply by inv_c1 = 1.0f / c1 (the
// wrapper computes it as PyTorch does).  On the H100 the eager chain gave
// x * (1.0f / c) and not x / c, bit for bit (the probe in
// chip_smoke.py's phase 9a, `division_form`).  The division by the
// denominator (two CUDA tensors) is an IEEE division and the square root
// is correctly rounded, as PyTorch's kernels compute them without fast
// math.  A bf16 p is widened, updated in f32 and rounded to bf16 (to
// nearest even) once, at the end, as `p.copy_(...)` does; a bf16 g is
// widened exactly.  NaN and inf propagate as in the chain.
//
// What bounds it on the card: bytes, 28 an element with f32 p and g (p,
// g, m, v read once; p, m, v written once), 2.6 operations a byte.  The
// design: a grid-stride loop over 4-element vectors (16-byte loads and
// stores of m, v and f32 p / g; 8 bytes for bf16), neighbouring threads
// on neighbouring vectors, 64-bit offsets (one qwen2.5-3b leaf is 811.6 M
// elements), eight 256-thread CTAs an SM, so that an SM keeps ~128 KB of
// loads in flight; the n mod 4 tail elements by the first threads of CTA
// 0.  One launch per leaf: a leaf of a full-width model is large (the 14
// leaves of qwen2.5-3b average 220 M elements), so a launch's few
// microseconds are far below its bytes' time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;

struct Hyper {
  float b1, omb1, b2, omb2, inv_c1, inv_c2, eps, lr, decay;
};

__device__ __forceinline__ void load4(const float* __restrict__ x,
                                      long long i, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(x + i);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ x,
                                      long long i, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(x + i);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(lo);
  out[1] = __high2float(lo);
  out[2] = __low2float(hi);
  out[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* __restrict__ x, long long i,
                                       const float in[4]) {
  *reinterpret_cast<float4*>(x + i) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* __restrict__ x,
                                       long long i, const float in[4]) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(in[0]);
  lo.y = __float2bfloat16_rn(in[1]);
  hi.x = __float2bfloat16_rn(in[2]);
  hi.y = __float2bfloat16_rn(in[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(x + i) = raw;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* x, float v) { *x = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* x, float v) {
  *x = __float2bfloat16_rn(v);
}

// One element, in the eager chain's order of operations and roundings.
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       float scale, const Hyper& h) {
  const float gs = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(gs, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(gs, gs), h.omb2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_c2)), h.eps);
  const float u = __fmul_rn(__fdiv_rn(__fmul_rn(m, h.inv_c1), den), h.lr);
  p = __fsub_rn(__fmul_rn(p, h.decay), u);
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(P* __restrict__ p, const G* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v,
             const float* __restrict__ scale_ptr, long long n, Hyper h) {
  const float scale = *scale_ptr;
  const long long nvec = n >> 2;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
       k < nvec; k += stride) {
    const long long i = k << 2;
    float pp[4], gg[4], mm[4], vv[4];
    load4(p, i, pp);
    load4(g, i, gg);
    load4(m, i, mm);
    load4(v, i, vv);
#pragma unroll
    for (int j = 0; j < 4; ++j) update(pp[j], gg[j], mm[j], vv[j], scale, h);
    store4(p, i, pp);
    store4(m, i, mm);
    store4(v, i, vv);
  }
  const long long tail = n - (nvec << 2);
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const long long i = (nvec << 2) + threadIdx.x;
    float pp = to_f32(p[i]), mm = m[i], vv = v[i];
    update(pp, to_f32(g[i]), mm, vv, scale, h);
    from_f32(p + i, pp);
    m[i] = mm;
    v[i] = vv;
  }
}

template <typename P, typename G>
cudaError_t launch(void* p, const void* g, float* m, float* v,
                   const float* scale, long long n, const Hyper& h,
                   cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long nvec = n >> 2;
  long long ctas = (nvec + kThreads - 1) / kThreads;
  if (ctas > (long long)sms * kCtasPerSm) ctas = (long long)sms * kCtasPerSm;
  if (ctas < 1) ctas = 1;
  adamw_kernel<P, G><<<(unsigned)ctas, kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), m, v, scale, n, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One leaf of n > 0 elements, in place.  p_bf16 / g_bf16: 1 when p / g is
// bf16, 0 when f32; m and v f32; every pointer 16-byte aligned; scale a
// pointer to one f32 on the card.  hyper: b1, 1 - b1, b2, 1 - b2,
// 1 / c1, 1 / c2, eps, lr, decay, each rounded to f32 as PyTorch rounds
// the eager chain's scalars.  Returns the launch's cudaError_t.
int adamw_leaf(void* p, const void* g, float* m, float* v,
               const float* scale, int p_bf16, int g_bf16, long long n,
               const float* hyper, void* stream) {
  if (n <= 0) return 0;
  const Hyper h{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4],
                hyper[5], hyper[6], hyper[7], hyper[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p_bf16 && g_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, scale, n, h, s);
  else if (p_bf16)
    err = launch<__nv_bfloat16, float>(p, g, m, v, scale, n, h, s);
  else if (g_bf16)
    err = launch<float, __nv_bfloat16>(p, g, m, v, scale, n, h, s);
  else
    err = launch<float, float>(p, g, m, v, scale, n, h, s);
  return (int)err;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
