// Block int8 quantisation of a flat f32 vector, with error feedback: the
// quantise pass of grad_compress.
//
// Replaces no Pallas kernel.  The reference's `_quant` / `_dequant` and
// `compressed_allreduce_flat` (src/repro/train/grad_compress.py:31-41,
// :90-101) are plain jnp, which XLA fuses inside the jitted train_step
// (src/repro/train/trainer.py:150); the port's eager chain of the same
// arithmetic made ~10 passes over each f32 leaf.  Its plain versions are
// kernels/ref.py::ef_quant_ref and ::quant_ref.
//
// Per 256-element block, one warp a block (8 elements a lane, in two
// 16-byte vectors: lane l holds elements 4l..4l+3 and 128+4l..128+4l+3):
//
//   x   = e + g                       (error-feedback mode; else x = g)
//   s   = max|x| * (1.0f / 127.0f) + 1e-12f
//   q   = int8(clamp(rint(x / s), -127, 127))
//   xq  = q * s
//   e'  = x - xq
//
// Error-feedback mode writes xq over g and e' over e (the in-place
// contract of compressed_allreduce_flat); quantise mode (the ring's
// per-hop `_quant`) reads x and writes q and s only.  The bits are the eager chain's on the card: max|x| is
// max(amax, -amin) of `torch.aminmax`, exact; `/ 127.0` divides a CUDA
// tensor by a CPU scalar, which PyTorch's div_true_kernel_cuda runs as a
// multiplication by 1.0f / 127.0f (checked on the H100 by chip_smoke.py's
// phase 9a, `division_form`); `x / s` divides two CUDA tensors, an IEEE
// division; `round` is rint (half to even); each rounding is written out
// so that nothing is contracted into an FMA.  NaN: `aminmax` gives NaN
// for a block holding one, and so does the max here, which keeps NaN
// (fmaxf would drop it); then s, x / s and rint are NaN, clamp keeps it,
// the int8 cast makes it what PyTorch's cast makes it (the same C++
// conversion), and xq = q * NaN and e' are NaN over the whole block: a NaN
// gradient never turns into finite numbers.
//
// What bounds it on the card: bytes, 16 an element in error-feedback mode
// (g and e read, xq and e' written), 4 + 1 + 4 / 256 in quantise mode.  A block's max needs all its
// 256 values before any output, so a warp holds its block in registers
// (one read of each input), reduces with five shuffles, and writes every
// output once; 8 warps a CTA, 64-bit offsets.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;          // elements a quantisation block
constexpr int kWarps = 8;            // blocks (warps) a CTA
constexpr float kInv127 = 1.0f / 127.0f;
constexpr float kTiny = 1e-12f;

// max that keeps NaN, as torch.aminmax / torch.maximum do.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float clamp127(float r) {
  // torch.clamp keeps NaN; fminf / fmaxf would drop it.
  if (r != r) return r;
  return r < -127.0f ? -127.0f : (r > 127.0f ? 127.0f : r);
}

template <bool kEF>
__global__ void __launch_bounds__(kWarps * 32)
grad_quant_kernel(float* __restrict__ g, float* __restrict__ e,
                  signed char* __restrict__ q, float* __restrict__ s,
                  long long n_blocks) {
  const long long blk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;
  const int lane = threadIdx.x & 31;
  const long long base = blk * kBlock;
  const long long off[2] = {base + 4 * lane, base + kBlock / 2 + 4 * lane};
  float x[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 gv = *reinterpret_cast<const float4*>(g + off[h]);
    float* xs = x + 4 * h;
    xs[0] = gv.x;
    xs[1] = gv.y;
    xs[2] = gv.z;
    xs[3] = gv.w;
    if (kEF) {
      const float4 ev = *reinterpret_cast<const float4*>(e + off[h]);
      xs[0] = __fadd_rn(ev.x, xs[0]);
      xs[1] = __fadd_rn(ev.y, xs[1]);
      xs[2] = __fadd_rn(ev.z, xs[2]);
      xs[3] = __fadd_rn(ev.w, xs[3]);
    }
  }
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) amax = nan_max(amax, fabsf(x[j]));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, d));
  const float sc = __fadd_rn(__fmul_rn(amax, kInv127), kTiny);
  signed char qq[8];
  float xq[8], er[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float r = clamp127(rintf(__fdiv_rn(x[j], sc)));
    qq[j] = static_cast<signed char>(r);
    xq[j] = __fmul_rn(static_cast<float>(qq[j]), sc);
    er[j] = __fsub_rn(x[j], xq[j]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kEF) {
      *reinterpret_cast<float4*>(g + off[h]) =
          make_float4(xq[4 * h], xq[4 * h + 1], xq[4 * h + 2], xq[4 * h + 3]);
      *reinterpret_cast<float4*>(e + off[h]) =
          make_float4(er[4 * h], er[4 * h + 1], er[4 * h + 2], er[4 * h + 3]);
    }
    if (!kEF) {
      char4 c;
      c.x = qq[4 * h];
      c.y = qq[4 * h + 1];
      c.z = qq[4 * h + 2];
      c.w = qq[4 * h + 3];
      *reinterpret_cast<char4*>(q + off[h]) = c;
    }
  }
  if (!kEF && lane == 0) s[blk] = sc;
}

template <bool kEF>
cudaError_t launch(float* g, float* e, signed char* q, float* s,
                   long long n_blocks, cudaStream_t stream) {
  const long long ctas = (n_blocks + kWarps - 1) / kWarps;
  grad_quant_kernel<kEF><<<(unsigned)ctas, kWarps * 32, 0, stream>>>(
      g, e, q, s, n_blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// n_blocks > 0 blocks of 256 f32.  e non-null: error-feedback mode, g and
// e updated in place (g <- xq, e <- e'), q and s unused.  e null: quantise
// mode, g read only, q and s written.  g and e 16-byte aligned, q 4-byte
// aligned.  Returns the launch's cudaError_t.
int grad_quant(float* g, float* e, signed char* q, float* s,
               long long n_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = e == nullptr
                              ? launch<false>(g, e, q, s, n_blocks, st)
                              : launch<true>(g, e, q, s, n_blocks, st);
  return (int)err;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
