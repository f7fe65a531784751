// Backward of causal or non-causal GQA flash attention, for training.
//
// The TPU package has no backward kernel: the reference trains through the
// jnp online-softmax scan repro/models/layers.py:118 (attention),
// differentiated by jax.value_and_grad (repro/train/trainer.py:155).  This
// source is that gradient as kernels, beside the forward of
// flash_attention.cu, which hands it each row's log-sum-exp (lse).
//
// For q [B, Tq, H, dh], k and v [B, Tk, n_kv, dh], the forward's output o,
// its gradient dO and lse [B, H, Tq] f32, with queries at positions 0 ..
// Tq - 1 (causal: row i sees keys j <= i):
//   D  = rowsum(dO o o)                    (pre-pass, f32 [B, H, Tq])
//   P  = exp(scale Q K^T - lse)            (exact zeros where masked)
//   dV = sum over rows P^T dO              dS = P o (dO V^T - D)
//   dQ = scale dS K                        dK = scale dS^T Q
// with dK and dV summed over the g = H / n_kv query heads of a KV head.
//
// What bounds it on the card: operations.  At the training shape (B 2,
// T 2048, 16 heads over 2 KV heads of 128, causal, bf16) the five products
// are ~86 GFLOP against ~50 MB of inputs and outputs.
//
// Three launches, no atomics, so the gradient is deterministic (every
// sum runs in one fixed order):
//   1. the D pre-pass, one warp per row;
//   2. dK / dV: one CTA per (64-key tile, KV head, batch row) keeps its
//      K and V tiles in shared memory and walks the g heads x the query
//      tiles that can see its keys (causal: from the tile's diagonal on),
//      recomputing S and P from lse, with dK and dV in f32 registers;
//   3. dQ: the forward's tiling, one CTA per (64 rows = g heads x 64 / g
//      positions, KV head, batch row), walking the key tiles up to its
//      last row's diagonal.
// bf16 at head dims 32, 64, 96 and 128 runs 2 and 3 on the tensor cores
// (mma.sync.m16n8k16 fragments as in the forward, f32 accumulate; P and
// dS are rounded to bf16 only as mma inputs); f32, which must match its
// plain version at 2e-5, and the other head dims run a CUDA-core path of
// 32 x 32 tiles.  Masked scores get no probability at all (a select, not
// -inf arithmetic), as the forward's exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ldf(const void* base, size_t off, bool f32) {
  return f32 ? static_cast<const float*>(base)[off]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(base)[off]);
}

__device__ __forceinline__ void stf(void* base, size_t off, bool f32,
                                    float x) {
  if (f32)
    static_cast<float*>(base)[off] = x;
  else
    static_cast<__nv_bfloat16*>(base)[off] = __float2bfloat16_rn(x);
}

// ------------------------------------------------------------ D pre-pass

// D[b, h, i] = sum_d dO[b, i, h, d] o[b, i, h, d]: one warp per row of
// [B, Tq, H] (row-major), lanes striding the head dim.
__global__ void bwd_rowdot_kernel(const void* __restrict__ o,
                                  const void* __restrict__ dout,
                                  float* __restrict__ D, int rows, int Tq,
                                  int H, int dh, int is_f32) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bool f32 = is_f32 != 0;
  float s = 0.f;
  for (int d = lane; d < dh; d += 32) {
    const size_t off = (size_t)row * dh + d;
    s = fmaf(ldf(dout, off, f32), ldf(o, off, f32), s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % H;
    const int i = (row / H) % Tq;
    const int b = row / (H * Tq);
    D[((size_t)b * H + h) * Tq + i] = s;
  }
}

// ------------------------------------------------------- CUDA-core path

constexpr int kCcTile = 32;        // keys and query rows per tile
constexpr int kCcThreads = 256;    // 16 x 16: 2 x 2 scores each

// Four [32][dh + 1] f32 tiles (the +1 keeps a column walk across rows on
// distinct banks), two [32][33] score tiles, lse and D.
size_t cc_smem_bytes(int dh) {
  return ((size_t)4 * kCcTile * (dh + 1)
          + (size_t)2 * kCcTile * (kCcTile + 1) + 2 * kCcTile)
         * sizeof(float);
}

// Rows row0 .. row0 + 31 of x [B, T, heads, DH] at (b, head) into
// dst[32][DH + 1] as f32; rows past T are zero.
template <int DH>
__device__ __forceinline__ void cc_load_rows(float* dst, const void* x,
                                             bool f32, int b, int T,
                                             int heads, int head, int row0) {
  for (int i = threadIdx.x; i < kCcTile * DH; i += kCcThreads) {
    const int r = i / DH, c = i % DH;
    dst[r * (DH + 1) + c] =
        row0 + r < T
            ? ldf(x, (((size_t)b * T + row0 + r) * heads + head) * DH + c,
                  f32)
            : 0.f;
  }
}

// dK / dV: one CTA per (32-key tile, KV head, batch row).  Thread (tx, ty)
// owns the scores of keys 2 ty + {0, 1} x query rows 2 tx + {0, 1}, then
// the dK / dV columns tx + 16 c of its two keys.
template <int DH>
__global__ void __launch_bounds__(kCcThreads)
bwd_dkdv_cc_kernel(const void* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v, const void* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ D,
                   void* __restrict__ dk, void* __restrict__ dv, int Tq,
                   int Tk, int H, int n_kv, int causal, int is_f32,
                   float scale) {
  constexpr int P = DH + 1;
  constexpr int PS = kCcTile + 1;
  constexpr int NC = DH / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kCcTile * P;
  float* q_s = v_s + kCcTile * P;
  float* do_s = q_s + kCcTile * P;
  float* p_s = do_s + kCcTile * P;     // [query][key]
  float* ds_s = p_s + kCcTile * PS;    // [query][key]
  float* lse_s = ds_s + kCcTile * PS;
  float* d_s = lse_s + kCcTile;
  const bool f32 = is_f32 != 0;
  const int g = H / n_kv;
  const int key0 = blockIdx.x * kCcTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  cc_load_rows<DH>(k_s, k, f32, b, Tk, n_kv, kvh, key0);
  cc_load_rows<DH>(v_s, v, f32, b, Tk, n_kv, kvh, key0);

  float dk_acc[2][NC], dv_acc[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  const int n_qt = (Tq + kCcTile - 1) / kCcTile;
  const int qt0 = causal ? key0 / kCcTile : 0;   // rows >= key0 see the tile
  for (int j = 0; j < g; ++j) {
    const int h = kvh * g + j;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kCcTile;
      __syncthreads();                 // the previous step is consumed
      cc_load_rows<DH>(q_s, q, f32, b, Tq, H, h, q0);
      cc_load_rows<DH>(do_s, dout, f32, b, Tq, H, h, q0);
      if (threadIdx.x < kCcTile) {
        const int i = q0 + threadIdx.x;
        const size_t off = ((size_t)b * H + h) * Tq + i;
        lse_s[threadIdx.x] = i < Tq ? lse[off] : 0.f;
        d_s[threadIdx.x] = i < Tq ? D[off] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kr = 2 * ty + a, qr = 2 * tx + c;
          float s = 0.f, dp = 0.f;
#pragma unroll 8
          for (int d = 0; d < DH; ++d) {
            s = fmaf(k_s[kr * P + d], q_s[qr * P + d], s);
            dp = fmaf(v_s[kr * P + d], do_s[qr * P + d], dp);
          }
          const int key = key0 + kr, row = q0 + qr;
          const bool ok = key < Tk && row < Tq && (!causal || key <= row);
          const float p = ok ? expf(s * scale - lse_s[qr]) : 0.f;
          p_s[qr * PS + kr] = p;
          ds_s[qr * PS + kr] = p * (dp - d_s[qr]);
        }
      __syncthreads();
      for (int r = 0; r < kCcTile; ++r) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float pa = p_s[r * PS + 2 * ty + a];
          const float da = ds_s[r * PS + 2 * ty + a];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[a][c] = fmaf(pa, do_s[r * P + tx + 16 * c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(da, q_s[r * P + tx + 16 * c], dk_acc[a][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = key0 + 2 * ty + a;
    if (key >= Tk) continue;
    const size_t off = (((size_t)b * Tk + key) * n_kv + kvh) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      stf(dk, off + tx + 16 * c, f32, dk_acc[a][c] * scale);
      stf(dv, off + tx + 16 * c, f32, dv_acc[a][c]);
    }
  }
}

// dQ: one CTA per (32-row query tile, query head, batch row).  Thread
// (tx, ty) owns the scores of rows 2 ty + {0, 1} x keys 2 tx + {0, 1},
// then the dQ columns tx + 16 c of its two rows.
template <int DH>
__global__ void __launch_bounds__(kCcThreads)
bwd_dq_cc_kernel(const void* __restrict__ q, const void* __restrict__ k,
                 const void* __restrict__ v, const void* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 void* __restrict__ dq, int Tq, int Tk, int H, int n_kv,
                 int causal, int is_f32, float scale) {
  constexpr int P = DH + 1;
  constexpr int PS = kCcTile + 1;
  constexpr int NC = DH / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kCcTile * P;
  float* k_s = do_s + kCcTile * P;
  float* v_s = k_s + kCcTile * P;
  float* ds_s = v_s + kCcTile * P;     // [row][key]
  float* lse_s = ds_s + 2 * kCcTile * PS;
  float* d_s = lse_s + kCcTile;
  const bool f32 = is_f32 != 0;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kCcTile;  // heaviest first
  const int h = blockIdx.y;
  const int kvh = h / (H / n_kv);
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  cc_load_rows<DH>(q_s, q, f32, b, Tq, H, h, q0);
  cc_load_rows<DH>(do_s, dout, f32, b, Tq, H, h, q0);
  if (threadIdx.x < kCcTile) {
    const int i = q0 + threadIdx.x;
    const size_t off = ((size_t)b * H + h) * Tq + i;
    lse_s[threadIdx.x] = i < Tq ? lse[off] : 0.f;
    d_s[threadIdx.x] = i < Tq ? D[off] : 0.f;
  }
  float acc[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  const int kend = causal ? min(Tk, q0 + kCcTile) : Tk;
  const int n_kt = (kend + kCcTile - 1) / kCcTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int key0 = kt * kCcTile;
    __syncthreads();                   // the previous tile is consumed
    cc_load_rows<DH>(k_s, k, f32, b, Tk, n_kv, kvh, key0);
    cc_load_rows<DH>(v_s, v, f32, b, Tk, n_kv, kvh, key0);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qr = 2 * ty + a, kr = 2 * tx + c;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          s = fmaf(q_s[qr * P + d], k_s[kr * P + d], s);
          dp = fmaf(do_s[qr * P + d], v_s[kr * P + d], dp);
        }
        const int key = key0 + kr, row = q0 + qr;
        const bool ok = key < Tk && row < Tq && (!causal || key <= row);
        const float p = ok ? expf(s * scale - lse_s[qr]) : 0.f;
        ds_s[qr * PS + kr] = p * (dp - d_s[qr]);
      }
    __syncthreads();
    for (int kk = 0; kk < kCcTile; ++kk) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float da = ds_s[(2 * ty + a) * PS + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[a][c] = fmaf(da, k_s[kk * P + tx + 16 * c], acc[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = q0 + 2 * ty + a;
    if (row >= Tq) continue;
    const size_t off = (((size_t)b * Tq + row) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      stf(dq, off + tx + 16 * c, f32, acc[a][c] * scale);
  }
}

// ------------------------------------------------------ tensor-core path

constexpr int kTcThreads = 128;    // 4 warps x 16 rows (keys or queries)
constexpr int kTile = 64;          // rows of every tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (4-byte) asynchronous copy; with ok false it reads nothing and
// zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Fragment helpers over row-major [rows][S] bf16 tiles in shared memory.
// In an m16n8 accumulator, lane holds rows lane / 4 (e = 0, 1) and
// lane / 4 + 8 (e = 2, 3), columns 2 (lane % 4) + (e & 1).
//
// A operand: rows row0 .. row0 + 15, columns col0 .. col0 + 15.
template <int S>
__device__ __forceinline__ void ld_a(uint32_t* a, const __nv_bfloat16* t,
                                     int row0, int col0, int lane) {
  ldsm_x4(a, t + (row0 + lane % 8 + ((lane / 8) & 1) * 8) * S + col0
                 + (lane / 16) * 8);
}

// B operand of X Y^T: the 16 rows row0 .. row0 + 15 of Y are the n index
// (two 8-column tiles: b[0..1] and b[2..3]), columns col0 .. col0 + 15 the
// k index.
template <int S>
__device__ __forceinline__ void ld_b_nt(uint32_t* b, const __nv_bfloat16* t,
                                        int row0, int col0, int lane) {
  ldsm_x4(b, t + (row0 + lane % 8 + (lane / 16) * 8) * S + col0
                 + ((lane / 8) & 1) * 8);
}

// B operand of X Y: rows row0 .. row0 + 15 of Y are the k index, columns
// col0 .. col0 + 15 the n index (two 8-column tiles).
template <int S>
__device__ __forceinline__ void ld_b_nn(uint32_t* b, const __nv_bfloat16* t,
                                        int row0, int col0, int lane) {
  ldsm_x4_trans(b, t + (row0 + lane % 8 + ((lane / 8) & 1) * 8) * S + col0
                       + (lane / 16) * 8);
}

// acc[16 x 64] = X[row0 .. +15, :DH] Y[0 .. 63, :DH]^T.
template <int DH, int S>
__device__ __forceinline__ void mma_xyt(float (*acc)[4],
                                        const __nv_bfloat16* x,
                                        const __nv_bfloat16* y, int row0,
                                        int lane) {
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ld_a<S>(a, x, row0, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      uint32_t bf[4];
      ld_b_nt<S>(bf, y, np * 16, kk * 16, lane);
      mma_bf16(acc[2 * np], a, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// out[16 x DH] += W[16 x 64] Y[0 .. 63, :DH], W given as accumulator
// fragments (rounded to bf16 here).
template <int DH, int S>
__device__ __forceinline__ void mma_wy(float (*out)[4], const float (*w)[4],
                                       const __nv_bfloat16* y, int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(w[2 * kk][0], w[2 * kk][1]),
        pack_bf16(w[2 * kk][2], w[2 * kk][3]),
        pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]),
        pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t bf[4];
      ld_b_nn<S>(bf, y, kk * 16, np * 16, lane);
      mma_bf16(out[2 * np], a, bf[0], bf[1]);
      mma_bf16(out[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// 64 rows of x [B, T, heads, DH] at (b, head) into dst[64][S]: rows past
// T zero-filled.
template <int DH, int S>
__device__ __forceinline__ void tc_load_rows(__nv_bfloat16* dst,
                                             const __nv_bfloat16* x, int b,
                                             int T, int heads, int head,
                                             int row0) {
  constexpr int CPR = DH / 8;
  for (int i = threadIdx.x; i < kTile * CPR; i += kTcThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = row0 + r < T;
    cp_async16(dst + r * S + c,
               x + (ok ? (((size_t)b * T + row0 + r) * heads + head) * DH + c
                       : 0),
               ok);
  }
}

size_t tc_smem_bytes(int dh) {
  // Two fixed tiles and two stages of two streamed tiles in bf16, plus two
  // stages of (lse, D) in f32.
  return (size_t)6 * kTile * (dh + 8) * sizeof(__nv_bfloat16)
         + (size_t)4 * kTile * sizeof(float);
}

// dK / dV: warp w owns keys key0 + 16 w .. + 15 of the CTA's 64.  Each
// step streams one (head, 64-row query tile) through a two-stage cp.async
// ring: Q, dO, lse and D.
template <int DH>
__global__ void __launch_bounds__(kTcThreads)
bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ D,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int Tq, int Tk, int H,
                   int n_kv, int causal, float scale) {
  constexpr int S = DH + 8;
  constexpr int NT = DH / 8;
  constexpr int ST = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kTile * S;
  __nv_bfloat16* qd_s = v_s + kTile * S;      // [stage][Q, dO][64][S]
  float* ld_s = reinterpret_cast<float*>(qd_s + 4 * kTile * S);
  // ld_s: [stage][lse[64], D[64]]
  const float scale_log2 = scale * kLog2e;
  const int g = H / n_kv;
  const int key0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  tc_load_rows<DH, S>(k_s, k, b, Tk, n_kv, kvh, key0);
  tc_load_rows<DH, S>(v_s, v, b, Tk, n_kv, kvh, key0);
  const int n_qt = (Tq + kTile - 1) / kTile;
  const int qt0 = causal ? key0 / kTile : 0;   // rows >= key0 see the tile
  const int per_head = n_qt - qt0;
  const int n_steps = per_head > 0 ? g * per_head : 0;
  auto load_step = [&](int step, int stage) {
    const int h = kvh * g + step / per_head;
    const int q0 = (qt0 + step % per_head) * kTile;
    __nv_bfloat16* qs = qd_s + (size_t)stage * 2 * kTile * S;
    tc_load_rows<DH, S>(qs, q, b, Tq, H, h, q0);
    tc_load_rows<DH, S>(qs + kTile * S, dout, b, Tq, H, h, q0);
    if (threadIdx.x < 2 * kTile) {
      const int r = threadIdx.x % kTile;
      const bool ok = q0 + r < Tq;
      const size_t off = ok ? ((size_t)b * H + h) * Tq + q0 + r : 0;
      cp_async4(ld_s + stage * 2 * kTile + threadIdx.x,
                (threadIdx.x < kTile ? lse : D) + off, ok);
    }
  };
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();                   // group 0: K, V and the first step

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) load_step(step + 1, (step + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();                // this step's tiles have landed
    __syncthreads();
    const __nv_bfloat16* qs = qd_s + (size_t)(step % 2) * 2 * kTile * S;
    const __nv_bfloat16* dos = qs + kTile * S;
    const float* lse_s = ld_s + (step % 2) * 2 * kTile;
    const float* d_s = lse_s + kTile;
    const int q0 = (qt0 + step % per_head) * kTile;

    // P^T [16 keys x 64 rows] from S^T = K Q^T.
    float p[ST][4];
    mma_xyt<DH, S>(p, k_s, qs, warp * 16, lane);
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + warp * 16 + lane / 4 + 8 * (e >> 1);
        const int r = n * 8 + 2 * (lane % 4) + (e & 1);
        const int row = q0 + r;
        const bool ok = key < Tk && row < Tq && (!causal || key <= row);
        p[n][e] = ok ? exp2f(p[n][e] * scale_log2 - lse_s[r] * kLog2e)
                     : 0.f;
      }
    mma_wy<DH, S>(dv_acc, p, dos, lane);           // dV += P^T dO

    // dS^T = P^T o (V dO^T - D).
    float ds[ST][4];
    mma_xyt<DH, S>(ds, v_s, dos, warp * 16, lane);
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = p[n][e] * (ds[n][e] - d_s[n * 8 + 2 * (lane % 4) + (e & 1)]);
    mma_wy<DH, S>(dk_acc, ds, qs, lane);           // dK += dS^T Q
    __syncthreads();                   // stage step % 2 is consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key0 + warp * 16 + lane / 4 + 8 * half;
    if (key >= Tk) continue;
    const size_t off = (((size_t)b * Tk + key) * n_kv + kvh) * DH
                       + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(dk_acc[n][2 * half] * scale,
                                dk_acc[n][2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dv_acc[n][2 * half],
                                dv_acc[n][2 * half + 1]);
    }
  }
}

// dQ: the forward's tiling.  Row r of the CTA is head kvh * g + r / bq at
// position pos0 + r % bq; warp w owns rows 16 w .. 16 w + 15.  K and V
// tiles stream through a two-stage cp.async ring.
template <int DH>
__global__ void __launch_bounds__(kTcThreads)
bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int H,
                 int n_kv, int causal, float scale) {
  constexpr int S = DH + 8;
  constexpr int NT = DH / 8;
  constexpr int ST = kTile / 8;
  constexpr int CPR = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kTile * S;
  __nv_bfloat16* kv_s = do_s + kTile * S;     // [stage][K, V][64][S]
  float* lse_s = reinterpret_cast<float*>(kv_s + 4 * kTile * S);
  float* d_s = lse_s + kTile;
  const float scale_log2 = scale * kLog2e;
  const int g = H / n_kv;
  const int bq = kTile / g;
  const int pos0 = (gridDim.x - 1 - blockIdx.x) * bq;   // heaviest first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_pos = min(bq, Tq - pos0);

  for (int i = threadIdx.x; i < kTile * CPR; i += kTcThreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int j = r / bq, p = r % bq;
    const bool ok = j < g && p < n_pos;
    const size_t off =
        ok ? (((size_t)b * Tq + pos0 + p) * H + kvh * g + j) * DH + c : 0;
    cp_async16(q_s + r * S + c, q + off, ok);
    cp_async16(do_s + r * S + c, dout + off, ok);
  }
  if (threadIdx.x < 2 * kTile) {
    const int r = threadIdx.x % kTile;
    const int j = r / bq, p = r % bq;
    const bool ok = j < g && p < n_pos;
    const size_t off = ok ? ((size_t)b * H + kvh * g + j) * Tq + pos0 + p : 0;
    cp_async4(lse_s + threadIdx.x, (threadIdx.x < kTile ? lse : D) + off, ok);
  }
  const int kend = causal ? min(Tk, pos0 + n_pos) : Tk;   // keys [0, kend)
  const int n_kt = (kend + kTile - 1) / kTile;
  auto load_tile = [&](int t, int stage) {
    __nv_bfloat16* ks = kv_s + (size_t)stage * 2 * kTile * S;
    tc_load_rows<DH, S>(ks, k, b, Tk, n_kv, kvh, t * kTile);
    tc_load_rows<DH, S>(ks + kTile * S, v, b, Tk, n_kv, kvh, t * kTile);
  };
  if (n_kt > 0) load_tile(0, 0);
  cp_async_commit();                   // group 0: Q, dO, lse, D, tile 0

  int rpos[2];
  bool rvalid[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = warp * 16 + lane / 4 + 8 * a;
    rvalid[a] = r / bq < g && r % bq < n_pos;
    rpos[a] = pos0 + r % bq;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load_tile(t + 1, (t + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();                // tile t (and Q, dO) have landed
    __syncthreads();
    const __nv_bfloat16* ks = kv_s + (size_t)(t % 2) * 2 * kTile * S;
    const __nv_bfloat16* vs = ks + kTile * S;
    const int key0 = t * kTile;
    float p[ST][4], ds[ST][4];
    mma_xyt<DH, S>(p, q_s, ks, warp * 16, lane);     // S = Q K^T
    mma_xyt<DH, S>(ds, do_s, vs, warp * 16, lane);   // dO V^T
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = warp * 16 + lane / 4 + 8 * a;
      const float l2 = lse_s[r] * kLog2e;
      const float dr = d_s[r];
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + n * 8 + 2 * (lane % 4) + e;
          const bool ok = rvalid[a] && key < Tk
                          && (!causal || key <= rpos[a]);
          const float pr =
              ok ? exp2f(p[n][2 * a + e] * scale_log2 - l2) : 0.f;
          ds[n][2 * a + e] = pr * (ds[n][2 * a + e] - dr);
        }
    }
    mma_wy<DH, S>(acc, ds, ks, lane);               // dQ += dS K
    __syncthreads();                   // stage t % 2 is consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!rvalid[a]) continue;
    const int r = warp * 16 + lane / 4 + 8 * a;
    const size_t off = (((size_t)b * Tq + pos0 + r % bq) * H + kvh * g
                        + r / bq) * DH + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * a] * scale,
                                acc[n][2 * a + 1] * scale);
  }
}

// Raises a kernel's dynamic shared-memory limit once, at its first launch,
// so that a later launch inside a CUDA-graph capture makes no attribute
// call.
template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, size_t smem, bool* raised) {
  if (smem <= 48 * 1024 || *raised) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *raised = true;
  return err;
}

template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* D,
                      void* dq, void* dk, void* dv, int B, int Tq, int Tk,
                      int H, int n_kv, int causal, float scale,
                      cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const size_t smem = tc_smem_bytes(DH);
  static bool raised_kv = false, raised_q = false;
  cudaError_t err = raise_smem(bwd_dkdv_tc_kernel<DH>, smem, &raised_kv);
  if (err != cudaSuccess) return err;
  err = raise_smem(bwd_dq_tc_kernel<DH>, smem, &raised_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((Tk + kTile - 1) / kTile, n_kv, B);
  bwd_dkdv_tc_kernel<DH><<<grid_kv, kTcThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, D,
      static_cast<bf*>(dk), static_cast<bf*>(dv), Tq, Tk, H, n_kv, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bq = kTile / (H / n_kv);
  const dim3 grid_q((Tq + bq - 1) / bq, n_kv, B);
  bwd_dq_tc_kernel<DH><<<grid_q, kTcThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, D,
      static_cast<bf*>(dq), Tq, Tk, H, n_kv, causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_cc(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* D,
                      void* dq, void* dk, void* dv, int B, int Tq, int Tk,
                      int H, int n_kv, int causal, int is_f32, float scale,
                      cudaStream_t stream) {
  const size_t smem = cc_smem_bytes(DH);
  static bool raised_kv = false, raised_q = false;
  cudaError_t err = raise_smem(bwd_dkdv_cc_kernel<DH>, smem, &raised_kv);
  if (err != cudaSuccess) return err;
  err = raise_smem(bwd_dq_cc_kernel<DH>, smem, &raised_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((Tk + kCcTile - 1) / kCcTile, n_kv, B);
  bwd_dkdv_cc_kernel<DH><<<grid_kv, kCcThreads, smem, stream>>>(
      q, k, v, dout, lse, D, dk, dv, Tq, Tk, H, n_kv, causal, is_f32, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((Tq + kCcTile - 1) / kCcTile, H, B);
  bwd_dq_cc_kernel<DH><<<grid_q, kCcThreads, smem, stream>>>(
      q, k, v, dout, lse, D, dq, Tq, Tk, H, n_kv, causal, is_f32, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, dout, dq [B, Tq, H, dh]; k, v, dk, dv [B, Tk, n_kv, dh]; all bf16
// (is_f32 = 0) or all f32, contiguous; lse f32 [B, H, Tq] from the
// forward; D f32 [B, H, Tq] scratch, written here.  Queries at positions
// 0 .. Tq - 1; dh a multiple of 32 up to 256; H / n_kv at most 64.  Three
// launches (D, dK / dV, dQ) on `stream`; returns the first cudaError_t (0
// on success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* D, void* dq, void* dk, void* dv, int B, int Tq,
                        int Tk, int H, int n_kv, int dh, int causal,
                        int is_f32, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * Tq * H;
  bwd_rowdot_kernel<<<(rows + 7) / 8, 256, 0, s>>>(o, dout, D, rows, Tq, H,
                                                   dh, is_f32);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!is_f32) {
    switch (dh) {
#define TC(D_)                                                               \
  case D_:                                                                   \
    return (int)launch_tc<D_>(q, k, v, dout, lse, D, dq, dk, dv, B, Tq, Tk,  \
                              H, n_kv, causal, scale, s);
      TC(32) TC(64) TC(96) TC(128)
#undef TC
      default:
        break;
    }
  }
  switch (dh) {
#define CC(D_)                                                               \
  case D_:                                                                   \
    return (int)launch_cc<D_>(q, k, v, dout, lse, D, dq, dk, dv, B, Tq, Tk,  \
                              H, n_kv, causal, is_f32, scale, s);
    CC(32) CC(64) CC(96) CC(128) CC(160) CC(192) CC(224) CC(256)
#undef CC
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
