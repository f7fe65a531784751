// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060 §6).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py: ssd_scan (body
// _ssd_kernel).  For one (batch row b, head h) and chunks of Q time steps,
// with x [T, hd], dt [T] (post-softplus), the scalar A < 0, B / C [T, N]
// of the head's group (head h reads group h / (nh / G)) and the carried
// state h [hd, N] (h0 or zeros before chunk 0):
//
//   cum_i  = sum_{j <= i} dt_j A                      (inclusive, per chunk)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) (C_i . h_p)_p                 (h of the previous chunk)
//   h'     = exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
//
// Outputs y [B, T, nh, hd] and the final state [B, nh, hd, N] in f32.
//
// What bounds it on the card: bytes.  At zamba2-1.2b's prefill shape
// (T = 1280, 64 heads, hd = N = 64, Q = 256, one B/C group, bf16) a call
// moves ~33.2 MB when B and C come as their G = 1 groups (x 10.5 MB read,
// B and C 0.33 MB, y 21 MB and the state 1 MB written): 0.0099 ms at
// 3.35 TB/s.  Head-expanded B and C (G = nh) read 21 MB more: 53.8 MB,
// 0.0161 ms.  The ~4 GFLOP of its products take 0.004 ms on the tensor
// cores, so the call is bytes-bound, but only if the whole card works on
// it and the products do not run on CUDA cores.  The TPU kernel walks the
// chunks in order along a sequential grid axis with the state in VMEM;
// here that axis would leave one CTA per (head, row), 64 of 132 SMs.
//
// So the bf16 path runs in three phases, each parallel over chunks:
//
//   (i)   ssd_states_kernel, grid (hd blocks of 64, head, chunk) x rows:
//         the chunk's cum (written to scratch for (ii)) and its local
//         state S_c = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T as one
//         mma.sync.m16n8k16 product over the chunk's rows (x scaled by its
//         weight in f32 and split into a bf16 hi + lo pair in registers,
//         B as it comes), written to f32 scratch.  320 CTAs at zamba2's
//         shape.
//   (ii)  ssd_pass_kernel, per state element: h_prev[c] = h,
//         h = exp(cum_last_c) h + S_c over the nc chunks from h0 or zero;
//         h_prev goes out as a bf16 hi + lo pair (h - hi rounded again),
//         the last h is the final state.  Light: nc <= 5 elementwise
//         steps.  Its own launch: folded into (iii) as a prologue, where
//         each output CTA walks its earlier chunks' S itself, it was slower
//         on every shape measured (PERF.md).
//   (iii) ssd_out_kernel, grid (head, chunk) x row x 64-row query tile,
//         1280 CTAs at zamba2's shape, heaviest tiles first: four warps of
//         16 rows; the C tile lives in mma fragments; over the key tiles
//         up to the diagonal (two-stage cp.async ring of B and x, each warp
//         skipping the 32-key parts above its rows), S = C B^T,
//         P = S exp(cum_i - cum_j) dt_j in f32 as one exp2 per score,
//         masked before the exp on the diagonal (a masked segment is
//         positive and would overflow), y += (P_hi + P_lo) x; then the
//         carried term y += exp(cum_i) C . (h_hi + h_lo) on the tensor
//         cores.
//
// Only the carried term of (iii) needs (i) and (ii): (iii) scans its own
// chunk's dt for cum (the same arithmetic as (i), so the same bits), and
// (ii) and (iii) are launched as programmatic dependents, so that (iii)'s
// intra-chunk work overlaps (i) and (ii), which leave most of the card
// idle on their own; (iii) waits for them only before it loads the
// carried state.  Each CTA also issues its few small loads (dt, A) before
// its tiles' cp.async traffic, and (iii) keeps to 48 KB of shared memory
// at hd = N = 64 so that four CTAs share an SM.
//
// Why the hi + lo pairs: C, B and x are bf16 inputs, so their products are
// exact; the operands made in the kernel (w x, P, h) are f32.  Unlike
// attention's P <= 1, the SSD scores C . B_j are unnormalized (~sqrt(N)),
// and y is their sum over up to 256 keys: P rounded once to bf16 missed
// the 3e-2 tolerance (0.040 at one element of a two-chunk N = 128 call on
// the card) where the terms cancel.  A second mma on the remainder costs
// ~50 % more tensor-core work in (iii) and keeps the f32 result.
//
// The groups are read as they come (the head's group row), so G = 1 reads
// B and C once from device memory and from L2 for the other heads.  There
// are no atomics and every sum runs in a fixed order, so two calls give the
// same bits, and a batch row's result does not depend on the others.
// f32 inputs (tolerance 2e-4, which TF32 would not hold) keep the CUDA-core
// kernel of the first port: one CTA per (head, row) walks the chunks in
// order with the f32 state in shared memory.  Q need not be a power of two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 256;   // the models' chunk (cfg.ssm.chunk)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;        // rows of a query tile and of a key tile

// Raises a kernel's dynamic shared memory limit to `bytes`, once per
// instantiation (the caller's static flag), so that a launch inside a
// CUDA-graph capture makes no attribute call.
template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes, bool* raised) {
  if (bytes <= 48 * 1024 || *raised) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *raised = true;
  return err;
}

// Inclusive scan cum_s[i] = sum_{j <= i} dt_s[j] a over i < Q, by one warp:
// each lane sums a run of E rows, a shuffle scan offsets the runs.
__device__ __forceinline__ void chunk_cumsum(const float* dt_s, float* cum_s,
                                             int Q, float a, int lane) {
  const int E = (Q + 31) / 32;
  const int lo = min(lane * E, Q), hi = min(lo + E, Q);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) run += dt_s[i] * a;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.f;
  for (int i = lo; i < hi; ++i) {
    acc += dt_s[i] * a;
    cum_s[i] = acc;
  }
}

// ------------------------------------------------------ tensor-core path

constexpr int kTcThreads = 128;  // 4 warps x 16 rows
constexpr int kStages = 2;       // B / x ring depth of phase (iii)
constexpr int kSub = 32;         // keys per score block of phase (iii)
constexpr int kStatesStages = 2; // tile ring depth of phase (i)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with ok false it reads nothing and zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
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

// (a, b) as two bf16 pairs, *hi = round(a, b) and *lo = the rounding's
// remainder rounded again: hi + lo carries ~16 bits of each mantissa.
__device__ __forceinline__ void pack_split(float a, float b, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&l);
}

// h as a bf16 pair hi + lo (lo = h - hi rounded): ~16 bits of mantissa.
__device__ __forceinline__ void split_bf16(float h, bf16* hi, bf16* lo) {
  const bf16 a = __float2bfloat16_rn(h);
  *hi = a;
  *lo = __float2bfloat16_rn(h - __bfloat162float(a));
}

// Programmatic dependent launch (PDL): a kernel launched with the
// programmatic-serialization attribute may start while the kernel before
// it on the stream still runs, once every CTA of that one has passed
// launch_dependents; wait_prior blocks until the kernel before has
// finished and its writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// (i) Chunk states.  Warp w owns state rows (head-dim columns p) 16 w ..
// 16 w + 15 of the CTA's 64-column block; the product runs over the
// chunk's rows j in 64-row tiles that stream through a cp.async ring of
// kStatesStages (x [j][p] and B [j][n] as they come; the first tiles load
// while the CTA computes the chunk's cum).  A = (w x)^T comes from the x
// tile through ldmatrix.trans and is scaled by w_j and split into hi + lo
// in registers; B = B_j through ldmatrix.trans.
template <int HD, int N>
constexpr size_t states_tile_bytes() {
  constexpr int PW = HD > 64 ? 64 : HD;
  return (size_t)kTile * ((PW + 8) + (N + 8)) * sizeof(bf16);
}

size_t states_smem_bytes(size_t tile_bytes, int n_tiles) {
  return 3 * kMaxChunk * sizeof(float) + n_tiles * tile_bytes;
}

template <int HD, int N>
__global__ void __launch_bounds__(kTcThreads)
ssd_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  float* __restrict__ states, float* __restrict__ cum_g,
                  int T, int nh, int G, int Q) {
  constexpr int PB = HD > 64 ? HD / 64 : 1;   // 64-column blocks of hd
  constexpr int PW = HD / PB;                 // columns of this CTA
  constexpr int SX = PW + 8, SB = N + 8;      // padded row strides
  constexpr int NT = N / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dt_s = reinterpret_cast<float*>(smem_raw);       // [kMaxChunk]
  float* cum_s = dt_s + kMaxChunk;                        // [kMaxChunk]
  float* w_s = cum_s + kMaxChunk;                         // [kMaxChunk]
  bf16* tiles = reinterpret_cast<bf16*>(w_s + kMaxChunk);  // ring [x, B]
  const int pb = blockIdx.x % PB;
  const int h = (blockIdx.x / PB) % nh;
  const int c = blockIdx.x / (PB * nh);
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nc = T / Q;
  const int t0 = c * Q;
  const int grp = h / (nh / G);
  const int n_tiles = (Q + kTile - 1) / kTile;
  const size_t bc_stride = (size_t)G * N, x_stride = (size_t)nh * HD;
  launch_dependents();               // (ii) and (iii) may start now

  auto load_tile = [&](int t) {
    bf16* xs = tiles + (size_t)(t % kStatesStages) * kTile * (SX + SB);
    bf16* bs = xs + kTile * SX;
    const int k0 = t * kTile;
    for (int i = tid; i < kTile * (N / 8); i += kTcThreads) {
      const int r = i / (N / 8), col = (i % (N / 8)) * 8;
      const bool ok = k0 + r < Q;
      cp_async16(bs + r * SB + col,
                 ok ? Bm + ((size_t)b * T + t0 + k0 + r) * bc_stride
                          + (size_t)grp * N + col
                    : Bm,
                 ok);
    }
    for (int i = tid; i < kTile * (PW / 8); i += kTcThreads) {
      const int r = i / (PW / 8), col = (i % (PW / 8)) * 8;
      const bool ok = k0 + r < Q;
      cp_async16(xs + r * SX + col,
                 ok ? x + ((size_t)b * T + t0 + k0 + r) * x_stride
                          + (size_t)h * HD + pb * PW + col
                    : x,
                 ok);
    }
  };
  // dt and A go out first: small loads that would otherwise queue behind
  // the tiles' cp.async traffic (Q <= 2 x kTcThreads rows).
  const float a_h = A[h];
  float dv[kMaxChunk / kTcThreads];
#pragma unroll
  for (int k = 0; k < kMaxChunk / kTcThreads; ++k) {
    const int i = tid + k * kTcThreads;
    dv[k] = i < Q ? dt[((size_t)b * T + t0 + i) * nh + h] : 0.f;
  }
  for (int t = 0; t < kStatesStages; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }
#pragma unroll
  for (int k = 0; k < kMaxChunk / kTcThreads; ++k)
    if (tid + k * kTcThreads < Q) dt_s[tid + k * kTcThreads] = dv[k];
  __syncthreads();
  if (warp == 0) chunk_cumsum(dt_s, cum_s, Q, a_h, lane);
  __syncthreads();
  for (int i = tid; i < n_tiles * kTile; i += kTcThreads) {
    // Rows past Q weigh zero (their x and B are zero-filled too).
    w_s[i] = i < Q ? expf(cum_s[Q - 1] - cum_s[i]) * dt_s[i] : 0.f;
    if (pb == 0 && i < Q)
      cum_g[((size_t)b * nh + h) * T + t0 + i] = cum_s[i];
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bool active = warp * 16 < PW;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStatesStages - 1>();  // tile t has landed
    __syncthreads();                     // ... for every thread; w_s too
    const bf16* xs = tiles + (size_t)(t % kStatesStages) * kTile * (SX + SB);
    const bf16* bs = xs + kTile * SX;
#pragma unroll
    for (int kk = 0; kk < kTile / 16 && active; ++kk) {
      // xr[r] holds x at rows j = 64 t + 16 kk + 2 (lane % 4) + {0, 1}
      // (r = 0, 1) and + 8 + {0, 1} (r = 2, 3).
      uint32_t xr[4], a[4], al[4];
      ldsm_x4_trans(xr, xs + (kk * 16 + lane % 8 + (lane / 16) * 8) * SX
                            + warp * 16 + ((lane / 8) & 1) * 8);
      const float* w = w_s + t * kTile + kk * 16 + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xr[r]));
        const int o = (r / 2) * 8;
        pack_split(f.x * w[o], f.y * w[o + 1], &a[r], &al[r]);
      }
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, bs + (kk * 16 + lane % 8 + ((lane / 8) & 1) * 8)
                               * SB + np * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * np], a, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
        mma_bf16(acc[2 * np], al, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
      }
    }
    __syncthreads();                     // stage t is consumed
    if (t + kStatesStages < n_tiles) load_tile(t + kStatesStages);
    cp_async_commit();
  }
  if (!active) return;
  float* out = states + (((size_t)b * nc + c) * nh + h) * HD * N;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int p = pb * PW + warp * 16 + lane / 4 + 8 * a;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(out + (size_t)p * N + n * 8
                                 + 2 * (lane % 4)) =
          make_float2(acc[n][2 * a], acc[n][2 * a + 1]);
  }
}

constexpr int kPassThreads = 256;

// State elements per thread of (ii): eight CTAs per (head, row) whatever
// the state's size.  The pass starts early (PDL) and waits for (i) once
// it has let (iii) start, so its CTAs sit idle on the SMs meanwhile: more
// of them crowd (iii) out, fewer take longer once (i) is done.
template <int HD, int N>
constexpr int pass_elems() {
  return HD * N / (8 * kPassThreads) > 1 ? HD * N / (8 * kPassThreads) : 1;
}

// (ii) State passing, PE state elements of one (head, row) per thread.
template <int PE>
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const float* __restrict__ states,
                const float* __restrict__ cum_g, const float* __restrict__ h0,
                bf16* __restrict__ hp, long long plane,
                float* __restrict__ h_out, int T, int nh, int Q, int hdn) {
  launch_dependents();
  wait_prior();
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = T / Q;
  const float* cum = cum_g + ((size_t)b * nh + h) * T;
  const int e0 = blockIdx.x * kPassThreads * PE + threadIdx.x;
  const size_t sh = ((size_t)b * nh + h) * hdn;
  float v[PE];
#pragma unroll
  for (int u = 0; u < PE; ++u) {
    const int e = e0 + u * kPassThreads;
    v[u] = h0 != nullptr && e < hdn ? h0[sh + e] : 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    const float cl = cum[c * Q + Q - 1];
    const size_t base = (((size_t)b * nc + c) * nh + h) * hdn;
#pragma unroll
    for (int u = 0; u < PE; ++u) {
      const int e = e0 + u * kPassThreads;
      if (e < hdn) {
        split_bf16(v[u], hp + base + e, hp + plane + base + e);
        v[u] = fmaf(expf(cl), v[u], states[base + e]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < PE; ++u) {
    const int e = e0 + u * kPassThreads;
    if (e < hdn) h_out[sh + e] = v[u];
  }
}

// lc and kd [kMaxChunk] f32; then in bf16 C [kTile][N + 8] and the ring of
// kStages x (B [kTile][N + 8], x [kTile][HD + 8]), which after the last
// key tile holds h_hi and h_lo [HD][N + 8].  The 16-byte row pad keeps
// ldmatrix's eight row reads on distinct banks.
template <int HD, int N>
constexpr size_t out_smem_bytes() {
  static_assert(kStages * kTile * ((N + 8) + (HD + 8)) >= 2 * HD * (N + 8),
                "the carried state must fit in the ring");
  return 2 * kMaxChunk * sizeof(float)
         + ((size_t)kTile * (N + 8)
            + (size_t)kStages * kTile * ((N + 8) + (HD + 8)))
               * sizeof(bf16);
}

// CTAs per SM that (iii) is built for: 48 KB of shared memory at hd = N
// = 64 and registers capped at 128 let four share an SM, without spills
// (built for three, the hd = 64 instances are slower: launch/ssd_phases.py).
// At hd = 128, two keep every instance unspilled.
template <int HD, int N>
__host__ __device__ constexpr int out_min_blocks() {
  return HD > 64 ? 2 : HD * N <= 64 * 64 ? 4 : 3;
}

// (iii) Chunk outputs.  Warp w owns rows 16 w .. 16 w + 15 of the CTA's
// 64 query rows; in an m16n8 fragment lane holds rows lane / 4 and
// lane / 4 + 8 (a = 0, 1) and columns 2 (lane % 4) + {0, 1} of each
// 8-column tile.  A key tile is staged once for the four warps; each warp
// works through it in kSub-key parts and skips the parts above its rows.
// Everything but the carried term needs only the inputs: the CTA scans
// its chunk's dt itself (the same arithmetic as (i), so the same cum), so
// it can start while (i) and (ii) run (PDL) and waits for them only
// before it loads the carried state.
template <int HD, int N>
__global__ void __launch_bounds__(kTcThreads, out_min_blocks<HD, N>())
ssd_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm, const bf16* __restrict__ hp,
               long long plane, float* __restrict__ y, int T, int nh, int G,
               int Q, int carry_in) {
  constexpr int SN = N + 8, SH = HD + 8;    // padded row strides
  constexpr int KN = N / 16;                // k steps over the state size
  constexpr int NT = HD / 8;                // 8-column tiles of y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lc_s = reinterpret_cast<float*>(smem_raw);       // [kMaxChunk]
  float* kd_s = lc_s + kMaxChunk;                         // [kMaxChunk]
  bf16* c_s = reinterpret_cast<bf16*>(kd_s + kMaxChunk);  // [kTile][SN]
  bf16* ring = c_s + kTile * SN;   // [kStages][B [kTile][SN], x [kTile][SH]]
  bf16* hh_s = ring;                                      // [HD][SN]
  bf16* hl_s = hh_s + HD * SN;                            // [HD][SN]
  const int nc = T / Q;
  const int h = blockIdx.x % nh, c = blockIdx.x / nh;
  const int b = blockIdx.y;
  const int rt = gridDim.z - 1 - blockIdx.z;   // heaviest tiles first
  const int r0 = rt * kTile;
  const int rows = min(kTile, Q - r0);         // valid rows of the tile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = h / (nh / G);
  const int t0 = c * Q;
  const bool carried = c > 0 || carry_in;
  const size_t bc_stride = (size_t)G * N, x_stride = (size_t)nh * HD;
  const size_t bc_base = ((size_t)b * T + t0) * bc_stride + (size_t)grp * N;
  const size_t x_base = ((size_t)b * T + t0) * x_stride + (size_t)h * HD;
  const size_t hdn = (size_t)HD * N;

  // dt and A go out first: small loads that would otherwise queue behind
  // the tiles' cp.async traffic (Q <= 2 x kTcThreads rows).
  const float a_h = A[h];
  float dv[kMaxChunk / kTcThreads];
#pragma unroll
  for (int k = 0; k < kMaxChunk / kTcThreads; ++k) {
    const int i = tid + k * kTcThreads;
    dv[k] = i < Q ? dt[((size_t)b * T + t0 + i) * nh + h] : 0.f;
  }

  // Group 0: the C tile and key tile 0.
  for (int i = tid; i < kTile * (N / 8); i += kTcThreads) {
    const int r = i / (N / 8), col = (i % (N / 8)) * 8;
    const bool ok = r < rows;
    cp_async16(c_s + r * SN + col,
               ok ? Cm + bc_base + (size_t)(r0 + r) * bc_stride + col : Cm,
               ok);
  }
  auto load_tile = [&](int t, int stage) {
    bf16* bs = ring + (size_t)stage * kTile * (SN + SH);
    bf16* xs = bs + kTile * SN;
    const int k0 = t * kTile;
    for (int i = tid; i < kTile * (N / 8); i += kTcThreads) {
      const int r = i / (N / 8), col = (i % (N / 8)) * 8;
      const bool ok = k0 + r < Q;
      cp_async16(bs + r * SN + col,
                 ok ? Bm + bc_base + (size_t)(k0 + r) * bc_stride + col : Bm,
                 ok);
    }
    for (int i = tid; i < kTile * (HD / 8); i += kTcThreads) {
      const int r = i / (HD / 8), col = (i % (HD / 8)) * 8;
      const bool ok = k0 + r < Q;
      cp_async16(xs + r * SH + col,
                 ok ? x + x_base + (size_t)(k0 + r) * x_stride + col : x, ok);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // The chunk's cum (kd_s holds dt meanwhile), then in base 2:
  // lc_i = cum_i log2(e) and kd_j = lc_j - log2(dt_j), so that
  // exp(cum_i - cum_j) dt_j = exp2(lc_i - kd_j), one MUFU op per score
  // (dt_j = 0, a padded row, gives kd_j = +inf and a zero weight).
#pragma unroll
  for (int k = 0; k < kMaxChunk / kTcThreads; ++k)
    if (tid + k * kTcThreads < Q) kd_s[tid + k * kTcThreads] = dv[k];
  __syncthreads();
  if (warp == 0) chunk_cumsum(kd_s, lc_s, Q, a_h, lane);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kMaxChunk / kTcThreads; ++k) {
    const int i = tid + k * kTcThreads;
    if (i < Q) {
      const float lc = lc_s[i] * kLog2e;
      lc_s[i] = lc;
      kd_s[i] = lc - log2f(dv[k]);
    }
  }

  const int wrow = r0 + warp * 16;             // the warp's first row
  const bool wactive = warp * 16 < rows;
  int row[2];
  bool rvalid[2];
  float lci[2];                      // lc of the row; -inf past the chunk
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    row[a] = wrow + lane / 4 + 8 * a;          // chunk-relative
    rvalid[a] = row[a] < r0 + rows;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t cf[KN][4];

  // Key tiles up to the one holding the tile's last row.
  const int n_tiles = (r0 + rows - 1) / kTile + 1;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1, (t + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();                        // tile t (and C) landed
    __syncthreads();
    if (t == 0 && wactive) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
        lci[a] = rvalid[a] ? lc_s[row[a]] : -INFINITY;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        ldsm_x4(cf[kk], c_s + (warp * 16 + lane % 8 + ((lane / 8) & 1) * 8)
                                  * SN + kk * 16 + (lane / 16) * 8);
    }
    const bf16* bs = ring + (size_t)(t % kStages) * kTile * (SN + SH);
    const bf16* xs = bs + kTile * SN;
#pragma unroll
    for (int kh = 0; kh < kTile / kSub; ++kh) {
      const int k0 = t * kTile + kh * kSub;    // the part's first key
      if (!wactive || k0 > wrow + 15) continue;   // above every row
      const bool below = k0 + kSub - 1 < wrow;

      // S = C B^T over the state size, 16 at a time, for kSub keys.
      float s[kSub / 8][4];
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, bs + (kh * kSub + np * 16 + lane % 8 + (lane / 16) * 8)
                          * SN + kk * 16 + ((lane / 8) & 1) * 8);
          mma_bf16(s[2 * np], cf[kk], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], cf[kk], bf[2], bf[3]);
        }
      }

      // P = S exp(cum_i - cum_j) dt_j = S exp2(lc_i - kd_j) for j <= i.
      // Keys below every row of the warp need no mask (a row past the
      // chunk has lc_i = -inf: weight 0); on the diagonal the mask comes
      // before the exp.
      if (below) {
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float kd = kd_s[k0 + n * 8 + 2 * (lane % 4) + e];
#pragma unroll
            for (int a = 0; a < 2; ++a)
              s[n][2 * a + e] *= exp2f(lci[a] - kd);
          }
      } else {
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = k0 + n * 8 + 2 * (lane % 4) + e;
            const float kd = kd_s[j];
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              const bool ok = rvalid[a] && j <= row[a];
              const float seg = ok ? lci[a] - kd : -INFINITY;
              s[n][2 * a + e] = ok ? s[n][2 * a + e] * exp2f(seg) : 0.f;
            }
          }
      }

      // y += (P_hi + P_lo) x: the S fragments of 8-key tiles 2 kk and
      // 2 kk + 1 are the A fragment of keys 16 kk .. 16 kk + 15.
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        uint32_t pa[4], pl[4];
        pack_split(s[2 * kk][0], s[2 * kk][1], &pa[0], &pl[0]);
        pack_split(s[2 * kk][2], s[2 * kk][3], &pa[1], &pl[1]);
        pack_split(s[2 * kk + 1][0], s[2 * kk + 1][1], &pa[2], &pl[2]);
        pack_split(s[2 * kk + 1][2], s[2 * kk + 1][3], &pa[3], &pl[3]);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, xs + (kh * kSub + kk * 16 + lane % 8
                                  + ((lane / 8) & 1) * 8) * SH
                                + np * 16 + (lane / 16) * 8);
          mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
          mma_bf16(acc[2 * np], pl, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], pl, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                   // stage t % kStages is consumed
  }
  cp_async_wait<0>();

  // The carried term, once (i) and (ii) are done: the previous chunk's
  // state into the free ring, y += exp(cum_i) C_i . (h_hi + h_lo).
  wait_prior();
  if (carried) {
    const size_t off = (((size_t)b * nc + c) * nh + h) * hdn;
    for (int i = tid; i < HD * (N / 8); i += kTcThreads) {
      const int p = i / (N / 8), col = (i % (N / 8)) * 8;
      cp_async16(hh_s + p * SN + col, hp + off + (size_t)p * N + col, true);
      cp_async16(hl_s + p * SN + col, hp + plane + off + (size_t)p * N + col,
                 true);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  if (carried && wactive) {
    float hc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {     // h_hi, then h_lo
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, (half ? hl_s : hh_s)
                          + (np * 16 + lane % 8 + (lane / 16) * 8) * SN
                          + kk * 16 + ((lane / 8) & 1) * 8);
          mma_bf16(hc[2 * np], cf[kk], bf[0], bf[1]);
          mma_bf16(hc[2 * np + 1], cf[kk], bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float e = exp2f(lci[a]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * a] = fmaf(e, hc[n][2 * a], acc[n][2 * a]);
        acc[n][2 * a + 1] = fmaf(e, hc[n][2 * a + 1], acc[n][2 * a + 1]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!rvalid[a]) continue;
    float* out = y + ((size_t)b * T + t0 + row[a]) * x_stride
                 + (size_t)h * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(out + n * 8 + 2 * (lane % 4)) =
          make_float2(acc[n][2 * a], acc[n][2 * a + 1]);
  }
}

// Launches a kernel that may start before the one before it on the
// stream has finished (see launch_dependents / wait_prior).
template <typename... P, typename... Args>
cudaError_t launch_pdl(void (*kernel)(P...), dim3 grid, int threads,
                       size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);
}

template <int HD, int N>
cudaError_t launch_tc(const bf16* x, const float* dt, const float* A,
                      const bf16* Bm, const bf16* Cm, const float* h0,
                      float* y, float* h_out, float* states, float* cum,
                      bf16* hp, int B, int T, int nh, int G, int Q,
                      cudaStream_t stream) {
  constexpr int PB = HD > 64 ? HD / 64 : 1;
  const int nc = T / Q;
  const long long plane = (long long)B * nc * nh * HD * N;
  constexpr size_t tile_bytes = states_tile_bytes<HD, N>();
  static bool states_raised = false;
  cudaError_t err = raise_smem(
      ssd_states_kernel<HD, N>,
      states_smem_bytes(tile_bytes, kStatesStages), &states_raised);
  if (err != cudaSuccess) return err;
  const size_t states_smem = states_smem_bytes(
      tile_bytes, std::min((Q + kTile - 1) / kTile, kStatesStages));
  ssd_states_kernel<HD, N><<<dim3(PB * nc * nh, B), kTcThreads, states_smem,
                             stream>>>(x, dt, A, Bm, states, cum, T, nh, G,
                                       Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int PE = pass_elems<HD, N>();
  constexpr int per_cta = kPassThreads * PE;
  err = launch_pdl(ssd_pass_kernel<PE>,
                   dim3((HD * N + per_cta - 1) / per_cta, nh, B),
                   kPassThreads, 0, stream, states, cum, h0, hp, plane, h_out,
                   T, nh, Q, HD * N);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = out_smem_bytes<HD, N>();
  static bool raised = false;
  err = raise_smem(ssd_out_kernel<HD, N>, smem, &raised);
  if (err != cudaSuccess) return err;
  const int n_row_tiles = (Q + kTile - 1) / kTile;
  return launch_pdl(ssd_out_kernel<HD, N>, dim3(nc * nh, B, n_row_tiles),
                    kTcThreads, smem, stream, x, dt, A, Bm, Cm, hp, plane, y,
                    T, nh, G, Q, (int)(h0 != nullptr));
}

// ------------------------------------------------------- CUDA-core path

constexpr int kRows = 64;        // query rows of a chunk per tile
constexpr int kKeys = 64;        // key rows of a chunk per tile
constexpr int kThreads = 256;    // 16 x 16 threads

size_t smem_bytes(int hd, int n) {
  // state [N][hd], C^T [N][kRows], B^T [N][kKeys], x [kKeys][hd],
  // p [kKeys][kRows], dt and cum [kMaxChunk], all f32.
  return ((size_t)n * hd + (size_t)n * kRows + (size_t)n * kKeys
          + (size_t)kKeys * hd + (size_t)kKeys * kRows + 2 * kMaxChunk)
         * sizeof(float);
}

// Rows row0 .. row0 + 63 (chunk-relative) of a [T, G, N] operand's group
// into dst [N][64] (transposed; rows past Q are zeros).  Consecutive
// threads take consecutive rows, so the transposing stores do not conflict.
template <int N>
__device__ __forceinline__ void load_rows_t(float* dst, const float* src,
                                            size_t base, size_t row_stride,
                                            int row0, int Q, int tid) {
  for (int i = tid; i < 64 * (N / 4); i += kThreads) {
    const int r = i % 64;
    const int c = (i / 64) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < Q)
      v = *reinterpret_cast<const float4*>(
          src + base + (size_t)(row0 + r) * row_stride + c);
    dst[(c + 0) * 64 + r] = v.x;
    dst[(c + 1) * 64 + r] = v.y;
    dst[(c + 2) * 64 + r] = v.z;
    dst[(c + 3) * 64 + r] = v.w;
  }
}

// Rows row0 .. row0 + 63 of x (head h) into dst [64][HD], row r scaled by
// dt_r, and with decay, by exp(cum_last - cum_r) after that (zeros past Q).
template <int HD>
__device__ __forceinline__ void load_x(float* dst, const float* x,
                                       size_t base, size_t row_stride,
                                       int row0, int Q, const float* dt_s,
                                       const float* cum_s, bool decay,
                                       int tid) {
  constexpr int per_row = HD / 4;
  for (int i = tid; i < 64 * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * 4;
    const int t = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < Q) {
      v = *reinterpret_cast<const float4*>(x + base
                                           + (size_t)t * row_stride + c);
      const float dtv = dt_s[t];
      const float dec = decay ? expf(cum_s[Q - 1] - cum_s[t]) : 1.f;
      const float buf[4] = {v.x, v.y, v.z, v.w};
      float o[4];
      for (int e = 0; e < 4; ++e)
        o[e] = decay ? (buf[e] * dtv) * dec : buf[e] * dtv;
      v = make_float4(o[0], o[1], o[2], o[3]);
    }
    *reinterpret_cast<float4*>(dst + r * HD + c) = v;
  }
}

// NH = hd / 16, NN = N / 16.  Each thread owns a 4 x 4 block of a tile's
// scores and a 4-row x hd/16-column block of the output; the intra-chunk
// term is masked before exp; the carried term reads the previous chunk's
// state, which the state update overwrites only after a barrier that
// every row has passed.
template <int NH, int NN>
__global__ void __launch_bounds__(kThreads)
ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ h_out, int T,
                    int nh, int G, int Q) {
  constexpr int HD = NH * 16;
  constexpr int N = NN * 16;
  extern __shared__ float smem[];
  float* h_s = smem;                    // [N][HD] carried state, transposed
  float* c_s = h_s + N * HD;            // [N][kRows]
  float* b_s = c_s + N * kRows;         // [N][kKeys]
  float* x_s = b_s + N * kKeys;         // [kKeys][HD]
  float* p_s = x_s + kKeys * HD;        // [kKeys][kRows]
  float* dt_s = p_s + kKeys * kRows;    // [kMaxChunk]
  float* cum_s = dt_s + kMaxChunk;      // [kMaxChunk]
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;              // output columns tx + 16 j
  const int ty = tid / 16;              // rows 4 ty .. 4 ty + 3
  const float a_h = A[h];
  const size_t bc_stride = (size_t)G * N;    // between time steps
  const size_t x_stride = (size_t)nh * HD;
  const size_t state_off = ((size_t)b * nh + h) * HD * N;
  const int grp = h / (nh / G);

  for (int i = tid; i < N * HD; i += kThreads) {
    const int p = i / N, n = i % N;           // coalesced read of h0[p][n]
    h_s[n * HD + p] = h0 != nullptr ? h0[state_off + i] : 0.f;
  }

  const float4* c4 = reinterpret_cast<const float4*>(c_s);
  const float4* b4 = reinterpret_cast<const float4*>(b_s);
  const float4* p4 = reinterpret_cast<const float4*>(p_s);
  const int n_chunks = T / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * Q;
    const size_t bc_base = ((size_t)b * T + t0) * bc_stride
                           + (size_t)grp * N;
    const size_t x_base = ((size_t)b * T + t0) * x_stride + (size_t)h * HD;
    __syncthreads();  // the previous chunk's state and tiles are settled
    for (int i = tid; i < Q; i += kThreads)
      dt_s[i] = dt[((size_t)b * T + t0 + i) * nh + h];
    __syncthreads();
    if (tid < 32) chunk_cumsum(dt_s, cum_s, Q, a_h, tid);

    for (int r0 = 0; r0 < Q; r0 += kRows) {
      __syncthreads();  // cum_s is visible; the previous tile is consumed
      load_rows_t<N>(c_s, Cm, bc_base, bc_stride, r0, Q, tid);
      __syncthreads();
      int row[4];
      bool rvalid[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        row[a] = r0 + ty * 4 + a;
        rvalid[a] = row[a] < Q;
      }
      // Carried term from the previous chunk's state: exp(cum_i) C_i . h_p.
      float acc[4][NH];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < NH; ++j) acc[a][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = c4[n * (kRows / 4) + ty];
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const float hv = h_s[n * HD + tx + 16 * j];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][j] = fmaf(cr[a], hv, acc[a][j]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = rvalid[a] ? expf(cum_s[row[a]]) : 0.f;
#pragma unroll
        for (int j = 0; j < NH; ++j) acc[a][j] *= e;
      }

      // Intra-chunk term over the key tiles up to the diagonal.
      for (int k0 = 0; k0 <= r0; k0 += kKeys) {
        __syncthreads();  // the previous key tile is consumed
        load_rows_t<N>(b_s, Bm, bc_base, bc_stride, k0, Q, tid);
        load_x<HD>(x_s, x, x_base, x_stride, k0, Q, dt_s, cum_s, false, tid);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = c4[n * (kRows / 4) + ty];
          const float4 bv = b4[n * (kKeys / 4) + tx];
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float bk[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb)
              s[a][bb] = fmaf(cr[a], bk[bb], s[a][bb]);
        }
        // Mask before exp: only j <= i (both inside the chunk) is computed.
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int key = k0 + tx * 4 + bb;
          float pr[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            pr[a] = (rvalid[a] && key <= row[a])
                        ? s[a][bb] * expf(cum_s[row[a]] - cum_s[key])
                        : 0.f;
          reinterpret_cast<float4*>(p_s)[(tx * 4 + bb) * (kRows / 4) + ty] =
              make_float4(pr[0], pr[1], pr[2], pr[3]);
        }
        __syncthreads();
        const int kend = min(kKeys, Q - k0);
        for (int kk = 0; kk < kend; ++kk) {
          const float4 pv = p4[kk * (kRows / 4) + ty];
          const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int j = 0; j < NH; ++j) {
            const float xv = x_s[kk * HD + tx + 16 * j];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][j] = fmaf(pr[a], xv, acc[a][j]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (!rvalid[a]) continue;
        float* out = y + ((size_t)b * T + t0 + row[a]) * x_stride
                     + (size_t)h * HD;
#pragma unroll
        for (int j = 0; j < NH; ++j) out[tx + 16 * j] = acc[a][j];
      }
    }

    // State update, after a barrier that every row passes after its last
    // read of the old state; from there each thread reads and writes only
    // its own state elements (rows ty + 16 i, columns tx + 16 j).
    __syncthreads();
    float hacc[NN][NH];
    const float e_last = expf(cum_s[Q - 1]);
#pragma unroll
    for (int i = 0; i < NN; ++i)
#pragma unroll
      for (int j = 0; j < NH; ++j)
        hacc[i][j] = h_s[(ty + 16 * i) * HD + tx + 16 * j] * e_last;
    for (int k0 = 0; k0 < Q; k0 += kKeys) {
      if (k0 > 0) __syncthreads();  // the previous key tile is consumed
      load_rows_t<N>(b_s, Bm, bc_base, bc_stride, k0, Q, tid);
      load_x<HD>(x_s, x, x_base, x_stride, k0, Q, dt_s, cum_s, true, tid);
      __syncthreads();
      const int kend = min(kKeys, Q - k0);
      for (int kk = 0; kk < kend; ++kk) {
#pragma unroll
        for (int i = 0; i < NN; ++i) {
          const float bv = b_s[(ty + 16 * i) * kKeys + kk];
#pragma unroll
          for (int j = 0; j < NH; ++j)
            hacc[i][j] = fmaf(bv, x_s[kk * HD + tx + 16 * j], hacc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NN; ++i)
#pragma unroll
      for (int j = 0; j < NH; ++j)
        h_s[(ty + 16 * i) * HD + tx + 16 * j] = hacc[i][j];
  }

  __syncthreads();
  for (int i = tid; i < N * HD; i += kThreads) {
    const int p = i / N, n = i % N;
    h_out[state_off + i] = h_s[n * HD + p];
  }
}

template <int NH, int NN>
cudaError_t launch_f32(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, const float* h0,
                       float* y, float* h_out, int B, int T, int nh, int G,
                       int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(NH * 16, NN * 16);
  static bool raised = false;
  const cudaError_t err =
      raise_smem(ssd_scan_f32_kernel<NH, NN>, smem, &raised);
  if (err != cudaSuccess) return err;
  ssd_scan_f32_kernel<NH, NN><<<dim3(nh, B), kThreads, smem, stream>>>(
      x, dt, A, Bm, Cm, h0, y, h_out, T, nh, G, Q);
  return cudaGetLastError();
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;
  float* y;
  float* h_out;
  float* states;
  float* cum;
  void* hp;
  int B, T, nh, G, Q, is_f32;
  cudaStream_t stream;
};

template <int HD, int N>
cudaError_t dispatch(const Args& a) {
  if (a.is_f32)
    return launch_f32<HD / 16, N / 16>(
        static_cast<const float*>(a.x), a.dt, a.A,
        static_cast<const float*>(a.Bm), static_cast<const float*>(a.Cm),
        a.h0, a.y, a.h_out, a.B, a.T, a.nh, a.G, a.Q, a.stream);
  return launch_tc<HD, N>(
      static_cast<const bf16*>(a.x), a.dt, a.A,
      static_cast<const bf16*>(a.Bm), static_cast<const bf16*>(a.Cm), a.h0,
      a.y, a.h_out, a.states, a.cum, static_cast<bf16*>(a.hp), a.B, a.T,
      a.nh, a.G, a.Q, a.stream);
}

template <int HD>
cudaError_t dispatch_n(int n, const Args& a) {
  switch (n) {
    case 16: return dispatch<HD, 16>(a);
    case 32: return dispatch<HD, 32>(a);
    case 64: return dispatch<HD, 64>(a);
    case 128: return dispatch<HD, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [B, T, nh, hd] and Bm / Cm [B, T, G, N], all bf16 (is_f32 = 0) or all
// f32; G divides nh; dt [B, T, nh] f32; A [nh] f32; h0 [B, nh, hd, N] f32
// or null; y [B, T, nh, hd] and h_out [B, nh, hd, N] f32.  hd and N in
// {16, 32, 64, 128}; 1 <= Q <= 256 and T a multiple of Q.  bf16 needs f32
// scratch states [B, T / Q, nh, hd, N] and cum [B, nh, T] and bf16
// scratch hp [2, B, T / Q, nh, hd, N] (f32 needs none: pass null).
// Returns the first failing launch's cudaError_t (0 on success).
int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, const float* h0, float* y,
                 float* h_out, float* states, float* cum, void* hp, int B,
                 int T, int nh, int G, int hd, int n, int Q, int is_f32,
                 void* stream) {
  if (Q < 1 || Q > kMaxChunk || T % Q != 0 || G < 1 || nh % G != 0
      || B > 65535 || nh > 65535 || (long long)(T / Q) * nh * 2 > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (!is_f32 && (states == nullptr || cum == nullptr || hp == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{x, dt, A, Bm, Cm, h0, y, h_out, states, cum, hp,
               B, T, nh, G, Q, is_f32,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 16: return (int)dispatch_n<16>(n, a);
    case 32: return (int)dispatch_n<32>(n, a);
    case 64: return (int)dispatch_n<64>(n, a);
    case 128: return (int)dispatch_n<128>(n, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
