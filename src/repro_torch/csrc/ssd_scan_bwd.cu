// Backward of the Mamba-2 SSD chunked scan (csrc/ssd_scan.cu).
//
// No Pallas twin: the reference differentiates its jnp scan
// (repro/models/mamba2.py: ssd_chunked) with jax.value_and_grad.  For one
// (batch row b, head h), chunks of Q steps, the forward is
//
//   cum_i = sum_{j <= i} dt_j A                 (inclusive, per chunk)
//   y_i   = sum_{j <= i} (C_i . B_j) L_ij dt_j x_j + e^{cum_i} h_p C_i
//   h_c   = e^{cum_L} h_p + S_c,  S_c = sum_j e^{cum_L - cum_j} dt_j x_j B_j^T
//
// with L_ij = e^{cum_i - cum_j}, L the chunk's last row and h_p the state
// carried in (h0 or zero before chunk 0).  Given dy and d h_final (or
// zero), with g = dh_c the gradient of the chunk's outgoing state:
//
//   dh_{c-1} = e^{cum_L} dh_c + E_c,  E_c = sum_i e^{cum_i} dy_i C_i^T
//   per pair j <= i:  s = C_i . B_j,  D = dy_i . x_j
//     M = s L,  W = L dt_j D,  P = s W
//   u_j  = sum_i M_ij dy_i + e^{cum_L - cum_j} g B_j      dx_j = dt_j u_j
//   dC_i = sum_j W_ij B_j + e^{cum_i} h_p^T dy_i
//   dB_j = sum_i W_ij C_i + dt_j e^{cum_L - cum_j} g^T x_j
//   q_j  = e^{cum_L - cum_j} dt_j x_j . (g B_j)
//   dcum_k = sum_j P_kj - sum_i P_ik + C_k . (e^{cum_k} h_p^T dy_k) - q_k
//            + [k = L] (e^{cum_L} <g, h_p> + sum_j q_j)
//   da_k = sum_{i >= k} dcum_i;  d dt_k = x_k . u_k + A da_k;
//   dA = sum_k dt_k da_k;  dB, dC summed over each group's heads.
//
// Seven launches, every one parallel over chunks or elements.  What bounds
// the backward on this card is operations: at mamba2-1.3b's training shape
// (B 2, T 2048, 64 heads, hd 64, N 128, Q 256) the pairs' products and the
// state terms are ~56 GFLOP against ~0.14 GB of inputs and outputs, 0.057
// ms at the bf16 tensor-core peak.  The bf16 path runs every product on
// the tensor cores, over 64-row tiles:
//
//   (1) ssd_bwd_states_tc_kernel, grid (S or E, chunk, head) x row, four
//       warps of 16 state rows on mma.sync.m16n8k16: S_c = sum_j w_j x_j^T
//       B_j (w x split into a bf16 hi + lo pair) and E_c = sum_i e^{cum_i}
//       dy_i^T C_i (e dy split likewise) over the chunk's rows through a
//       two-stage ring; the S CTAs also write the chunk's cum_L and each
//       row's lc = cum log2(e) and dt, the E CTAs dy as a bf16 hi + lo pair,
//       the form (3) and (4) read them in;
//   (2) ssd_bwd_pass_tc_kernel, four state elements a thread: the reverse
//       pass (g = dh_c, then dh0) and the forward one (h_p), each written
//       as a bf16 hi + lo pair, and per warp its part of <g, h_p>;
//   (3) ssd_bwd_rows_wg_kernel, grid (head block, chunk) x row x 64-row
//       query tile, heaviest tiles first, one warpgroup on wgmma: dy_i's
//       hi and lo are register A operands; over the key tiles up to the
//       diagonal (two-stage cp.async ring of B and x) D = dy x^T, W = L dt
//       D in f32 (masked before the exp) split into the A operand of dC +=
//       W B; then the carried term e^{cum_i} dy_i h_p and each row's C .
//       that;
//   (4) ssd_bwd_cols_wg_kernel, grid (head block, chunk) x row x 64-row
//       key tile, heaviest first, one warpgroup on wgmma: over the query
//       tiles from the diagonal on (ring of C and dy's hi and lo) s^T = B
//       C^T and D^T = x dy^T from shared memory, M^T, W^T and P in f32,
//       u += M^T dy and dB += W^T C with M and W as register A operands;
//       each key's sum_i P and each query tile's sum_j P (a fixed-order
//       sum over the four warps, one partial per key tile to scratch);
//       then the state terms g B_j and g^T x_j, dx, q and x . u;
//   (5)-(7) as the f32 path below: dcum (the row partials summed in tile
//       order), its suffix sum, d dt and dA's partials; dB and dC per
//       group; dA.
//
// wgmma tiles lie in shared memory in the 128-byte swizzle its
// descriptors name, loaded by cp.async.  The pair work is split as the
// flash backward's: (3) recomputes D, ~12 % more tensor work than one
// pass, whose dC partials would go through scratch.  (3) and (4) each walk
// `heads` heads of one group in turn (the wrapper's choice, up to 8), so
// dB and dC leave them summed over those heads; each head's next tiles go
// out while the CTA finishes the head before.  What still holds the call
// above its bound (PERF.md): per tile the warpgroup waits on each product
// group before its f32 work (exp, the masks, the hi + lo splits and the
// column sums), two CTAs an SM at ~255 registers; and the states, the
// passes and the dB / dC partials move ~0.5 GB at mamba2's shape.
//
// Why the hi + lo pairs: C, B and x are bf16 inputs, so their products
// are exact; dy is f32 and W, M, e dy, w x, h_p and g are f32 values made
// in the kernel.  dcum = sum_j P - sum_i P is a difference of large sums
// that d dt and dA inherit, and the SSD scores are unnormalized, so every
// such operand goes in as a bf16 pair (~16 bits of mantissa; the lo x lo
// product is dropped where both are split), as the forward's P does.
//
// f32 inputs (tolerance 2e-5, which TF32 would not hold) keep the first
// port's seven CUDA-core kernels, f32 FMAs from shared memory:
//
//   (1) ssd_bwd_states_kernel, grid (chunk, head, row): S_c and E_c
//       [hd, N] and the chunk's cum_L, by one thread per 32 state elements
//       over the chunk's rows;
//   (2) ssd_bwd_pass_kernel, per state element: the forward state pass
//       (S_c is overwritten by h_p of chunk c) and the reverse one (E_c by
//       dh_c); the last reverse state is dh0;
//   (3) ssd_bwd_rows_kernel, grid (64-row query tile x chunk, head, row):
//       over the key tiles up to the diagonal, s and D of each pair from
//       shared-memory tiles, W, then dC += W B; the carried term of dC;
//       each row's sum_j P + C . dC_off;
//   (4) ssd_bwd_cols_kernel, grid (64-row key tile x chunk, head, row):
//       over the query tiles from the diagonal on, s and D again, M and W,
//       then u += M^T dy and dB += W^T C; the state terms; dx = dt u, each
//       key's sum_i P, q and x . u;
//   (5) ssd_bwd_dt_kernel, grid (chunk, head, row): dcum, its suffix sum
//       over the chunk (da), d dt and the chunk's dA partial;
//   (6) ssd_bwd_groups_kernel: dB and dC per group, its heads summed in
//       head order, in the inputs' dtype;
//   (7) ssd_bwd_da_kernel: dA, the partials summed over rows and chunks
//       in order.
//
// No atomics: every sum runs in a fixed order (tiles in order, the
// heads of a group in head order, dA over rows then chunks), so two calls
// give the same bits, as checkpoint-resume needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 256;
constexpr int kThreads = 256;    // 16 x 16
constexpr int kT = 64;           // rows of a query or key tile
constexpr int kR = 16;           // rows per step of the states kernel


template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16(v);
}

// Raises a kernel's dynamic shared memory limit once per instantiation.
template <typename K>
cudaError_t raise_smem(K kernel, size_t bytes, bool* raised) {
  if (bytes <= 48 * 1024 || *raised) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *raised = true;
  return err;
}

// Inclusive scan cum_s[i] = sum_{j <= i} dt_s[j] a over i < Q, by one warp
// (the forward's arithmetic: each lane sums a run of rows, a shuffle scan
// offsets the runs).
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

// Suffix sum out[k] = sum_{i >= k} v[i] over k < Q, by one warp: the
// scan above over the reversed rows.
__device__ __forceinline__ void chunk_suffix_sum(const float* v, float* out,
                                                 int Q, int lane) {
  const int E = (Q + 31) / 32;
  const int lo = min(lane * E, Q), hi = min(lo + E, Q);
  float run = 0.f;
  for (int r = lo; r < hi; ++r) run += v[Q - 1 - r];
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.f;
  for (int r = lo; r < hi; ++r) {
    acc += v[Q - 1 - r];
    out[Q - 1 - r] = acc;
  }
}

// The chunk's dt (rows t0 .. t0 + Q - 1 of head h) and its cum.
__device__ __forceinline__ void load_dt_cum(float* dt_s, float* cum_s,
                                            const float* dt, const float* A,
                                            int b, int T, int t0, int nh,
                                            int h, int Q, int tid) {
  for (int i = tid; i < Q; i += kThreads)
    dt_s[i] = dt[((size_t)b * T + t0 + i) * nh + h];
  __syncthreads();
  if (tid < 32) chunk_cumsum(dt_s, cum_s, Q, A[h], tid);
  __syncthreads();
}

// Rows r0 .. r0 + kT - 1 (chunk-relative, zero at and past Q) of a
// [B, T, heads, D] tensor at one head into dst[r * ld + d].
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          size_t base, size_t row_stride,
                                          int r0, int Q, int tid) {
  for (int i = tid; i < kT * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * ld + d] =
        r0 + r < Q ? src[base + (size_t)(r0 + r) * row_stride + d]
                   : 0.f;
  }
}

// acc[a][m] += sum_k A(ty + 16 a, k) B(k, tx + 16 m), with A(r, k) =
// sa[r * ar + k * ak] and B(k, c) = sb[c * bc + k * bk] in shared memory.
template <int RA, int CM, int K>
__device__ __forceinline__ void mm(float (&acc)[RA][CM], const float* sa,
                                   int ar, int ak, const float* sb, int bc,
                                   int bk, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RA], bv[CM];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = sa[(ty + 16 * a) * ar + k * ak];
#pragma unroll
    for (int m = 0; m < CM; ++m) bv[m] = sb[(tx + 16 * m) * bc + k * bk];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int m = 0; m < CM; ++m) acc[a][m] = fmaf(av[a], bv[m], acc[a][m]);
  }
}

template <int RA, int CM>
__device__ __forceinline__ void zero(float (&acc)[RA][CM]) {
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int m = 0; m < CM; ++m) acc[a][m] = 0.f;
}

// Sum of v over the block's threads, in a fixed order; red holds
// kThreads floats.  Every thread gets the sum.
__device__ __forceinline__ float block_sum(float v, float* red, int tid) {
  __syncthreads();
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// ------------------------------------------------------------- (1) states

template <int HD, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ Bm,
                      const float* __restrict__ Cm, const float* __restrict__ dy,
                      float* __restrict__ S, float* __restrict__ E,
                      float* __restrict__ cumL, int T, int nh, int G, int Q) {
  constexpr int kElems = HD * N / kThreads, kStep = kThreads / N;
  static_assert(HD * N % kThreads == 0 && kThreads % N == 0, "layout");
  extern __shared__ float sm[];
  float* dt_s = sm;
  float* cum_s = dt_s + kMaxChunk;
  float* w_s = cum_s + kMaxChunk;
  float* e_s = w_s + kMaxChunk;
  float* xa = e_s + kMaxChunk;   // [kR][HD] w-scaled x
  float* ba = xa + kR * HD;      // [kR][N]
  float* ya = ba + kR * N;       // [kR][HD] e-scaled dy
  float* ca = ya + kR * HD;      // [kR][N]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (nh / G), tid = threadIdx.x;
  const int t0 = c * Q;
  load_dt_cum(dt_s, cum_s, dt, A, b, T, t0, nh, h, Q, tid);
  for (int i = tid; i < Q; i += kThreads) {
    w_s[i] = dt_s[i] * expf(cum_s[Q - 1] - cum_s[i]);
    e_s[i] = expf(cum_s[i]);
  }
  const int n = tid % N, p0 = tid / N;
  float accS[kElems], accE[kElems];
#pragma unroll
  for (int k = 0; k < kElems; ++k) accS[k] = accE[k] = 0.f;
  const size_t xrow = (size_t)nh * HD, brow = (size_t)G * N;
  for (int r0 = 0; r0 < Q; r0 += kR) {
    __syncthreads();
    for (int i = tid; i < kR * HD; i += kThreads) {
      const int r = i / HD, p = i % HD, t = r0 + r;
      const size_t off = ((size_t)b * T + t0 + t) * xrow + (size_t)h * HD + p;
      xa[i] = t < Q ? w_s[t] * x[off] : 0.f;
      ya[i] = t < Q ? e_s[t] * dy[off] : 0.f;
    }
    for (int i = tid; i < kR * N; i += kThreads) {
      const int r = i / N, nn = i % N, t = r0 + r;
      const size_t off = ((size_t)b * T + t0 + t) * brow + (size_t)g * N + nn;
      ba[i] = t < Q ? Bm[off] : 0.f;
      ca[i] = t < Q ? Cm[off] : 0.f;
    }
    __syncthreads();
    const int rows = min(kR, Q - r0);
    for (int r = 0; r < rows; ++r) {
      const float bv = ba[r * N + n], cv = ca[r * N + n];
#pragma unroll
      for (int k = 0; k < kElems; ++k) {
        accS[k] = fmaf(xa[r * HD + p0 + kStep * k], bv, accS[k]);
        accE[k] = fmaf(ya[r * HD + p0 + kStep * k], cv, accE[k]);
      }
    }
  }
  const size_t base = (((size_t)b * nc + c) * nh + h) * HD * N;
#pragma unroll
  for (int k = 0; k < kElems; ++k) {
    const size_t i = base + (size_t)(p0 + kStep * k) * N + n;
    S[i] = accS[k];
    E[i] = accE[k];
  }
  if (tid == 0) cumL[((size_t)b * nc + c) * nh + h] = cum_s[Q - 1];
}

// --------------------------------------------------------------- (2) pass

__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass_kernel(float* __restrict__ S, float* __restrict__ E,
                    const float* __restrict__ cumL,
                    const float* __restrict__ h0,
                    const float* __restrict__ dh, float* __restrict__ dh0,
                    int B, int nh, int hn, int nc) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)B * nh * hn) return;
  const int pn = (int)(e % hn);
  const size_t bh = e / hn;
  const int h = (int)(bh % nh), b = (int)(bh / nh);
  float hv = h0 != nullptr ? h0[e] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t ch = ((size_t)b * nc + c) * nh + h;
    const size_t i = ch * hn + pn;
    const float s = S[i];
    S[i] = hv;
    hv = expf(cumL[ch]) * hv + s;
  }
  float gv = dh != nullptr ? dh[e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t ch = ((size_t)b * nc + c) * nh + h;
    const size_t i = ch * hn + pn;
    const float ev = E[i];
    E[i] = gv;
    gv = expf(cumL[ch]) * gv + ev;
  }
  if (dh0 != nullptr) dh0[e] = gv;
}

// --------------------------------------------------------------- (3) rows

template <int HD, int N>
constexpr size_t rows_smem_floats() {
  return 2 * kMaxChunk + 2 * kT * (N + 1) + 2 * kT * (HD + 1)
         + kT * (kT + 1) + kT * 17;
}

template <int HD, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ dy,
                    const float* __restrict__ Hp, float* __restrict__ dCh,
                    float* __restrict__ rowp, int T, int nh, int G, int Q) {
  static_assert(HD <= kT && HD % 16 == 0 && N % 16 == 0, "tile shapes");
  constexpr int LN = N + 1, LH = HD + 1, LW = kT + 1, CN = N / 16;
  extern __shared__ float sm[];
  float* dt_s = sm;
  float* cum_s = dt_s + kMaxChunk;
  float* Cs = cum_s + kMaxChunk;   // [kT][LN] query rows' C
  float* Ys = Cs + kT * LN;        // [kT][LH] query rows' dy
  float* Bs = Ys + kT * LH;        // [kT][LN] key rows' B; then h_p [HD][LN]
  float* Xs = Bs + kT * LN;        // [kT][LH] key rows' x
  float* Ws = Xs + kT * LH;        // [kT][LW]
  float* red = Ws + kT * LW;       // [kT][17]
  const int nt = (Q + kT - 1) / kT;
  const int I = blockIdx.x % nt, c = blockIdx.x / nt;
  const int h = blockIdx.y, b = blockIdx.z, nc = gridDim.x / nt;
  const int g = h / (nh / G), tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = c * Q, i0 = I * kT;
  load_dt_cum(dt_s, cum_s, dt, A, b, T, t0, nh, h, Q, tid);
  const size_t xrow = (size_t)nh * HD, brow = (size_t)G * N;
  const size_t xbase = (size_t)b * T * xrow + (size_t)t0 * xrow + (size_t)h * HD;
  const size_t bbase = (size_t)b * T * brow + (size_t)t0 * brow + (size_t)g * N;
  load_tile<N>(Cs, LN, Cm, bbase, brow, i0, Q, tid);
  load_tile<HD>(Ys, LH, dy, xbase, xrow, i0, Q, tid);
  float acc[4][CN];
  zero(acc);
  float rp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int J = 0; J <= I; ++J) {
    const int j0 = J * kT;
    __syncthreads();
    load_tile<N>(Bs, LN, Bm, bbase, brow, j0, Q, tid);
    load_tile<HD>(Xs, LH, x, xbase, xrow, j0, Q, tid);
    __syncthreads();
    float s[4][4], d[4][4];
    zero(s);
    zero(d);
    mm<4, 4, N>(s, Cs, LN, 1, Bs, LN, 1, ty, tx);
    mm<4, 4, HD>(d, Ys, LH, 1, Xs, LH, 1, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = ty + 16 * a, j = tx + 16 * m;
        const int gi = i0 + i, gj = j0 + j;
        float w = 0.f;
        if (gj <= gi && gi < Q) {   // masked before the exp
          w = expf(cum_s[gi] - cum_s[gj]) * dt_s[gj] * d[a][m];
          rp[a] = fmaf(s[a][m], w, rp[a]);
        }
        Ws[i * LW + j] = w;
      }
    __syncthreads();
    mm<4, CN, kT>(acc, Ws, LW, 1, Bs, 1, LN, ty, tx);
  }
  // The carried term: dC_i += e^{cum_i} h_p^T dy_i, and C_i . that.
  __syncthreads();
  const float* hp = Hp + ((((size_t)b * nc + c) * nh + h) * HD) * N;
  for (int i = tid; i < HD * N; i += kThreads)
    Bs[(i / N) * LN + i % N] = hp[i];
  __syncthreads();
  float off[4][CN];
  zero(off);
  mm<4, CN, HD>(off, Ys, LH, 1, Bs, 1, LN, ty, tx);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a, gi = i0 + i;
    if (gi >= Q) continue;
    const float e = expf(cum_s[gi]);
    float* out = dCh + (((size_t)b * T + t0 + gi) * nh + h) * N;
#pragma unroll
    for (int m = 0; m < CN; ++m) {
      const float v = e * off[a][m];
      rp[a] = fmaf(Cs[i * LN + tx + 16 * m], v, rp[a]);
      out[tx + 16 * m] = acc[a][m] + v;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) red[(ty + 16 * a) * 17 + tx] = rp[a];
  __syncthreads();
  if (tid < kT && i0 + tid < Q) {
    float sum = 0.f;
    for (int k = 0; k < 16; ++k) sum += red[tid * 17 + k];
    rowp[((size_t)b * nh + h) * T + t0 + i0 + tid] = sum;
  }
}

// --------------------------------------------------------------- (4) cols

template <int HD, int N>
constexpr size_t cols_smem_floats() {
  return 2 * kMaxChunk + 2 * kT * (N + 1) + 2 * kT * (HD + 1)
         + 2 * kT * (kT + 1);
}

template <int HD, int N>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cols_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ dy,
                    const float* __restrict__ Gs, float* __restrict__ dx,
                    float* __restrict__ dBh, float* __restrict__ colp,
                    float* __restrict__ qv, float* __restrict__ ddtd, int T,
                    int nh, int G, int Q) {
  static_assert(HD <= kT && HD % 16 == 0 && N % 16 == 0, "tile shapes");
  constexpr int LN = N + 1, LH = HD + 1, LW = kT + 1;
  constexpr int CN = N / 16, CH = HD / 16;
  extern __shared__ float sm[];
  float* dt_s = sm;
  float* cum_s = dt_s + kMaxChunk;
  float* Bs = cum_s + kMaxChunk;   // [kT][LN] key rows' B
  float* Xs = Bs + kT * LN;        // [kT][LH] key rows' x
  float* Cs = Xs + kT * LH;        // [kT][LN] query rows' C; then g [HD][LN]
  float* Ys = Cs + kT * LN;        // [kT][LH] query rows' dy
  float* Ms = Ys + kT * LH;        // [kT][LW]; then the reductions
  float* Ws = Ms + kT * LW;        // [kT][LW]
  const int nt = (Q + kT - 1) / kT;
  const int J = blockIdx.x % nt, c = blockIdx.x / nt;
  const int h = blockIdx.y, b = blockIdx.z, nc = gridDim.x / nt;
  const int g = h / (nh / G), tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = c * Q, j0 = J * kT;
  load_dt_cum(dt_s, cum_s, dt, A, b, T, t0, nh, h, Q, tid);
  const size_t xrow = (size_t)nh * HD, brow = (size_t)G * N;
  const size_t xbase = (size_t)b * T * xrow + (size_t)t0 * xrow + (size_t)h * HD;
  const size_t bbase = (size_t)b * T * brow + (size_t)t0 * brow + (size_t)g * N;
  load_tile<N>(Bs, LN, Bm, bbase, brow, j0, Q, tid);
  load_tile<HD>(Xs, LH, x, xbase, xrow, j0, Q, tid);
  float u[4][CH], db[4][CN];
  zero(u);
  zero(db);
  float cp[4] = {0.f, 0.f, 0.f, 0.f};   // sum_i P over key columns tx + 16 m
  for (int I = J; I < nt; ++I) {
    const int i0 = I * kT;
    __syncthreads();
    load_tile<N>(Cs, LN, Cm, bbase, brow, i0, Q, tid);
    load_tile<HD>(Ys, LH, dy, xbase, xrow, i0, Q, tid);
    __syncthreads();
    float s[4][4], d[4][4];
    zero(s);
    zero(d);
    mm<4, 4, N>(s, Cs, LN, 1, Bs, LN, 1, ty, tx);
    mm<4, 4, HD>(d, Ys, LH, 1, Xs, LH, 1, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = ty + 16 * a, j = tx + 16 * m;
        const int gi = i0 + i, gj = j0 + j;
        float mv = 0.f, w = 0.f;
        if (gj <= gi && gi < Q) {   // masked before the exp
          const float L = expf(cum_s[gi] - cum_s[gj]);
          mv = s[a][m] * L;
          w = L * dt_s[gj] * d[a][m];
          cp[m] = fmaf(s[a][m], w, cp[m]);
        }
        Ms[i * LW + j] = mv;
        Ws[i * LW + j] = w;
      }
    __syncthreads();
    // Rows of u and dB are key rows j = ty + 16 a; the sums run over i.
    mm<4, CH, kT>(u, Ms, 1, LW, Ys, 1, LH, ty, tx);
    mm<4, CN, kT>(db, Ws, 1, LW, Cs, 1, LN, ty, tx);
  }
  // The state terms, with g = dh_c.
  __syncthreads();
  const float* gp = Gs + ((((size_t)b * nc + c) * nh + h) * HD) * N;
  for (int i = tid; i < HD * N; i += kThreads)
    Cs[(i / N) * LN + i % N] = gp[i];
  __syncthreads();
  float gb[4][CH], xg[4][CN];
  zero(gb);
  zero(xg);
  mm<4, CH, N>(gb, Bs, LN, 1, Cs, LN, 1, ty, tx);   // (g B_j)_p
  mm<4, CN, HD>(xg, Xs, LH, 1, Cs, 1, LN, ty, tx);  // (g^T x_j)_n
  const float cum_last = cum_s[Q - 1];
  float qp[4], dd[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = ty + 16 * a, gj = j0 + j;
    const bool valid = gj < Q;
    const float f = valid ? expf(cum_last - cum_s[gj]) : 0.f;
    const float dtj = valid ? dt_s[gj] : 0.f;
    const size_t row = ((size_t)b * T + t0 + gj) * nh + h;
    qp[a] = dd[a] = 0.f;
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      const int p = tx + 16 * m;
      const float st = f * gb[a][m], uu = u[a][m] + st;
      const float xv = Xs[j * LH + p];
      qp[a] = fmaf(xv, st, qp[a]);
      dd[a] = fmaf(xv, uu, dd[a]);
      if (valid) dx[row * HD + p] = dtj * uu;
    }
#pragma unroll
    for (int m = 0; m < CN; ++m)
      if (valid)
        dBh[row * N + tx + 16 * m] = fmaf(dtj * f, xg[a][m], db[a][m]);
  }
  float* redq = Ms;               // [kT][17] each
  float* redd = redq + kT * 17;
  float* redc = redd + kT * 17;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    redq[(ty + 16 * a) * 17 + tx] = qp[a];
    redd[(ty + 16 * a) * 17 + tx] = dd[a];
    redc[(tx + 16 * a) * 17 + ty] = cp[a];
  }
  __syncthreads();
  if (tid < kT && j0 + tid < Q) {
    float q = 0.f, ddt = 0.f, col = 0.f;
    for (int k = 0; k < 16; ++k) {
      q += redq[tid * 17 + k];
      ddt += redd[tid * 17 + k];
      col += redc[tid * 17 + k];
    }
    q *= dt_s[j0 + tid];
    const size_t o = ((size_t)b * nh + h) * T + t0 + j0 + tid;
    colp[o] = -col - q;
    qv[o] = q;
    ddtd[o] = ddt;
  }
}

// ----------------------------------------------------------------- (5) dt

// rowp holds row_parts planes [B, nh, T] of each row's sum_j P and carried
// term, then colp, qv and ddtd: one plane (the f32 path), or the bf16
// path's carried term and one partial per key tile (part p >= 1 is key
// tile p - 1, written for the rows of query tiles from p - 1 on).  <g, h_p>
// comes from the f32 states (Hp, Gs) or, when ghp is not null, as gh_parts
// per-warp partials of (2).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Hp, const float* __restrict__ Gs,
                  const float* __restrict__ ghp, int gh_parts,
                  const float* __restrict__ rowp, int row_parts,
                  float* __restrict__ ddt, float* __restrict__ dApart, int T,
                  int nh, int hn, int Q) {
  __shared__ float dt_s[kMaxChunk], cum_s[kMaxChunk], dcum_s[kMaxChunk],
      da_s[kMaxChunk], red[kThreads];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, t0 = c * Q;
  const size_t plane = (size_t)gridDim.z * nh * T;
  const float* colp = rowp + row_parts * plane;
  const float* qv = colp + plane;
  const float* ddtd = qv + plane;
  load_dt_cum(dt_s, cum_s, dt, A, b, T, t0, nh, h, Q, tid);
  const size_t ch = ((size_t)b * nc + c) * nh + h;
  float gh = 0.f;
  if (ghp != nullptr) {
    for (int k = 0; k < gh_parts; ++k) gh += ghp[ch * gh_parts + k];
  } else {
    for (int i = tid; i < hn; i += kThreads)
      gh = fmaf(Gs[ch * hn + i], Hp[ch * hn + i], gh);
    gh = block_sum(gh, red, tid);
  }
  const size_t rb = ((size_t)b * nh + h) * T + t0;
  const float qsum = block_sum(tid < Q ? qv[rb + tid] : 0.f, red, tid);
  if (tid < Q) {
    float rs = 0.f;
    for (int p = 0; p < row_parts; ++p)
      if (p == 0 || (p - 1) * kT <= tid) rs += rowp[p * plane + rb + tid];
    dcum_s[tid] = rs + colp[rb + tid];
  }
  __syncthreads();
  if (tid == 0) dcum_s[Q - 1] += expf(cum_s[Q - 1]) * gh + qsum;
  __syncthreads();
  if (tid < 32) chunk_suffix_sum(dcum_s, da_s, Q, tid);
  __syncthreads();
  float part = 0.f;
  if (tid < Q) {
    ddt[((size_t)b * T + t0 + tid) * nh + h] = ddtd[rb + tid] + A[h] * da_s[tid];
    part = dt_s[tid] * da_s[tid];
  }
  part = block_sum(part, red, tid);
  if (tid == 0) dApart[ch] = part;
}

// ------------------------------------------------------- (6) groups, (7) dA

// dBh / dCh [B, T, nhk, N]: partials over blocks of nh / nhk heads (one
// head each on the f32 path); group g sums its nhk / G blocks in order.
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_groups_kernel(const float* __restrict__ dBh,
                      const float* __restrict__ dCh, Tin* __restrict__ dB,
                      Tin* __restrict__ dC, size_t total, int nhk, int G,
                      int N) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int n = (int)(e % N);
  const size_t rest = e / N;
  const int g = (int)(rest % G);
  const size_t bt = rest / G;
  const int per = nhk / G;
  const float* src = (blockIdx.y ? dCh : dBh) + (bt * nhk + (size_t)g * per) * N + n;
  float s = 0.f;
  for (int k = 0; k < per; ++k) s += src[(size_t)k * N];
  (blockIdx.y ? dC : dB)[e] = narrow<Tin>(s);
}

__global__ void ssd_bwd_da_kernel(const float* __restrict__ dApart,
                                  float* __restrict__ dA, int B, int nc,
                                  int nh) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= nh) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) s += dApart[((size_t)b * nc + c) * nh + h];
  dA[h] = s;
}

// ------------------------------------------------------ tensor-core path

constexpr int kTcThreads = 128;   // one warpgroup: 4 warps x 16 rows
constexpr int kStages = 2;        // streamed-tile ring depth
constexpr int kPassElems = 4;     // state elements per thread of (2)
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// Four floats as bf16 hi and lo quads (8 bytes each).
__device__ __forceinline__ void split4(float4 v, uint2* hi, uint2* lo) {
  pack_split(v.x, v.y, &hi->x, &lo->x);
  pack_split(v.z, v.w, &hi->y, &lo->y);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Rows r0 .. r0 + kT - 1 (chunk-relative; zero-filled at and past Q) of
// a bf16 [rows, W] operand at src + base, row stride `stride`, into dst
// with row stride ld, by cp.async.
template <int W>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld,
                                                const bf16* src, size_t base,
                                                size_t stride, int r0, int Q,
                                                int tid) {
  for (int i = tid; i < kT * (W / 8); i += kTcThreads) {
    const int r = i / (W / 8), col = (i % (W / 8)) * 8;
    const bool ok = r0 + r < Q;
    cp_async16(dst + r * ld + col,
               ok ? src + base + (size_t)(r0 + r) * stride + col : src, ok);
  }
}

// A fragments (rows `row`, k = 16 kk + ...) of a bf16 [rows, K] operand at
// src + base with row stride `stride`, straight from device memory; rows
// with valid false are zero.
template <int K>
__device__ __forceinline__ void load_a_frags(uint32_t (&frag)[K / 16][4],
                                             const bf16* src, size_t base,
                                             size_t stride, const int* row,
                                             const bool* valid, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int a = r & 1, col = kk * 16 + 2 * (lane % 4) + (r / 2) * 8;
      frag[kk][r] = valid[a] ? ld32(src + base + (size_t)row[a] * stride
                                    + col)
                             : 0u;
    }
}

// The chunk's lc = cum log2(e) and dt (zero past Q) from the rows (1)
// wrote (lcdt: lc, then dt one plane on), loaded by the CTA into
// registers; kept apart from their store to shared memory so that the
// loads overlap the caller's next ones.
constexpr int kLcPer = kMaxChunk / kTcThreads;

__device__ __forceinline__ void lc_load(float (&lv)[kLcPer],
                                        float (&dv)[kLcPer],
                                        const float* lcdt, size_t plane,
                                        size_t row, int Q, int tid) {
#pragma unroll
  for (int k = 0; k < kLcPer; ++k) {
    const int i = tid + k * kTcThreads;
    lv[k] = i < Q ? lcdt[row + i] : 0.f;
    dv[k] = i < Q ? lcdt[plane + row + i] : 0.f;
  }
}

__device__ __forceinline__ void lc_store(const float (&lv)[kLcPer],
                                         const float (&dv)[kLcPer],
                                         float* lc_s, float* dt_s, int tid) {
#pragma unroll
  for (int k = 0; k < kLcPer; ++k) {
    lc_s[tid + k * kTcThreads] = lv[k];
    dt_s[tid + k * kTcThreads] = dv[k];
  }
}

// ---------------------------------------------------------------- wgmma

// The bf16 products run on wgmma: one warpgroup (the CTA's four warps)
// issues each product over all 64 rows of its tile, so every operand is
// read from shared memory once per CTA, where mma.sync has each warp read
// all of it (an mma.sync key-side pass was bound by those reads: PERF.md).
// Tiles lie in shared memory as 64-row x 64-column blocks of 128-byte rows
// in the 128-byte swizzle that wgmma's descriptors name: the 16-byte chunk
// c of row r sits at chunk c ^ (r % 8) of its row; blocks start on
// 1024-byte boundaries.
constexpr int kBlock = kT * 128;   // bytes of a 64-row x 64-column block

template <int W>
__host__ __device__ constexpr int sw_bytes() {   // a 64-row tile, W wide
  return (W + 63) / 64 * kBlock;
}

// cp.async of rows r0 .. r0 + 63 (zero at and past Q) of a bf16 [rows, W]
// operand at src + base, row stride `stride`, into the swizzled tile at
// shared address dst.
template <int W>
__device__ __forceinline__ void load_sw128(uint32_t dst, const bf16* src,
                                           size_t base, size_t stride,
                                           int r0, int Q, int tid) {
  for (int i = tid; i < kT * (W / 8); i += kTcThreads) {
    const int r = i / (W / 8), c = i % (W / 8);
    const bool ok = r0 + r < Q;
    const uint32_t d = dst + (c / 8) * kBlock + r * 128
                       + (((c % 8) ^ (r % 8)) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d),
                    "l"(ok ? src + base + (size_t)(r0 + r) * stride + c * 8
                           : src),
                    "r"(ok ? 16 : 0));
  }
}

// Descriptor of a 128-byte-swizzled operand at shared address addr.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// K-major operand (tile rows are M or N, columns the contraction), k-step
// kk: columns 16 kk .. 16 kk + 15.  8-row groups are 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * kBlock + (kk % 4) * 32, 16, 1024);
}

// MN-major B operand (tile rows are the contraction, columns N), k-step
// kk: rows 16 kk .. 16 kk + 15.  64-column blocks are kBlock apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2048, kBlock, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins registers that a wgmma writes asynchronously: reads after a
// wgmma_wait() stay after it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d[64 x N] += A B: A and B in shared memory (descriptors; A K-major, B
// K-major when TB is 0, MN-major when 1).  The accumulator layout of a
// wgmma m64nN (f32): warp w holds rows 16 w + lane / 4 (e = 0, 1) and
// 16 w + lane / 4 + 8 (e = 2, 3) at columns 8 n + 2 (lane % 4) + (e & 1)
// in d[4 n + e], mma.sync's C layout per warp.
template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da,
                                         uint64_t db);

// d[64 x N] += A B with A in registers: at k-step kk the A fragment is
// the accumulator layout over columns 16 kk .. 16 kk + 15 as bf16 pairs
// (mma.sync's A layout per warp).
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32, 0>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16, 0>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16, 1>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64, 0>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64, 1>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16, 1>(float* d,
                                                 const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 0>(float* d,
                                                 const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 1>(float* d,
                                                 const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128, 1>(float* d,
                                                 const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit, subnormal results flushed to zero.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// k-step kk of an m64nN accumulator d as hi + lo A fragments.
__device__ __forceinline__ void acc_split(const float* d, int kk,
                                          uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    pack_split(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1], &hi[r], &lo[r]);
}

// ---------------------------------------------------- (1) states, bf16

// Bytes of a ring stage of (1): a 64-row tile's B or C [64 x N]
// (swizzled, the wgmma B operand), then x, or (e dy)'s hi and lo, [kT][HD
// + 8] each (padded rows: ldmatrix.trans reads them).
template <int HD, int N>
__host__ __device__ constexpr int states_stage() {
  return sw_bytes<N>() + 2 * kT * (HD + 8) * (int)sizeof(bf16);
}

template <int HD, int N>
constexpr size_t states_tc_smem() {
  return 3 * kMaxChunk * sizeof(float) + 1024
         + (size_t)kStages * states_stage<HD, N>();
}

// Warp w of the warpgroup owns state rows (head-dim columns p) 16 w ..
// 16 w + 15 (at hd 16 warps 1-3 feed zeros); the product runs over the
// chunk's rows in 64-row tiles through a two-stage ring (the next tile's
// loads in flight while the CTA computes one), on wgmma with A in
// registers.  S (blockIdx.x even): A = (w x)^T from the x tile through
// ldmatrix.trans, scaled and split in registers, B = B_j.  E (odd): dy is
// read as f32 into registers a tile ahead, written to dys as a hi + lo
// pair, and e dy split into two bf16 tiles that ldmatrix.trans reads as A;
// B = C_i.
template <int HD, int N>
__global__ void __launch_bounds__(kTcThreads, 3)
ssd_bwd_states_tc_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm,
                         const float* __restrict__ dy, float* __restrict__ S,
                         float* __restrict__ E, float* __restrict__ cumL,
                         bf16* __restrict__ dys, long long dy_plane,
                         float* __restrict__ lcdt, int T, int nh, int G,
                         int Q) {
  static_assert(HD <= 64, "four warps of 16 state rows");
  static_assert(states_stage<HD, N>() % 1024 == 0, "stages stay aligned");
  constexpr int SA = HD + 8;
  constexpr int STAGE = states_stage<HD, N>();
  constexpr int kPer = kT * (HD / 4) / kTcThreads;   // dy float4s a thread
  static_assert(kT * (HD / 4) % kTcThreads == 0, "even split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dt_s = reinterpret_cast<float*>(smem_raw);
  float* cum_s = dt_s + kMaxChunk;
  float* w_s = cum_s + kMaxChunk;
  unsigned char* ring = reinterpret_cast<unsigned char*>(w_s + kMaxChunk);
  ring += (1024 - (smem_addr(ring) & 1023)) & 1023;
  const bool is_e = blockIdx.x & 1;
  const int h = (blockIdx.x >> 1) % nh, c = (blockIdx.x >> 1) / nh;
  const int b = blockIdx.y, nc = T / Q, t0 = c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = h / (nh / G);
  const size_t bc_stride = (size_t)G * N, x_stride = (size_t)nh * HD;
  const size_t bc_base = ((size_t)b * T + t0) * bc_stride + (size_t)grp * N;
  const size_t x_base = ((size_t)b * T + t0) * x_stride + (size_t)h * HD;
  const int n_tiles = (Q + kT - 1) / kT;
  const bool active = warp * 16 < HD;
  const int pw = active ? warp * 16 : 0;   // a valid column for the others

  auto load_tile = [&](int t) {        // cp.async part of tile t
    unsigned char* st = ring + (t % kStages) * STAGE;
    load_sw128<N>(smem_addr(st), is_e ? Cm : Bm, bc_base, bc_stride, t * kT,
                  Q, tid);
    if (!is_e)
      load_rows_async<HD>(reinterpret_cast<bf16*>(st + sw_bytes<N>()), SA, x,
                          x_base, x_stride, t * kT, Q, tid);
  };
  float4 v[kPer];                      // E: dy of the next tile
  auto load_dy = [&](int t) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + k * kTcThreads;
      const int r = t * kT + i / (HD / 4), col = (i % (HD / 4)) * 4;
      v[k] = r < Q ? *reinterpret_cast<const float4*>(
                         dy + x_base + (size_t)r * x_stride + col)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load_tile(0);
  cp_async_commit();
  if (is_e) load_dy(0);

  for (int i = tid; i < Q; i += kTcThreads)
    dt_s[i] = dt[((size_t)b * T + t0 + i) * nh + h];
  __syncthreads();
  if (warp == 0) chunk_cumsum(dt_s, cum_s, Q, A[h], lane);
  __syncthreads();
  for (int i = tid; i < n_tiles * kT; i += kTcThreads)
    w_s[i] = i >= Q ? 0.f
             : is_e ? expf(cum_s[i])
                    : dt_s[i] * expf(cum_s[Q - 1] - cum_s[i]);
  if (!is_e) {
    if (tid == 0) cumL[((size_t)b * nc + c) * nh + h] = cum_s[Q - 1];
    const size_t row = ((size_t)b * nh + h) * T + t0;
    const size_t plane = (size_t)gridDim.y * nh * T;
    for (int i = tid; i < Q; i += kTcThreads) {
      lcdt[row + i] = cum_s[i] * kLog2e;
      lcdt[plane + row + i] = dt_s[i];
    }
  }
  __syncthreads();                     // w_s is visible

  float acc[N / 2];                    // [64 x N]: rows p, columns n
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    unsigned char* st = ring + (t % kStages) * STAGE;
    bf16* as = reinterpret_cast<bf16*>(st + sw_bytes<N>());   // x, (e dy)_hi
    bf16* al_s = as + kT * SA;                                // (e dy)_lo
    if (is_e) {   // tile t's dy: its pair to dys, e dy's pair to the stage
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * kTcThreads;
        const int r = i / (HD / 4), col = (i % (HD / 4)) * 4;
        uint2 hi, lo;
        if (t * kT + r < Q) {
          const size_t off = x_base + (size_t)(t * kT + r) * x_stride + col;
          split4(v[k], &hi, &lo);
          *reinterpret_cast<uint2*>(dys + off) = hi;
          *reinterpret_cast<uint2*>(dys + dy_plane + off) = lo;
        }
        const float e = w_s[t * kT + r];   // zero past Q
        split4(make_float4(v[k].x * e, v[k].y * e, v[k].z * e, v[k].w * e),
               &hi, &lo);
        *reinterpret_cast<uint2*>(as + r * SA + col) = hi;
        *reinterpret_cast<uint2*>(al_s + r * SA + col) = lo;
      }
    }
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      if (is_e) load_dy(t + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();                // tile t has landed
    __syncthreads();
    // A = (w x)^T or (e dy)^T of the warp's 16 state rows, k steps over the
    // tile's 64 rows, split before the products are issued; selects, not
    // branches (an A operand written on a divergent path makes ptxas
    // serialize the wgmmas).
    uint32_t a[kT / 16][4], al[kT / 16][4];
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const int ao = (kk * 16 + lane % 8 + (lane / 16) * 8) * SA + pw
                     + ((lane / 8) & 1) * 8;
      // xr[r] holds x (or (e dy)_hi) at rows j = 64 t + 16 kk + 2 (lane %
      // 4) + {0, 1} (r = 0, 1) and + 8 + {0, 1} (r = 2, 3).
      uint32_t xr[4], yl[4];
      ldsm_x4_trans(xr, as + ao);
      ldsm_x4_trans(yl, al_s + ao);
      const float* w = w_s + t * kT + kk * 16 + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = unpack(xr[r]);
        const int o = (r / 2) * 8;
        uint32_t hi, lo;
        pack_split(f.x * w[o], f.y * w[o + 1], &hi, &lo);
        a[kk][r] = !active ? 0u : is_e ? xr[r] : hi;
        al[kk][r] = !active ? 0u : is_e ? yl[r] : lo;
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      wgmma_rs<N, 1>(acc, a[kk], desc_mn(smem_addr(st), kk));
      wgmma_rs<N, 1>(acc, al[kk], desc_mn(smem_addr(st), kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<N / 2>(acc);
    __syncthreads();                   // stage t % kStages is consumed
  }
  if (!active) return;
  float* out = (is_e ? E : S) + (((size_t)b * nc + c) * nh + h) * HD * N;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int p = warp * 16 + lane / 4 + 8 * a;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      *reinterpret_cast<float2*>(out + (size_t)p * N + n * 8
                                 + 2 * (lane % 4)) =
          make_float2(acc[4 * n + 2 * a], acc[4 * n + 2 * a + 1]);
  }
}

// ------------------------------------------------------ (2) pass, bf16

// kPassElems state elements of one (head, row) per thread.  The reverse
// pass writes g = dh_c of each chunk (planes 2, 3 of hpg: hi, lo) and
// dh0; the forward pass writes h_p (planes 0, 1) and, per warp, its part
// of <g, h_p> (g read back as hi + lo) to ghp: gh_parts = 8 per CTA.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass_tc_kernel(const float* __restrict__ S,
                       const float* __restrict__ E,
                       const float* __restrict__ cumL,
                       const float* __restrict__ h0,
                       const float* __restrict__ dh, float* __restrict__ dh0,
                       bf16* __restrict__ hpg, long long plane,
                       float* __restrict__ ghp, int nh, int hn, int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int e0 = (blockIdx.x * kThreads + tid) * kPassElems;
  const bool valid = e0 < hn;
  const int gh_parts = gridDim.x * (kThreads / 32);
  const size_t sh = ((size_t)b * nh + h) * hn + e0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 gv = valid && dh != nullptr
                  ? *reinterpret_cast<const float4*>(dh + sh) : zero;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t ch = ((size_t)b * nc + c) * nh + h;
    const float el = expf(cumL[ch]);
    if (valid) {
      const size_t i = ch * hn + e0;
      uint2 hi, lo;
      split4(gv, &hi, &lo);
      *reinterpret_cast<uint2*>(hpg + 2 * plane + i) = hi;
      *reinterpret_cast<uint2*>(hpg + 3 * plane + i) = lo;
      const float4 ev = *reinterpret_cast<const float4*>(E + i);
      gv = make_float4(fmaf(el, gv.x, ev.x), fmaf(el, gv.y, ev.y),
                       fmaf(el, gv.z, ev.z), fmaf(el, gv.w, ev.w));
    }
  }
  if (valid && dh0 != nullptr) *reinterpret_cast<float4*>(dh0 + sh) = gv;
  float4 hv = valid && h0 != nullptr
                  ? *reinterpret_cast<const float4*>(h0 + sh) : zero;
  for (int c = 0; c < nc; ++c) {
    const size_t ch = ((size_t)b * nc + c) * nh + h;
    const float el = expf(cumL[ch]);
    float part = 0.f;
    if (valid) {
      const size_t i = ch * hn + e0;
      uint2 hi, lo;
      split4(hv, &hi, &lo);
      *reinterpret_cast<uint2*>(hpg + i) = hi;
      *reinterpret_cast<uint2*>(hpg + plane + i) = lo;
      const uint2 gh = *reinterpret_cast<const uint2*>(hpg + 2 * plane + i);
      const uint2 gl = *reinterpret_cast<const uint2*>(hpg + 3 * plane + i);
      const float2 g01h = unpack(gh.x), g23h = unpack(gh.y);
      const float2 g01l = unpack(gl.x), g23l = unpack(gl.y);
      part = (g01h.x + g01l.x) * hv.x + (g01h.y + g01l.y) * hv.y
             + (g23h.x + g23l.x) * hv.z + (g23h.y + g23l.y) * hv.w;
      const float4 sv = *reinterpret_cast<const float4*>(S + i);
      hv = make_float4(fmaf(el, hv.x, sv.x), fmaf(el, hv.y, sv.y),
                       fmaf(el, hv.z, sv.z), fmaf(el, hv.w, sv.w));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0)
      ghp[ch * gh_parts + blockIdx.x * (kThreads / 32) + warp] = part;
  }
}

// ---------------------------------------------------- (3) rows, bf16

// Bytes of a ring stage of (3): a key tile's B [64 x N] and x
// [64 x HD], or h_p's hi and lo [HD x N] (the stage the last key tile
// leaves free), swizzled as in (4).
template <int HD, int N>
__host__ __device__ constexpr int rows_wg_stage() {
  return sw_bytes<N>() + sw_bytes<HD>() > 2 * sw_bytes<N>()
             ? sw_bytes<N>() + sw_bytes<HD>() : 2 * sw_bytes<N>();
}

template <int HD, int N>
constexpr size_t rows_wg_smem() {
  return 2 * kMaxChunk * sizeof(float) + 1024
         + kStages * rows_wg_stage<HD, N>();
}

// The query-side pass on wgmma: the warpgroup's dy_i (hi, lo) are
// register A operands of D = dy x^T and of the carried term; W is one of
// dC += W B.
template <int HD, int N>
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_bwd_rows_wg_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ lcdt,
                       const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm,
                       const bf16* __restrict__ dys, long long dy_plane,
                       const bf16* __restrict__ hpg, long long st_plane,
                       float* __restrict__ dCh, float* __restrict__ rowc,
                       int T, int nh, int G, int Q, int heads) {
  constexpr int KH = HD / 16;
  constexpr int NB = N < 64 ? N : 64;    // columns of a carried product
  constexpr int STAGE = rows_wg_stage<HD, N>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dt_s = reinterpret_cast<float*>(smem_raw);
  float* lc_s = dt_s + kMaxChunk;
  const uint32_t raw = smem_addr(lc_s + kMaxChunk);
  const uint32_t ring = raw + ((1024 - (raw & 1023)) & 1023);
  const int nhk = nh / heads, nc = T / Q;
  const int hb = blockIdx.x % nhk, c = blockIdx.x / nhk, b = blockIdx.y;
  const int I = gridDim.z - 1 - blockIdx.z;    // heaviest tiles first
  const int i0 = I * kT, rows = min(kT, Q - i0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = hb * heads / (nh / G), t0 = c * Q;
  const size_t bc_stride = (size_t)G * N, x_stride = (size_t)nh * HD;
  const size_t bc_base = ((size_t)b * T + t0) * bc_stride + (size_t)grp * N;
  const size_t plane = (size_t)gridDim.y * nh * T;
  const bool wactive = warp * 16 < rows;
  int row[2];
  bool rvalid[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    row[a] = i0 + warp * 16 + lane / 4 + 8 * a;   // chunk-relative
    rvalid[a] = row[a] < Q;
  }
  float dc[N / 2];                 // dC_i [64 x N], summed over the heads
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dc[i] = 0.f;
  // A head's loads (key tiles 0 .. I, then h_p) take ring stages in turn,
  // and the next head's tile 0 goes out during this head's carried term.
  auto load_tile = [&](int t, int stage, int h) {
    const uint32_t bs = ring + stage * STAGE;
    const size_t xb = ((size_t)b * T + t0) * x_stride + (size_t)h * HD;
    load_sw128<N>(bs, Bm, bc_base, bc_stride, t * kT, Q, tid);
    load_sw128<HD>(bs + sw_bytes<N>(), x, xb, x_stride, t * kT, Q, tid);
  };
  load_tile(0, 0, hb * heads);
  cp_async_commit();

  for (int hh = 0; hh < heads; ++hh) {
    const int h = hb * heads + hh;
    const int base = hh * (I + 2);   // loads of the heads before
    const size_t x_base = ((size_t)b * T + t0) * x_stride + (size_t)h * HD;
    const size_t st = (((size_t)b * nc + c) * nh + h) * HD * N;
    const uint32_t hp_hi = ring + ((base + I + 1) % kStages) * STAGE;
    const uint32_t hp_lo = hp_hi + sw_bytes<N>();
    float lv[kLcPer], dv[kLcPer];
    lc_load(lv, dv, lcdt, plane, ((size_t)b * nh + h) * T + t0, Q, tid);
    uint32_t ah[KH][4], al[KH][4];   // dy_i's hi and lo, k = p
    load_a_frags<HD>(ah, dys, x_base, x_stride, row, rvalid, lane);
    load_a_frags<HD>(al, dys + dy_plane, x_base, x_stride, row, rvalid,
                     lane);
    lc_store(lv, dv, lc_s, dt_s, tid);
    __syncthreads();
    float lci[2];                    // lc of the row; -inf past the chunk
#pragma unroll
    for (int a = 0; a < 2; ++a) lci[a] = rvalid[a] ? lc_s[row[a]] : -INFINITY;

    for (int t = 0; t <= I; ++t) {
      if (t < I) {
        load_tile(t + 1, (base + t + 1) % kStages, h);
      } else {                       // h_p into the stage left free
        load_sw128<N>(hp_hi, hpg, st, N, 0, HD, tid);
        load_sw128<N>(hp_lo, hpg + st_plane, st, N, 0, HD, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();            // tile t has landed
      __syncthreads();
      const uint32_t bs = ring + ((base + t) % kStages) * STAGE;
      const uint32_t xs = bs + sw_bytes<N>();
      // D = (dy_hi + dy_lo) x^T: 64 rows x 64 keys.
      const bool below = t < I;      // every key below every row
      float d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        wgmma_rs<64, 0>(d, ah[kk], desc_k(xs, kk));
        wgmma_rs<64, 0>(d, al[kk], desc_k(xs, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(d);
      // W = exp2(lc_i - lc_j) dt_j D for j <= i, masked before the exp
      // (a row past the chunk has lc = -inf: weight 0).
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = t * kT + n * 8 + 2 * (lane % 4) + e;
          const float lcj = lc_s[j], dtj = dt_s[j];
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const bool ok = below || j <= row[a];
            const float seg = ok ? lci[a] - lcj : -INFINITY;
            d[4 * n + 2 * a + e] *= fast_exp2(seg) * dtj;
          }
        }
      uint32_t wh[4][4], wl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_split(d, kk, wh[kk], wl[kk]);
      // dC += (W_hi + W_lo) B, B read MN-major (rows: the tile's keys).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<N, 1>(dc, wh[kk], desc_mn(bs, kk));
        wgmma_rs<N, 1>(dc, wl[kk], desc_mn(bs, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<N / 2>(dc);
      __syncthreads();               // stage (base + t) % 2 is consumed
    }
    cp_async_wait<0>();              // h_p has landed
    __syncthreads();
    if (hh + 1 < heads) {            // into the stage of key tile I
      load_tile(0, (base + I) % kStages, h + 1);
      cp_async_commit();
    }

    // The carried term dC_off = e^{cum_i} dy_i h_p (both as hi + lo), NB
    // columns at a time, and each row's C_i . dC_off.
    float rc[2] = {0.f, 0.f}, ei[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) ei[a] = exp2f(lci[a]);
#pragma unroll
    for (int blk = 0; blk < N / NB; ++blk) {
      float off[NB / 2];
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) off[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        wgmma_rs<NB, 1>(off, ah[kk], desc_mn(hp_hi + blk * kBlock, kk));
        wgmma_rs<NB, 1>(off, al[kk], desc_mn(hp_hi + blk * kBlock, kk));
        wgmma_rs<NB, 1>(off, ah[kk], desc_mn(hp_lo + blk * kBlock, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NB / 2>(off);
#pragma unroll
      for (int n = 0; n < NB / 8; ++n) {
        const int col = blk * NB + n * 8 + 2 * (lane % 4);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float v0 = ei[a] * off[4 * n + 2 * a];
          const float v1 = ei[a] * off[4 * n + 2 * a + 1];
          if (rvalid[a]) {
            const float2 cv = unpack(ld32(Cm + bc_base
                                          + (size_t)row[a] * bc_stride + col));
            rc[a] = fmaf(cv.y, v1, fmaf(cv.x, v0, rc[a]));
          }
          dc[4 * (blk * (NB / 8) + n) + 2 * a] += v0;
          dc[4 * (blk * (NB / 8) + n) + 2 * a + 1] += v1;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      rc[a] += __shfl_xor_sync(0xffffffffu, rc[a], 1);
      rc[a] += __shfl_xor_sync(0xffffffffu, rc[a], 2);
      if (rvalid[a] && lane % 4 == 0)
        rowc[((size_t)b * nh + h) * T + t0 + row[a]] = rc[a];
    }
    __syncthreads();   // the ring, dt_s and lc_s are free for the next head
  }
  if (!wactive) return;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!rvalid[a]) continue;
    float* out = dCh + (((size_t)b * T + t0 + row[a]) * nhk + hb) * N;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      *reinterpret_cast<float2*>(out + n * 8 + 2 * (lane % 4)) =
          make_float2(dc[4 * n + 2 * a], dc[4 * n + 2 * a + 1]);
  }
}

// ---------------------------------------------------- (4) cols, bf16

// Bytes of (4) past its 3 KB of f32 (dt, lc, the column sums):
// B_j [64 x N], x_j [64 x HD] for two heads in turn, and a ring of two
// stages of C [64 x N], dy_hi and dy_lo [64 x HD] (g's hi and lo, each
// [HD x N], in the stage the last query tile leaves free), plus the slack
// that aligns them to 1024 bytes.
template <int HD, int N>
__host__ __device__ constexpr int cols_wg_stage() {
  return sw_bytes<N>() + 2 * sw_bytes<HD>();
}

template <int HD, int N>
constexpr size_t cols_wg_smem() {
  return (2 * kMaxChunk + 4 * kT) * sizeof(float) + 1024 + sw_bytes<N>()
         + 2 * sw_bytes<HD>() + kStages * cols_wg_stage<HD, N>();
}

template <int HD, int N>
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_bwd_cols_wg_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ lcdt,
                       const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm,
                       const bf16* __restrict__ dys, long long dy_plane,
                       const bf16* __restrict__ hpg, long long st_plane,
                       bf16* __restrict__ dx, float* __restrict__ dBh,
                       float* __restrict__ rowpart, float* __restrict__ colp,
                       float* __restrict__ qv, float* __restrict__ ddtd,
                       int T, int nh, int G, int Q, int heads) {
  static_assert(2 * sw_bytes<N>() <= cols_wg_stage<HD, N>(),
                "g's hi and lo fit in a stage");
  constexpr int KH = HD / 16, KN = N / 16;
  constexpr int NB = N < 64 ? N : 64;      // columns of a g^T x product
  constexpr int STAGE = cols_wg_stage<HD, N>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dt_s = reinterpret_cast<float*>(smem_raw);
  float* lc_s = dt_s + kMaxChunk;
  float* red = lc_s + kMaxChunk;           // [4][kT]
  const uint32_t raw = smem_addr(red + 4 * kT);
  const uint32_t bj_s = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t xj_s = bj_s + sw_bytes<N>();           // [2] heads in turn
  const uint32_t ring = xj_s + 2 * sw_bytes<HD>();
  const int nhk = nh / heads, nc = T / Q, nt = (Q + kT - 1) / kT;
  const int hb = blockIdx.x % nhk, c = blockIdx.x / nhk, b = blockIdx.y;
  const int J = blockIdx.z;                // key tile 0 walks the most
  const int j0 = J * kT, rows = min(kT, Q - j0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = hb * heads / (nh / G), t0 = c * Q;
  const size_t bc_stride = (size_t)G * N, x_stride = (size_t)nh * HD;
  const size_t bc_base = ((size_t)b * T + t0) * bc_stride + (size_t)grp * N;
  const size_t plane = (size_t)gridDim.y * nh * T;
  const int wrow = j0 + warp * 16;
  const bool wactive = warp * 16 < rows;
  int row[2];
  bool rvalid[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    row[a] = wrow + lane / 4 + 8 * a;
    rvalid[a] = row[a] < Q;
  }
  float db[N / 2];                         // dB_j [64 x N], the group's
#pragma unroll
  for (int i = 0; i < N / 2; ++i) db[i] = 0.f;
  // A head's loads (query tiles J .. nt - 1 with its x_j, then g) take
  // ring stages in turn; the next head's first tile and x_j go out during
  // this head's state terms.
  auto load_tile = [&](int I, int stage, int h) {
    const uint32_t cs = ring + stage * STAGE;
    const size_t xb = ((size_t)b * T + t0) * x_stride + (size_t)h * HD;
    load_sw128<N>(cs, Cm, bc_base, bc_stride, I * kT, Q, tid);
    load_sw128<HD>(cs + sw_bytes<N>(), dys, xb, x_stride, I * kT, Q, tid);
    load_sw128<HD>(cs + sw_bytes<N>() + sw_bytes<HD>(), dys + dy_plane, xb,
                   x_stride, I * kT, Q, tid);
  };
  auto load_xj = [&](int hh) {
    const int h = hb * heads + hh;
    load_sw128<HD>(xj_s + (hh % 2) * sw_bytes<HD>(), x,
                   ((size_t)b * T + t0) * x_stride + (size_t)h * HD,
                   x_stride, j0, Q, tid);
  };
  load_sw128<N>(bj_s, Bm, bc_base, bc_stride, j0, Q, tid);
  load_xj(0);
  load_tile(J, 0, hb * heads);
  cp_async_commit();

  for (int hh = 0; hh < heads; ++hh) {
    const int h = hb * heads + hh;
    const int base = hh * (nt - J + 1);   // loads of the heads before
    const size_t x_base = ((size_t)b * T + t0) * x_stride + (size_t)h * HD;
    const size_t st = (((size_t)b * nc + c) * nh + h) * HD * N;
    const uint32_t xj = xj_s + (hh % 2) * sw_bytes<HD>();
    const uint32_t g_hi = ring + ((base + nt - J) % kStages) * STAGE;
    const uint32_t g_lo = g_hi + sw_bytes<N>();
    float lv[kLcPer], dv[kLcPer];
    lc_load(lv, dv, lcdt, plane, ((size_t)b * nh + h) * T + t0, Q, tid);
    lc_store(lv, dv, lc_s, dt_s, tid);
    __syncthreads();
    float lcj[2], dtj[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      lcj[a] = lc_s[row[a]];               // zero past the chunk
      dtj[a] = dt_s[row[a]];
    }
    float u[HD / 2];                       // u_j [64 x HD]
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) u[i] = 0.f;
    float cp[2] = {0.f, 0.f};              // sum_i P of the rows

    for (int I = J; I < nt; ++I) {
      const int it = I - J;
      if (I + 1 < nt) {
        load_tile(I + 1, (base + it + 1) % kStages, h);
      } else {                             // g into the stage left free
        load_sw128<N>(g_hi, hpg + 2 * st_plane, st, N, 0, HD, tid);
        load_sw128<N>(g_lo, hpg + 3 * st_plane, st, N, 0, HD, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();                  // tile I (and B_j, x_j) landed
      __syncthreads();
      const uint32_t cs = ring + ((base + it) % kStages) * STAGE;
      const uint32_t yh = cs + sw_bytes<N>(), yl = yh + sw_bytes<HD>();
      // In two parts of 32 queries (one product group of the whole tile
      // is slower: its A operands make ptxas serialize the wgmmas).  s^T =
      // B C^T and D^T = x (dy_hi + dy_lo)^T, 64 keys x 32 queries (queries
      // past Q are zero rows, masked below).
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int q0 = I * kT + kh * 32;     // the part's first query
        const bool full = q0 >= j0 + kT - 1 && q0 + 32 <= Q;
        float sT[16], dT[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) sT[i] = dT[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KN; ++kk)
          wgmma_ss<32, 0>(sT, desc_k(bj_s, kk), desc_k(cs + kh * 4096, kk));
#pragma unroll
        for (int kk = 0; kk < KH; ++kk) {
          wgmma_ss<32, 0>(dT, desc_k(xj, kk), desc_k(yh + kh * 4096, kk));
          wgmma_ss<32, 0>(dT, desc_k(xj, kk), desc_k(yl + kh * 4096, kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<16>(sT);
        fence_regs<16>(dT);
        // M^T = s^T L, W^T = L dt_j D^T, P = s W for i >= j (masked before
        // the exp); each key's sum_i P and each query's sum over the warp.
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = q0 + n * 8 + 2 * (lane % 4) + e;
            const float lci = lc_s[i];
            float col = 0.f;
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              const bool ok = full || (i < Q && i >= row[a]);
              const float L = fast_exp2(ok ? lci - lcj[a] : -INFINITY);
              const float s = sT[4 * n + 2 * a + e];
              const float w = L * dtj[a] * dT[4 * n + 2 * a + e];
              const float p = s * w;
              cp[a] += p;
              col += p;
              sT[4 * n + 2 * a + e] = s * L;
              dT[4 * n + 2 * a + e] = w;
            }
            col += __shfl_xor_sync(0xffffffffu, col, 4);
            col += __shfl_xor_sync(0xffffffffu, col, 8);
            col += __shfl_xor_sync(0xffffffffu, col, 16);
            if (lane < 4) red[warp * kT + kh * 32 + n * 8 + 2 * lane + e] = col;
          }
        // u += M^T dy (hi + lo of both, lo x lo dropped); dB += W^T C;
        // dy and C read MN-major (rows: the part's queries).  Every A
        // operand is split before the products are issued.
        uint32_t mh[2][4], ml[2][4], wh[2][4], wl[2][4];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          acc_split(sT, k, mh[k], ml[k]);
          acc_split(dT, k, wh[k], wl[k]);
        }
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int kk = 2 * kh + k;
          wgmma_rs<HD, 1>(u, mh[k], desc_mn(yh, kk));
          wgmma_rs<HD, 1>(u, ml[k], desc_mn(yh, kk));
          wgmma_rs<HD, 1>(u, mh[k], desc_mn(yl, kk));
          wgmma_rs<N, 1>(db, wh[k], desc_mn(cs, kk));
          wgmma_rs<N, 1>(db, wl[k], desc_mn(cs, kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<HD / 2>(u);
        fence_regs<N / 2>(db);
      }
      __syncthreads();     // stage consumed; the warps' column sums are in
      if (tid < kT && I * kT + tid < Q)
        rowpart[(size_t)J * plane + ((size_t)b * nh + h) * T + t0 + I * kT
                + tid] = red[tid] + red[kT + tid] + red[2 * kT + tid]
                         + red[3 * kT + tid];
    }
    cp_async_wait<0>();                    // g has landed
    __syncthreads();
    if (hh + 1 < heads) {                  // into the stage of tile nt - 1
      load_xj(hh + 1);
      load_tile(J, (base + nt - J - 1) % kStages, h + 1);
      cp_async_commit();
    }

    // The state terms, with g = dh_c as hi + lo: u += f_j (g B_j), then
    // dx = dt_j u, q and x . u; dB += dt_j f_j (g^T x_j), NB columns at a
    // time.
    const float lcL = lc_s[Q - 1];
    float f[2], qp[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 2; ++a) f[a] = rvalid[a] ? exp2f(lcL - lcj[a]) : 0.f;
    {
      float gb[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) gb[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        wgmma_ss<HD, 0>(gb, desc_k(bj_s, kk), desc_k(g_hi, kk));
        wgmma_ss<HD, 0>(gb, desc_k(bj_s, kk), desc_k(g_lo, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<HD / 2>(gb);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          // x at (row[a], 8 n + 2 (lane % 4) + {0, 1}), unswizzled.
          const int r = warp * 16 + lane / 4 + 8 * a;
          const uint32_t xa = xj + r * 128 + ((n ^ (r % 8)) << 4)
                              + 4 * (lane % 4);
          uint32_t xw;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(xw) : "r"(xa));
          const float2 xv = unpack(xw);
          const float st0 = f[a] * gb[4 * n + 2 * a];
          const float st1 = f[a] * gb[4 * n + 2 * a + 1];
          const float u0 = u[4 * n + 2 * a] + st0;
          const float u1 = u[4 * n + 2 * a + 1] + st1;
          qp[a] = fmaf(xv.y, st1, fmaf(xv.x, st0, qp[a]));
          dd[a] = fmaf(xv.y, u1, fmaf(xv.x, u0, dd[a]));
          if (rvalid[a])
            *reinterpret_cast<__nv_bfloat162*>(
                dx + x_base + (size_t)row[a] * x_stride + n * 8
                + 2 * (lane % 4)) =
                __floats2bfloat162_rn(dtj[a] * u0, dtj[a] * u1);
        }
    }
#pragma unroll
    for (int blk = 0; blk < N / NB; ++blk) {
      float xg[NB / 2];
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) xg[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        wgmma_ss<NB, 1>(xg, desc_k(xj, kk), desc_mn(g_hi + blk * kBlock, kk));
        wgmma_ss<NB, 1>(xg, desc_k(xj, kk), desc_mn(g_lo + blk * kBlock, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NB / 2>(xg);
#pragma unroll
      for (int n = 0; n < NB / 8; ++n)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float sc = dtj[a] * f[a];
          float* d = db + 4 * (blk * (NB / 8) + n) + 2 * a;
          d[0] = fmaf(sc, xg[4 * n + 2 * a], d[0]);
          d[1] = fmaf(sc, xg[4 * n + 2 * a + 1], d[1]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        qp[a] += __shfl_xor_sync(0xffffffffu, qp[a], off);
        dd[a] += __shfl_xor_sync(0xffffffffu, dd[a], off);
        cp[a] += __shfl_xor_sync(0xffffffffu, cp[a], off);
      }
      if (rvalid[a] && lane % 4 == 0) {
        const size_t o = ((size_t)b * nh + h) * T + t0 + row[a];
        const float q = qp[a] * dtj[a];
        colp[o] = -cp[a] - q;
        qv[o] = q;
        ddtd[o] = dd[a];
      }
    }
    __syncthreads();   // the ring, dt_s and lc_s are free for the next head
  }
  if (!wactive) return;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!rvalid[a]) continue;
    float* out = dBh + (((size_t)b * T + t0 + row[a]) * nhk + hb) * N;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      *reinterpret_cast<float2*>(out + n * 8 + 2 * (lane % 4)) =
          make_float2(db[4 * n + 2 * a], db[4 * n + 2 * a + 1]);
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *x, *Bm, *Cm;
  const float *dt, *A, *h0, *dy, *dh;
  void *dx, *dB, *dC;
  float *ddt, *dA, *dh0;
  float *S, *E, *cumL, *dBh, *dCh, *rows, *dApart;
  bf16 *dys, *hpg;
  float* ghp;
  int B, T, nh, G, Q, heads;
  cudaStream_t stream;
};

// The last two launches of either path: dB / dC per group from the
// [B, T, nh / heads, N] partials, and dA.
template <typename Tin>
cudaError_t launch_groups_da(const Args& a, int N, int nc) {
  const size_t grouped = (size_t)a.B * a.T * a.G * N;
  ssd_bwd_groups_kernel<Tin><<<dim3((unsigned)((grouped + kThreads - 1)
                                               / kThreads), 2),
                               kThreads, 0, a.stream>>>(
      a.dBh, a.dCh, static_cast<Tin*>(a.dB), static_cast<Tin*>(a.dC),
      grouped, a.nh / a.heads, a.G, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_da_kernel<<<(a.nh + 127) / 128, 128, 0, a.stream>>>(
      a.dApart, a.dA, a.B, nc, a.nh);
  return cudaGetLastError();
}

template <int HD, int N>
cudaError_t launch_f32(const Args& a) {
  const int nc = a.T / a.Q, nt = (a.Q + kT - 1) / kT;
  const float* x = static_cast<const float*>(a.x);
  const float* Bm = static_cast<const float*>(a.Bm);
  const float* Cm = static_cast<const float*>(a.Cm);
  const size_t bt = (size_t)a.B * a.nh * a.T;
  float* rowp = a.rows;
  float* colp = rowp + bt;
  float* qv = colp + bt;
  float* ddtd = qv + bt;
  const dim3 chunks(nc, a.nh, a.B), tiles(nt * nc, a.nh, a.B);

  const size_t st_smem = (4 * kMaxChunk + kR * (2 * HD + 2 * N)) * sizeof(float);
  ssd_bwd_states_kernel<HD, N><<<chunks, kThreads, st_smem, a.stream>>>(
      x, a.dt, a.A, Bm, Cm, a.dy, a.S, a.E, a.cumL, a.T, a.nh, a.G, a.Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t states = (size_t)a.B * a.nh * HD * N;
  ssd_bwd_pass_kernel<<<(unsigned)((states + kThreads - 1) / kThreads),
                        kThreads, 0, a.stream>>>(
      a.S, a.E, a.cumL, a.h0, a.dh, a.dh0, a.B, a.nh, HD * N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t rows_smem = rows_smem_floats<HD, N>() * sizeof(float);
  static bool rows_raised = false;
  if ((err = raise_smem(ssd_bwd_rows_kernel<HD, N>, rows_smem,
                        &rows_raised)) != cudaSuccess)
    return err;
  ssd_bwd_rows_kernel<HD, N><<<tiles, kThreads, rows_smem, a.stream>>>(
      x, a.dt, a.A, Bm, Cm, a.dy, a.S, a.dCh, rowp, a.T, a.nh, a.G, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t cols_smem = cols_smem_floats<HD, N>() * sizeof(float);
  static bool cols_raised = false;
  if ((err = raise_smem(ssd_bwd_cols_kernel<HD, N>, cols_smem,
                        &cols_raised)) != cudaSuccess)
    return err;
  ssd_bwd_cols_kernel<HD, N><<<tiles, kThreads, cols_smem, a.stream>>>(
      x, a.dt, a.A, Bm, Cm, a.dy, a.E, static_cast<float*>(a.dx), a.dBh, colp,
      qv, ddtd, a.T, a.nh, a.G, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_dt_kernel<<<chunks, kThreads, 0, a.stream>>>(
      a.dt, a.A, a.S, a.E, nullptr, 0, rowp, 1, a.ddt, a.dApart, a.T, a.nh,
      HD * N, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_groups_da<float>(a, N, nc);
}

template <int HD, int N>
cudaError_t launch_tc(const Args& a) {
  const int nc = a.T / a.Q, nt = (a.Q + kT - 1) / kT;
  const int nhk = a.nh / a.heads, hn = HD * N;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* Bm = static_cast<const bf16*>(a.Bm);
  const bf16* Cm = static_cast<const bf16*>(a.Cm);
  const size_t plane = (size_t)a.B * a.nh * a.T;
  const long long dy_plane = (long long)a.B * a.T * a.nh * HD;
  const long long st_plane = (long long)a.B * nc * a.nh * hn;
  float* rowc = a.rows;
  float* rowpart = rowc + plane;
  float* colp = rowpart + nt * plane;
  float* qv = colp + plane;
  float* ddtd = qv + plane;
  float* lcdt = ddtd + plane;

  constexpr size_t st_smem = states_tc_smem<HD, N>();
  static bool states_raised = false;
  cudaError_t err = raise_smem(ssd_bwd_states_tc_kernel<HD, N>, st_smem,
                               &states_raised);
  if (err != cudaSuccess) return err;
  ssd_bwd_states_tc_kernel<HD, N><<<dim3(2 * nc * a.nh, a.B), kTcThreads,
                                    st_smem, a.stream>>>(
      x, a.dt, a.A, Bm, Cm, a.dy, a.S, a.E, a.cumL, a.dys, dy_plane, lcdt,
      a.T, a.nh, a.G, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int pass_ctas = (hn + kThreads * kPassElems - 1) / (kThreads * kPassElems);
  ssd_bwd_pass_tc_kernel<<<dim3(pass_ctas, a.nh, a.B), kThreads, 0,
                           a.stream>>>(
      a.S, a.E, a.cumL, a.h0, a.dh, a.dh0, a.hpg, st_plane, a.ghp, a.nh, hn,
      nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 tiles(nc * nhk, a.B, nt);
  constexpr size_t rows_smem = rows_wg_smem<HD, N>();
  static bool rows_raised = false;
  if ((err = raise_smem(ssd_bwd_rows_wg_kernel<HD, N>, rows_smem,
                        &rows_raised)) != cudaSuccess)
    return err;
  ssd_bwd_rows_wg_kernel<HD, N><<<tiles, kTcThreads, rows_smem,
                                  a.stream>>>(
      x, lcdt, Bm, Cm, a.dys, dy_plane, a.hpg, st_plane, a.dCh, rowc, a.T,
      a.nh, a.G, a.Q, a.heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr size_t cols_smem = cols_wg_smem<HD, N>();
  static bool cols_raised = false;
  if ((err = raise_smem(ssd_bwd_cols_wg_kernel<HD, N>, cols_smem,
                        &cols_raised)) != cudaSuccess)
    return err;
  ssd_bwd_cols_wg_kernel<HD, N><<<tiles, kTcThreads, cols_smem,
                                  a.stream>>>(
      x, lcdt, Bm, Cm, a.dys, dy_plane, a.hpg, st_plane,
      static_cast<bf16*>(a.dx), a.dBh, rowpart, colp, qv, ddtd, a.T, a.nh,
      a.G, a.Q, a.heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_dt_kernel<<<dim3(nc, a.nh, a.B), kThreads, 0, a.stream>>>(
      a.dt, a.A, nullptr, nullptr, a.ghp, pass_ctas * (kThreads / 32), a.rows,
      1 + nt, a.ddt, a.dApart, a.T, a.nh, hn, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_groups_da<bf16>(a, N, nc);
}

template <int HD, int N>
cudaError_t dispatch(const Args& a, int is_f32) {
  return is_f32 ? launch_f32<HD, N>(a) : launch_tc<HD, N>(a);
}

}  // namespace

extern "C" {

// x [B, T, nh, hd] and Bm / Cm [B, T, G, N], all bf16 (is_f32 = 0) or all
// f32; G divides nh; dt [B, T, nh], A [nh], h0 [B, nh, hd, N] (or null),
// dy [B, T, nh, hd] and dh [B, nh, hd, N] (or null: zero), all f32.
// Writes dx (x's dtype), ddt [B, T, nh] f32, dA [nh] f32, dB / dC (the
// groups, x's dtype) and, when dh0 is not null, dh0 [B, nh, hd, N] f32.
// (hd, N) in {(64, 128), (64, 64), (16, 16)}; 1 <= Q <= 256 and T a
// multiple of Q.  Scratch, with nt = ceil(Q / 64) and nc = T / Q: f32 S
// and E [B, nc, nh, hd, N], cumL and dApart [B, nc, nh], dBh and dCh
// [B, T, nh / heads, N], rows [R, B, nh, T] with R = 4 (f32) or 6 + nt
// (bf16).  bf16 also: dys [2, B, T, nh, hd] and hpg [4, B, nc, nh, hd, N]
// bf16, ghp [B, nc, nh, 8 ceil(hd N / 1024)] f32; heads (of one group a
// CTA of the pair passes) divides nh / G, and is 1 for f32 (null dys,
// hpg, ghp).  Returns the first failing launch's cudaError_t (0 on
// success).
int ssd_scan_bwd(const void* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, const float* h0,
                 const float* dy, const float* dh, void* dx, float* ddt,
                 float* dA, void* dB, void* dC, float* dh0, float* S,
                 float* E, float* cumL, float* dBh, float* dCh, float* rows,
                 float* dApart, void* dys, void* hpg, float* ghp, int B,
                 int T, int nh, int G, int hd, int n, int Q, int is_f32,
                 int heads, void* stream) {
  if (Q < 1 || Q > kMaxChunk || T % Q != 0 || G < 1 || nh % G != 0
      || B < 1 || B > 65535 || nh < 1 || nh > 65535 || heads < 1
      || (nh / G) % heads != 0 || (is_f32 && heads != 1)
      || (!is_f32 && (dys == nullptr || hpg == nullptr || ghp == nullptr))
      || (long long)(T / Q) * ((Q + kT - 1) / kT) > INT32_MAX
      || 2LL * (T / Q) * nh > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const Args a{x, Bm, Cm, dt, A, h0, dy, dh, dx, dB, dC, ddt, dA, dh0,
               S, E, cumL, dBh, dCh, rows, dApart,
               static_cast<bf16*>(dys), static_cast<bf16*>(hpg), ghp,
               B, T, nh, G, Q, heads, static_cast<cudaStream_t>(stream)};
  if (hd == 64 && n == 128) return (int)dispatch<64, 128>(a, is_f32);
  if (hd == 64 && n == 64) return (int)dispatch<64, 64>(a, is_f32);
  if (hd == 16 && n == 16) return (int)dispatch<16, 16>(a, is_f32);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
