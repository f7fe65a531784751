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
// Seven launches, every one parallel over chunks or elements, f32 on the
// CUDA cores (x, B, C in bf16 or f32 are widened exactly on load; dy f32):
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
// (3) and (4) recompute s and D, so the pair work runs twice: a first,
// simple kernel.  What bounds the backward on this card is operations:
// at mamba2-1.3b's training shape (B 2, T 2048, 64 heads, hd 64, N 128,
// Q 256) the pairs' products and the state terms are ~56 GFLOP against
// ~0.14 GB of inputs and outputs, 0.057 ms at the bf16 tensor-core peak.
// On CUDA cores in f32 this design does about twice that, with shared-
// memory traffic per product, so it sits far from the bound (PERF.md);
// the tensor cores, one pass over the pairs and the forward's saved
// states are its later tuning (ROADMAP).
//
// No atomics: every sum runs in a fixed order (tiles in order, the
// heads of a group in head order, dA over rows then chunks), so two calls
// give the same bits, as checkpoint-resume needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 256;
constexpr int kThreads = 256;    // 16 x 16
constexpr int kT = 64;           // rows of a query or key tile
constexpr int kR = 16;           // rows per step of the states kernel

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

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
// [B, T, heads, D] tensor at one head, widened into dst[r * ld + d].
template <int D, typename Tin>
__device__ __forceinline__ void load_tile(float* dst, int ld, const Tin* src,
                                          size_t base, size_t row_stride,
                                          int r0, int Q, int tid) {
  for (int i = tid; i < kT * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * ld + d] =
        r0 + r < Q ? widen(src[base + (size_t)(r0 + r) * row_stride + d])
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

template <int HD, int N, typename Tin>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_kernel(const Tin* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const Tin* __restrict__ Bm,
                      const Tin* __restrict__ Cm, const float* __restrict__ dy,
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
      xa[i] = t < Q ? w_s[t] * widen(x[off]) : 0.f;
      ya[i] = t < Q ? e_s[t] * dy[off] : 0.f;
    }
    for (int i = tid; i < kR * N; i += kThreads) {
      const int r = i / N, nn = i % N, t = r0 + r;
      const size_t off = ((size_t)b * T + t0 + t) * brow + (size_t)g * N + nn;
      ba[i] = t < Q ? widen(Bm[off]) : 0.f;
      ca[i] = t < Q ? widen(Cm[off]) : 0.f;
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

template <int HD, int N, typename Tin>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_rows_kernel(const Tin* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const Tin* __restrict__ Bm,
                    const Tin* __restrict__ Cm, const float* __restrict__ dy,
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

template <int HD, int N, typename Tin>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cols_kernel(const Tin* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const Tin* __restrict__ Bm,
                    const Tin* __restrict__ Cm, const float* __restrict__ dy,
                    const float* __restrict__ Gs, Tin* __restrict__ dx,
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
      if (valid) dx[row * HD + p] = narrow<Tin>(dtj * uu);
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

__global__ void __launch_bounds__(kThreads)
ssd_bwd_dt_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Hp, const float* __restrict__ Gs,
                  const float* __restrict__ rowp,
                  const float* __restrict__ colp,
                  const float* __restrict__ qv,
                  const float* __restrict__ ddtd, float* __restrict__ ddt,
                  float* __restrict__ dApart, int T, int nh, int hn, int Q) {
  __shared__ float dt_s[kMaxChunk], cum_s[kMaxChunk], dcum_s[kMaxChunk],
      da_s[kMaxChunk], red[kThreads];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, t0 = c * Q;
  load_dt_cum(dt_s, cum_s, dt, A, b, T, t0, nh, h, Q, tid);
  const size_t sb = (((size_t)b * nc + c) * nh + h) * hn;
  float gh = 0.f;
  for (int i = tid; i < hn; i += kThreads) gh = fmaf(Gs[sb + i], Hp[sb + i], gh);
  gh = block_sum(gh, red, tid);
  const size_t rb = ((size_t)b * nh + h) * T + t0;
  const float qsum = block_sum(tid < Q ? qv[rb + tid] : 0.f, red, tid);
  if (tid < Q) dcum_s[tid] = rowp[rb + tid] + colp[rb + tid];
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
  if (tid == 0) dApart[((size_t)b * nc + c) * nh + h] = part;
}

// ------------------------------------------------------- (6) groups, (7) dA

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_groups_kernel(const float* __restrict__ dBh,
                      const float* __restrict__ dCh, Tin* __restrict__ dB,
                      Tin* __restrict__ dC, size_t total, int nh, int G,
                      int N) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int n = (int)(e % N);
  const size_t rest = e / N;
  const int g = (int)(rest % G);
  const size_t bt = rest / G;
  const int hpg = nh / G;
  const float* src = (blockIdx.y ? dCh : dBh) + (bt * nh + (size_t)g * hpg) * N + n;
  float s = 0.f;
  for (int k = 0; k < hpg; ++k) s += src[(size_t)k * N];
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

// ------------------------------------------------------------------ launch

struct Args {
  const void *x, *Bm, *Cm;
  const float *dt, *A, *h0, *dy, *dh;
  void *dx, *dB, *dC;
  float *ddt, *dA, *dh0;
  float *S, *E, *cumL, *dBh, *dCh, *rows, *dApart;
  int B, T, nh, G, Q;
  cudaStream_t stream;
};

template <int HD, int N, typename Tin>
cudaError_t launch(const Args& a) {
  const int nc = a.T / a.Q, nt = (a.Q + kT - 1) / kT;
  const Tin* x = static_cast<const Tin*>(a.x);
  const Tin* Bm = static_cast<const Tin*>(a.Bm);
  const Tin* Cm = static_cast<const Tin*>(a.Cm);
  const size_t bt = (size_t)a.B * a.nh * a.T;
  float* rowp = a.rows;
  float* colp = rowp + bt;
  float* qv = colp + bt;
  float* ddtd = qv + bt;
  const dim3 chunks(nc, a.nh, a.B), tiles(nt * nc, a.nh, a.B);

  const size_t st_smem = (4 * kMaxChunk + kR * (2 * HD + 2 * N)) * sizeof(float);
  ssd_bwd_states_kernel<HD, N, Tin><<<chunks, kThreads, st_smem, a.stream>>>(
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
  if ((err = raise_smem(ssd_bwd_rows_kernel<HD, N, Tin>, rows_smem,
                        &rows_raised)) != cudaSuccess)
    return err;
  ssd_bwd_rows_kernel<HD, N, Tin><<<tiles, kThreads, rows_smem, a.stream>>>(
      x, a.dt, a.A, Bm, Cm, a.dy, a.S, a.dCh, rowp, a.T, a.nh, a.G, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t cols_smem = cols_smem_floats<HD, N>() * sizeof(float);
  static bool cols_raised = false;
  if ((err = raise_smem(ssd_bwd_cols_kernel<HD, N, Tin>, cols_smem,
                        &cols_raised)) != cudaSuccess)
    return err;
  ssd_bwd_cols_kernel<HD, N, Tin><<<tiles, kThreads, cols_smem, a.stream>>>(
      x, a.dt, a.A, Bm, Cm, a.dy, a.E, static_cast<Tin*>(a.dx), a.dBh, colp,
      qv, ddtd, a.T, a.nh, a.G, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_dt_kernel<<<chunks, kThreads, 0, a.stream>>>(
      a.dt, a.A, a.S, a.E, rowp, colp, qv, ddtd, a.ddt, a.dApart, a.T, a.nh,
      HD * N, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t grouped = (size_t)a.B * a.T * a.G * N;
  ssd_bwd_groups_kernel<Tin><<<dim3((unsigned)((grouped + kThreads - 1)
                                               / kThreads), 2),
                               kThreads, 0, a.stream>>>(
      a.dBh, a.dCh, static_cast<Tin*>(a.dB), static_cast<Tin*>(a.dC),
      grouped, a.nh, a.G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_da_kernel<<<(a.nh + 127) / 128, 128, 0, a.stream>>>(
      a.dApart, a.dA, a.B, nc, a.nh);
  return cudaGetLastError();
}

template <int HD, int N>
cudaError_t dispatch(const Args& a, int is_f32) {
  return is_f32 ? launch<HD, N, float>(a) : launch<HD, N, bf16>(a);
}

}  // namespace

extern "C" {

// x [B, T, nh, hd] and Bm / Cm [B, T, G, N], all bf16 (is_f32 = 0) or all
// f32; G divides nh; dt [B, T, nh], A [nh], h0 [B, nh, hd, N] (or null),
// dy [B, T, nh, hd] and dh [B, nh, hd, N] (or null: zero), all f32.
// Writes dx (x's dtype), ddt [B, T, nh] f32, dA [nh] f32, dB / dC (the
// groups, x's dtype) and, when dh0 is not null, dh0 [B, nh, hd, N] f32.
// (hd, N) in {(64, 128), (64, 64), (16, 16)}; 1 <= Q <= 256 and T a
// multiple of Q.  f32 scratch: S and E [B, T / Q, nh, hd, N], cumL and
// dApart [B, T / Q, nh], dBh and dCh [B, T, nh, N], rows [4, B, nh, T].
// Returns the first failing launch's cudaError_t (0 on success).
int ssd_scan_bwd(const void* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, const float* h0,
                 const float* dy, const float* dh, void* dx, float* ddt,
                 float* dA, void* dB, void* dC, float* dh0, float* S,
                 float* E, float* cumL, float* dBh, float* dCh, float* rows,
                 float* dApart, int B, int T, int nh, int G, int hd, int n,
                 int Q, int is_f32, void* stream) {
  if (Q < 1 || Q > kMaxChunk || T % Q != 0 || G < 1 || nh % G != 0
      || B < 1 || B > 65535 || nh < 1 || nh > 65535
      || (long long)(T / Q) * ((Q + kT - 1) / kT) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const Args a{x, Bm, Cm, dt, A, h0, dy, dh, dx, dB, dC, ddt, dA, dh0,
               S, E, cumL, dBh, dCh, rows, dApart, B, T, nh, G, Q,
               static_cast<cudaStream_t>(stream)};
  if (hd == 64 && n == 128) return (int)dispatch<64, 128>(a, is_f32);
  if (hd == 64 && n == 64) return (int)dispatch<64, 64>(a, is_f32);
  if (hd == 16 && n == 16) return (int)dispatch<16, 16>(a, is_f32);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
