// Backward of causal or non-causal GQA flash attention, for training.
//
// The TPU package has no backward kernel: the reference trains through the
// jnp online-softmax scan repro/models/layers.py:118 (attention),
// differentiated by jax.value_and_grad (repro/train/trainer.py:155).  This
// source is that gradient as kernels, beside the forward of
// flash_attention.cu, which hands it each row's log-sum-exp (lse).
//
// For q [B, Tq, H, dh], k [B, Tk, n_kv, dh] and v [B, Tk, n_kv, dh_v], the
// forward's output o [B, Tq, H, dh_v], its gradient dO and lse [B, H, Tq]
// f32, with queries at positions 0 .. Tq - 1 (causal: row i sees keys j <=
// i); dh_v = dh, or MLA's dh 192 (nope 128 + rope 64) with dh_v 128:
//   D  = rowsum(dO o o)                    (f32 [B, H, Tq], over dh_v)
//   P  = exp(scale Q K^T - lse)            (exact zeros where masked)
//   dV = sum over rows P^T dO              dS = P o (dO V^T - D)
//   dQ = scale dS K                        dK = scale dS^T Q
// with dK and dV summed over the g = H / n_kv query heads of a KV head.
//
// What bounds it on the card: operations.  At the training shape (B 2,
// T 2048, 16 heads over 2 KV heads of 128, causal, bf16) the five products
// are ~86 GFLOP against ~50 MB of inputs and outputs.  Without atomics dQ
// needs a launch of its own, which recomputes S and dP: 7 products are
// issued, a floor of 1.4x the bound.
//
// No atomics, so the gradient is deterministic: every sum runs in an order
// the code fixes, not the scheduler.  bf16 at head dims 32, 64, 96 and 128,
// and at MLA's 192 / 128, is two launches:
//   1. dQ: the forward's tiling, one CTA per (64 rows = g heads x 64 / g
//      positions, KV head, batch row), walking the key tiles up to its
//      last row's diagonal; its prologue also computes D for its rows and
//      writes it, for launch 2;
//   2. dK / dV: the g query heads of a KV head are split over c = min(g,
//      4) CTAs per 64-key tile, which form one thread-block cluster.  Rank
//      r walks heads [r g / c, (r + 1) g / c) x the query tiles that see
//      its keys (causal: from the tile's diagonal on), recomputing S and P
//      from lse, with its dK and dV in f32 registers.  Then each rank parks
//      those partials in its shared memory, and rank r sums its 64 / c
//      rows of all c partials in rank order through distributed shared
//      memory (cluster.sync(), map_shared_rank) and writes them: nothing
//      crosses device memory and no address is written twice, so no
//      atomic is needed.  At the training shape that is 4 x 32 x 2 x 2 =
//      512 CTAs, each walking at most 64 steps (4 ranks measured faster
//      than 8, 2 or 1: launch/flash_bwd_variants.py).
// Both run the rows or key tile with the longest causal walk first.
//
// Each CTA is one warpgroup (4 warps) owning 64 keys (dK / dV) or 64 rows
// (dQ).  wgmma m64n64k16 computes S^T = K Q^T and dP^T = V dO^T key-major
// (dQ: S = Q K^T, dP = dO V^T) with both operands K-major in shared
// memory; P^T and dS^T are rounded to bf16 in registers straight from
// those accumulators and feed dV += P^T dO and dK += dS^T Q (dQ: dQ += dS
// K) as register A operands of m64n{dh}k16, the streamed tile read
// MN-major from the same shared bytes.  Tiles lie in shared memory as
// 64-column blocks in the 128-byte swizzle that both the descriptors and
// the tensor memory accelerator (TMA) name: one thread has the TMA bring
// each tile (a box per 64 columns; rows past the end arrive as zeros) and
// arms an mbarrier that the warpgroup waits on.  The streamed tiles (Q and
// dO for dK / dV, with each row's lse and D by cp.async; K and V for dQ)
// run through two stages (~98 KB a CTA at dh 128: two CTAs a SM; ~122 KB
// at 192 / 128, where Q and K take three 64-column blocks and V and dO
// two: one CTA a SM), the fixed pair (K, V; Q, dO) stays.  At 192 / 128
// dK's and dV's accumulators alone take 160 registers a thread, so a dK /
// dV step runs its 64 query rows as two parts of 32 (S^T and dP^T as
// m64n32 products; dK += dS^T Q as m64n192k16, dV += P^T dO as
// m64n128k16); the dQ launch needs no split (m64n192k16 for dQ).  The tensor maps are encoded per call
// (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint:
// nothing links libcuda).  P and dS are rounded to bf16 only as mma
// inputs; masked scores get no probability at all (a select, not -inf
// arithmetic), as the forward's exact zeros, and tiles that no mask
// touches skip the mask arithmetic.
//
// f32, which must match its plain version at 2e-5, and bf16 at the other
// head dims run three launches on CUDA cores: the D pre-pass (one warp a
// row), dK / dV per (32-key tile, KV head, batch row) over all g heads in
// series, dQ per (32-row query tile, head).  The path is picked by an
// explicit (dtype, dh, dh_v) dispatch in flash_attention_bwd below.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

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
// [B, Tq, H] (row-major), lanes striding the value width dv.
__global__ void bwd_rowdot_kernel(const void* __restrict__ o,
                                  const void* __restrict__ dout,
                                  float* __restrict__ D, int rows, int Tq,
                                  int H, int dv, int is_f32) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bool f32 = is_f32 != 0;
  float s = 0.f;
  for (int d = lane; d < dv; d += 32) {
    const size_t off = (size_t)row * dv + d;
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

// Two [32][dh + 1] f32 tiles (K and Q; the +1 keeps a column walk across
// rows on distinct banks), two [32][dv + 1] (V and dO), two [32][33] score
// tiles, lse and D.
size_t cc_smem_bytes(int dh, int dv) {
  return ((size_t)2 * kCcTile * (dh + 1) + (size_t)2 * kCcTile * (dv + 1)
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
// the dK / dV columns tx + 16 c of its two keys.  Keys and queries are DH
// wide, values and dO DV wide.
template <int DH, int DV>
__global__ void __launch_bounds__(kCcThreads)
bwd_dkdv_cc_kernel(const void* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v, const void* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ D,
                   void* __restrict__ dk, void* __restrict__ dv, int Tq,
                   int Tk, int H, int n_kv, int causal, int is_f32,
                   float scale) {
  constexpr int P = DH + 1;
  constexpr int PV = DV + 1;
  constexpr int PS = kCcTile + 1;
  constexpr int NC = DH / 16;
  constexpr int NCV = DV / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kCcTile * P;
  float* q_s = v_s + kCcTile * PV;
  float* do_s = q_s + kCcTile * P;
  float* p_s = do_s + kCcTile * PV;    // [query][key]
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
  cc_load_rows<DV>(v_s, v, f32, b, Tk, n_kv, kvh, key0);

  float dk_acc[2][NC], dv_acc[2][NCV];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[a][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NCV; ++c) dv_acc[a][c] = 0.f;
  }

  const int n_qt = (Tq + kCcTile - 1) / kCcTile;
  const int qt0 = causal ? key0 / kCcTile : 0;   // rows >= key0 see the tile
  for (int j = 0; j < g; ++j) {
    const int h = kvh * g + j;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kCcTile;
      __syncthreads();                 // the previous step is consumed
      cc_load_rows<DH>(q_s, q, f32, b, Tq, H, h, q0);
      cc_load_rows<DV>(do_s, dout, f32, b, Tq, H, h, q0);
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
          for (int d = 0; d < DH; ++d)
            s = fmaf(k_s[kr * P + d], q_s[qr * P + d], s);
#pragma unroll 8
          for (int d = 0; d < DV; ++d)
            dp = fmaf(v_s[kr * PV + d], do_s[qr * PV + d], dp);
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
          for (int c = 0; c < NCV; ++c)
            dv_acc[a][c] = fmaf(pa, do_s[r * PV + tx + 16 * c], dv_acc[a][c]);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            dk_acc[a][c] = fmaf(da, q_s[r * P + tx + 16 * c], dk_acc[a][c]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = key0 + 2 * ty + a;
    if (key >= Tk) continue;
    const size_t row = ((size_t)b * Tk + key) * n_kv + kvh;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      stf(dk, row * DH + tx + 16 * c, f32, dk_acc[a][c] * scale);
#pragma unroll
    for (int c = 0; c < NCV; ++c)
      stf(dv, row * DV + tx + 16 * c, f32, dv_acc[a][c]);
  }
}

// dQ: one CTA per (32-row query tile, query head, batch row).  Thread
// (tx, ty) owns the scores of rows 2 ty + {0, 1} x keys 2 tx + {0, 1},
// then the dQ columns tx + 16 c of its two rows.
template <int DH, int DV>
__global__ void __launch_bounds__(kCcThreads)
bwd_dq_cc_kernel(const void* __restrict__ q, const void* __restrict__ k,
                 const void* __restrict__ v, const void* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 void* __restrict__ dq, int Tq, int Tk, int H, int n_kv,
                 int causal, int is_f32, float scale) {
  constexpr int P = DH + 1;
  constexpr int PV = DV + 1;
  constexpr int PS = kCcTile + 1;
  constexpr int NC = DH / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kCcTile * P;
  float* k_s = do_s + kCcTile * PV;
  float* v_s = k_s + kCcTile * P;
  float* ds_s = v_s + kCcTile * PV;    // [row][key]
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
  cc_load_rows<DV>(do_s, dout, f32, b, Tq, H, h, q0);
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
    cc_load_rows<DV>(v_s, v, f32, b, Tk, n_kv, kvh, key0);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qr = 2 * ty + a, kr = 2 * tx + c;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d)
          s = fmaf(q_s[qr * P + d], k_s[kr * P + d], s);
#pragma unroll 8
        for (int d = 0; d < DV; ++d)
          dp = fmaf(do_s[qr * PV + d], v_s[kr * PV + d], dp);
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

constexpr int kTile = 64;          // rows of every tile (keys or queries)
constexpr int kMaxCluster = 4;     // CTAs a key tile's heads split over
constexpr int kBlock = kTile * 128;   // bytes of a 64-row x 64-column block

// A 64-row bf16 tile of width DH lies in shared memory as DH / 64 blocks
// (rounded up) of 64 rows x 64 columns, 128 bytes a row, in the 128-byte
// swizzle that wgmma's descriptors name: the 16-byte chunk c of row r sits
// at chunk c ^ (r % 8) of its row.  Blocks start on 1024-byte boundaries.
template <int DH>
__host__ __device__ constexpr int tile_bytes() {
  return (DH + 63) / 64 * kBlock;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy to a shared-memory address; with ok false it
// reads nothing and zero-fills.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// mbarriers that the tensor memory accelerator (TMA) completes: one
// thread arms a barrier with the bytes it expects, and every thread waits
// for its phase to flip.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar));
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// The box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at dst; its bytes complete on bar.  Parts of
// the box outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar) : "memory");
}

// A tile of x [B, T, heads, DH] (the map's layout, see make_map): the
// boxes of its DH / 64 column blocks at (head, row, b).
template <int DH>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row,
                                         int b) {
#pragma unroll
  for (int j = 0; j < (DH + 63) / 64; ++j)
    tma_load(dst + j * kBlock, map, bar, 64 * j, head, row, b);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Accumulator layout of a wgmma m64nN (f32): warp w of the warpgroup holds
// rows 16 w + lane / 4 (e = 0, 1) and 16 w + lane / 4 + 8 (e = 2, 3) at
// columns 8 n + 2 (lane % 4) + (e & 1) in d[4 n + e].  The A fragment of
// a register-A wgmma at k-step kk is the same layout over columns 16 kk ..
// 16 kk + 15, rounded to bf16 pairs.
__device__ __forceinline__ void a_frag(uint32_t* a, const float* d, int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// d[64 x N] (+)= A B^T with A and B K-major in shared memory (named by
// descriptors); scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a,
                                         uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x N] += A[64 x 16] B[16 x N]: A in registers (a_frag), B MN-major
// in shared memory (desc_mn).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

constexpr int kThreads = 128;      // one warpgroup a CTA

// 2^x on the special-function unit, subnormal results flushed to zero.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P^T in place from S^T [64 keys x 2 NI rows] (dK / dV's layout: keys are
// accumulator rows, query rows q0 .. its columns, lse_s their lse): exp2 of
// the scaled score less the row's lse.  With MASK, keys past Tk, rows past
// Tq and (causal) keys after their row get an exact zero; without, the
// caller knows there are none.
template <bool MASK, int NI>
__device__ __forceinline__ void probs_keys_rows(float* p, const float* lse_s,
                                                float scale_log2, int key,
                                                int q0, int Tk, int Tq,
                                                bool causal, int lane) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
    const float e = fast_exp2(p[i] * scale_log2 - lse_s[r] * kLog2e);
    if (MASK) {
      const int kr = key + 8 * ((i >> 1) & 1), row = q0 + r;
      p[i] = (kr < Tk) & (row < Tq) & (!causal | (kr <= row)) ? e : 0.f;
    } else {
      p[i] = e;
    }
  }
}

// P in place from S [64 rows x 64 keys] (dQ's layout): the thread's rows
// rows[0, 1] at positions rpos[0, 1], valid where rvalid.
template <bool MASK>
__device__ __forceinline__ void probs_rows_keys(float* p, const float* lse_s,
                                                float scale_log2,
                                                const int* rows,
                                                const int* rpos,
                                                const bool* rvalid, int key0,
                                                int Tk, bool causal,
                                                int lane) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int a = (i >> 1) & 1;
    const float e = fast_exp2(p[i] * scale_log2 - lse_s[rows[a]] * kLog2e);
    if (MASK) {
      const int key = key0 + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
      p[i] = rvalid[a] & (key < Tk) & (!causal | (key <= rpos[a])) ? e : 0.f;
    } else {
      p[i] = e;
    }
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// Three pairs of tiles, a DH-wide and a DV-wide one each (the fixed pair
// and two stages of the streamed pair), two stages of 64 + 64 f32 (lse and
// D), three mbarriers (a stage each and the fixed tiles) and the slack that
// aligns the base to 1024 bytes.  After its walk a dK / dV CTA reuses the
// tiles' bytes for its f32 partials [64][DH + 4] of dK and [64][DV + 4] of
// dV, which fit.
template <int DH, int DV>
constexpr size_t tc_smem_bytes() {
  static_assert(kTile * (DH + 4 + DV + 4) * sizeof(float)
                    <= 3 * (size_t)(tile_bytes<DH>() + tile_bytes<DV>()),
                "the dK / dV partials fit in the tiles' bytes");
  return (size_t)3 * (tile_bytes<DH>() + tile_bytes<DV>())
         + 4 * kTile * sizeof(float) + 64 + 1024;
}

// Parts a dK / dV step splits its 64 query rows into.  At DH + DV above
// 256 (MLA's 192 / 128) dK's and dV's f32 accumulators take DH / 2 + DV /
// 2 = 160 registers a thread, and S^T and dP^T over all 64 rows 32 more
// each: a step then runs as two parts of 32 rows (S^T and dP^T m64n32,
// 16 registers each), so that nothing spills.
template <int DH, int DV>
__host__ __device__ constexpr int q_parts() {
  return DH + DV > 256 ? 2 : 1;
}

// Rows [lo, hi) of the c ranks' f32 partials part [64][stride] (W columns
// wide), summed in rank order through distributed shared memory, times
// mul, into out [.., Tk, n_kv, W] bf16 at keys key0 + row (head row
// kv_row0 + key n_kv); rows past Tk are not written.
template <int W>
__device__ __forceinline__ void cluster_sum_rows(cg::cluster_group& cluster,
                                                 float* part, int stride,
                                                 int lo, int hi, int c,
                                                 __nv_bfloat16* out, int key0,
                                                 int Tk, size_t kv_row0,
                                                 int n_kv, float mul) {
  for (int i = threadIdx.x; i < (hi - lo) * (W / 4); i += kThreads) {
    const int r = lo + i / (W / 4), col = (i % (W / 4)) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < c; ++src) {              // rank order
      const float4 x = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, src) + r * stride + col);
      sum = src ? make_float4(sum.x + x.x, sum.y + x.y, sum.z + x.z,
                              sum.w + x.w)
                : x;
    }
    const int key = key0 + r;
    if (key >= Tk) continue;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(
        out + (kv_row0 + (size_t)key * n_kv) * W + col);
    o2[0] = __floats2bfloat162_rn(sum.x * mul, sum.y * mul);
    o2[1] = __floats2bfloat162_rn(sum.z * mul, sum.w * mul);
  }
}

// dK / dV: one CTA per (64-key tile, KV head, batch row, rank r of c =
// min(g, kMaxCluster)); the c CTAs of a key tile form a cluster.  Rank r
// walks heads kvh g + [r g / c, (r + 1) g / c) x the query tiles that see
// its keys, one (head, 64-row query tile) step at a time: thread 0 has the
// TMA bring the next step's Q and dO tiles into the other stage while
// every thread copies its row's lse and D.  S^T = K Q^T and dP^T = V dO^T
// are shared x shared wgmmas; dV += P^T dO and dK += dS^T Q take P^T and
// dS^T from registers and read dO and Q MN-major (a step in q_parts()
// parts of its query rows).  Then every rank parks its f32 partials in its
// shared memory, and rank r sums rows [64 r / c, 64 (r + 1) / c) of all c
// partials, in rank order, through distributed shared memory, and writes
// them.  Key tile 0 (the longest causal walk) runs first.
template <int DH, int DV>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const float* __restrict__ lse,
                      const float* __restrict__ D,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int B, int Tq, int Tk,
                      int H, int n_kv, int causal, float scale) {
  constexpr int TBK = tile_bytes<DH>();
  constexpr int TBV = tile_bytes<DV>();
  constexpr int TBP = TBK + TBV;       // a pair of tiles
  constexpr int PSK = DH + 4;          // f32 partial row strides
  constexpr int PSV = DV + 4;
  constexpr int QP = q_parts<DH, DV>();
  constexpr int QN = kTile / QP;       // query rows of a part
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t k_s = smem_addr(smem);
  const uint32_t v_s = k_s + TBK;
  const uint32_t qd_s = k_s + TBP;     // [stage][Q, dO] tiles
  float* ld_s = reinterpret_cast<float*>(smem + 3 * TBP);
  // ld_s: [stage][lse[64], D[64]]; then the mbarriers [stage 0, 1, fixed]
  const uint32_t bar = smem_addr(ld_s + 4 * kTile);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const float scale_log2 = scale * kLog2e;
  const int g = H / n_kv;
  int slot = blockIdx.x / c;
  const int kvh = slot % n_kv;
  slot /= n_kv;
  const int b = slot % B;
  const int key0 = slot / B * kTile;   // key tile 0 (the longest walk) first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(bar + 16, TBP);
    tma_tile<DH>(k_s, &tm_k, bar + 16, kvh, key0, b);
    tma_tile<DV>(v_s, &tm_v, bar + 16, kvh, key0, b);
  }
  const int n_qt = (Tq + kTile - 1) / kTile;
  const int qt0 = causal ? min(key0 / kTile, n_qt) : 0;   // rows >= key0
  const int per_head = n_qt - qt0;
  const int j0 = rank * g / c;
  const int n_steps = ((rank + 1) * g / c - j0) * per_head;
  auto load_step = [&](int step, int stage) {
    const int h = kvh * g + j0 + step / per_head;
    const int q0 = (qt0 + step % per_head) * kTile;
    if (threadIdx.x == 0) {
      const uint32_t qs = qd_s + stage * TBP;
      mbar_expect(bar + 8 * stage, TBP);
      tma_tile<DH>(qs, &tm_q, bar + 8 * stage, h, q0, b);
      tma_tile<DV>(qs + TBK, &tm_do, bar + 8 * stage, h, q0, b);
    }
    const int r = threadIdx.x % kTile;
    const bool ok = q0 + r < Tq;
    const size_t off = ok ? ((size_t)b * H + h) * Tq + q0 + r : 0;
    cp_async4(smem_addr(ld_s + stage * 2 * kTile + threadIdx.x),
              (threadIdx.x < kTile ? lse : D) + off, ok);
  };
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dk_acc[DH / 2], dv_acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.f;
  mbar_wait(bar + 16, 0);              // K and V have landed

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) load_step(step + 1, (step + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();                // this step's lse and D
    mbar_wait(bar + 8 * (step % 2), (step / 2) & 1);   // its Q and dO
    __syncthreads();
    const uint32_t qs = qd_s + (step % 2) * TBP;
    const uint32_t dos = qs + TBK;
    const float* lse_s = ld_s + (step % 2) * 2 * kTile;
    const float* d_s = lse_s + kTile;
    const int q0 = (qt0 + step % per_head) * kTile;
    // Masks only where the tile crosses the diagonal or an edge.
    const bool edge = key0 + kTile > Tk || q0 + kTile > Tq
                      || (causal && key0 + kTile - 1 > q0);
    const int key = key0 + warp * 16 + lane / 4;
#pragma unroll
    for (int part = 0; part < QP; ++part) {
      const int r0 = part * QN;        // the part's first row in the tile
      float p[QN / 2], ds[QN / 2];     // P^T and dS^T [64 keys x QN rows]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)           // S^T = K Q^T
        wgmma_ss<QN>(p, desc_k(k_s, kk), desc_k(qs + r0 * 128, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)           // dP^T = V dO^T
        wgmma_ss<QN>(ds, desc_k(v_s, kk), desc_k(dos + r0 * 128, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<QN / 2>(p);
      if (edge)
        probs_keys_rows<true, QN / 2>(p, lse_s + r0, scale_log2, key,
                                      q0 + r0, Tk, Tq, causal, lane);
      else
        probs_keys_rows<false, QN / 2>(p, lse_s + r0, scale_log2, key,
                                       q0 + r0, Tk, Tq, causal, lane);
      // Both A operands are packed before the products are issued: a
      // register written between two wgmmas makes the compiler fence them.
      uint32_t pa[QN / 16][4], sa[QN / 16][4];
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk) a_frag(pa[kk], p, kk);
      wgmma_wait<0>();
      fence_regs<QN / 2>(ds);
#pragma unroll
      for (int i = 0; i < QN / 2; ++i)               // dS^T = P^T o (dP^T - D)
        ds[i] = p[i] * (ds[i]
                        - d_s[r0 + (i / 4) * 8 + 2 * (lane % 4) + (i & 1)]);
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk) a_frag(sa[kk], ds, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)           // dV += P^T dO
        wgmma_rs<DV>(dv_acc, pa[kk], desc_mn(dos, r0 / 16 + kk));
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)           // dK += dS^T Q
        wgmma_rs<DH>(dk_acc, sa[kk], desc_mn(qs, r0 / 16 + kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DV / 2>(dv_acc);
      fence_regs<DH / 2>(dk_acc);
    }
    __syncthreads();                   // stage step % 2 is consumed
  }
  cp_async_wait<0>();
  __syncthreads();                     // the tiles are dead: partials next

  float* pk = reinterpret_cast<float*>(smem);
  float* pv = pk + kTile * PSK;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + lane / 4 + 8 * half;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(pk + r * PSK + n * 8 + 2 * (lane % 4)) =
          make_float2(dk_acc[4 * n + 2 * half], dk_acc[4 * n + 2 * half + 1]);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<float2*>(pv + r * PSV + n * 8 + 2 * (lane % 4)) =
          make_float2(dv_acc[4 * n + 2 * half], dv_acc[4 * n + 2 * half + 1]);
  }
  cluster.sync();                      // every rank's partials are parked
  const int lo = rank * kTile / c, hi = (rank + 1) * kTile / c;
  cluster_sum_rows<DH>(cluster, pk, PSK, lo, hi, c, dk, key0, Tk,
                       ((size_t)b * Tk * n_kv + kvh), n_kv, scale);
  cluster_sum_rows<DV>(cluster, pv, PSV, lo, hi, c, dv, key0, Tk,
                       ((size_t)b * Tk * n_kv + kvh), n_kv, 1.f);
  cluster.sync();                      // no rank leaves while read from
}

// dQ: the forward's tiling, one CTA per (64 rows, KV head, batch row).
// Row r is head kvh g + r % g at position pos0 + r / g (bq = 64 / g
// positions, g bq rows: the order in which one TMA box (64 columns x g
// heads x bq positions) lands), so each K / V tile staged serves all g
// heads.  Thread 0 has the TMA bring the next K and V tiles into the other
// stage; S = Q K^T and dP = dO V^T are shared x shared wgmmas, then dQ +=
// dS K takes dS from registers and reads K MN-major.  The latest positions
// (the longest causal walk) run first.
template <int DH, int DV>
__global__ void __launch_bounds__(kThreads)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __nv_bfloat16* __restrict__ o,
                    const float* __restrict__ lse, float* __restrict__ D,
                    __nv_bfloat16* __restrict__ dq, int B, int Tq, int Tk,
                    int H, int n_kv, int causal, float scale) {
  constexpr int TBK = tile_bytes<DH>();
  constexpr int TBV = tile_bytes<DV>();
  constexpr int TBP = TBK + TBV;       // a pair of tiles
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t q_s = smem_addr(smem);
  const uint32_t do_s = q_s + TBK;
  const uint32_t kv_s = q_s + TBP;     // [stage][K, V] tiles
  float* lse_s = reinterpret_cast<float*>(smem + 3 * TBP);
  float* d_s = lse_s + kTile;
  const uint32_t bar = smem_addr(lse_s + 4 * kTile);   // [stage 0, 1, fixed]
  const float scale_log2 = scale * kLog2e;
  const int g = H / n_kv;
  const int bq = kTile / g;
  const int rows_used = g * bq;
  const int n_pt = (Tq + bq - 1) / bq;
  int slot = blockIdx.x;
  const int kvh = slot % n_kv;
  slot /= n_kv;
  const int b = slot % B;
  const int pos0 = (n_pt - 1 - slot / B) * bq;   // heaviest first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_pos = min(bq, Tq - pos0);

  // Rows the box does not reach (g not a power of two) are zeros.
  for (int i = rows_used * 8 + threadIdx.x; i < kTile * 8; i += kThreads)
#pragma unroll
    for (int j = 0; j < TBP / kBlock; ++j)         // Q's blocks, then dO's
      *reinterpret_cast<uint4*>(smem + j * kBlock + 16 * i) = uint4{};
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(bar + 16, (TBP / kBlock) * rows_used * 128);
    tma_tile<DH>(q_s, &tm_q, bar + 16, kvh * g, pos0, b);
    tma_tile<DV>(do_s, &tm_do, bar + 16, kvh * g, pos0, b);
  }
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    const bool ok = r < rows_used && r / g < n_pos;
    const size_t off =
        ok ? ((size_t)b * H + kvh * g + r % g) * Tq + pos0 + r / g : 0;
    cp_async4(smem_addr(lse_s + r), lse + off, ok);
  }
  const int kend = causal ? min(Tk, pos0 + n_pos) : Tk;   // keys [0, kend)
  const int n_kt = (kend + kTile - 1) / kTile;
  auto load_tile = [&](int t, int stage) {
    if (threadIdx.x == 0) {
      const uint32_t ks = kv_s + stage * TBP;
      mbar_expect(bar + 8 * stage, TBP);
      tma_tile<DH>(ks, &tm_k, bar + 8 * stage, kvh, t * kTile, b);
      tma_tile<DV>(ks + TBK, &tm_v, bar + 8 * stage, kvh, t * kTile, b);
    }
  };
  if (n_kt > 0) load_tile(0, 0);
  cp_async_commit();
  // D = rowsum(dO o O) of the CTA's rows, two threads a row, for dS here
  // and for the dK / dV launch that follows: this thread's half of its
  // row of O is fetched while the TMA brings Q and dO.
  const int d_row = threadIdx.x / 2, d_half = threadIdx.x % 2;
  const bool d_ok = d_row < rows_used && d_row / g < n_pos;
  uint4 ov[DV / 16];
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        o + (((size_t)b * Tq + pos0 + d_row / g) * H + kvh * g + d_row % g)
                * DV
          + d_half * (DV / 2));
#pragma unroll
    for (int i = 0; i < DV / 16; ++i) ov[i] = d_ok ? src[i] : uint4{};
  }

  int rpos[2], rows[2];
  bool rvalid[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = warp * 16 + lane / 4 + 8 * a;
    rows[a] = r;
    rvalid[a] = r < rows_used && r / g < n_pos;
    rpos[a] = pos0 + r / g;
  }
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  cp_async_wait<0>();                  // lse
  mbar_wait(bar + 16, 0);              // Q and dO
  {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 16; ++i) {
      const int col = d_half * (DV / 2) + 8 * i;
      const uint4 dv = *reinterpret_cast<const uint4*>(   // swizzled dO
          smem + TBK + (col / 64) * kBlock + d_row * 128
          + ((((col / 8) & 7) ^ (d_row & 7)) << 4));
      const __nv_bfloat162* o2 =
          reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]);
        const float2 df = __bfloat1622float2(d2[e]);
        sum = fmaf(df.y, of.y, fmaf(df.x, of.x, sum));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (d_half == 0) {
      d_s[d_row] = sum;
      if (d_ok)
        D[((size_t)b * H + kvh * g + d_row % g) * Tq + pos0 + d_row / g] =
            sum;
    }
  }
  __syncthreads();

  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load_tile(t + 1, (t + 1) % 2);
    mbar_wait(bar + 8 * (t % 2), (t / 2) & 1);       // tile t
    const uint32_t ks = kv_s + (t % 2) * TBP;
    const uint32_t vs = ks + TBK;
    const int key0 = t * kTile;
    // Masks only where the tile crosses a row's diagonal or an edge.
    const bool edge = key0 + kTile > Tk || n_pos < bq || rows_used < kTile
                      || (causal && key0 + kTile - 1 > pos0);
    float p[32], ds[32];               // P and dS [64 rows x 64 keys]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)             // S = Q K^T
      wgmma_ss<64>(p, desc_k(q_s, kk), desc_k(ks, kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)             // dP = dO V^T
      wgmma_ss<64>(ds, desc_k(do_s, kk), desc_k(vs, kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<32>(p);
    if (edge)
      probs_rows_keys<true>(p, lse_s, scale_log2, rows, rpos, rvalid, key0,
                            Tk, causal, lane);
    else
      probs_rows_keys<false>(p, lse_s, scale_log2, rows, rpos, rvalid, key0,
                             Tk, causal, lane);
    wgmma_wait<0>();
    fence_regs<32>(ds);
#pragma unroll
    for (int i = 0; i < 32; ++i)                     // dS = P o (dP - D)
      ds[i] = p[i] * (ds[i] - d_s[rows[(i >> 1) & 1]]);
    uint32_t sa[kTile / 16][4];        // packed before the products issue
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) a_frag(sa[kk], ds, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)          // dQ += dS K
      wgmma_rs<DH>(acc, sa[kk], desc_mn(ks, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DH / 2>(acc);
    __syncthreads();                   // stage t % 2 is consumed
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!rvalid[a]) continue;
    const int r = rows[a];
    const size_t off = (((size_t)b * Tq + pos0 + r / g) * H + kvh * g
                        + r % g) * DH + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + off + n * 8) =
          __floats2bfloat162_rn(acc[4 * n + 2 * a] * scale,
                                acc[4 * n + 2 * a + 1] * scale);
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

// cuTensorMapEncodeTiled, a driver-API call, fetched through the runtime
// (nothing links libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D tensor map of x [B, T, heads, dh] bf16 (innermost first) in
// boxes of 64 columns x bh heads x bt rows, landing in the 128-byte
// swizzle (a box's row is 128 bytes: dh 32 pads with zeros).
bool make_map(CUtensorMap* map, const void* x, int B, int T, int heads,
              int dh, int bh, int bt) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)T * heads * dh * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)bh, (cuuint32_t)bt, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode != nullptr
         && encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(x), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int DV>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* D, void* dq, void* dk, void* dv, int B, int Tq,
                      int Tk, int H, int n_kv, int causal, float scale,
                      cudaStream_t stream) {
  using bf = __nv_bfloat16;
  // The tensor maps are encoded by a driver call, which needs the device's
  // context current on this thread; a thread that has made no runtime call
  // yet (autograd's device thread, say) may not have it.
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = tc_smem_bytes<DH, DV>();
  static bool raised_kv = false, raised_q = false;
  err = raise_smem(bwd_dkdv_wgmma_kernel<DH, DV>, smem, &raised_kv);
  if (err != cudaSuccess) return err;
  err = raise_smem(bwd_dq_wgmma_kernel<DH, DV>, smem, &raised_q);
  if (err != cudaSuccess) return err;
  const int g = H / n_kv;
  const int c = g < kMaxCluster ? g : kMaxCluster;
  const int bq = kTile / g;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_q_rows, tm_do_rows;
  if (!make_map(&tm_q, q, B, Tq, H, DH, 1, kTile)
      || !make_map(&tm_do, dout, B, Tq, H, DV, 1, kTile)
      || !make_map(&tm_k, k, B, Tk, n_kv, DH, 1, kTile)
      || !make_map(&tm_v, v, B, Tk, n_kv, DV, 1, kTile)
      || !make_map(&tm_q_rows, q, B, Tq, H, DH, g, bq)
      || !make_map(&tm_do_rows, dout, B, Tq, H, DV, g, bq))
    return cudaErrorInvalidValue;
  // dQ first: it also writes D, which dK / dV reads.
  bwd_dq_wgmma_kernel<DH, DV><<<((Tq + bq - 1) / bq) * n_kv * B, kThreads,
                                smem, stream>>>(
      tm_q_rows, tm_do_rows, tm_k, tm_v, static_cast<const bf*>(o), lse, D,
      static_cast<bf*>(dq), B, Tq, Tk, H, n_kv, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = c;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * ((Tk + kTile - 1) / kTile) * n_kv * B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bwd_dkdv_wgmma_kernel<DH, DV>, tm_q, tm_do,
                           tm_k,
                           tm_v, lse, static_cast<const float*>(D),
                           static_cast<bf*>(dk), static_cast<bf*>(dv), B, Tq,
                           Tk, H, n_kv, causal, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int DH, int DV>
cudaError_t launch_cc(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* D, void* dq, void* dk, void* dv, int B, int Tq,
                      int Tk, int H, int n_kv, int causal, int is_f32,
                      float scale, cudaStream_t stream) {
  const int rows = B * Tq * H;
  bwd_rowdot_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(o, dout, D, rows, Tq,
                                                        H, DV, is_f32);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = cc_smem_bytes(DH, DV);
  static bool raised_kv = false, raised_q = false;
  err = raise_smem(bwd_dkdv_cc_kernel<DH, DV>, smem, &raised_kv);
  if (err != cudaSuccess) return err;
  err = raise_smem(bwd_dq_cc_kernel<DH, DV>, smem, &raised_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((Tk + kCcTile - 1) / kCcTile, n_kv, B);
  bwd_dkdv_cc_kernel<DH, DV><<<grid_kv, kCcThreads, smem, stream>>>(
      q, k, v, dout, lse, D, dk, dv, Tq, Tk, H, n_kv, causal, is_f32, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((Tq + kCcTile - 1) / kCcTile, H, B);
  bwd_dq_cc_kernel<DH, DV><<<grid_q, kCcThreads, smem, stream>>>(
      q, k, v, dout, lse, D, dq, Tq, Tk, H, n_kv, causal, is_f32, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dq [B, Tq, H, dh]; o, dout [B, Tq, H, dh_v]; k, dk [B, Tk, n_kv, dh];
// v, dv [B, Tk, n_kv, dh_v]; all bf16 (is_f32 = 0) or all f32,
// contiguous; lse f32 [B, H, Tq] from the forward; D f32 [B, H, Tq]
// scratch, written here.  Queries at positions 0 .. Tq - 1; dh_v = dh 16
// or a multiple of 32 up to 256, or dh 192 with dh_v 128 (MLA); H / n_kv
// at most 64.  On `stream`: bf16 at dh = dh_v 32, 64, 96 and 128 and at dh
// 192 / dh_v 128 is two launches (dQ, which also writes D, then dK / dV in
// clusters), the rest three (D, dK / dV, dQ).  Returns the first
// cudaError_t (0 on success).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* D, void* dq, void* dk, void* dv, int B, int Tq,
                        int Tk, int H, int n_kv, int dh, int dh_v, int causal,
                        int is_f32, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = dh * 1024 + dh_v;
  if (!is_f32) {
    switch (key) {
#define TC(D_, DV_)                                                          \
  case D_ * 1024 + DV_:                                                      \
    return (int)launch_tc<D_, DV_>(q, k, v, o, dout, lse, D, dq, dk, dv, B,  \
                                   Tq, Tk, H, n_kv, causal, scale, s);
      TC(32, 32) TC(64, 64) TC(96, 96) TC(128, 128) TC(192, 128)
#undef TC
      default:
        break;
    }
  }
  switch (key) {
#define CC(D_, DV_)                                                          \
  case D_ * 1024 + DV_:                                                      \
    return (int)launch_cc<D_, DV_>(q, k, v, o, dout, lse, D, dq, dk, dv, B,  \
                                   Tq, Tk, H, n_kv, causal, is_f32, scale,   \
                                   s);
    CC(16, 16) CC(32, 32) CC(64, 64) CC(96, 96) CC(128, 128) CC(160, 160)
    CC(192, 192) CC(224, 224) CC(256, 256) CC(192, 128)
#undef CC
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
