// Causal or non-causal GQA flash attention for prefill, full or suffix-only.
// Keys are dh wide and values dh_v wide (dh_v = dh for GQA; MLA's expanded
// prefill has dh 192 = nope 128 + rope 64 and dh_v 128).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py: flash_attention
// (body _flash_kernel).  Computes, for every query row (batch b, position i,
// head h) at absolute position q_offset + i,
//   o = sum_j softmax_j(scale * q . k_j) v_j
// over the keys j < kv_len[b] (all Tk keys without kv_len) and, when causal,
// j <= q_offset + i.  Suffix prefill passes the cached prefix's keys in
// front of the in-flight ones (Tk = P + Tq, q_offset = P); full prefill has
// Tq = Tk and q_offset = 0.  Non-causal calls (an encoder, cross-attention
// over an encoder memory, Tq = 1 at decode) take any Tq and Tk.  Lengths
// need not be multiples of any tile.
//
// What bounds it on the card: operations.  A causal call at the serving
// shapes (Tq = Tk = 1152, 16 heads, head dim 128, bf16) reads ~11 MB and
// does ~5.4 GFLOP, ~1600 flops per byte, far above the ~295 where an H100
// turns compute-bound, so the bf16 arithmetic runs on the tensor cores.
//
// Both paths share the tiling: one CTA per (tile of query positions, KV
// head, batch row) holds all g = H / n_kv query heads of the group for
// 64 / g positions (64 rows; the GQA trick of the Pallas kernel: each K/V
// byte staged in shared memory serves the whole group), walks key tiles of
// 64, and keeps the online-softmax m, l and the f32 output accumulator in
// registers.  Causal CTAs stop at their last row's diagonal and are
// scheduled heaviest first.
//
// Tensor-core path (bf16, head dim 32, 64, 96 or 128, and MLA's dh 192 with
// dh_v 128): four warps of 16 rows each.  The Q tile is loaded once into mma fragments; K/V tiles
// stream through a two-stage cp.async ring in bf16; S = Q K^T and O += P V
// run as mma.sync.m16n8k16 (bf16 in, f32 accumulate), P rounded to bf16 in
// registers straight from the S accumulator fragments, m and l kept per
// row beside them.  wgmma (m64nNk16 from shared memory) is the next step.
//
// CUDA-core path (f32 inputs, which must match their plain version at 2e-5
// and would not in TF32, and bf16 head dims the tensor-core path does not
// take, the smoke configs' 16 among them): 256 threads, each owning a 4 x 4
// block of a tile's scores and a 4-row x dh_v/16-column block of the
// output, f32 FMAs over f32 tiles.
//
// Bitwise contract (the prefix cache relies on it): a row's result does not
// depend on Tq, q_offset's split between prefix and suffix, or which other
// rows share its CTA.  Key tiles start at absolute key positions 0, 64, ...;
// a row's arithmetic is one fixed instruction sequence (on the tensor-core
// path too: an mma's output row depends only on its own A row, and a thread
// owns the same key columns of every row); a tile past a row's diagonal
// that its CTA still processes is an exact no-op for it (m starts at -1e30,
// not -inf, as the Pallas kernel; masked probabilities are exact zeros, so
// alpha = exp(m - m) = 1 and P.V adds exact zeros).  No step depends on
// another row (no tile-wide rescale shortcut).  So the rows of a suffix call
// equal the same rows of the full call bit for bit.
// A row with no valid key returns 0 (l = 0), as the Pallas kernel.
//
// Training (flash_attention_bwd.cu) also needs each row's log-sum-exp of
// its scaled scores, lse = m + log l, f32 [B, H, Tq]: with a non-null lse
// pointer each row's (m, l), already in registers, is written there after
// o.  Nothing before that store changes, so o keeps its bits with or
// without lse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kRows = 64;          // query rows (group heads x positions)
constexpr int kKeys = 64;          // keys per shared-memory tile
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 scores each
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value, not -inf

size_t smem_bytes(int dh, int dh_v) {
  // q^T [dh][kRows], k^T [dh][kKeys], v [kKeys][dh_v], p [kKeys][kRows] in
  // f32.
  return ((size_t)2 * dh * kRows + (size_t)kKeys * dh_v
          + (size_t)kKeys * kRows) * sizeof(float);
}

// Reads the 16 bytes at element offset off of a bf16 (f32 = false) or f32
// array as floats; returns how many (8 or 4).
__device__ __forceinline__ int load16(const void* base, size_t off, bool f32,
                                      float* out) {
  if (f32) {
    const float4 x = *reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + off);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
    return 4;
  }
  const uint4 x = *reinterpret_cast<const uint4*>(
      static_cast<const __nv_bfloat16*>(base) + off);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
  return 8;
}

// Max and sum over the 16 lanes that share a row group (xor shuffles stay
// inside each half-warp; every lane ends with the same bits).
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------- CUDA-core path

// Keys DH wide, values DV wide.  Each thread owns CPT consecutive output
// columns of each of NCH chunks 16 * CPT wide: for DV a multiple of 32,
// columns 32 * c + 2 * tx + {0, 1}; at DV = 16 (the smoke configs' width)
// column tx.
template <int DH, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                       const void* __restrict__ v, void* __restrict__ o,
                       float* __restrict__ lse,
                       const int* __restrict__ kv_len, int Tq, int Tk, int H,
                       int n_kv, int q_offset, int causal, int is_f32,
                       float scale) {
  constexpr int dh = DH;
  constexpr int CPT = DV % 32 == 0 ? 2 : 1;
  constexpr int NCH = DV / (16 * CPT);
  static_assert(NCH * 16 * CPT == DV, "DV is 16 or a multiple of 32");
  extern __shared__ float smem[];
  float* q_s = smem;                  // [dh][kRows], pre-scaled
  float* k_s = q_s + dh * kRows;      // [dh][kKeys]
  float* v_s = k_s + dh * kKeys;      // [kKeys][DV]
  float* p_s = v_s + kKeys * DV;      // [kKeys][kRows]
  const bool f32 = is_f32 != 0;
  const int g = H / n_kv;
  const int bq = kRows / g;           // query positions per CTA
  // Heaviest (latest) causal tiles first: they have the most key tiles.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;            // score key block / output columns
  const int ty = tid / 16;            // rows 4 * ty .. 4 * ty + 3
  const int pos0 = qt * bq;
  const int n_pos = min(bq, Tq - pos0);

  // Row r of the CTA is head kvh * g + r / bq at query index pos0 + r % bq.
  const size_t q_row_stride = (size_t)H * dh;     // between positions
  const size_t o_row_stride = (size_t)H * DV;
  const size_t kv_row_stride = (size_t)n_kv * dh;
  const size_t v_row_stride = (size_t)n_kv * DV;
  const int vec = f32 ? 4 : 8;
  float buf[8];
  for (int i = tid; i < kRows * (dh / vec); i += kThreads) {
    const int r = i % kRows;
    const int c = (i / kRows) * vec;
    const int j = r / bq, p = r % bq;
    if (j < g && p < n_pos) {
      const size_t off = ((size_t)b * Tq + pos0 + p) * q_row_stride
                         + (size_t)(kvh * g + j) * dh + c;
      load16(q, off, f32, buf);
      for (int e = 0; e < vec; ++e) q_s[(c + e) * kRows + r] = buf[e] * scale;
    } else {
      for (int e = 0; e < vec; ++e) q_s[(c + e) * kRows + r] = 0.f;
    }
  }

  int rpos[4];
  bool rvalid[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    rvalid[a] = r / bq < g && r % bq < n_pos;
    rpos[a] = q_offset + pos0 + r % bq;
  }
  float m[4], l[4], acc[4][CPT * NCH];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT * NCH; ++c) acc[a][c] = 0.f;
  }

  const int kvl = kv_len != nullptr ? min(kv_len[b], Tk) : Tk;
  int kend = kvl;                                     // keys [0, kend)
  if (causal) kend = min(kend, q_offset + pos0 + n_pos);
  const int n_tiles = kend > 0 ? (kend + kKeys - 1) / kKeys : 0;

  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  const float4* k4 = reinterpret_cast<const float4*>(k_s);
  const float4* p4 = reinterpret_cast<const float4*>(p_s);
  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * kKeys;
    __syncthreads();  // the previous tile is consumed; q_s is visible
    // K transposed (consecutive threads on consecutive keys: no bank
    // conflicts on the transposing store), V row-major.
    for (int i = tid; i < kKeys * (dh / vec); i += kThreads) {
      const int key = i % kKeys;
      const int c = (i / kKeys) * vec;
      if (key0 + key < Tk) {
        load16(k, ((size_t)b * Tk + key0 + key) * kv_row_stride
                      + (size_t)kvh * dh + c, f32, buf);
      } else {
        for (int e = 0; e < vec; ++e) buf[e] = 0.f;
      }
      for (int e = 0; e < vec; ++e) k_s[(c + e) * kKeys + key] = buf[e];
    }
    for (int i = tid; i < kKeys * (DV / vec); i += kThreads) {
      const int key = i / (DV / vec);
      const int c = (i % (DV / vec)) * vec;
      if (key0 + key < Tk) {
        load16(v, ((size_t)b * Tk + key0 + key) * v_row_stride
                      + (size_t)kvh * DV + c, f32, buf);
      } else {
        for (int e = 0; e < vec; ++e) buf[e] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(v_s + key * DV + c);
      dst[0] = make_float4(buf[0], buf[1], buf[2], buf[3]);
      if (vec == 8) dst[1] = make_float4(buf[4], buf[5], buf[6], buf[7]);
    }
    __syncthreads();

    // Scores of rows 4 ty + a against keys key0 + 4 tx + bb, summed over the
    // head dim in order.
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      const float4 qa = q4[d * (kRows / 4) + ty];
      const float4 kb = k4[d * (kKeys / 4) + tx];
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) s[a][bb] = fmaf(qv[a], kv[bb], s[a][bb]);
    }

    // Online softmax.  Masked scores never enter the max and their
    // probabilities are exact zeros.
    float pr[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int key = key0 + tx * 4 + bb;
        ok[bb] = rvalid[a] && key < kvl && (!causal || key <= rpos[a]);
        if (ok[bb]) mx = fmaxf(mx, s[a][bb]);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        pr[a][bb] = ok[bb] ? expf(s[a][bb] - m_new) : 0.f;
        psum += pr[a][bb];
      }
      psum = group_sum(psum);
      l[a] = l[a] * alpha + psum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < CPT * NCH; ++c) acc[a][c] *= alpha;
    }
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
      reinterpret_cast<float4*>(p_s)[(tx * 4 + bb) * (kRows / 4) + ty] =
          make_float4(pr[0][bb], pr[1][bb], pr[2][bb], pr[3][bb]);
    __syncthreads();

    // acc += P V over the tile's keys in order.
    for (int kk = 0; kk < kKeys; ++kk) {
      const float4 pa = p4[kk * (kRows / 4) + ty];
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      if constexpr (CPT == 2) {
        const float2* vrow = reinterpret_cast<const float2*>(v_s + kk * DV);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float2 vv = vrow[c * 16 + tx];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][2 * c] = fmaf(pv[a], vv.x, acc[a][2 * c]);
            acc[a][2 * c + 1] = fmaf(pv[a], vv.y, acc[a][2 * c + 1]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float vv = v_s[kk * DV + c * 16 + tx];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pv[a], vv, acc[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (!rvalid[a]) continue;
    const int r = ty * 4 + a;
    const size_t off = ((size_t)b * Tq + pos0 + r % bq) * o_row_stride
                       + (size_t)(kvh * g + r / bq) * DV;
    const float den = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if constexpr (CPT == 2) {
        const int col = c * 32 + 2 * tx;
        const float x0 = acc[a][2 * c] / den;
        const float x1 = acc[a][2 * c + 1] / den;
        if (f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(o) + off + col) =
              make_float2(x0, x1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(o) + off + col) =
              __floats2bfloat162_rn(x0, x1);
        }
      } else {
        const int col = c * 16 + tx;
        const float x = acc[a][c] / den;
        if (f32)
          static_cast<float*>(o)[off + col] = x;
        else
          static_cast<__nv_bfloat16*>(o)[off + col] = __float2bfloat16_rn(x);
      }
    }
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + kvh * g + r / bq) * Tq + pos0 + r % bq] =
          m[a] + logf(l[a]);
  }
}

// ------------------------------------------------------ tensor-core path

constexpr int kTcThreads = 128;    // 4 warps x 16 rows
constexpr int kStages = 2;         // K/V ring depth

// Q tile [kRows][dh + 8] and kStages x (K [kKeys][dh + 8], V [kKeys][dh_v
// + 8]) tiles in bf16; the 16-byte row pad keeps ldmatrix's eight row reads
// on distinct banks.
size_t tc_smem_bytes(int dh, int dh_v) {
  return ((size_t)(kRows + kStages * kKeys) * (dh + 8)
          + (size_t)kStages * kKeys * (dh_v + 8)) * sizeof(__nv_bfloat16);
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Warp w owns rows 16 w .. 16 w + 15; in an m16n8 fragment lane holds rows
// lane / 4 and lane / 4 + 8 (a = 0, 1) and columns 2 (lane % 4) + {0, 1} of
// each 8-column tile.  scale_log2 = scale * log2(e): scores live in base 2.
template <int DH, int DV>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse,
                          const int* __restrict__ kv_len, int Tq, int Tk,
                          int H, int n_kv, int q_offset, int causal,
                          float scale_log2) {
  constexpr int S = DH + 8;        // Q / K shared-memory row stride
  constexpr int SV = DV + 8;       // V shared-memory row stride
  constexpr int KS = DH / 16;      // k steps of Q K^T
  constexpr int NT = DV / 8;       // 8-column tiles of the output
  constexpr int CPR = DH / 8;      // 16-byte pieces per Q / K row
  constexpr int CPRV = DV / 8;     // 16-byte pieces per V row
  constexpr int ST = kKeys / 8;    // 8-key tiles of a score tile
  constexpr int STAGE = kKeys * (S + SV);  // elements of one (K, V) stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // [kStages][K [kKeys][S], V [kKeys][SV]]
  __nv_bfloat16* kv_s = q_s + kRows * S;
  const int g = H / n_kv;
  const int bq = kRows / g;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int pos0 = qt * bq;
  const int n_pos = min(bq, Tq - pos0);
  const size_t q_row_stride = (size_t)H * DH;
  const size_t o_row_stride = (size_t)H * DV;
  const size_t kv_row_stride = (size_t)n_kv * DH;
  const size_t v_row_stride = (size_t)n_kv * DV;

  // Row r is head kvh * g + r / bq at query index pos0 + r % bq; rows past
  // the group or the call are zero.
  for (int i = tid; i < kRows * CPR; i += kTcThreads) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const int j = r / bq, p = r % bq;
    const bool ok = j < g && p < n_pos;
    const __nv_bfloat16* src =
        ok ? q + ((size_t)b * Tq + pos0 + p) * q_row_stride
                 + (size_t)(kvh * g + j) * DH + c
           : q;
    cp_async16(q_s + r * S + c, src, ok);
  }

  const int kvl = kv_len != nullptr ? min(kv_len[b], Tk) : Tk;
  int kend = kvl;                                     // keys [0, kend)
  if (causal) kend = min(kend, q_offset + pos0 + n_pos);
  const int n_tiles = kend > 0 ? (kend + kKeys - 1) / kKeys : 0;

  // Keys past Tk are zero-filled (and masked); keys in [kvl, Tk) are read
  // and masked.
  auto load_tile = [&](int t, int stage) {
    __nv_bfloat16* ks = kv_s + (size_t)stage * STAGE;
    __nv_bfloat16* vs = ks + kKeys * S;
    const int key0 = t * kKeys;
    for (int i = tid; i < kKeys * CPR; i += kTcThreads) {
      const int key = i / CPR;
      const int c = (i % CPR) * 8;
      const bool ok = key0 + key < Tk;
      const size_t off =
          ok ? ((size_t)b * Tk + key0 + key) * kv_row_stride
                   + (size_t)kvh * DH + c
             : 0;
      cp_async16(ks + key * S + c, k + off, ok);
      if constexpr (DV == DH) cp_async16(vs + key * SV + c, v + off, ok);
    }
    if constexpr (DV != DH) {
      for (int i = tid; i < kKeys * CPRV; i += kTcThreads) {
        const int key = i / CPRV;
        const int c = (i % CPRV) * 8;
        const bool ok = key0 + key < Tk;
        const size_t off =
            ok ? ((size_t)b * Tk + key0 + key) * v_row_stride
                     + (size_t)kvh * DV + c
               : 0;
        cp_async16(vs + key * SV + c, v + off, ok);
      }
    }
  };
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();                   // group 0: Q and the first tile

  int rpos[2];
  bool rvalid[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = warp * 16 + lane / 4 + 8 * a;
    rvalid[a] = r / bq < g && r % bq < n_pos;
    rpos[a] = q_offset + pos0 + r % bq;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};             // this lane's columns only
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[KS][4];

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1, (t + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();                // tile t (and Q) have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], q_s + (warp * 16 + lane % 8 + ((lane / 8) & 1) * 8)
                                  * S + kk * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* ks = kv_s + (size_t)(t % kStages) * STAGE;
    const __nv_bfloat16* vs = ks + kKeys * S;

    // S = Q K^T over the head dim, 16 at a time.
    float s[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, ks + (np * 16 + lane % 8 + (lane / 16) * 8) * S
                        + kk * 16 + ((lane / 8) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // Online softmax per row.  A masked score becomes -inf, whose
    // probability exp2(-inf - m) is an exact zero and which never wins the
    // max (mx starts at -1e30).  A tile below every row's diagonal and
    // inside kv_len masks no valid row, so it skips the tests (the rows of
    // the CTA past the call compute garbage that is never stored).
    const int key0 = t * kKeys;
    const bool inside = key0 + kKeys <= kvl
                        && (!causal || key0 + kKeys - 1 <= q_offset + pos0);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + n * 8 + 2 * (lane % 4) + e;
          const bool ok = inside || (rvalid[a] && key < kvl
                                     && (!causal || key <= rpos[a]));
          const float x = ok ? s[n][2 * a + e] * scale_log2 : -INFINITY;
          s[n][2 * a + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = exp2f(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < ST; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[n][2 * a + e] - m_new);
          s[n][2 * a + e] = p;
          psum += p;
        }
      l[a] = l[a] * alpha + psum;
      m[a] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * a] *= alpha;
        acc[n][2 * a + 1] *= alpha;
      }
    }

    // O += P V: the S fragments of key tiles 2 kk and 2 kk + 1 are the A
    // fragment of keys 16 kk .. 16 kk + 15.
#pragma unroll
    for (int kk = 0; kk < ST / 2; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vs + (kk * 16 + lane % 8 + ((lane / 8) & 1) * 8)
                                   * SV + np * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();                   // stage t % kStages is consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float lsum = l[a] + __shfl_xor_sync(0xffffffffu, l[a], 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    if (!rvalid[a]) continue;
    const int r = warp * 16 + lane / 4 + 8 * a;
    const size_t off = ((size_t)b * Tq + pos0 + r % bq) * o_row_stride
                       + (size_t)(kvh * g + r / bq) * DV;
    const float den = fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(o + off + n * 8 + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[n][2 * a] / den,
                                acc[n][2 * a + 1] / den);
    }
    // m is in base 2 (scores times log2 e): lse = (m + log2 l) ln 2.
    if (lse != nullptr && lane % 4 == 0)
      lse[((size_t)b * H + kvh * g + r / bq) * Tq + pos0 + r % bq] =
          (m[a] + log2f(lsum)) * 0.6931471805599453f;
  }
}

template <int DH, int DV>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, const int* kv_len, int B, int Tq, int Tk, int H,
                      int n_kv, int q_offset, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(DH, DV);
  static bool smem_raised = false;     // see launch() below
  if (smem > 48 * 1024 && !smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc_kernel<DH, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const int bq = kRows / (H / n_kv);
  const dim3 grid((Tq + bq - 1) / bq, n_kv, B);
  flash_attention_tc_kernel<DH, DV><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, kv_len, Tq, Tk, H, n_kv, q_offset, causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int DH, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* kv_len, int B, int Tq, int Tk, int H, int n_kv,
                   int q_offset, int causal, int is_f32, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(DH, DV);
  // Raised once per instantiation, at its first launch, so that a later
  // launch inside a CUDA-graph capture makes no attribute call.
  static bool smem_raised = false;
  if (smem > 48 * 1024 && !smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<DH, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const int bq = kRows / (H / n_kv);
  const dim3 grid((Tq + bq - 1) / bq, n_kv, B);
  flash_attention_kernel<DH, DV><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, kv_len, Tq, Tk, H, n_kv, q_offset, causal, is_f32,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Tq, H, dh], k [B, Tk, n_kv, dh], v [B, Tk, n_kv, dh_v], o [B, Tq,
// H, dh_v], all bf16 (is_f32 = 0) or all f32; lse f32 [B, H, Tq] or null
// (written when given); kv_len int32 [B] or null;
// dh_v = dh 16 or a multiple of 32 up to 256, or dh 192 with dh_v 128
// (MLA);
// H / n_kv at most 64.  bf16 at dh = dh_v 32, 64, 96 or 128 and at dh 192 /
// dh_v 128 runs the tensor-core path, the rest the CUDA-core path.  Returns
// the launch's cudaError_t (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        float* lse, const int* kv_len, int B, int Tq, int Tk, int H,
                        int n_kv, int dh, int dh_v, int q_offset, int causal,
                        int is_f32, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = dh * 1024 + dh_v;
  if (!is_f32) {
    switch (key) {
#define TC(D, DV)                                                            \
  case D * 1024 + DV:                                                        \
    return (int)launch_tc<D, DV>(q, k, v, o, lse, kv_len, B, Tq, Tk, H,      \
                                 n_kv, q_offset, causal, scale, s);
      TC(32, 32) TC(64, 64) TC(96, 96) TC(128, 128) TC(192, 128)
#undef TC
      default:
        break;
    }
  }
  switch (key) {
#define CASE(D, DV)                                                          \
  case D * 1024 + DV:                                                        \
    return (int)launch<D, DV>(q, k, v, o, lse, kv_len, B, Tq, Tk, H, n_kv,   \
                              q_offset, causal, is_f32, scale, s);
    CASE(16, 16) CASE(32, 32) CASE(64, 64) CASE(96, 96) CASE(128, 128)
    CASE(160, 160) CASE(192, 192) CASE(224, 224) CASE(256, 256)
    CASE(192, 128)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
