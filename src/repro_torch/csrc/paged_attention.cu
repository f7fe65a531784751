// Paged decode attention over a Mosaic KV pool, both granularities.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:
// paged_attention_kernel (bodies _paged_kernel and _flash_step), for
// granularity "page" (one block = one base page of ptok tokens) and "frame"
// (one block = one coalesced, aligned frame of frame_pages pages, read from
// one frame-table entry).  Both views address the pool the same way: token t
// of block entry e lives at row e * tokens_per_block + t of the pool viewed
// as [rows, n_kv, dh].
//
// Computes, per (row b, query head h), the unnormalized flash partials
//   m = max_j s_j,  l = sum_j exp(s_j - m),  o = sum_j exp(s_j - m) v_j
// over the valid tokens of the blocks named by tables[b, :] (-1 = hole,
// ntok[b, blk] valid tokens), with s_j = (scale * q) . k_j.  A row made only
// of holes gives m = -1e30, l = 0, o = 0, as the TPU kernel does.
//
// What bounds it on the card: bytes.  Each step reads the K and V of every
// valid token once (2 * tokens * dh * 2 bytes per KV head) and does ~4 * g
// flops per element read, far below the ~295 flops/byte where an H100 turns
// compute-bound; the CUDA cores suffice.  What it needs is enough CTAs in
// flight: decode has few rows (B * n_kv is 8 for qwen2.5-3b at B = 4), so
// the KV walk is split (flash-decoding), in two launches:
//
// 1. partials, grid (split, n_kv, B): table token position p of a row is
//    block p / tokens_per_block, token p % tokens_per_block, and split s
//    walks the positions [s * kSpan, (s + 1) * kSpan), kSpan = 64.  Its
//    256 threads map the span's positions to pool rows (holes and the
//    invalid tail of a partial block map to none) and stage the valid
//    rows' K and V in their own dtype with 16-byte cp.async (kChunk
//    positions a step; chunks beyond the first would stream through a
//    two-buffer ring; chunks without a valid token are skipped, so a span
//    of holes loads nothing).  Warp w takes positions w, w + 8, ... of the
//    span, its lanes split the head dim, and it keeps its own (m, l, o) for
//    all g query heads, 4 heads per register pass, so each staged byte
//    serves every head and g = 1 still uses the whole CTA.  The eight
//    warps' partials are folded in warp order into the split's (o, m, l)
//    in f32 scratch.  (Spans of 64 with one chunk, 8 warps and 4-head
//    passes were the fastest of 7 variants timed on an H100; the CTA's
//    serial work per warp sets its latency, and decode has few CTAs.)
// 2. combine, one CTA per (row, head): the global max over the splits
//    first, then l and o summed in split order.
//
// Every step's order is a function of the row's table token positions
// alone, never of B, page ids, staging slots or other rows, and a split,
// chunk or warp without valid tokens adds exact zeros (m = -1e30, l = 0,
// o = 0; exp(-1e30 - M) = 0).  So a row's result is the same bits in any
// batch, at any page ids, with any table width, and the fused variant
// below is bitwise this kernel on the same bytes.
//
// MLA's absorbed decode (K 576 = latent 512 + rope 64 wide, V the 512-wide
// latent, one KV head for 16 query heads) takes a partials kernel of its
// own, paged_mla_partial_kernel, at the same spans and into the same
// scratch, so the combine launch and the split contract are unchanged.  Its
// 16 heads share every K/V byte and make one 16-row tile: S = Q K^T and
// O = P V run as mma.sync.m16n8k16 (bf16 in, f32 accumulate; M = the 16
// heads), the whole span's K (74 KB) and V (67 KB) are staged at once in
// shared memory (the dynamic shared-memory attribute is raised before the
// first launch), K in one cp.async group and V in the next so that the
// scores overlap V's arrival, and the 512 output columns are split over
// the eight warps (64 each, 32 f32 accumulators a lane).  Per span the
// scores are complete before the softmax, so m and l are exact f32 over
// the span (l from the f32 probabilities) and only P enters the P V
// product rounded to bf16, as in the flash kernel's tensor-core path.  It
// is still bound by bytes: 2 x 16 x 1088 flops per token over its 2,176
// bytes, far below the ridge.
//
// Fused gather-attend (entry fused_paged_attention_fwd) replaces the TPU
// kernel repro/kernels/paged_attention.py: fused_paged_attention_kernel (body
// _fused_kernel).  It is the page-granularity kernel above with one change,
// the template flag kFused: page blk of row b is read from the staging pool
// at stage[slots[b, blk]] when that slot is >= 0 (a page that arrived from
// the host this step and has not been scattered into the pool yet) and from
// pool[tables[b, blk]] otherwise.  Only the base pointer of a row of K/V
// differs; the instruction sequence that does the arithmetic is the same,
// so there is one accumulator in canonical table order.  The TPU kernel
// instead keeps two accumulators (ready and late pages) and combines them
// at the flush, which is what its readiness_meta bookkeeping serves; with
// one accumulator the result is bitwise the page kernel's when every slot
// is -1 or when the staged bytes equal the pool's, which keeps decode
// tokens identical across the engine's sync, async and fused modes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSpan = 64;            // table token positions per split
constexpr int kChunk = 64;           // positions staged per step
constexpr int kChunks = kSpan / kChunk;
constexpr int kBufs = kChunks > 1 ? 2 : 1;  // K/V ring depth
constexpr int kPerWarp = kChunk / kWarps;  // positions of a chunk per warp
constexpr float kNegInf = -1e30f;    // the TPU kernel's mask value, not -inf
static_assert(kSpan % kChunk == 0 && kChunks <= kThreads, "span layout");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// K and V ring [kBufs][K, V][kChunk][dh] in the pools' dtype, then f32
// q [g][dh] (pre-scaled), per-warp o [kWarps][g][dh], m and l [kWarps][g],
// then the span's source rows and staged flags [kSpan] as ints.
size_t partial_smem_bytes(int g, int dh, size_t elem) {
  return 2 * kBufs * (size_t)kChunk * dh * elem
         + ((size_t)g * dh + (size_t)kWarps * g * (dh + 2)) * sizeof(float)
         + 2 * (size_t)kSpan * sizeof(int);
}

// NC = ceil(DH / 32): lane owns head dims lane + 32 c < DH, c < NC (at
// DH = 16, the smoke configs' width, lanes 16-31 own none and add zeros).
template <typename T, bool kFused, int DH>
__global__ void __launch_bounds__(kThreads)
paged_partial_kernel(const void* __restrict__ q, int q_is_f32,
                     const T* __restrict__ pool_k,
                     const T* __restrict__ pool_v,
                     const T* __restrict__ stage_k,
                     const T* __restrict__ stage_v,
                     const int* __restrict__ tables,
                     const int* __restrict__ slots,
                     const int* __restrict__ ntok,
                     float* __restrict__ part_o, float* __restrict__ part_m,
                     float* __restrict__ part_l, int H, int n_kv, int nblk,
                     int tokens_per_block, float scale) {
  constexpr int dh = DH;
  constexpr int NC = (DH + 31) / 32;
  constexpr int HB = 4;                  // query heads per register pass
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte copy
  constexpr int VPR = dh / kVec;         // 16-byte copies per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int chunk_valid[kChunks];
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / n_kv;
  const int h0 = kvh * g;  // query heads h0 .. h0+g-1 share this KV head
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // Whether head dim cc * 32 + lane exists (always, for DH % 32 == 0).
  auto owns = [&](int cc) { return DH % 32 == 0 || cc * 32 + lane < DH; };

  T* kv_s = reinterpret_cast<T*>(smem_raw);     // [kBufs][2][kChunk][dh]
  float* q_s = reinterpret_cast<float*>(kv_s + 2 * kBufs * kChunk * dh);
  float* o_s = q_s + g * dh;                               // [kWarps][g][dh]
  float* m_s = o_s + kWarps * g * dh;                      // [kWarps][g]
  float* l_s = m_s + kWarps * g;                           // [kWarps][g]
  int* row_s = reinterpret_cast<int*>(l_s + kWarps * g);   // [kSpan]
  int* stg_s = row_s + kSpan;                              // [kSpan]

  // Map the span's positions to pool (or stage) rows; -1: no valid token.
  if (tid < kChunks) chunk_valid[tid] = 0;
  __syncthreads();
  for (int i = tid; i < kSpan; i += kThreads) {
    const int p = split * kSpan + i;
    int row = -1, staged = 0;
    if (p < nblk * tokens_per_block) {
      const int blk = p / tokens_per_block;
      const int t = p - blk * tokens_per_block;
      const int entry = tables[b * nblk + blk];
      const int nt = min(ntok[b * nblk + blk], tokens_per_block);
      if (entry >= 0 && t < nt) {
        row = entry * tokens_per_block + t;
        if constexpr (kFused) {
          const int slot = slots[b * nblk + blk];
          if (slot >= 0) {         // staged this step: read it where it landed
            row = slot * tokens_per_block + t;
            staged = 1;
          }
        }
      }
    }
    row_s[i] = row;
    stg_s[i] = staged;
    if (row >= 0) chunk_valid[i / kChunk] = 1;
  }
  __syncthreads();

  const size_t out_rows = ((size_t)b * H + h0) * nsplit + split;  // head h0
  int first = 0;
  while (first < kChunks && !chunk_valid[first]) ++first;
  if (first == kChunks) {          // only holes: nothing is loaded
    for (int i = tid; i < g * dh; i += kThreads)
      part_o[(out_rows + (size_t)(i / dh) * nsplit) * dh + i % dh] = 0.f;
    for (int i = tid; i < g; i += kThreads) {
      part_m[out_rows + (size_t)i * nsplit] = kNegInf;
      part_l[out_rows + (size_t)i * nsplit] = 0.f;
    }
    return;
  }

  const size_t row_stride = (size_t)n_kv * dh;  // elements between tokens
  auto load_chunk = [&](int c, int buf) {
    T* ks = kv_s + (size_t)buf * 2 * kChunk * dh;
    T* vs = ks + kChunk * dh;
    for (int i = tid; i < kChunk * VPR; i += kThreads) {
      const int j = i / VPR;
      const int e = (i % VPR) * kVec;
      const int row = row_s[c * kChunk + j];
      if (row < 0) continue;       // holes and invalid tails: never loaded
      const T* src_k = pool_k;
      const T* src_v = pool_v;
      if constexpr (kFused) {
        if (stg_s[c * kChunk + j]) {
          src_k = stage_k;
          src_v = stage_v;
        }
      }
      const size_t off = (size_t)row * row_stride + (size_t)kvh * dh + e;
      cp_async16(ks + j * dh + e, src_k + off);
      cp_async16(vs + j * dh + e, src_v + off);
    }
  };
  auto next_valid = [&](int c) {
    while (c < kChunks && !chunk_valid[c]) ++c;
    return c;
  };

  load_chunk(first, 0);
  cp_async_commit();
  const size_t q0 = ((size_t)b * H + h0) * dh;
  for (int i = tid; i < g * dh; i += kThreads)
    q_s[i] = (q_is_f32 ? static_cast<const float*>(q)[q0 + i]
                       : __bfloat162float(
                             static_cast<const __nv_bfloat16*>(q)[q0 + i]))
             * scale;
  for (int i = tid; i < kWarps * g * dh; i += kThreads) o_s[i] = 0.f;
  for (int i = tid; i < kWarps * g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  int buf = 0;
  for (int c = first; c < kChunks;) {
    const int cn = next_valid(c + 1);
    if (cn < kChunks) load_chunk(cn, (buf + 1) % kBufs);
    cp_async_commit();
    cp_async_wait<1>();            // chunk c has landed
    __syncthreads();
    const T* ks = kv_s + (size_t)buf * 2 * kChunk * dh;
    const T* vs = ks + kChunk * dh;
    bool valid[kPerWarp];
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i)
      valid[i] = row_s[c * kChunk + warp + kWarps * i] >= 0;
    for (int hb = 0; hb < g; hb += HB) {
      float qr[HB][NC];
#pragma unroll
      for (int hh = 0; hh < HB; ++hh)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          qr[hh][cc] = hb + hh < g && owns(cc)
                           ? q_s[(hb + hh) * dh + cc * 32 + lane] : 0.f;
      // Scores of this warp's positions; -inf where there is no token.
      float s[kPerWarp][HB];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        if (valid[i]) {
          const T* kr = ks + (warp + kWarps * i) * dh;
          float kv[NC];
#pragma unroll
          for (int cc = 0; cc < NC; ++cc)
            kv[cc] = owns(cc) ? to_float(kr[cc * 32 + lane]) : 0.f;
#pragma unroll
          for (int hh = 0; hh < HB; ++hh) {
            if (hb + hh >= g) {    // past the group (g < HB): no work
              s[i][hh] = -INFINITY;
              continue;
            }
            float part = 0.f;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc)
              part = fmaf(qr[hh][cc], kv[cc], part);
            s[i][hh] = warp_sum(part);
          }
        } else {
#pragma unroll
          for (int hh = 0; hh < HB; ++hh) s[i][hh] = -INFINITY;
        }
      }
      // Online softmax per head over the warp's positions, in order.
      float alpha[HB], acc[HB][NC];
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        const int h = min(hb + hh, g - 1);  // heads past g: not kept
        const int st = warp * g + h;
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < kPerWarp; ++i) mx = fmaxf(mx, s[i][hh]);
        const float m_old = m_s[st];
        const float m_new = fmaxf(m_old, mx);
        alpha[hh] = expf(m_old - m_new);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < kPerWarp; ++i) {
          s[i][hh] = expf(s[i][hh] - m_new);   // exp(-inf) = 0 exactly
          psum += s[i][hh];
        }
        const float l_new = l_s[st] * alpha[hh] + psum;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          acc[hh][cc] = owns(cc) ? o_s[st * dh + cc * 32 + lane] * alpha[hh]
                                 : 0.f;
        __syncwarp();
        if (lane == 0 && hb + hh < g) {
          m_s[st] = m_new;
          l_s[st] = l_new;
        }
      }
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        if (!valid[i]) continue;
        const T* vr = vs + (warp + kWarps * i) * dh;
        float vv[NC];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          vv[cc] = owns(cc) ? to_float(vr[cc * 32 + lane]) : 0.f;
#pragma unroll
        for (int hh = 0; hh < HB; ++hh) {
          if (hb + hh >= g) continue;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc)
            acc[hh][cc] = fmaf(s[i][hh], vv[cc], acc[hh][cc]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        if (hb + hh >= g) continue;
        const int st = warp * g + hb + hh;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          if (owns(cc)) o_s[st * dh + cc * 32 + lane] = acc[hh][cc];
      }
    }
    __syncthreads();               // buffer buf is consumed
    c = cn;
    buf = (buf + 1) % kBufs;
  }
  cp_async_wait<0>();

  // Fold the warps' partials in warp order.
  for (int i = tid; i < g * dh; i += kThreads) {
    const int h = i / dh;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * g + h]);
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      acc = fmaf(o_s[(w * g) * dh + i], expf(m_s[w * g + h] - mx), acc);
    part_o[(out_rows + (size_t)h * nsplit) * dh + i % dh] = acc;
  }
  for (int h = tid; h < g; h += kThreads) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * g + h]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum = fmaf(l_s[w * g + h], expf(m_s[w * g + h] - mx), sum);
    part_m[out_rows + (size_t)h * nsplit] = mx;
    part_l[out_rows + (size_t)h * nsplit] = sum;
  }
}

// ------------------------------------------------------------ MLA path

constexpr int kMlaHeads = 16;          // query heads per CTA: one mma tile
constexpr int kMlaWarps = 8;
static_assert(kSpan % 32 == 0, "MLA spans hold whole warps of positions");

// Q [16][DK + 8], K [kSpan][DK + 8], V [kSpan][DV + 8] and P [16][kSpan + 8]
// in bf16 (16-byte row pads keep ldmatrix's row reads on distinct banks),
// then scores [16][kSpan], m and l [16] in f32 and the span's source rows
// [kSpan] as ints.
size_t mla_smem_bytes(int dk, int dv) {
  return ((size_t)(kMlaHeads + kSpan) * (dk + 8) + (size_t)kSpan * (dv + 8)
          + (size_t)kMlaHeads * (kSpan + 8)) * sizeof(__nv_bfloat16)
         + ((size_t)kMlaHeads * kSpan + 2 * kMlaHeads) * sizeof(float)
         + (size_t)kSpan * sizeof(int);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with ok false it reads nothing and zero-fills.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
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

// Grid (split, n_kv * ceil(g / 16), B): CTA (s, kvh * tiles + t, b) owns
// query heads kvh * g + 16 t .. + 15 (rows past the group are zero and not
// stored) over span s of row b.  In an m16n8 fragment a lane holds rows
// lane / 4 and lane / 4 + 8 and columns 2 (lane % 4) + {0, 1}.
template <int DK, int DV>
__global__ void __launch_bounds__(kMlaWarps * 32)
paged_mla_partial_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ pool_k,
                         const __nv_bfloat16* __restrict__ pool_v,
                         const int* __restrict__ tables,
                         const int* __restrict__ ntok,
                         float* __restrict__ part_o,
                         float* __restrict__ part_m,
                         float* __restrict__ part_l, int H, int n_kv,
                         int nblk, int tokens_per_block, float scale) {
  constexpr int SK = DK + 8;           // Q / K row stride (elements)
  constexpr int SV = DV + 8;           // V row stride
  constexpr int SP = kSpan + 8;        // P row stride
  constexpr int COLS = DV / kMlaWarps; // output columns per warp
  static_assert(DK % 32 == 0 && COLS % 16 == 0, "MLA tile layout");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kMlaHeads * SK;
  __nv_bfloat16* v_s = k_s + kSpan * SK;
  __nv_bfloat16* p_s = v_s + kSpan * SV;
  float* s_s = reinterpret_cast<float*>(p_s + kMlaHeads * SP);
  float* m_s = s_s + kMlaHeads * kSpan;
  float* l_s = m_s + kMlaHeads;
  int* row_s = reinterpret_cast<int*>(l_s + kMlaHeads);
  __shared__ int any_valid;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int g = H / n_kv;
  const int tiles = (g + kMlaHeads - 1) / kMlaHeads;
  const int kvh = blockIdx.y / tiles;
  const int r0 = (blockIdx.y % tiles) * kMlaHeads;  // first row in the group
  const int rows = min(kMlaHeads, g - r0);
  const int h0 = kvh * g + r0;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (tid == 0) any_valid = 0;
  __syncthreads();
  for (int i = tid; i < kSpan; i += kMlaWarps * 32) {
    const int p = split * kSpan + i;
    int row = -1;
    if (p < nblk * tokens_per_block) {
      const int blk = p / tokens_per_block;
      const int t = p - blk * tokens_per_block;
      const int entry = tables[b * nblk + blk];
      if (entry >= 0 && t < min(ntok[b * nblk + blk], tokens_per_block))
        row = entry * tokens_per_block + t;
    }
    row_s[i] = row;
    if (row >= 0) any_valid = 1;
  }
  __syncthreads();

  const size_t out_rows = ((size_t)b * H + h0) * nsplit + split;  // head h0
  if (!any_valid) {                    // only holes: nothing is loaded
    for (int i = tid; i < rows * DV; i += kMlaWarps * 32)
      part_o[(out_rows + (size_t)(i / DV) * nsplit) * DV + i % DV] = 0.f;
    for (int i = tid; i < rows; i += kMlaWarps * 32) {
      part_m[out_rows + (size_t)i * nsplit] = kNegInf;
      part_l[out_rows + (size_t)i * nsplit] = 0.f;
    }
    return;
  }

  // Group 0: Q and K; group 1: V.  Positions without a token, and rows past
  // the group, are zero-filled (masked scores, zero P V terms).
  const size_t kstride = (size_t)n_kv * DK;
  const size_t vstride = (size_t)n_kv * DV;
  for (int i = tid; i < kMlaHeads * (DK / 8); i += kMlaWarps * 32) {
    const int r = i / (DK / 8);
    const int c = (i % (DK / 8)) * 8;
    const bool ok = r < rows;
    cp_async16_zfill(q_s + r * SK + c,
                     q + (ok ? ((size_t)b * H + h0 + r) * DK + c : 0), ok);
  }
  for (int i = tid; i < kSpan * (DK / 8); i += kMlaWarps * 32) {
    const int j = i / (DK / 8);
    const int c = (i % (DK / 8)) * 8;
    const int row = row_s[j];
    cp_async16_zfill(k_s + j * SK + c,
                     pool_k + (row >= 0 ? row * kstride + kvh * DK + c : 0),
                     row >= 0);
  }
  cp_async_commit();
  for (int i = tid; i < kSpan * (DV / 8); i += kMlaWarps * 32) {
    const int j = i / (DV / 8);
    const int c = (i % (DV / 8)) * 8;
    const int row = row_s[j];
    cp_async16_zfill(v_s + j * SV + c,
                     pool_v + (row >= 0 ? row * vstride + kvh * DV + c : 0),
                     row >= 0);
  }
  cp_async_commit();
  cp_async_wait<1>();                  // Q and K have landed
  __syncthreads();

  // Scores: warp w takes the 8-key tiles w, w + 8, ...; two k steps of 16
  // per ldmatrix of K.
  const int qrow = lane % 8 + ((lane / 8) & 1) * 8;
  for (int nt = warp; nt < kSpan / 8; nt += kMlaWarps) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
    for (int kk = 0; kk < DK / 16; kk += 2) {
      uint32_t a0[4], a1[4], bk[4];
      ldsm_x4(a0, q_s + qrow * SK + kk * 16 + (lane / 16) * 8);
      ldsm_x4(a1, q_s + qrow * SK + (kk + 1) * 16 + (lane / 16) * 8);
      ldsm_x4(bk, k_s + (nt * 8 + lane % 8) * SK + kk * 16 + (lane / 8) * 8);
      mma_bf16(acc, a0, bk[0], bk[1]);
      mma_bf16(acc, a1, bk[2], bk[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = lane / 4 + 8 * (e / 2);
      const int j = nt * 8 + 2 * (lane % 4) + e % 2;
      s_s[r * kSpan + j] = row_s[j] >= 0 ? acc[e] * scale : -INFINITY;
    }
  }
  __syncthreads();

  // Softmax over the span, per head: warp w takes rows 2 w and 2 w + 1.
#pragma unroll
  for (int rr = 0; rr < kMlaHeads / kMlaWarps; ++rr) {
    const int r = warp * (kMlaHeads / kMlaWarps) + rr;
    float mx = kNegInf;
#pragma unroll
    for (int j = lane; j < kSpan; j += 32) mx = fmaxf(mx, s_s[r * kSpan + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float psum = 0.f;
#pragma unroll
    for (int j = lane; j < kSpan; j += 32) {
      const float pr = expf(s_s[r * kSpan + j] - mx);  // exp(-inf) = 0
      p_s[r * SP + j] = __float2bfloat16(pr);
      psum += pr;
    }
    psum = warp_sum(psum);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = psum;
    }
  }
  cp_async_wait<0>();                  // V has landed
  __syncthreads();

  // O = P V over this warp's COLS columns.
  float acc[COLS / 8][4];
#pragma unroll
  for (int n = 0; n < COLS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int c0 = warp * COLS;
#pragma unroll
  for (int ks = 0; ks < kSpan / 16; ++ks) {
    uint32_t pa[4];
    ldsm_x4(pa, p_s + qrow * SP + ks * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < COLS / 16; ++np) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, v_s + (ks * 16 + qrow) * SV + c0 + np * 16
                            + (lane / 16) * 8);
      mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
      mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int r = lane / 4 + 8 * a;
    if (r >= rows) continue;
    float* dst = part_o + (out_rows + (size_t)r * nsplit) * DV + c0
                 + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < COLS / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(acc[n][2 * a], acc[n][2 * a + 1]);
  }
  for (int r = tid; r < rows; r += kMlaWarps * 32) {
    part_m[out_rows + (size_t)r * nsplit] = m_s[r];
    part_l[out_rows + (size_t)r * nsplit] = l_s[r];
  }
}

template <int DK, int DV>
cudaError_t launch_mla(const void* q, const void* pool_k, const void* pool_v,
                       const int* tables, const int* ntok, float* scratch,
                       int B, int H, int n_kv, int nblk,
                       int tokens_per_block, float scale, int nsplit,
                       cudaStream_t stream) {
  const size_t smem = mla_smem_bytes(DK, DV);
  static bool smem_raised = false;     // see launch_nc()
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_mla_partial_kernel<DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const size_t parts = (size_t)B * H * nsplit;
  const int g = H / n_kv;
  const dim3 grid(nsplit, n_kv * ((g + kMlaHeads - 1) / kMlaHeads), B);
  paged_mla_partial_kernel<DK, DV><<<grid, kMlaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), tables, ntok, scratch,
      scratch + parts * DV, scratch + parts * (DV + 1), H, n_kv, nblk,
      tokens_per_block, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------ combine

// One CTA of dh threads per (row, head): the max over the splits, each
// split's weight exp(m_s - max) once, then l and o summed in split order.
// A row of holes (or nsplit = 0) gives m = -1e30, l = 0, o = 0.
__global__ void paged_combine_kernel(const float* __restrict__ part_o,
                                     const float* __restrict__ part_m,
                                     const float* __restrict__ part_l,
                                     float* __restrict__ o,
                                     float* __restrict__ m,
                                     float* __restrict__ l, int nsplit,
                                     int dh) {
  extern __shared__ float w_s[];       // [nsplit] weights, [nsplit] l
  float* l_s = w_s + nsplit;
  __shared__ float mx_s;
  const size_t bh = blockIdx.x;
  const float* pm = part_m + bh * nsplit;
  if (threadIdx.x < 32) {              // the max is exact in any order
    float mx = kNegInf;
    for (int s = threadIdx.x; s < nsplit; s += 32) mx = fmaxf(mx, pm[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (threadIdx.x == 0) mx_s = mx;
  }
  __syncthreads();
  const float mx = mx_s;
  const float* pl = part_l + bh * nsplit;
  for (int s = threadIdx.x; s < nsplit; s += blockDim.x) {
    w_s[s] = expf(pm[s] - mx);
    l_s[s] = pl[s];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float acc = 0.f;
#pragma unroll 32   // up to 32 splits' loads in flight at once
    for (int s = 0; s < nsplit; ++s)
      acc = fmaf(part_o[(bh * nsplit + s) * dh + d], w_s[s], acc);
    o[bh * dh + d] = acc;
  }
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int s = 0; s < nsplit; ++s) sum = fmaf(l_s[s], w_s[s], sum);
    m[bh] = mx;
    l[bh] = sum;
  }
}

// The second launch: partials [B * H * nsplit] x (o [dh], m, l) -> o, m, l.
cudaError_t combine(float* o, float* m, float* l, const float* scratch,
                    int B, int H, int dh, int nsplit, cudaStream_t stream) {
  const size_t parts = (size_t)B * H * nsplit;
  // At least a warp: the max's shuffles take every lane (dh may be 16).
  paged_combine_kernel<<<B * H, dh < 32 ? 32 : dh,
                         2 * nsplit * sizeof(float), stream>>>(
      scratch, scratch + parts * dh, scratch + parts * (dh + 1), o, m, l,
      nsplit, dh);
  return cudaGetLastError();
}

int splits(int nblk, int tokens_per_block) {
  return (int)(((long long)nblk * tokens_per_block + kSpan - 1) / kSpan);
}

template <typename T, bool kFused, int DH>
cudaError_t launch_dh(const void* q, int q_is_f32, const void* pool_k,
                      const void* pool_v,
                      const void* stage_k, const void* stage_v,
                      const int* tables, const int* slots, const int* ntok,
                      float* scratch, int B, int H, int n_kv, int nblk,
                      int tokens_per_block, float scale, int nsplit,
                      cudaStream_t stream) {
  const int g = H / n_kv;
  const size_t smem = partial_smem_bytes(g, DH, sizeof(T));
  // Raised once per instantiation, to the card's opt-in maximum less the
  // kernel's static shared memory, so that a later launch inside a
  // CUDA-graph capture makes no attribute call.
  static bool smem_raised = false;
  if (smem > 48 * 1024 && !smem_raised) {
    const auto kernel = paged_partial_kernel<T, kFused, DH>;
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const size_t parts = (size_t)B * H * nsplit;
  float* part_o = scratch;
  float* part_m = part_o + parts * DH;
  float* part_l = part_m + parts;
  const dim3 grid(nsplit, n_kv, B);
  paged_partial_kernel<T, kFused, DH><<<grid, kThreads, smem, stream>>>(
      q, q_is_f32, static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const T*>(stage_k),
      static_cast<const T*>(stage_v), tables,
      slots, ntok, part_o, part_m, part_l, H, n_kv, nblk, tokens_per_block,
      scale);
  return cudaGetLastError();
}

template <typename T, bool kFused>
cudaError_t launch(const void* q, int q_is_f32, const void* pool_k,
                   const void* pool_v,
                   const void* stage_k, const void* stage_v, const int* tables,
                   const int* slots, const int* ntok, float* o, float* m,
                   float* l, float* scratch, int B, int H, int n_kv, int dh,
                   int nblk, int tokens_per_block, float scale,
                   cudaStream_t stream) {
  const int nsplit = splits(nblk, tokens_per_block);
  if (nsplit > 0) {
    cudaError_t err = cudaErrorInvalidValue;
    switch (dh) {
#define CASE(D)                                                              \
  case D:                                                                    \
    err = launch_dh<T, kFused, D>(                                           \
        q, q_is_f32, pool_k, pool_v, stage_k, stage_v, tables, slots, ntok,  \
        scratch, B, H, n_kv, nblk, tokens_per_block, scale, nsplit, stream); \
    break;
      CASE(16) CASE(32) CASE(64) CASE(96) CASE(128) CASE(160) CASE(192)
      CASE(224) CASE(256)
#undef CASE
      default:
        break;
    }
    if (err != cudaSuccess) return err;
  }
  return combine(o, m, l, scratch, B, H, dh, nsplit, stream);
}

}  // namespace

extern "C" {

// Table token positions each split of the first launch walks.
int paged_attention_split_tokens() { return kSpan; }

// q [B, H, dh] f32 (q_is_f32 = 1) or bf16; pools [rows, n_kv, dh] and
// [rows, n_kv, dh_v] bf16 (kv_is_f32 = 0) or f32; tables / ntok int32
// [B, nblk]; outputs o [B, H, dh_v], m / l [B, H] f32; scratch f32 of
// B * H * nsplit * (dh_v + 2) floats, nsplit = ceil(nblk * tokens_per_block
// / paged_attention_split_tokens()).  dh_v = dh (16, or a multiple of 32
// up to 256), or MLA's dh 576 / dh_v 512 with bf16 q and pools.  Returns the
// first failing launch's cudaError_t (0 on success).
int paged_attention_fwd(const void* q, int q_is_f32, const void* pool_k,
                        const void* pool_v, const int* tables, const int* ntok,
                        float* o, float* m, float* l, float* scratch, int B,
                        int H, int n_kv, int dh, int dh_v, int nblk,
                        int tokens_per_block, int kv_is_f32, float scale,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh != dh_v) {
    if (dh != 576 || dh_v != 512 || q_is_f32 || kv_is_f32)
      return (int)cudaErrorInvalidValue;
    const int nsplit = splits(nblk, tokens_per_block);
    if (nsplit > 0) {
      const cudaError_t err = launch_mla<576, 512>(
          q, pool_k, pool_v, tables, ntok, scratch, B, H, n_kv, nblk,
          tokens_per_block, scale, nsplit, s);
      if (err != cudaSuccess) return (int)err;
    }
    return (int)combine(o, m, l, scratch, B, H, dh_v, nsplit, s);
  }
  if (kv_is_f32)
    return (int)launch<float, false>(q, q_is_f32, pool_k, pool_v, nullptr,
                                     nullptr, tables, nullptr, ntok, o, m, l,
                                     scratch, B, H, n_kv, dh, nblk,
                                     tokens_per_block, scale, s);
  return (int)launch<__nv_bfloat16, false>(
      q, q_is_f32, pool_k, pool_v, nullptr, nullptr, tables, nullptr, ntok, o,
      m, l, scratch, B, H, n_kv, dh, nblk, tokens_per_block, scale, s);
}

// As paged_attention_fwd at page granularity, plus stage_k / stage_v
// [NS * page_tokens, n_kv, dh] in the pools' dtype (null when NS = 0) and
// slots int32 [B, nblk]: the staging slot of each block, -1 to read the pool.
int fused_paged_attention_fwd(const void* q, int q_is_f32,
                              const void* pool_k, const void* pool_v,
                              const void* stage_k, const void* stage_v,
                              const int* tables, const int* slots,
                              const int* ntok, float* o, float* m, float* l,
                              float* scratch, int B, int H, int n_kv, int dh,
                              int nblk, int page_tokens, int kv_is_f32,
                              float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_is_f32)
    return (int)launch<float, true>(q, q_is_f32, pool_k, pool_v, stage_k,
                                    stage_v, tables, slots, ntok, o, m, l,
                                    scratch, B, H, n_kv, dh, nblk,
                                    page_tokens, scale, s);
  return (int)launch<__nv_bfloat16, true>(
      q, q_is_f32, pool_k, pool_v, stage_k, stage_v, tables, slots, ntok, o,
      m, l, scratch, B, H, n_kv, dh, nblk, page_tokens, scale, s);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
