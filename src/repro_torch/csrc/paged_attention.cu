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
// compute-bound.  This first design is simple: one CTA per (row, KV head)
// walks the row's blocks in table order (the TPU's sequential "arbitrary"
// grid axis becomes a loop inside the CTA), stages up to kTile valid tokens
// of K and V in shared memory with 16-byte vector loads, and its warps share
// the g query heads of the group, so each K/V byte is read from device
// memory once for all g heads.  Holes and the invalid tail of a partial page
// are never loaded.  It leaves most SMs idle when B * n_kv is small;
// splitting the KV walk across CTAs and TMA bulk loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;            // tokens staged in shared memory per step
constexpr float kNegInf = -1e30f;    // the TPU kernel's mask value, not -inf

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t smem_bytes(int g, int dh) {
  const size_t floats = 2 * (size_t)g * dh        // q, o accumulators
                        + 2 * (size_t)g           // m, l
                        + (size_t)kTile * (dh + 1)  // K tile (padded rows)
                        + (size_t)kTile * dh        // V tile
                        + (size_t)kWarps * kTile;   // per-warp probabilities
  return floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const int* __restrict__ tables,
                       const int* __restrict__ ntok,
                       float* __restrict__ o_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int H, int n_kv, int dh,
                       int nblk, int tokens_per_block, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / n_kv;
  const int h0 = kvh * g;  // query heads h0 .. h0+g-1 share this KV head
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float* q_s = smem;                     // [g][dh], pre-scaled
  float* o_s = q_s + g * dh;             // [g][dh]
  float* m_s = o_s + g * dh;             // [g]
  float* l_s = m_s + g;                  // [g]
  float* k_s = l_s + g;                  // [kTile][dh + 1]
  float* v_s = k_s + kTile * (dh + 1);   // [kTile][dh]
  float* p_w = v_s + kTile * dh + warp * kTile;  // this warp's [kTile]

  for (int i = threadIdx.x; i < g * dh; i += kThreads) {
    q_s[i] = q[((size_t)b * H + h0) * dh + i] * scale;
    o_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  const int vec_per_row = dh / kVec;
  const size_t row_stride = (size_t)n_kv * dh;  // elements between tokens

  for (int blk = 0; blk < nblk; ++blk) {
    const int entry = tables[b * nblk + blk];
    int nt = ntok[b * nblk + blk];
    if (entry < 0 || nt <= 0) continue;   // hole: never loaded
    nt = min(nt, tokens_per_block);
    const size_t base =
        (size_t)entry * tokens_per_block * row_stride + (size_t)kvh * dh;
    for (int t0 = 0; t0 < nt; t0 += kTile) {
      const int cnt = min(kTile, nt - t0);
      __syncthreads();  // the previous tile is consumed; init is visible
      for (int i = threadIdx.x; i < cnt * vec_per_row; i += kThreads) {
        const int r = i / vec_per_row;
        const int c = (i % vec_per_row) * kVec;
        const size_t off = base + (size_t)(t0 + r) * row_stride + c;
        const uint4 kr = *reinterpret_cast<const uint4*>(pool_k + off);
        const uint4 vr = *reinterpret_cast<const uint4*>(pool_v + off);
        const T* ke = reinterpret_cast<const T*>(&kr);
        const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          k_s[r * (dh + 1) + c + e] = to_float(ke[e]);
          v_s[r * dh + c + e] = to_float(ve[e]);
        }
      }
      __syncthreads();
      for (int h = warp; h < g; h += kWarps) {
        // Scores: one token per lane; padded K rows keep lanes on
        // distinct shared-memory banks.
        const float* qh = q_s + h * dh;
        float smax = kNegInf;
        for (int r = lane; r < cnt; r += 32) {
          const float* kr = k_s + r * (dh + 1);
          float s = 0.f;
          for (int d = 0; d < dh; ++d) s = fmaf(qh[d], kr[d], s);
          p_w[r] = s;
          smax = fmaxf(smax, s);
        }
        smax = warp_max(smax);
        const float m_old = m_s[h];
        const float m_new = fmaxf(m_old, smax);
        const float alpha = expf(m_old - m_new);   // 0 on the first block
        float psum = 0.f;
        for (int r = lane; r < cnt; r += 32) {
          const float p = expf(p_w[r] - m_new);
          p_w[r] = p;
          psum += p;
        }
        psum = warp_sum(psum);
        __syncwarp();
        // o update: each lane owns the head dims lane, lane+32, ...
        for (int d = lane; d < dh; d += 32) {
          float acc = o_s[h * dh + d] * alpha;
          for (int r = 0; r < cnt; ++r) acc = fmaf(p_w[r], v_s[r * dh + d], acc);
          o_s[h * dh + d] = acc;
        }
        if (lane == 0) {
          m_s[h] = m_new;
          l_s[h] = l_s[h] * alpha + psum;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * dh; i += kThreads)
    o_out[((size_t)b * H + h0) * dh + i] = o_s[i];
  for (int i = threadIdx.x; i < g; i += kThreads) {
    m_out[(size_t)b * H + h0 + i] = m_s[i];
    l_out[(size_t)b * H + h0 + i] = l_s[i];
  }
}

template <typename T>
cudaError_t launch(const float* q, const void* pool_k, const void* pool_v,
                   const int* tables, const int* ntok, float* o, float* m,
                   float* l, int B, int H, int n_kv, int dh, int nblk,
                   int tokens_per_block, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / n_kv, dh);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_kv, B);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(pool_k), static_cast<const T*>(pool_v), tables,
      ntok, o, m, l, H, n_kv, dh, nblk, tokens_per_block, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, H, dh] f32; pools [rows, n_kv, dh] bf16 (kv_is_f32 = 0) or f32;
// tables / ntok int32 [B, nblk]; outputs o [B, H, dh], m / l [B, H] f32.
// Returns the launch's cudaError_t (0 on success).
int paged_attention_fwd(const float* q, const void* pool_k,
                        const void* pool_v, const int* tables, const int* ntok,
                        float* o, float* m, float* l, int B, int H, int n_kv,
                        int dh, int nblk, int tokens_per_block, int kv_is_f32,
                        float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_is_f32)
    return (int)launch<float>(q, pool_k, pool_v, tables, ntok, o, m, l, B, H,
                              n_kv, dh, nblk, tokens_per_block, scale, s);
  return (int)launch<__nv_bfloat16>(q, pool_k, pool_v, tables, ntok, o, m, l,
                                    B, H, n_kv, dh, nblk, tokens_per_block,
                                    scale, s);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
