// Base-page movement over layer-stacked KV pools: gather, scatter, compact.
//
// Replaces the TPU kernels repro/kernels/page_compact.py: page_gather,
// page_scatter and page_compact.  Pools are [L, NP, page] with `page` the
// bytes of one base page of one layer (ptok * n_kv * dh * itemsize); one
// launch covers all L layers, where the TPU engine launches once per layer
// through vmap.
//
//   gather : out[l, i]       = pool[l, idx[i]]   (a hole, idx < 0, reads page 0)
//   scatter: pool[l, idx[i]] = pages[l, i]       (holes skipped), in place
//   compact: pool[l, dst[i]] = pool[l, src[i]]   (holes skipped), in place;
//            a src is never also a dst (CAC plans), so entries are independent
//
// What bounds it on the card: bytes (each page is read once and written
// once; no arithmetic).  A copy has no arithmetic to hide its DRAM latency
// behind, so the design keeps loads in flight: one CTA per (entry,
// layer), and each thread issues all its 16-byte loads of a batch (kBatch,
// 8 per thread: a 32 KiB page over 256 threads) before any of its stores,
// neighbouring threads on neighbouring addresses.  The store of a vector
// needs its load's register, so a load-store loop would make one DRAM
// round trip per vector.  With the batch a CTA has a whole 32 KiB page in
// flight at once, so a call of few entries is one round trip too (a split
// of each page over several CTAs, tried, made no difference: PERF.md).
// In compact, source and destination lie in one pool and are not
// __restrict__; the loads of an entry may still all go ahead of its stores
// because a CAC plan never uses a page both as source and as destination,
// so no entry's stores touch any entry's source.
// Holes are skipped directly; the TPU kernels' rewrite of holes into
// duplicate copies and their page-0 restore are not needed here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;    // loads in flight per thread

// The page's nvec vectors: each thread loads up to kBatch vectors, then
// stores them.  The loads are cache-streaming (ld.global.cs): a page is
// read once; on the H100 the hint made compact measurably faster and left
// gather and scatter where they were.
__device__ __forceinline__ void copy_page(const uint4* src, uint4* dst,
                                          long long nvec) {
  for (long long i0 = threadIdx.x; i0 < nvec;
       i0 += (long long)kThreads * kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < nvec) v[u] = __ldcs(src + i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < nvec) dst[i] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint4* __restrict__ pool, const int* __restrict__ idx,
              uint4* __restrict__ out, long long np, long long nvec, int n) {
  const int i = blockIdx.x;
  const long long l = blockIdx.y;
  const int p = max(idx[i], 0);
  copy_page(pool + (l * np + p) * nvec, out + (l * n + i) * nvec, nvec);
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(uint4* __restrict__ pool, const int* __restrict__ idx,
               const uint4* __restrict__ pages, long long np, long long nvec,
               int n) {
  const int i = blockIdx.x;
  const long long l = blockIdx.y;
  const int p = idx[i];
  if (p < 0) return;
  copy_page(pages + (l * n + i) * nvec, pool + (l * np + p) * nvec, nvec);
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(uint4* pool, const int* __restrict__ src,
               const int* __restrict__ dst, long long np, long long nvec) {
  const int i = blockIdx.x;
  const long long l = blockIdx.y;
  const int s = src[i];
  const int d = dst[i];
  if (s < 0 || d < 0) return;
  copy_page(pool + (l * np + s) * nvec, pool + (l * np + d) * nvec, nvec);
}

}  // namespace

extern "C" {

// All sizes are in pages; page_bytes must be a multiple of 16 and every
// pointer 16-byte aligned.  Each call returns its launch's cudaError_t.

int page_gather(const void* pool, const int* idx, void* out, int n, int L,
                long long np, long long page_bytes, void* stream) {
  if (n > 0 && L > 0)
    gather_kernel<<<dim3(n, L), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(pool), idx, static_cast<uint4*>(out), np,
        page_bytes / 16, n);
  return (int)cudaGetLastError();
}

int page_scatter(void* pool, const int* idx, const void* pages, int n, int L,
                 long long np, long long page_bytes, void* stream) {
  if (n > 0 && L > 0)
    scatter_kernel<<<dim3(n, L), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint4*>(pool), idx, static_cast<const uint4*>(pages), np,
        page_bytes / 16, n);
  return (int)cudaGetLastError();
}

int page_compact(void* pool, const int* src, const int* dst, int n, int L,
                 long long np, long long page_bytes, void* stream) {
  if (n > 0 && L > 0)
    compact_kernel<<<dim3(n, L), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint4*>(pool), src, dst, np, page_bytes / 16);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
