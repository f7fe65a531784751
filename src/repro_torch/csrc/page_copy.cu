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
// once; no arithmetic).  One CTA per (entry, layer) copies its page with
// 16-byte vector loads and stores, neighbouring threads on neighbouring
// addresses.  Holes are skipped directly; the TPU kernels' rewrite of holes
// into duplicate copies and their page-0 restore are not needed here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void copy_page(const uint4* __restrict__ src,
                                          uint4* __restrict__ dst,
                                          long long nvec) {
  for (long long i = threadIdx.x; i < nvec; i += kThreads) dst[i] = src[i];
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
