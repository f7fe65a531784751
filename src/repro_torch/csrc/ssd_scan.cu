// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060 §6).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py: ssd_scan (body
// _ssd_kernel).  For one (batch row b, head h) and chunks of Q time steps,
// with x [T, hd], dt [T] (post-softplus), the scalar A < 0, B / C [T, N]
// and the carried state h [hd, N] (h0 or zeros before chunk 0):
//
//   cum_i  = sum_{j <= i} dt_j A                      (inclusive, per chunk)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) (C_i . h_p)_p                 (h of the previous chunk)
//   h'     = exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
//
// Outputs y [B, T, nh, hd] and the final state [B, nh, hd, N] in f32.
//
// What bounds it on the card: bytes, in the limit.  At zamba2-1.2b's prefill
// shape (T = 1280, 64 heads, hd = N = 64, bf16) the call reads ~31 MB,
// writes ~22 MB and needs ~4 GFLOP over the causal pairs, ~75 flops per
// byte, below the ~295 where an H100 turns compute-bound.  This first
// design is simple and runs the f32 arithmetic on CUDA cores (tensor cores
// with wgmma, reading the un-expanded B/C groups, and splitting a head's
// chunks across CTAs with a second state-passing pass are later work).  One CTA of 256 threads per
// (head, batch row) walks the chunks in order, as the TPU grid's sequential
// chunk axis does, and keeps the [hd, N] f32 state in shared memory.  A
// chunk of up to 256 rows does not fit whole (B and C alone would take
// 256 KB in f32 at N = 128), so each chunk is tiled: 64 query rows against
// 64-key tiles up to the diagonal, with C, B, dt-scaled x and the masked
// scores staged in shared memory.  Each thread owns a 4 x 4 block of a
// tile's scores and a 4-row x hd/16-column block of the output.  The
// intra-chunk term is masked before exp (exp of a positive segment would
// overflow); the carried term reads the previous chunk's state, which the
// state update overwrites only after a barrier that every row has passed.
// Q need not be a power of two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;        // query rows of a chunk per tile
constexpr int kKeys = 64;        // key rows of a chunk per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kMaxChunk = 256;   // the models' chunk (cfg.ssm.chunk)

size_t smem_bytes(int hd, int n) {
  // state [N][hd], C^T [N][kRows], B^T [N][kKeys], x [kKeys][hd],
  // p [kKeys][kRows], dt and cum [kMaxChunk], all f32.
  return ((size_t)n * hd + (size_t)n * kRows + (size_t)n * kKeys
          + (size_t)kKeys * hd + (size_t)kKeys * kRows + 2 * kMaxChunk)
         * sizeof(float);
}

// Reads the 16 bytes at element offset off of a bf16 (f32 = false) or f32
// array as floats; returns how many (8 or 4).
__device__ __forceinline__ int load16(const void* base, size_t off, bool f32,
                                      float* out) {
  if (f32) {
    const float4 v = *reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + off);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    return 4;
  }
  const uint4 v = *reinterpret_cast<const uint4*>(
      static_cast<const __nv_bfloat16*>(base) + off);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
  return 8;
}

// Rows row0 .. row0 + 63 (chunk-relative, starting at time t0) of a
// [T, nh, N] operand of head h into dst [N][64] (transposed; rows past Q are
// zeros).  Consecutive threads take consecutive rows, so the transposing
// stores do not conflict.
template <int N>
__device__ __forceinline__ void load_rows_t(float* dst, const void* src,
                                            size_t base, size_t row_stride,
                                            int row0, int Q, bool f32,
                                            int tid) {
  const int vec = f32 ? 4 : 8;
  float buf[8];
  for (int i = tid; i < 64 * (N / vec); i += kThreads) {
    const int r = i % 64;
    const int c = (i / 64) * vec;
    if (row0 + r < Q) {
      load16(src, base + (size_t)(row0 + r) * row_stride + c, f32, buf);
    } else {
      for (int e = 0; e < vec; ++e) buf[e] = 0.f;
    }
    for (int e = 0; e < vec; ++e) dst[(c + e) * 64 + r] = buf[e];
  }
}

// Rows row0 .. row0 + 63 of x (head h) into dst [64][HD], row r scaled by
// dt_r, and with decay, by exp(cum_last - cum_r) after that (zeros past Q).
template <int HD>
__device__ __forceinline__ void load_x(float* dst, const void* x, size_t base,
                                       size_t row_stride, int row0, int Q,
                                       bool f32, const float* dt_s,
                                       const float* cum_s, bool decay,
                                       int tid) {
  const int vec = f32 ? 4 : 8;
  const int per_row = HD / vec;
  float buf[8];
  for (int i = tid; i < 64 * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * vec;
    const int t = row0 + r;
    if (t < Q) {
      load16(x, base + (size_t)t * row_stride + c, f32, buf);
      const float dtv = dt_s[t];
      const float dec = decay ? expf(cum_s[Q - 1] - cum_s[t]) : 1.f;
      for (int e = 0; e < vec; ++e)
        dst[r * HD + c + e] = decay ? (buf[e] * dtv) * dec : buf[e] * dtv;
    } else {
      for (int e = 0; e < vec; ++e) dst[r * HD + c + e] = 0.f;
    }
  }
}

// NH = hd / 16, NN = N / 16.
template <int NH, int NN>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const void* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const void* __restrict__ Bm,
                const void* __restrict__ Cm, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_out, int T,
                int nh, int Q, int is_f32) {
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
  const bool f32 = is_f32 != 0;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;              // output columns tx + 16 j
  const int ty = tid / 16;              // rows 4 ty .. 4 ty + 3
  const float a_h = A[h];
  const size_t bc_stride = (size_t)nh * N;   // between time steps
  const size_t x_stride = (size_t)nh * HD;
  const size_t state_off = ((size_t)b * nh + h) * HD * N;

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
    const size_t bc_base = ((size_t)b * T + t0) * bc_stride + (size_t)h * N;
    const size_t x_base = ((size_t)b * T + t0) * x_stride + (size_t)h * HD;
    __syncthreads();  // the previous chunk's state and tiles are settled
    for (int i = tid; i < Q; i += kThreads)
      dt_s[i] = dt[((size_t)b * T + t0 + i) * nh + h];
    __syncthreads();
    if (tid < 32) {
      // Inclusive scan of dt A: each lane sums a run of E rows, a shuffle
      // scan offsets the runs.
      const int E = (Q + 31) / 32;
      const int lo = min(tid * E, Q), hi = min(lo + E, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) run += dt_s[i] * a_h;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float acc = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) acc = 0.f;
      for (int i = lo; i < hi; ++i) {
        acc += dt_s[i] * a_h;
        cum_s[i] = acc;
      }
    }

    for (int r0 = 0; r0 < Q; r0 += kRows) {
      __syncthreads();  // cum_s is visible; the previous tile is consumed
      load_rows_t<N>(c_s, Cm, bc_base, bc_stride, r0, Q, f32, tid);
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
        load_rows_t<N>(b_s, Bm, bc_base, bc_stride, k0, Q, f32, tid);
        load_x<HD>(x_s, x, x_base, x_stride, k0, Q, f32, dt_s, cum_s, false,
                   tid);
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
      load_rows_t<N>(b_s, Bm, bc_base, bc_stride, k0, Q, f32, tid);
      load_x<HD>(x_s, x, x_base, x_stride, k0, Q, f32, dt_s, cum_s, true,
                 tid);
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
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* h0, float* y,
                   float* h_out, int B, int T, int nh, int Q, int is_f32,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(NH * 16, NN * 16);
  // Raised once per instantiation, at its first launch, so that a later
  // launch inside a CUDA-graph capture makes no attribute call.
  static bool smem_raised = false;
  if (smem > 48 * 1024 && !smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<NH, NN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  ssd_scan_kernel<NH, NN><<<dim3(nh, B), kThreads, smem, stream>>>(
      x, dt, A, Bm, Cm, h0, y, h_out, T, nh, Q, is_f32);
  return cudaGetLastError();
}

template <int NH>
cudaError_t launch_n(int n, const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, const float* h0,
                     float* y, float* h_out, int B, int T, int nh, int Q,
                     int is_f32, cudaStream_t s) {
  switch (n) {
    case 16: return launch<NH, 1>(x, dt, A, Bm, Cm, h0, y, h_out, B, T, nh,
                                  Q, is_f32, s);
    case 32: return launch<NH, 2>(x, dt, A, Bm, Cm, h0, y, h_out, B, T, nh,
                                  Q, is_f32, s);
    case 64: return launch<NH, 4>(x, dt, A, Bm, Cm, h0, y, h_out, B, T, nh,
                                  Q, is_f32, s);
    case 128: return launch<NH, 8>(x, dt, A, Bm, Cm, h0, y, h_out, B, T, nh,
                                   Q, is_f32, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [B, T, nh, hd] and Bm / Cm [B, T, nh, N], all bf16 (is_f32 = 0) or all
// f32; dt [B, T, nh] f32; A [nh] f32; h0 [B, nh, hd, N] f32 or null; y
// [B, T, nh, hd] and h_out [B, nh, hd, N] f32.  hd and N in {16, 32, 64,
// 128}; 1 <= Q <= 256 and T a multiple of Q.  Returns the launch's
// cudaError_t (0 on success).
int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, const float* h0, float* y,
                 float* h_out, int B, int T, int nh, int hd, int n, int Q,
                 int is_f32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > kMaxChunk || T % Q != 0)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
#define CASE(D)                                                             \
  case D:                                                                   \
    return (int)launch_n<D / 16>(n, x, dt, A, Bm, Cm, h0, y, h_out, B, T,   \
                                 nh, Q, is_f32, s);
    CASE(16) CASE(32) CASE(64) CASE(128)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
