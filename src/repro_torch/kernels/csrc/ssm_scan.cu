// Mamba-1 selective-scan chunk for Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas kernel of the JAX reference package
//   ssm_scan_kernel <- src/repro/kernels/ssm_scan.py:28 _ssm_kernel
// One chunk of the recurrence, with the state carried in and out:
//   dA = exp(dt[t,d] * A[d,n])
//   h[d,n] = dA * h[d,n] + dt[t,d] * x[t,d] * B[t,n]
//   y[t,d] = sum_n h[d,n] * C[t,n]
//
// Design.  The TPU kernel tiles d_inner over its grid, keeps a (block_d, N)
// state in VMEM and walks the chunk with a fori_loop.  Here one thread owns
// one (batch row, channel d): it keeps that channel's N states and its N
// entries of A in registers and walks t = 0..L-1 itself, so the recurrence
// never touches device memory.  A block of kThreads threads covers a run of
// neighbouring channels of one batch row, so the per-step loads of dt and x
// and the store of y are coalesced across the warp.  B[b,t,:] and C[b,t,:]
// are the same for every channel of the row: the block stages them in
// shared memory, kTile time steps at a time, and every thread reads them
// from there (a broadcast).  Any d_inner works (the ragged block is masked);
// N is a template parameter (instances 8 and 16).
//
// The inputs are addressed through a batch stride and a time stride each
// (the last dimension contiguous), so a chunk view of the layer's (B, S, .)
// tensors and the B/C column slices of the x_proj output are read in place,
// and y can be written into the layer's output buffer.  h_out may alias h0:
// each thread reads its own state row before it writes it, and no other
// thread touches that row.
//
// Numerics: inputs are widened to fp32 on load, the state and y are fp32.
// Build without --use_fast_math: expf is the accurate one (the tolerance
// against the plain version is 1e-4).
//
// What bounds it on an H100.  At the serving path's prefill chunk (B 8,
// L 256, di 8192, N 16, bf16 x/B/C) the kernel moves about 177 MB (dt and y
// in fp32 dominate) but evaluates B*L*di*N = 268 M exponentials: at the
// special-function units' 16 a clock per SM that is more time than the
// bytes take, so operations bound it.  At decode (L 1) the 8.4 MB of state
// read and written bound it.  This first version is latency-bound instead:
// B*di threads (65,536 at the path's shapes, a quarter of the card's
// resident threads) each run a serial loop of 16-wide updates.  Splitting N
// across lanes (shuffles for y) or a chunked two-pass scan over t would put
// more threads on the card; that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 128;   // channels of one batch row per block
constexpr int kTile = 32;       // time steps of B and C staged per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Strides in elements: one batch row, one time step.
struct Strides {
  int64_t b, t;
};

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ dt, const T* __restrict__ x,
                const T* __restrict__ Bc, const T* __restrict__ Cc,
                const float* __restrict__ A, const float* h0,
                float* __restrict__ y, float* h_out, int L, int di,
                Strides s_dt, Strides s_x, Strides s_b, Strides s_c,
                Strides s_y) {
  __shared__ float b_s[kTile][N];
  __shared__ float c_s[kTile][N];

  const int64_t b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < di;
  const int64_t h_row = (b * di + d) * N;

  float h[N], a[N];
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      h[n] = h0[h_row + n];
      a[n] = A[static_cast<int64_t>(d) * N + n];
    }
  }
  const int64_t dt_at = b * s_dt.b + d, x_at = b * s_x.b + d,
                y_at = b * s_y.b + d;
  const T* b_row = Bc + b * s_b.b;
  const T* c_row = Cc + b * s_c.b;

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int steps = min(kTile, L - t0);
    __syncthreads();                    // the previous tile is consumed
    for (int e = threadIdx.x; e < steps * N; e += kThreads) {
      const int t = e / N, n = e - t * N;
      b_s[t][n] = to_f32(b_row[(t0 + t) * s_b.t + n]);
      c_s[t][n] = to_f32(c_row[(t0 + t) * s_c.t + n]);
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < steps; ++t) {
      const int64_t tt = t0 + t;
      const float dtv = dt[dt_at + tt * s_dt.t];
      const float dx = dtv * to_f32(x[x_at + tt * s_x.t]);
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtv * a[n]) * h[n] + dx * b_s[t][n];
        acc = fmaf(h[n], c_s[t][n], acc);
      }
      y[y_at + tt * s_y.t] = acc;
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[h_row + n] = h[n];
  }
}

template <int N, typename T>
cudaError_t launch(const void* dt, const void* x, const void* Bc,
                   const void* Cc, const void* A, const void* h0, void* y,
                   void* h_out, int B, int L, int di, Strides s_dt,
                   Strides s_x, Strides s_b, Strides s_c, Strides s_y,
                   cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<N, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(Bc), static_cast<const T*>(Cc),
      static_cast<const float*>(A), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), L, di, s_dt, s_x,
      s_b, s_c, s_y);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(int dtype, const void* dt, const void* x,
                     const void* Bc, const void* Cc, const void* A,
                     const void* h0, void* y, void* h_out, int B, int L,
                     int di, Strides s_dt, Strides s_x, Strides s_b,
                     Strides s_c, Strides s_y, cudaStream_t stream) {
  if (dtype == kF32)
    return launch<N, float>(dt, x, Bc, Cc, A, h0, y, h_out, B, L, di, s_dt,
                            s_x, s_b, s_c, s_y, stream);
  if (dtype == kBF16)
    return launch<N, __nv_bfloat16>(dt, x, Bc, Cc, A, h0, y, h_out, B, L, di,
                                    s_dt, s_x, s_b, s_c, s_y, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dt (B,L,di) fp32; x (B,L,di), Bc/Cc (B,L,N) of one dtype (fp32 or bf16);
// A (di,N), h0 (B,di,N) fp32 and contiguous -> y (B,L,di) fp32, h_out
// (B,di,N) fp32 and contiguous (h_out may be h0).  dt, x, Bc, Cc and y are
// given by a batch stride and a time stride in elements, the last dimension
// contiguous.  N must be 8 or 16.
int ssm_scan_chunk(const void* dt, const void* x, const void* Bc,
                   const void* Cc, const void* A, const void* h0, void* y,
                   void* h_out, int B, int L, int di, int N, int64_t dt_sb,
                   int64_t dt_st, int64_t x_sb, int64_t x_st, int64_t b_sb,
                   int64_t b_st, int64_t c_sb, int64_t c_st, int64_t y_sb,
                   int64_t y_st, int dtype, void* stream) {
  if (B < 0 || L < 0 || di < 0 || B > 65535) return cudaErrorInvalidValue;
  if (B == 0 || di == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides s_dt{dt_sb, dt_st}, s_x{x_sb, x_st}, s_b{b_sb, b_st},
      s_c{c_sb, c_st}, s_y{y_sb, y_st};
  if (N == 8)
    return launch_n<8>(dtype, dt, x, Bc, Cc, A, h0, y, h_out, B, L, di, s_dt,
                       s_x, s_b, s_c, s_y, s);
  if (N == 16)
    return launch_n<16>(dtype, dt, x, Bc, Cc, A, h0, y, h_out, B, L, di,
                        s_dt, s_x, s_b, s_c, s_y, s);
  return cudaErrorInvalidValue;
}

const char* ssm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
