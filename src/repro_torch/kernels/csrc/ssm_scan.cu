// Mamba-1 selective-scan chunk for Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas kernel of the JAX reference package
//   ssm_scan_kernel <- src/repro/kernels/ssm_scan.py:28 _ssm_kernel
// One chunk of the recurrence, with the state carried in and out:
//   dA = exp(dt[t,d] * A[d,n])
//   h[d,n] = dA * h[d,n] + dt[t,d] * x[t,d] * B[t,n]
//   y[t,d] = sum_n h[d,n] * C[t,n]
//
// One kernel template, ssm_scan_kernel<N, T, Gated>, behind two entry
// points:
//   ssm_scan_chunk     (Gated = false) the Pallas kernel's contract: dt
//                      already softplus'ed, fp32; y fp32;
//   mamba1_scan_chunk  (Gated = true) the Mamba-1 block's scan with what
//                      surrounds it in src/repro/models/ssm.py:75-113:
//                      raw dt and dt_bias in T, dt = softplus(dt + bias)
//                      (jax's log1p(exp(-|v|)) + max(v, 0)); then
//                      y += x * D, g = T(z * T(sigmoid(z))) (common.silu),
//                      out = T(y * g), written in T.
// The epilogue keeps the plain route's roundings: each product and sum
// that the plain route rounds on its own is __fmul_rn / __fadd_rn here,
// so nvcc does not contract it into an FMA.
//
// Design.  A block owns kChannels (64) neighbouring channels of one batch
// row.  The state of a channel is split across N/8 lanes, eight states a
// lane, so h and A load and store as float4s (a warp reads 1 KB of
// contiguous state) and the block has 8*N threads: 131,072 threads at the
// serving path's shapes (B 8, d_inner 8192, N 16).  Each step a lane
// updates its eight states and the channel's partial sums of y are
// reduced with a shuffle.  Eight states a lane ran faster than four
// (tools/ssm_variants.py): the per-step loads of dt, dt*x, B and C and the
// shuffles are shared by twice the states.
// Time is walked in tiles of kTile steps.  The tiles of dt, x, z, B and C
// are copied into shared memory with 16-byte cp.async (rows that do not
// start on 16 bytes fall back to element loads), double-buffered: tile
// k+1 is in flight while tile k is computed.  Per tile, three passes:
//   prologue   once per (t, d): dt (softplus'ed when gated) and dt*x into
//              fp32 tiles; B and C widened to fp32;
//   recurrence the lanes walk the tile; y goes to shared memory;
//   epilogue   once per (t, d): D-skip and gate when gated, and the store
//              to y, coalesced across the channels.
// The exponential is ex2.approx of dt * (A * log2(e)), with A * log2(e)
// held in registers: one special-function op and one multiply a state
// and step.  Its error against the plain version's exp is within the
// 1e-4 the kernel is held to (chip_smoke.py phase 10).  The prologue's
// and epilogue's transcendentals (expf, log1pf, the division) are the
// accurate ones: build without --use_fast_math.  They cost the gated
// entry about a quarter of its time (tools/ssm_variants.py).
//
// The (B, L, .) operands are addressed through a batch stride and a time
// stride each (the last dimension contiguous), so chunk views, the gate
// z as a view of the in_proj output, and the B/C column slices of the
// x_proj output are read in place, and y is written into the caller's
// buffer.  A, h0 and h_out are contiguous and start on 16 bytes (the
// wrapper sees to it).  h_out may alias h0: each lane reads its own four
// states before it writes them, and no other lane touches them.
//
// What bounds it on an H100.  At the prefill chunk (B 8, L 256, di 8192,
// N 16) the B*L*di*N = 268 M exponentials at the special-function
// units' 16 a clock per SM take longer than the bytes: operations bound
// it, but the bytes (177 MB for the plain entry, 143 MB gated) and the
// instructions around each exponential come close behind, so the three
// overlap imperfectly.  At decode (L 1) the 8.4 MB of state read and
// written bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kChannels = 64;   // channels of one batch row per block
constexpr int kTile = 32;       // time steps per staged tile
constexpr int kPerLane = 8;     // states a lane owns (whole float4s)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// jax.nn.softplus: log1p(exp(-|v|)) + max(v, 0)
__device__ __forceinline__ float softplus(float v) {
  return __fadd_rn(log1pf(expf(-fabsf(v))), fmaxf(v, 0.0f));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Strides in elements: one batch row, one time step.
struct Strides {
  int64_t b, t;
};

// Bits of ScanArgs::vec: the operands whose rows all start on 16 bytes.
enum VecBit { kVecDt = 1, kVecX = 2, kVecZ = 4, kVecB = 8, kVecC = 16 };

template <typename T, bool Gated>
struct ScanArgs {
  using TD = std::conditional_t<Gated, T, float>;   // dt's type
  using TY = std::conditional_t<Gated, T, float>;   // y's type
  const TD* dt;
  const T* dt_bias;   // gated only
  const T* x;
  const T* z;         // gated only
  const T* Bc;
  const T* Cc;
  const float* A;
  const float* D;     // gated only
  const float* h0;
  TY* y;
  float* h_out;
  int L, di;
  Strides s_dt, s_x, s_z, s_b, s_c, s_y;
  unsigned vec;
};

// Byte offsets of the dynamic shared memory for tiles of tt steps: two
// raw buffers (dt, x, z, B, C as they are in memory), then the fp32 tiles
// (dt, dt*x, B, C).  Every region is a multiple of 16 bytes.
template <int N, typename T, bool Gated>
struct Layout {
  using TD = typename ScanArgs<T, Gated>::TD;
  int tt;
  __host__ __device__ int x_raw() const { return tt * kChannels * sizeof(TD); }
  __host__ __device__ int z_raw() const {
    return x_raw() + tt * kChannels * sizeof(T);
  }
  __host__ __device__ int b_raw() const {
    return z_raw() + (Gated ? tt * kChannels * sizeof(T) : 0);
  }
  __host__ __device__ int c_raw() const { return b_raw() + tt * N * sizeof(T); }
  __host__ __device__ int raw() const { return c_raw() + tt * N * sizeof(T); }
  __host__ __device__ int dt_s() const { return 2 * raw(); }
  __host__ __device__ int dx_s() const { return dt_s() + tt * kChannels * 4; }
  __host__ __device__ int b_s() const { return dx_s() + tt * kChannels * 4; }
  __host__ __device__ int c_s() const { return b_s() + tt * N * 4; }
  __host__ __device__ int bytes() const { return c_s() + tt * N * 4; }
};

// Stage rows t0..t0+steps-1, columns col0..col0+W-1 (those below ncols)
// of a (batch, time)-strided operand into a dense [steps][W] tile.  With
// vec, 16-byte cp.async copies (a copy that crosses ncols is cut there);
// else element loads.
template <typename T, int W>
__device__ __forceinline__ void stage(T* tile, const T* src, Strides s,
                                      bool vec, int64_t b, int t0, int steps,
                                      int col0, int ncols) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = W / kPer;
  static_assert(W % kPer == 0, "a tile row is whole 16-byte chunks");
  const T* base = src + b * s.b + t0 * s.t + col0;
  const int avail = ncols - col0;
  if (vec) {
    for (int e = threadIdx.x; e < steps * kChunks; e += blockDim.x) {
      const int t = e / kChunks, k = (e - t * kChunks) * kPer;
      const int valid = min(kPer, avail - k);
      if (valid > 0)
        cp_async16(tile + t * W + k, base + t * s.t + k,
                   valid * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int e = threadIdx.x; e < steps * W; e += blockDim.x) {
      const int t = e / W, k = e - t * W;
      if (k < avail) tile[t * W + k] = base[t * s.t + k];
    }
  }
}

template <int N, typename T, bool Gated>
__global__ void __launch_bounds__(kChannels * N / kPerLane)
ssm_scan_kernel(const ScanArgs<T, Gated> a) {
  using TD = typename ScanArgs<T, Gated>::TD;
  using TY = typename ScanArgs<T, Gated>::TY;
  constexpr int G = N / kPerLane;             // lanes a channel spans
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<N, T, Gated> lay{min(kTile, a.L)};
  const int tt = lay.tt;
  float* dt_s = reinterpret_cast<float*>(smem + lay.dt_s());
  float* dx_s = reinterpret_cast<float*>(smem + lay.dx_s());
  float* b_s = reinterpret_cast<float*>(smem + lay.b_s());
  float* c_s = reinterpret_cast<float*>(smem + lay.c_s());
  // y of a tile lands in dx_s: a channel's dt*x of step t is read by its
  // G lanes, whose partial sums feed the shuffles, before the first of
  // them writes y of that step in its place
  float* y_s = dx_s;

  const int64_t b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  // recurrence: channel sc of the block, states 4q..4q+3
  const int sc = tid / G, q = tid - sc * G;
  const bool active = d0 + sc < a.di;
  // prologue and epilogue: channel ec, rows er0, er0 + G, ...
  const int ec = tid % kChannels, er0 = tid / kChannels;
  const int ed = d0 + ec;
  const bool e_active = ed < a.di;

  auto raw = [&](int buf) { return smem + buf * lay.raw(); };
  auto prefetch = [&](int t0, int buf) {
    const int steps = min(tt, a.L - t0);
    unsigned char* r = raw(buf);
    stage<TD, kChannels>(reinterpret_cast<TD*>(r), a.dt, a.s_dt,
                         a.vec & kVecDt, b, t0, steps, d0, a.di);
    stage<T, kChannels>(reinterpret_cast<T*>(r + lay.x_raw()), a.x, a.s_x,
                        a.vec & kVecX, b, t0, steps, d0, a.di);
    if constexpr (Gated)
      stage<T, kChannels>(reinterpret_cast<T*>(r + lay.z_raw()), a.z, a.s_z,
                          a.vec & kVecZ, b, t0, steps, d0, a.di);
    stage<T, N>(reinterpret_cast<T*>(r + lay.b_raw()), a.Bc, a.s_b,
                a.vec & kVecB, b, t0, steps, 0, N);
    stage<T, N>(reinterpret_cast<T*>(r + lay.c_raw()), a.Cc, a.s_c,
                a.vec & kVecC, b, t0, steps, 0, N);
    cp_async_commit();
  };

  if (a.L > 0) prefetch(0, 0);
  float h[kPerLane] = {}, a2[kPerLane] = {};
  const int64_t h_row = (b * a.di + d0 + sc) * N + q * kPerLane;
  if (active) {
    const float* a_row = a.A + static_cast<int64_t>(d0 + sc) * N +
                         q * kPerLane;
#pragma unroll
    for (int j = 0; j < kPerLane; j += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(a.h0 + h_row + j);
      const float4 av = *reinterpret_cast<const float4*>(a_row + j);
      h[j] = hv.x, h[j + 1] = hv.y, h[j + 2] = hv.z, h[j + 3] = hv.w;
      a2[j] = av.x * kLog2e, a2[j + 1] = av.y * kLog2e;
      a2[j + 2] = av.z * kLog2e, a2[j + 3] = av.w * kLog2e;
    }
  }
  float bias = 0.0f, skip = 0.0f;
  if (Gated && e_active) {
    bias = to_f32(a.dt_bias[ed]);
    skip = a.D[ed];
  }

  for (int t0 = 0, buf = 0; t0 < a.L; t0 += tt, buf ^= 1) {
    const int steps = min(tt, a.L - t0);
    cp_async_wait_all();
    __syncthreads();      // tile landed; the previous tile is all done
    if (t0 + tt < a.L) prefetch(t0 + tt, buf ^ 1);
    const unsigned char* r = raw(buf);
    const TD* dt_r = reinterpret_cast<const TD*>(r);
    const T* x_r = reinterpret_cast<const T*>(r + lay.x_raw());
    const T* z_r = reinterpret_cast<const T*>(r + lay.z_raw());
    const T* b_r = reinterpret_cast<const T*>(r + lay.b_raw());
    const T* c_r = reinterpret_cast<const T*>(r + lay.c_raw());

    // prologue
    for (int t = er0; t < steps; t += G) {
      const int i = t * kChannels + ec;
      float dtv = 0.0f, dx = 0.0f;
      if (e_active) {
        dtv = to_f32(dt_r[i]);
        if constexpr (Gated) dtv = softplus(__fadd_rn(dtv, bias));
        dx = __fmul_rn(dtv, to_f32(x_r[i]));
      }
      dt_s[i] = dtv;
      dx_s[i] = dx;
    }
    for (int e = tid; e < steps * N; e += kChannels * G) {
      b_s[e] = to_f32(b_r[e]);
      c_s[e] = to_f32(c_r[e]);
    }
    __syncthreads();

    // recurrence
    for (int t = 0; t < steps; ++t) {
      const float dtv = dt_s[t * kChannels + sc];
      const float dx = dx_s[t * kChannels + sc];
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kPerLane; j += 4) {
        const float4 bv = *reinterpret_cast<const float4*>(
            b_s + t * N + q * kPerLane + j);
        const float4 cv = *reinterpret_cast<const float4*>(
            c_s + t * N + q * kPerLane + j);
        h[j] = fmaf(ex2(dtv * a2[j]), h[j], dx * bv.x);
        h[j + 1] = fmaf(ex2(dtv * a2[j + 1]), h[j + 1], dx * bv.y);
        h[j + 2] = fmaf(ex2(dtv * a2[j + 2]), h[j + 2], dx * bv.z);
        h[j + 3] = fmaf(ex2(dtv * a2[j + 3]), h[j + 3], dx * bv.w);
        acc = fmaf(h[j + 3], cv.w, fmaf(h[j + 2], cv.z,
                                        fmaf(h[j + 1], cv.y,
                                             fmaf(h[j], cv.x, acc))));
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (q == 0) y_s[t * kChannels + sc] = acc;
    }
    __syncthreads();

    // epilogue
    if (e_active) {
      for (int t = er0; t < steps; t += G) {
        const int i = t * kChannels + ec;
        float v = y_s[i];
        if constexpr (Gated) {
          v = __fadd_rn(v, __fmul_rn(to_f32(x_r[i]), skip));
          const float zv = to_f32(z_r[i]);
          const float sg = to_f32(from_f32<T>(1.0f / (1.0f + expf(-zv))));
          v = __fmul_rn(v, to_f32(from_f32<T>(__fmul_rn(zv, sg))));
        }
        a.y[b * a.s_y.b + (t0 + t) * a.s_y.t + ed] = from_f32<TY>(v);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < kPerLane; j += 4)
      *reinterpret_cast<float4*>(a.h_out + h_row + j) =
          make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
  }
}

// The operands as the entry points receive them.
struct Operands {
  const void *dt, *dt_bias, *x, *z, *Bc, *Cc, *A, *D, *h0;
  void *y, *h_out;
  int B, L, di;
  Strides s_dt, s_x, s_z, s_b, s_c, s_y;
};

bool rows16(const void* p, Strides s, size_t item, int B, int L) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (B == 1 || (s.b * item) % 16 == 0) &&
         (L == 1 || (s.t * item) % 16 == 0);
}

template <int N, typename T, bool Gated>
cudaError_t launch(const Operands& o, cudaStream_t stream) {
  using Args = ScanArgs<T, Gated>;
  using TD = typename Args::TD;
  using TY = typename Args::TY;
  const unsigned vec =
      (rows16(o.dt, o.s_dt, sizeof(TD), o.B, o.L) ? kVecDt : 0) |
      (rows16(o.x, o.s_x, sizeof(T), o.B, o.L) ? kVecX : 0) |
      (Gated && rows16(o.z, o.s_z, sizeof(T), o.B, o.L) ? kVecZ : 0) |
      (rows16(o.Bc, o.s_b, sizeof(T), o.B, o.L) ? kVecB : 0) |
      (rows16(o.Cc, o.s_c, sizeof(T), o.B, o.L) ? kVecC : 0);
  const Args a{static_cast<const TD*>(o.dt), static_cast<const T*>(o.dt_bias),
               static_cast<const T*>(o.x),   static_cast<const T*>(o.z),
               static_cast<const T*>(o.Bc),  static_cast<const T*>(o.Cc),
               static_cast<const float*>(o.A),
               static_cast<const float*>(o.D),
               static_cast<const float*>(o.h0), static_cast<TY*>(o.y),
               static_cast<float*>(o.h_out), o.L, o.di, o.s_dt, o.s_x,
               o.s_z, o.s_b, o.s_c, o.s_y, vec};
  const Layout<N, T, Gated> lay{std::min(kTile, o.L)};
  const int smem = lay.bytes();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<N, T, Gated>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((o.di + kChannels - 1) / kChannels, o.B);
  ssm_scan_kernel<N, T, Gated>
      <<<grid, kChannels * N / kPerLane, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool Gated>
cudaError_t dispatch(int N, int dtype, const Operands& o,
                     cudaStream_t stream) {
  if (o.B < 0 || o.L < 0 || o.di < 0 || o.B > 65535)
    return cudaErrorInvalidValue;
  if (o.B == 0 || o.di == 0) return cudaSuccess;
  if (N == 8 && dtype == kF32) return launch<8, float, Gated>(o, stream);
  if (N == 8 && dtype == kBF16)
    return launch<8, __nv_bfloat16, Gated>(o, stream);
  if (N == 16 && dtype == kF32) return launch<16, float, Gated>(o, stream);
  if (N == 16 && dtype == kBF16)
    return launch<16, __nv_bfloat16, Gated>(o, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dt (B,L,di) fp32 (softplus'ed); x (B,L,di), Bc/Cc (B,L,N) of one dtype
// (fp32 or bf16); A (di,N), h0 (B,di,N) fp32 -> y (B,L,di) fp32, h_out
// (B,di,N) fp32 (h_out may be h0).  dt, x, Bc, Cc and y are given by a
// batch stride and a time stride in elements, the last dimension
// contiguous; A, h0 and h_out are contiguous and start on 16 bytes.  N
// must be 8 or 16.
int ssm_scan_chunk(const void* dt, const void* x, const void* Bc,
                   const void* Cc, const void* A, const void* h0, void* y,
                   void* h_out, int B, int L, int di, int N, int64_t dt_sb,
                   int64_t dt_st, int64_t x_sb, int64_t x_st, int64_t b_sb,
                   int64_t b_st, int64_t c_sb, int64_t c_st, int64_t y_sb,
                   int64_t y_st, int dtype, void* stream) {
  const Operands o{dt,          nullptr,      x,  nullptr, Bc,
                   Cc,          A,            nullptr, h0, y,
                   h_out,       B,            L,  di,      {dt_sb, dt_st},
                   {x_sb, x_st}, {0, 0},      {b_sb, b_st}, {c_sb, c_st},
                   {y_sb, y_st}};
  return dispatch<false>(N, dtype, o, static_cast<cudaStream_t>(stream));
}

// The Mamba-1 scan with its prologue and epilogue: dt (raw), x, z (B,L,di),
// dt_bias (di), Bc/Cc (B,L,N) of one dtype T (fp32 or bf16); A (di,N), D
// (di), h0 (B,di,N) fp32 -> y (B,L,di) in T, h_out (B,di,N) fp32 (h_out
// may be h0).  Strides and layouts as for ssm_scan_chunk; dt_bias and D
// contiguous.
int mamba1_scan_chunk(const void* dt, const void* dt_bias, const void* x,
                      const void* z, const void* Bc, const void* Cc,
                      const void* A, const void* D, const void* h0, void* y,
                      void* h_out, int B, int L, int di, int N, int64_t dt_sb,
                      int64_t dt_st, int64_t x_sb, int64_t x_st,
                      int64_t z_sb, int64_t z_st, int64_t b_sb, int64_t b_st,
                      int64_t c_sb, int64_t c_st, int64_t y_sb, int64_t y_st,
                      int dtype, void* stream) {
  const Operands o{dt,           dt_bias,      x,  z,  Bc,
                   Cc,           A,            D,  h0, y,
                   h_out,        B,            L,  di, {dt_sb, dt_st},
                   {x_sb, x_st}, {z_sb, z_st}, {b_sb, b_st}, {c_sb, c_st},
                   {y_sb, y_st}};
  return dispatch<true>(N, dtype, o, static_cast<cudaStream_t>(stream));
}

const char* ssm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
