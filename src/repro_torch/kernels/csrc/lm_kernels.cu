// Attention and RMSNorm kernels of the LM serving path for Hopper (sm_90a),
// bound through ctypes.
//
// They replace three Pallas kernels of the JAX reference package:
//   flash_attention_kernel  <- src/repro/kernels/flash_attention.py _flash_kernel
//   decode_attention_kernel <- src/repro/kernels/decode_attention.py _decode_kernel
//   rmsnorm_kernel          <- src/repro/kernels/fused_rmsnorm.py _rms_kernel
//
// Each is templated on the element type (float and __nv_bfloat16
// instances) and computes in fp32: loads convert to float, sums and the
// online-softmax state are fp32, and the result is rounded once, to
// nearest even, on the store.  Build without --use_fast_math: expf and
// the division are the IEEE ones.  rsqrtf differs from torch.rsqrt in
// the last ulp, so the norm matches its plain version to 2e-5 in fp32,
// not bit for bit.
//
// Every entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.  These are the simple,
// right first versions: FMA loops over shared-memory tiles, no tensor
// cores, no TMA pipeline.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeadDim = 128;        // every registry arch has hd <= 128
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// Prefill attention.  Replaces _flash_kernel (flash_attention.py:30).
//
// One CTA of 128 threads per (q tile of kBQ rows, query head, batch row).
// The loop over KV tiles of kBK keys takes the place of the TPU grid's
// sequential innermost axis; the running max, running sum and the fp32
// output accumulator stay in registers for the whole loop.  Thread
// (ty, tx) = (tid / 8, tid % 8) owns query rows ty*4 .. ty*4+3: in the
// score tile it computes keys tx*4 .. tx*4+3 of those rows, and in the
// output it accumulates head-dim columns tx, tx+8, ... of the same rows,
// so a row's softmax state never leaves the 8 lanes that share it (row
// max and row sum are 3-step shuffles).  Q and K tiles are stored with a
// row stride of hd+1 floats so the strided reads of the score loop hit
// distinct banks.
//
// GQA: query head h reads KV head h / (H / KV), as the reference's index
// maps do; no head is replicated.  Causal masking is decided from token
// positions (query i sees key j iff j <= i + T - S), and a KV tile that
// starts past the q tile's last visible key is never loaded.  The
// reference skips by block index (j <= i), which is right only for equal
// q and kv tiles; here the tiles differ (64 and 32) and S, T need not
// divide them: ragged edges are masked.
//
// What bounds it on an H100: at the slice's shapes (S = T = 1024, hd =
// 128) the work is 4*B*H*S*T*hd/2 flops against a few MB, far above the
// card's 295 flops per byte, so operations bound it (989 TFLOP/s is the
// bf16 tensor-core peak; these FMA loops reach a fraction of the 67
// TFLOP/s fp32 rate).  Moving the two products onto mma.sync / wgmma is
// the next step.
constexpr int kFlashThreads = 128;
constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kColsPerThread = kMaxHeadDim / 8;

size_t flash_smem_bytes(int hd) {
  const size_t ld = hd + 1;
  return sizeof(float) * (kBQ * ld + kBK * ld + kBK * hd + kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int T_len, int H, int KV, int hd, int causal,
                       float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* q_s = smem;                  // kBQ x ld
  float* k_s = q_s + kBQ * ld;        // kBK x ld
  float* v_s = k_s + kBK * ld;        // kBK x hd
  float* p_s = v_s + kBK * hd;        // kBQ x (kBK + 1)

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t kv_row = static_cast<int64_t>(KV) * hd;
  const T* qb = q + static_cast<int64_t>(b) * S * q_row
                + static_cast<int64_t>(h) * hd;
  const T* kb = k + static_cast<int64_t>(b) * T_len * kv_row
                + static_cast<int64_t>(kvh) * hd;
  const T* vb = v + static_cast<int64_t>(b) * T_len * kv_row
                + static_cast<int64_t>(kvh) * hd;

  for (int e = tid; e < kBQ * hd; e += kFlashThreads) {
    const int r = e / hd, d = e - r * hd;
    q_s[r * ld + d] = (i0 + r < S)
        ? to_f32(qb[static_cast<int64_t>(i0 + r) * q_row + d]) : 0.0f;
  }

  float acc[4][kColsPerThread];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[i][c] = 0.0f;
  }

  const int offset = T_len - S;
  const int last_row = min(i0 + kBQ, S) - 1;
  const int kv_end = causal ? min(T_len, last_row + offset + 1) : T_len;

  for (int j0 = 0; j0 < kv_end; j0 += kBK) {
    __syncthreads();    // Q is loaded / the last tile's readers are done
    for (int e = tid; e < kBK * hd; e += kFlashThreads) {
      const int r = e / hd, d = e - r * hd;
      const bool ok = j0 + r < T_len;
      const int64_t g = static_cast<int64_t>(j0 + r) * kv_row + d;
      k_s[r * ld + d] = ok ? to_f32(kb[g]) : 0.0f;
      v_s[r * hd + d] = ok ? to_f32(vb[g]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx * 4 + j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + tx * 4 + j;
        const bool ok = col < T_len && (!causal || col <= row + offset);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 4));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
      const float m_new = fmaxf(m[i], mt);
      float alpha = 1.0f, rs = 0.0f;
      if (m_new == -INFINITY) {           // nothing visible yet in this row
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      } else {
        alpha = expf(m[i] - m_new);       // 0 on the row's first tile
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
      }
      rs += __shfl_xor_sync(kFull, rs, 4);
      rs += __shfl_xor_sync(kFull, rs, 2);
      rs += __shfl_xor_sync(kFull, rs, 1);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(ty * 4 + i) * (kBK + 1) + tx * 4 + j] = s[i][j];
    }
    __syncthreads();

    for (int t = 0; t < kBK; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty * 4 + i) * (kBK + 1) + t];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int d = tx + 8 * c;
        if (d < hd) {
          const float vv = v_s[t * hd + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

  T* ob = out + static_cast<int64_t>(b) * S * q_row
          + static_cast<int64_t>(h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int d = tx + 8 * c;
      if (d < hd)
        ob[static_cast<int64_t>(row) * q_row + d] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Cached decode attention.  Replaces _decode_kernel (decode_attention.py:26).
//
// One CTA of 128 threads per (KV head, batch row).  It holds the G = H/KV
// query rows of that KV head in shared memory and reads every cache row
// 0..pos once, for all G of them, in tiles of kTile positions (a tile of K
// and V is staged in shared memory as fp32).  Per tile: each warp takes
// positions and reduces the G dot products over hd with shuffles; each
// warp takes query rows for the online-softmax update (one lane per
// position); each thread then owns (row, column) pairs of the fp32
// accumulator.  The loop stops at pos: positions past it are neither
// read nor masked, where the TPU grid swept all of Smax and predicated.
//
// What bounds it on an H100: the bytes of the k and v rows 0..pos (each
// read once) plus q and o, at 3.35 TB/s; the flops are 4 per cached
// element and query row.  With one CTA per (b, KV head) (64 CTAs at the
// slice's batch 8 x 8 KV heads, on 132 SMs) the card is under-filled;
// splitting the sequence across CTAs (flash-decoding) is later work.
constexpr int kDecodeThreads = 128;
constexpr int kTile = 32;               // one lane per position in a tile

size_t decode_smem_bytes(int G, int hd) {
  return sizeof(float) * (2 * G * hd + 2 * kTile * hd + G * kTile + 3 * G);
}

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, T* __restrict__ out, int H,
                        int KV, int Smax, int hd, int pos, float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  float* q_s = smem;                  // G x hd
  float* acc_s = q_s + G * hd;        // G x hd
  float* k_s = acc_s + G * hd;        // kTile x hd
  float* v_s = k_s + kTile * hd;      // kTile x hd
  float* p_s = v_s + kTile * hd;      // G x kTile: scores, then weights
  float* m_s = p_s + G * kTile;       // G running max
  float* l_s = m_s + G;               // G running sum
  float* a_s = l_s + G;               // G rescale of the current tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kDecodeThreads / 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int64_t head0 = static_cast<int64_t>(b) * H
                        + static_cast<int64_t>(kvh) * G;
  const int64_t row = static_cast<int64_t>(KV) * hd;
  const int64_t base = static_cast<int64_t>(b) * Smax * row
                       + static_cast<int64_t>(kvh) * hd;
  const T* qb = q + head0 * hd;       // the group's G rows are adjacent
  const T* kb = kc + base;
  const T* vb = vc + base;

  for (int e = tid; e < G * hd; e += kDecodeThreads) {
    q_s[e] = to_f32(qb[e]);
    acc_s[e] = 0.0f;
  }
  for (int g = tid; g < G; g += kDecodeThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.0f;
  }

  for (int t0 = 0; t0 <= pos; t0 += kTile) {
    const int n = min(kTile, pos + 1 - t0);
    __syncthreads();    // q is loaded / the last tile's readers are done
    for (int e = tid; e < n * hd; e += kDecodeThreads) {
      const int t = e / hd, d = e - t * hd;
      const int64_t g = static_cast<int64_t>(t0 + t) * row + d;
      k_s[e] = to_f32(kb[g]);
      v_s[e] = to_f32(vb[g]);
    }
    __syncthreads();

    for (int t = warp; t < n; t += kWarps) {
      for (int g = 0; g < G; ++g) {
        float part = 0.0f;
        for (int d = lane; d < hd; d += 32)
          part = fmaf(q_s[g * hd + d], k_s[t * hd + d], part);
        part = warp_sum(part);
        if (lane == 0) p_s[g * kTile + t] = part * scale;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      const float s = lane < n ? p_s[g * kTile + lane] : -INFINITY;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));   // finite: lane 0 < n
      const float p = lane < n ? expf(s - m_new) : 0.0f;
      const float sum = warp_sum(p);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);       // 0 on the first tile
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * hd; e += kDecodeThreads) {
      const int g = e / hd, d = e - g * hd;
      const float* pg = p_s + g * kTile;
      float a = acc_s[e] * a_s[g];
      for (int t = 0; t < n; ++t) a = fmaf(pg[t], v_s[t * hd + d], a);
      acc_s[e] = a;
    }
  }
  __syncthreads();

  T* ob = out + head0 * hd;
  for (int e = tid; e < G * hd; e += kDecodeThreads) {
    const int g = e / hd;
    ob[e] = from_f32<T>(acc_s[e] / fmaxf(l_s[g], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// RMSNorm.  Replaces _rms_kernel (fused_rmsnorm.py:16).
//
// One warp per row, 8 rows per CTA: the lanes read the row once for a
// fp32 sum of squares (shuffle-reduced), take rsqrtf(mean + eps), and
// write x * r * scale; the second read of the row hits L1.  Any d works:
// lanes stride the row by 32, so neighbouring lanes touch neighbouring
// elements.
//
// What bounds it on an H100: bytes, 2 * rows * d * itemsize (one read, one
// write) at 3.35 TB/s; a few flops per element.
constexpr int kNormThreads = 256;

template <typename T, typename S>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kNormThreads / 32)
                    + (threadIdx.x >> 5);
  if (r >= rows) return;              // whole warps leave together
  const T* xr = x + r * d;
  T* yr = out + r * d;
  float ss = 0.0f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int i = lane; i < d; i += 32)
    yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
}

template <typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int T_len, int H, int KV,
                         int hd, int causal, float scale,
                         cudaStream_t stream) {
  const size_t smem = flash_smem_bytes(hd);
  cudaError_t err = allow_smem(flash_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, H, KV, hd,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc,
                          void* out, int B, int H, int KV, int Smax, int hd,
                          int pos, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(H / KV, hd);
  cudaError_t err = allow_smem(decode_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, B);
  decode_attention_kernel<T><<<grid, kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(out), H, KV, Smax, hd, pos,
      scale);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_rmsnorm(const void* x, const void* scale, void* out,
                           int64_t rows, int d, float eps,
                           cudaStream_t stream) {
  constexpr int kRowsPerBlock = kNormThreads / 32;
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<T, S><<<static_cast<unsigned>(blocks), kNormThreads, 0,
                         stream>>>(static_cast<const T*>(x),
                                   static_cast<const S*>(scale),
                                   static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,S,H,hd), k/v (B,T,KV,hd) -> out (B,S,H,hd), all contiguous and of
// one dtype.  Needs hd <= 128, H % KV == 0 and, when causal, T >= S.
int lm_flash_attention(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int T_len, int H, int KV,
                       int hd, int causal, float scale, int dtype,
                       void* stream) {
  if (hd < 1 || hd > kMaxHeadDim || KV < 1 || H % KV != 0
      || (causal && T_len < S))
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (T_len == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_flash<float>(q, k, v, out, B, S, T_len, H, KV, hd, causal,
                               scale, s);
  if (dtype == kBF16)
    return launch_flash<__nv_bfloat16>(q, k, v, out, B, S, T_len, H, KV, hd,
                                       causal, scale, s);
  return cudaErrorInvalidValue;
}

// q (B,H,hd), caches (B,Smax,KV,hd) -> out (B,H,hd); attends 0..pos.
int lm_decode_attention(const void* q, const void* kc, const void* vc,
                        void* out, int B, int H, int KV, int Smax, int hd,
                        int pos, float scale, int dtype, void* stream) {
  if (hd < 1 || hd > kMaxHeadDim || KV < 1 || H % KV != 0 || pos < 0
      || pos >= Smax)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_decode<float>(q, kc, vc, out, B, H, KV, Smax, hd, pos,
                                scale, s);
  if (dtype == kBF16)
    return launch_decode<__nv_bfloat16>(q, kc, vc, out, B, H, KV, Smax, hd,
                                        pos, scale, s);
  return cudaErrorInvalidValue;
}

// x (rows, d), scale (d,) -> out (rows, d).  x and out share a dtype; the
// scale may be fp32 or bf16 on its own.
int lm_rmsnorm(const void* x, const void* scale, void* out, int64_t rows,
               int d, float eps, int x_dtype, int s_dtype, void* stream) {
  if (d < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && s_dtype == kF32)
    return launch_rmsnorm<float, float>(x, scale, out, rows, d, eps, s);
  if (x_dtype == kF32 && s_dtype == kBF16)
    return launch_rmsnorm<float, __nv_bfloat16>(x, scale, out, rows, d, eps,
                                                s);
  if (x_dtype == kBF16 && s_dtype == kF32)
    return launch_rmsnorm<__nv_bfloat16, float>(x, scale, out, rows, d, eps,
                                                s);
  if (x_dtype == kBF16 && s_dtype == kBF16)
    return launch_rmsnorm<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows,
                                                        d, eps, s);
  return cudaErrorInvalidValue;
}

const char* lm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
