// Wire-codec pack/unpack kernels for Hopper (sm_90a), bound through ctypes.
//
// They replace the Pallas kernels of the JAX reference package
// (src/repro/kernels/codec_pack.py): _q8_kernel (int8_pack), _dq8_kernel
// (int8_unpack), _q8f_kernel (fp8_pack), _dq8f_kernel (fp8_unpack) and
// _mag_kernel (topk_select).  The reference tiles a zero-padded
// (rows, 128) view; here every kernel takes a flat n with a grid-stride
// loop and masks the tail, so nothing is padded or sliced.
//
// What bounds them: all five are elementwise passes or one reduction, a
// few operations per element against 5 to 12 bytes moved, so device
// memory (3.35 TB/s on an H100 SXM) is the limit.  Loads are coalesced
// (neighbouring threads read neighbouring elements) and nothing is
// staged in shared memory beyond the block reduction's 32 partials.
//
// Numerics follow the bytes the reference puts on the wire, not its
// kernels/ref.py:
//   scale = max(max|x|, 1e-12) * fp32(1/127)   (1/448 for fp8; XLA folds
//           the reference's "/ 127.0" into this multiply)
//   inv   = 1.0f / scale                        (IEEE division: build
//           without --use_fast_math)
//   int8  = clamp(rint(x * inv), -127, 127)     (round half to even)
//   fp8   = __nv_cvt_float_to_fp8(x * inv, __NV_NOSAT, __NV_E4M3)
//           (round to nearest even, overflow to NaN like the reference)
//
// Every entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // 8 resident blocks on each of 132 SMs

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// max|x| over the whole tensor.  Each block reduces its grid-stride share
// in registers and shared memory, then one atomicMax per block folds it
// into *amax.  The bit patterns of non-negative floats order like the
// unsigned integers they are, so an integer atomicMax is a float max.
// *amax must be 0 before the launch (the caller memsets it).
__global__ void absmax_kernel(const float* __restrict__ x, int64_t n,
                              unsigned int* __restrict__ amax) {
  __shared__ float partial[kThreads / 32];
  float m = 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    m = fmaxf(m, fabsf(x[i]));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? partial[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(amax, __float_as_uint(m));
  }
}

__device__ __forceinline__ float scale_from(const float* amax, float rcp_max) {
  return fmaxf(*amax, 1e-12f) * rcp_max;
}

// int8 quantize: every thread derives scale and inv from the reduced
// abs-max (two flops, identical in every thread); thread 0 also stores
// the scale the wire carries.
__global__ void int8_pack_kernel(const float* __restrict__ x, int64_t n,
                                 const float* __restrict__ amax,
                                 int8_t* __restrict__ q,
                                 float* __restrict__ scale_out) {
  const float scale = scale_from(amax, 1.0f / 127.0f);
  const float inv = 1.0f / scale;
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float r = rintf(x[i] * inv);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    q[i] = static_cast<int8_t>(r);
  }
}

__global__ void fp8_pack_kernel(const float* __restrict__ x, int64_t n,
                                const float* __restrict__ amax,
                                __nv_fp8_storage_t* __restrict__ q,
                                float* __restrict__ scale_out) {
  const float scale = scale_from(amax, 1.0f / 448.0f);
  const float inv = 1.0f / scale;
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    q[i] = __nv_cvt_float_to_fp8(x[i] * inv, __NV_NOSAT, __NV_E4M3);
  }
}

__global__ void int8_unpack_kernel(const int8_t* __restrict__ q, float scale,
                                   float* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = static_cast<float>(q[i]) * scale;
  }
}

__global__ void fp8_unpack_kernel(const __nv_fp8_storage_t* __restrict__ q,
                                  float scale, float* __restrict__ out,
                                  int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    // e4m3 -> half is exact, half -> float is exact
    const __half_raw h = __nv_cvt_fp8_to_halfraw(q[i], __NV_E4M3);
    out[i] = __half2float(__half(h)) * scale;
  }
}

// The magnitude pass of topk_select, widened to one unique sort key per
// element: (bits(|x|) << 32) | (0xFFFFFFFF - i).  Larger keys mean larger
// magnitudes and, among equal magnitudes, lower indices — exactly the
// order lax.top_k selects in, so a top-k over the keys needs no tie rule.
__global__ void topk_keys_kernel(const float* __restrict__ x, int64_t n,
                                 int64_t* __restrict__ keys) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint64_t mag = __float_as_uint(fabsf(x[i]));
    keys[i] = static_cast<int64_t>((mag << 32) | (0xFFFFFFFFull - static_cast<uint64_t>(i)));
  }
}

int launch_absmax(const float* x, int64_t n, float* amax, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  absmax_kernel<<<grid_for(n), kThreads, 0, s>>>(
      x, n, reinterpret_cast<unsigned int*>(amax));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// aux: 2 fp32 words of device scratch; aux[0] receives max|x|, aux[1] the
// scale.  n >= 1 (the wrapper handles empty tensors without a launch).
int codec_int8_pack(const void* x, int64_t n, void* q, void* aux, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(aux);
  int err = launch_absmax(static_cast<const float*>(x), n, a, s);
  if (err) return err;
  int8_pack_kernel<<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const float*>(x), n, a, static_cast<int8_t*>(q), a + 1);
  return static_cast<int>(cudaGetLastError());
}

int codec_fp8_pack(const void* x, int64_t n, void* q, void* aux, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(aux);
  int err = launch_absmax(static_cast<const float*>(x), n, a, s);
  if (err) return err;
  fp8_pack_kernel<<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const float*>(x), n, a,
      static_cast<__nv_fp8_storage_t*>(q), a + 1);
  return static_cast<int>(cudaGetLastError());
}

int codec_int8_unpack(const void* q, float scale, void* out, int64_t n,
                      void* stream) {
  int8_unpack_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), scale, static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

int codec_fp8_unpack(const void* q, float scale, void* out, int64_t n,
                     void* stream) {
  fp8_unpack_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_fp8_storage_t*>(q), scale,
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

int codec_topk_keys(const void* x, int64_t n, void* keys, void* stream) {
  topk_keys_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<int64_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

const char* codec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
