// Wire-codec pack/unpack kernels for Hopper (sm_90a), bound through ctypes.
//
// They replace the Pallas kernels of the JAX reference package
// (src/repro/kernels/codec_pack.py): _q8_kernel (int8_pack), _dq8_kernel
// (int8_unpack), _q8f_kernel (fp8_pack), _dq8f_kernel (fp8_unpack) and
// _mag_kernel with the lax.top_k around it (topk_select).  The reference
// tiles a zero-padded (rows, 128) view; here every kernel takes a flat n
// and masks its own tail, so nothing is padded or sliced.
//
// What bounds them: all are elementwise passes, one reduction or one
// selection, a few operations per element against 5 to 12 bytes moved,
// so device memory (3.35 TB/s on an H100 SXM) bounds them; at the wire's
// sizes (0.6 to 3.2 M elements) those bytes take a few microseconds, and
// fixed costs set the pace: the launch, each grid-wide sync, and the
// chains of dependent loads between syncs (tools/codec_phases.py times
// each).  Three of them are one cooperative launch each
// (cudaLaunchCooperativeKernel, a grid no larger than the card keeps
// resident, cooperative_groups grid syncs), one CTA an SM:
//
//   int8_pack,  pack_fused_kernel<Int8Sym>, pack_fused_kernel<Fp8E4M3>:
//   fp8_pack    every CTA (1024 threads) loads its contiguous share of x
//               once (16-byte loads, scalar head and tail for a view that
//               is not 16-byte aligned): 16 floats a thread into
//               registers, the rest of the share into dynamic shared
//               memory (up to 200 KB a CTA); it reduces the abs-max,
//               publishes it, waits at one grid sync, folds every CTA's
//               partial, and quantizes from registers and shared memory
//               (int8: cvt.rni and an integer clamp; fp8: the hardware's
//               pair convert).  x is read from HBM once up to about 8.9 M
//               elements (132 CTAs x 67,584); past that the rest is read
//               again after the sync (correct, slower).  No memset, one
//               launch.
//   topk_select topk_select_kernel: a radix select of the k-th largest
//               key over the 31 bits of bits(x) & 0x7FFFFFFF (11 + 11 + 9
//               bits, a shared-memory histogram per CTA merged into a
//               global one with atomics, a grid sync, a scan from the top
//               in every CTA), then an ordered compaction: each CTA owns
//               one contiguous index range, counts its keys above and
//               equal to the threshold, and after a grid sync writes
//               each taken element at its rank (CTA prefix + warp prefix
//               + ballot), so indices come out ascending without a sort.
//               Five grid syncs; the keys stay in registers (16 a
//               thread, 512 threads a CTA: smaller CTAs cross their block
//               barriers and scans sooner) where the CTA's range fits,
//               and are read again from x past that.
//
// Numerics follow the bytes the reference puts on the wire, not its
// kernels/ref.py:
//   amax  = max of bits(x) & 0x7FFFFFFF as unsigned integers: the float
//           max of |x|, and any NaN ranks above inf, so a NaN wins as
//           the reference's jnp.max lets it
//   scale = max(amax, 1e-12) * fp32(1/127)      (1/448 for fp8; XLA folds
//           the reference's "/ 127.0" into this multiply; a NaN amax
//           stays NaN, which fmaxf alone would drop)
//   inv   = 1.0f / scale                        (IEEE division: build
//           without --use_fast_math)
//   int8  = clamp(rint(x * inv), -127, 127), a NaN product giving 0 (as
//           XLA converts NaN to an integer)
//   fp8   = __nv_cvt_float_to_fp8(x * inv, __NV_NOSAT, __NV_E4M3)
//           (round to nearest even, overflow to NaN like the reference)
//   topk  = the k largest keys bits(x) & 0x7FFFFFFF (NaNs above inf, by
//           payload; never fabsf, whose NaN payload PTX leaves open),
//           ties to the lower index, values copied bit for bit
//
// Every entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns a CUDA error code (the
// launch's or cudaGetLastError()) so the Python wrapper can raise on a
// refused launch; it returns cudaErrorInvalidValue, without launching,
// for arguments it cannot take (scratch too small, k outside 1..n).
#include <cooperative_groups.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // 8 resident blocks on each of 132 SMs
// Upper bound of a cooperative grid; the wrappers size their scratch
// for it (kernels/codec_pack.py: COOP_MAX_BLOCKS).
constexpr int kMaxCoopBlocks = 1024;
constexpr int kMaxDevices = 64;

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7FFFFFFFu;
}

__device__ __forceinline__ unsigned abs_bits4(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)),
             max(abs_bits(v.z), abs_bits(v.w)));
}

// The wire's scale from the abs-max's bits; a NaN stays NaN.
__device__ __forceinline__ float scale_from(unsigned amax_bits, float q_max) {
  const float a = __uint_as_float(amax_bits);
  return (isnan(a) ? a : fmaxf(a, 1e-12f)) * (1.0f / q_max);
}

// One quantize step each (quantize; quantize4 below packs four): the
// fused pack kernel takes either type.
struct Fp8E4M3 {
  static constexpr float kMax = 448.0f;
  __device__ static __forceinline__ uint8_t quantize(float v) {
    return __nv_cvt_float_to_fp8(v, __NV_NOSAT, __NV_E4M3);
  }
};

struct Int8Sym {
  static constexpr float kMax = 127.0f;
  __device__ static __forceinline__ uint8_t quantize(float v) {
    const float r = rintf(v);
    if (isnan(r)) return 0;
    return static_cast<uint8_t>(
        static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f)));
  }
};

// Max of ``v`` over the block, in every thread.  ``red`` holds one word
// a warp.
template <int THREADS>
__device__ __forceinline__ unsigned block_max(unsigned v, unsigned* red) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) v = max(v, red[w]);
  __syncthreads();
  return v;
}

// ------------------------------------------------------------ fused pack
constexpr int kPackThreads = 1024;
constexpr int kPackVecs = 4;   // float4s a thread keeps in registers
// A CTA's share past its registers is kept in dynamic shared memory, up
// to this much of the SM's 227 KB; past that it is read again from x.
constexpr int kSpillBytesMax = 200 * 1024;
constexpr int kSpillVecsMax = kSpillBytesMax / 16;

// Four quantized bytes, v.x's lowest (little-endian memory order).
template <class Quant>
__device__ __forceinline__ uint32_t quantize_each(float4 v) {
  return static_cast<uint32_t>(Quant::quantize(v.x))
       | static_cast<uint32_t>(Quant::quantize(v.y)) << 8
       | static_cast<uint32_t>(Quant::quantize(v.z)) << 16
       | static_cast<uint32_t>(Quant::quantize(v.w)) << 24;
}

template <class Quant>
__device__ __forceinline__ uint32_t quantize4(float4 v);

// e4m3 with __NV_NOSAT has no instruction: the header emulates it in
// integer code, tens of operations an element.  Where |v| <= 448 nothing
// saturates, so the hardware's saturating pair convert (cvt.rn.satfinite
// .e4m3x2.f32, the same round to nearest even) gives the same bytes;
// anything else (NaN, or past the e4m3 range) takes the exact emulation.
template <>
__device__ __forceinline__ uint32_t quantize4<Fp8E4M3>(float4 v) {
  const float m = Fp8E4M3::kMax;
  if (fabsf(v.x) <= m && fabsf(v.y) <= m && fabsf(v.z) <= m &&
      fabsf(v.w) <= m) {
    const uint32_t lo = __nv_cvt_float2_to_fp8x2(make_float2(v.x, v.y),
                                                 __NV_SATFINITE, __NV_E4M3);
    const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(v.z, v.w),
                                                 __NV_SATFINITE, __NV_E4M3);
    return lo | hi << 16;
  }
  return quantize_each<Fp8E4M3>(v);
}

// cvt.rni.s32.f32 (round to nearest even, as rintf; it saturates past
// the int range), an integer clamp to +-127, and 0 for a NaN product:
// Int8Sym::quantize's bytes, without its float min/max.
template <>
__device__ __forceinline__ uint32_t quantize4<Int8Sym>(float4 v) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = min(max(__float2int_rn(f[e]), -127), 127);
    w |= (isnan(f[e]) ? 0u : static_cast<uint32_t>(r) & 0xffu) << (8 * e);
  }
  return w;
}

template <class Quant>
__device__ __forceinline__ void store4(uint8_t* q, int64_t at, float4 v,
                                       float inv, bool aligned) {
  const uint32_t w = quantize4<Quant>(
      make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv));
  if (aligned) {
    *reinterpret_cast<uint32_t*>(q + at) = w;
  } else {
    q[at] = w & 0xff;
    q[at + 1] = (w >> 8) & 0xff;
    q[at + 2] = (w >> 16) & 0xff;
    q[at + 3] = w >> 24;
  }
}

// x = ``head`` scalars, then ``nvec`` 16-byte-aligned float4s, then a
// tail of at most 3 scalars.  CTA b owns one contiguous run of the
// float4s: the first kPackVecs x kPackThreads in registers, the next
// ``spill`` in dynamic shared memory (each thread reads back only what
// it wrote, so no barrier), the rest (if any) read again after the sync.
// Block 0 also owns the head and tail.  partials[b] receives the CTA's
// abs-max bits; aux[0] the tensor's, aux[1] the scale.
template <class Quant>
__global__ void __launch_bounds__(kPackThreads)
pack_fused_kernel(const float* __restrict__ x, int64_t n, int head,
                  int64_t nvec, int q_aligned, int spill,
                  unsigned* __restrict__ partials, float* __restrict__ aux,
                  uint8_t* __restrict__ q) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned red[kPackThreads / 32];
  extern __shared__ float4 spilled[];
  const int64_t G = gridDim.x, b = blockIdx.x;
  const int t = threadIdx.x;
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  const int64_t per = (nvec + G - 1) / G;
  const int64_t vb = min(b * per, nvec), ve = min(vb + per, nvec);
  const int64_t re = min(vb + static_cast<int64_t>(kPackVecs) * kPackThreads,
                         ve);
  const int64_t se = min(re + spill, ve);

  float4 v[kPackVecs];
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < kPackVecs; ++j) {
    const int64_t i = vb + t + static_cast<int64_t>(j) * kPackThreads;
    if (i < ve) {
      v[j] = __ldg(xv + i);
      m = max(m, abs_bits4(v[j]));
    }
  }
  for (int64_t i = re + t; i < ve; i += kPackThreads) {
    const float4 a = __ldg(xv + i);
    if (i < se) spilled[i - re] = a;
    m = max(m, abs_bits4(a));
  }
  // head: threads 0..head-1; tail: threads 4..4+tail-1 (block 0)
  const int64_t tail0 = head + 4 * nvec;
  int64_t si = -1;
  float s = 0.0f;
  if (b == 0) {
    if (t < head) si = t;
    else if (t >= 4 && t - 4 < n - tail0) si = tail0 + (t - 4);
    if (si >= 0) {
      s = __ldg(x + si);
      m = max(m, abs_bits(s));
    }
  }
  m = block_max<kPackThreads>(m, red);
  if (t == 0) partials[b] = m;
  grid.sync();

  m = 0;
  for (int64_t i = t; i < G; i += kPackThreads) m = max(m, __ldcg(partials + i));
  m = block_max<kPackThreads>(m, red);
  const float scale = scale_from(m, Quant::kMax);
  const float inv = 1.0f / scale;
  if (b == 0 && t == 0) {
    aux[0] = __uint_as_float(m);
    aux[1] = scale;
  }
#pragma unroll
  for (int j = 0; j < kPackVecs; ++j) {
    const int64_t i = vb + t + static_cast<int64_t>(j) * kPackThreads;
    if (i < ve) store4<Quant>(q, head + 4 * i, v[j], inv, q_aligned);
  }
  for (int64_t i = re + t; i < ve; i += kPackThreads)
    store4<Quant>(q, head + 4 * i, i < se ? spilled[i - re] : __ldg(xv + i),
                  inv, q_aligned);
  if (si >= 0) q[si] = Quant::quantize(s * inv);
}

// ------------------------------------------------------------ topk select
namespace topk {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                    // rows of 32 keys a warp keeps
constexpr int kTile = kThreads * kRows;      // keys a CTA keeps on chip
constexpr int kBins1 = 2048, kBins2 = 2048, kBins3 = 512;   // 11 + 11 + 9 bits
constexpr int kHistWords = kBins1 + kBins2 + kBins3;

// A warp's share of one tile [ts, te) of a CTA's range: ``rows`` rows of
// 32 consecutive elements from ``start`` (lane l holds start + 32 j + l),
// masked at ``end``.  Tile order, then warp order, then row order, then
// lane order is index order.
struct Span {
  int64_t start, end;
  int rows;
};

__device__ __forceinline__ Span warp_span(int64_t ts, int64_t te, int warp) {
  const int64_t rows_total = (te - ts + 31) >> 5;
  const int rows = static_cast<int>((rows_total + kWarps - 1) / kWarps);
  const int64_t start = ts + static_cast<int64_t>(warp) * rows * 32;
  return {start, min(start + static_cast<int64_t>(rows) * 32, te), rows};
}

__device__ __forceinline__ void load_span(const unsigned* __restrict__ xb,
                                          const Span& s, int lane,
                                          unsigned (&w)[kRows]) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int64_t e = s.start + j * 32 + lane;
    w[j] = (j < s.rows && e < s.end) ? __ldg(xb + e) : 0u;
  }
}

// Calls f(span, words) for each tile of the CTA's range [cs, ce) in
// index order: the first tile from the registers ``res``, later tiles
// (only where the range outgrows kTile) read again from x.
template <class F>
__device__ __forceinline__ void for_each_tile(const unsigned* __restrict__ xb,
                                              int64_t cs, int64_t ce,
                                              const unsigned (&res)[kRows],
                                              F&& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t ts = cs; ts < ce; ts += kTile) {
    const Span s = warp_span(ts, min(ts + kTile, ce), warp);
    unsigned w[kRows];
    if (ts == cs) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) w[j] = res[j];
    } else {
      load_span(xb, s, lane, w);
    }
    f(s, w);
  }
}

// The CTA's histogram of digit (u >> SHIFT) & (2^BITS - 1) over its keys
// u whose bits above SHIFT + BITS equal ``prefix``, in shared memory.
template <int SHIFT, int BITS>
__device__ void local_hist(const unsigned* __restrict__ xb, int64_t cs,
                           int64_t ce, const unsigned (&res)[kRows],
                           unsigned prefix, unsigned* s_hist) {
  constexpr unsigned kMask = (1u << BITS) - 1;
  for (int i = threadIdx.x; i <= static_cast<int>(kMask); i += kThreads)
    s_hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for_each_tile(xb, cs, ce, res, [&](const Span& s, const unsigned (&w)[kRows]) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int64_t e = s.start + j * 32 + lane;
      const unsigned u = w[j] & 0x7FFFFFFFu;
      if (j < s.rows && e < s.end && (u >> (SHIFT + BITS)) == prefix)
        atomicAdd(&s_hist[(u >> SHIFT) & kMask], 1u);
    }
  });
  __syncthreads();
}

template <int NB>
__device__ __forceinline__ void merge_hist(const unsigned* s_hist,
                                           unsigned* __restrict__ g) {
  for (int i = threadIdx.x; i < NB; i += kThreads) {
    const unsigned c = s_hist[i];
    if (c) atomicAdd(g + i, c);
  }
}

// The digit d of the global histogram g where the count of keys in bins
// above d is below krem and reaches it with bin d; → s_sel[0] = d,
// s_sel[1] = krem - (keys above d), in every thread after the call.
template <int NB>
__device__ void select_digit(const unsigned* __restrict__ g, unsigned krem,
                             unsigned* s_warp, unsigned* s_sel) {
  constexpr int kPer = (NB + kThreads - 1) / kThreads;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned h[kPer];
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int bin = t * kPer + i;
    h[i] = bin < NB ? __ldcg(g + bin) : 0u;
    sum += h[i];
  }
  // the keys in the bins of higher threads: an inclusive suffix sum over
  // the lanes, then over the warps above
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += o;
  }
  if (lane == 0) s_warp[warp] = incl;
  __syncthreads();
  unsigned above = incl - sum;
  for (int w = warp + 1; w < kWarps; ++w) above += s_warp[w];
#pragma unroll
  for (int i = kPer - 1; i >= 0; --i) {
    if (above < krem && krem <= above + h[i]) {
      s_sel[0] = t * kPer + i;
      s_sel[1] = krem - above;
    }
    above += h[i];
  }
  __syncthreads();
}

// (a, c) summed over the block, in every thread.
__device__ __forceinline__ void block_sum2(unsigned& a, unsigned& c,
                                           unsigned* s_a, unsigned* s_c) {
  a = __reduce_add_sync(0xffffffffu, a);
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) {
    s_a[threadIdx.x >> 5] = a;
    s_c[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  a = c = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += s_a[w];
    c += s_c[w];
  }
  __syncthreads();
}

// scratch: kHistWords words of global histograms (zeroed here before
// the first grid sync), then 2 words a CTA (its counts above and equal to
// the threshold).  1 <= k <= n < 2^31.
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const unsigned* __restrict__ xb, int64_t n, unsigned k,
                   int* __restrict__ idx_out, float* __restrict__ val_out,
                   unsigned* __restrict__ scratch) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned s_hist[kBins1];
  __shared__ unsigned s_a[kWarps], s_c[kWarps];
  __shared__ unsigned s_sel[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t G = gridDim.x, b = blockIdx.x;
  const int64_t per = (n + G - 1) / G;
  const int64_t cs = min(b * per, n), ce = min(cs + per, n);
  unsigned* g1 = scratch;
  unsigned* g2 = g1 + kBins1;
  unsigned* g3 = g2 + kBins2;
  unsigned* counts = g3 + kBins3;

  for (int64_t i = b * kThreads + t; i < kHistWords; i += G * kThreads)
    scratch[i] = 0;
  unsigned res[kRows];
  load_span(xb, warp_span(cs, min(cs + kTile, ce), warp), lane, res);

  // radix select: T = the k-th largest key, r = how many keys equal to T
  // are taken (the lowest-indexed r of them)
  local_hist<20, 11>(xb, cs, ce, res, 0u, s_hist);
  grid.sync();                                  // the zeroed histograms
  merge_hist<kBins1>(s_hist, g1);
  grid.sync();
  select_digit<kBins1>(g1, k, s_a, s_sel);
  const unsigned d1 = s_sel[0];
  unsigned krem = s_sel[1];
  local_hist<9, 11>(xb, cs, ce, res, d1, s_hist);
  merge_hist<kBins2>(s_hist, g2);
  grid.sync();
  select_digit<kBins2>(g2, krem, s_a, s_sel);
  const unsigned p2 = (d1 << 11) | s_sel[0];
  krem = s_sel[1];
  local_hist<0, 9>(xb, cs, ce, res, p2, s_hist);
  merge_hist<kBins3>(s_hist, g3);
  grid.sync();
  select_digit<kBins3>(g3, krem, s_a, s_sel);
  const unsigned T = (p2 << 9) | s_sel[0];
  const unsigned r = s_sel[1];

  // this CTA's keys above and equal to T
  unsigned gt = 0, eq = 0;
  for_each_tile(xb, cs, ce, res, [&](const Span& s, const unsigned (&w)[kRows]) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int64_t e = s.start + j * 32 + lane;
      const unsigned u = w[j] & 0x7FFFFFFFu;
      const bool valid = j < s.rows && e < s.end;
      gt += valid && u > T;
      eq += valid && u == T;
    }
  });
  block_sum2(gt, eq, s_a, s_c);
  if (t == 0) {
    counts[2 * b] = gt;
    counts[2 * b + 1] = eq;
  }
  grid.sync();

  // ordered compaction: an element's slot is the number of taken elements
  // before it, (keys above T before it) + min(keys equal to T before it, r)
  unsigned before_gt = 0, before_eq = 0;
  for (int64_t i = t; i < b; i += kThreads) {
    before_gt += __ldcg(counts + 2 * i);
    before_eq += __ldcg(counts + 2 * i + 1);
  }
  block_sum2(before_gt, before_eq, s_a, s_c);
  const unsigned lanes_below = (1u << lane) - 1u;
  for_each_tile(xb, cs, ce, res, [&](const Span& s, const unsigned (&w)[kRows]) {
    unsigned wgt = 0, weq = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < s.rows) {
        const int64_t e = s.start + j * 32 + lane;
        const unsigned u = w[j] & 0x7FFFFFFFu;
        const bool valid = e < s.end;
        wgt += __popc(__ballot_sync(0xffffffffu, valid && u > T));
        weq += __popc(__ballot_sync(0xffffffffu, valid && u == T));
      }
    }
    if (lane == 0) {
      s_a[warp] = wgt;
      s_c[warp] = weq;
    }
    __syncthreads();
    unsigned pgt = before_gt, peq = before_eq, tile_gt = 0, tile_eq = 0;
    for (int w2 = 0; w2 < kWarps; ++w2) {
      const unsigned a = s_a[w2], c = s_c[w2];
      if (w2 < warp) {
        pgt += a;
        peq += c;
      }
      tile_gt += a;
      tile_eq += c;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < s.rows) {
        const int64_t e = s.start + j * 32 + lane;
        const unsigned u = w[j] & 0x7FFFFFFFu;
        const bool valid = e < s.end;
        const bool above = valid && u > T, equal = valid && u == T;
        const unsigned bg = __ballot_sync(0xffffffffu, above);
        const unsigned be = __ballot_sync(0xffffffffu, equal);
        const unsigned gpos = pgt + __popc(bg & lanes_below);
        const unsigned epos = peq + __popc(be & lanes_below);
        if (above || (equal && epos < r)) {
          const unsigned slot = gpos + min(epos, r);
          idx_out[slot] = static_cast<int>(e);
          val_out[slot] = __uint_as_float(w[j]);
        }
        pgt += __popc(bg);
        peq += __popc(be);
      }
    }
    before_gt += tile_gt;
    before_eq += tile_eq;
  });
}

}  // namespace topk

// ------------------------------------------------------------ unpack
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

// ------------------------------------------------------------ launching
enum CoopKernel {
  kCoopPackInt8, kCoopPackFp8, kCoopTopk,
  // the pack kernels at kSpillBytesMax of dynamic shared memory
  kCoopPackInt8Spill, kCoopPackFp8Spill, kCoopKernels
};

// The most CTAs of a cooperative kernel the current device keeps
// resident at once with ``smem`` bytes of dynamic shared memory each
// (occupancy x SMs, capped at kMaxCoopBlocks), cached per device.  The
// first call on a device also lets the kernel take that much.
int coop_max_blocks(CoopKernel which, const void* kernel, int threads,
                    int smem, int* out) {
  static int cache[kCoopKernels][kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && cache[which][dev] > 0) {
    *out = cache[which][dev];
    return 0;
  }
  if (smem > 0)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = per_sm * sms;
  if (blocks > kMaxCoopBlocks) blocks = kMaxCoopBlocks;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (dev < kMaxDevices) cache[which][dev] = blocks;
  *out = blocks;
  return 0;
}

// ``blocks`` > 0 forces the grid (refused by the runtime if the card
// cannot keep it resident); 0 picks ceil(work / per_block), at least 1,
// at most what the card keeps resident.
int coop_grid(CoopKernel which, const void* kernel, int threads,
              int64_t work, int64_t per_block, int blocks, int* grid) {
  if (blocks > 0) {
    *grid = blocks;
    return 0;
  }
  int most = 0;
  const int err = coop_max_blocks(which, kernel, threads, 0, &most);
  if (err) return err;
  int64_t want = (work + per_block - 1) / per_block;
  if (want < 1) want = 1;
  *grid = static_cast<int>(want < most ? want : most);
  return 0;
}

int launch_coop(const void* kernel, int grid, int threads, void** args,
                size_t smem, cudaStream_t s) {
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, grid, threads,
                                                      args, smem, s);
  const cudaError_t last = cudaGetLastError();   // clears a refusal
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// One cooperative launch of pack_fused_kernel<Quant>.  Where a CTA's
// share outgrows its registers, the grid is the one the card keeps
// resident at kSpillBytesMax a CTA (a forced grid is taken as it is) and
// the overflow goes to shared memory, up to kSpillBytesMax.
template <class Quant>
int launch_pack(const void* x, int64_t n, void* q, void* aux,
                int64_t aux_words, int blocks, void* stream,
                CoopKernel which, CoopKernel which_spill) {
  const float* xf = static_cast<const float*>(x);
  uint8_t* q8 = static_cast<uint8_t*>(q);
  int64_t head = ((16 - (reinterpret_cast<uintptr_t>(xf) & 15)) & 15) / 4;
  if (head > n) head = n;
  int64_t nvec = (n - head) / 4;
  const void* kernel = reinterpret_cast<const void*>(&pack_fused_kernel<Quant>);
  int grid = 0;
  int err = coop_grid(which, kernel, kPackThreads, nvec, kPackThreads,
                      blocks, &grid);
  if (err) return err;
  constexpr int64_t kRegVecs = static_cast<int64_t>(kPackVecs) * kPackThreads;
  int64_t over = (nvec + grid - 1) / grid - kRegVecs;
  if (over > 0) {
    int most = 0;
    err = coop_max_blocks(which_spill, kernel, kPackThreads, kSpillBytesMax,
                          &most);
    if (err) return err;
    if (blocks <= 0 && grid > most) {
      grid = most;
      over = (nvec + grid - 1) / grid - kRegVecs;
    }
  }
  if (aux_words < 2 + static_cast<int64_t>(grid))
    return static_cast<int>(cudaErrorInvalidValue);
  int spill = static_cast<int>(over < 0 ? 0 : over < kSpillVecsMax
                                                  ? over : kSpillVecsMax);
  int h = static_cast<int>(head);
  int q_aligned = (reinterpret_cast<uintptr_t>(q8 + head) & 3) == 0;
  float* auxf = static_cast<float*>(aux);
  unsigned* partials = static_cast<unsigned*>(aux) + 2;
  void* args[] = {&xf, &n, &h, &nvec, &q_aligned, &spill, &partials, &auxf,
                  &q8};
  return launch_coop(kernel, grid, kPackThreads, args,
                     static_cast<size_t>(spill) * sizeof(float4),
                     static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// aux: aux_words fp32 words of device scratch, at least 2 + the grid's
// CTAs; aux[0] receives max|x| (its bits, see abs_bits), aux[1] the
// scale, the rest each CTA's partial abs-max.  n >= 0 (n = 0 gives the
// reference's scale of an empty tensor, 1e-12 / 127 or / 448).
// ``blocks`` > 0 forces the grid.
int codec_int8_pack(const void* x, int64_t n, void* q, void* aux,
                    int64_t aux_words, int blocks, void* stream) {
  return launch_pack<Int8Sym>(x, n, q, aux, aux_words, blocks, stream,
                              kCoopPackInt8, kCoopPackInt8Spill);
}

int codec_fp8_pack(const void* x, int64_t n, void* q, void* aux,
                   int64_t aux_words, int blocks, void* stream) {
  return launch_pack<Fp8E4M3>(x, n, q, aux, aux_words, blocks, stream,
                              kCoopPackFp8, kCoopPackFp8Spill);
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

// idx: k int32, val: k fp32, ascending by index.  scratch: scratch_words
// 32-bit words, at least topk::kHistWords + 2 x the grid's CTAs.
int codec_topk_select(const void* x, int64_t n, int64_t k, void* idx,
                      void* val, void* scratch, int64_t scratch_words,
                      int blocks, void* stream) {
  if (n < 1 || n >= (int64_t{1} << 31) || k < 1 || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(&topk::topk_select_kernel);
  int grid = 0;
  int err = coop_grid(kCoopTopk, kernel, topk::kThreads, n, topk::kThreads,
                      blocks, &grid);
  if (err) return err;
  if (scratch_words < topk::kHistWords + 2 * static_cast<int64_t>(grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned* xb = static_cast<const unsigned*>(x);
  unsigned kk = static_cast<unsigned>(k);
  int* ip = static_cast<int*>(idx);
  float* vp = static_cast<float*>(val);
  unsigned* sp = static_cast<unsigned*>(scratch);
  void* args[] = {&xb, &n, &kk, &ip, &vp, &sp};
  return launch_coop(kernel, grid, topk::kThreads, args, 0,
                     static_cast<cudaStream_t>(stream));
}

const char* codec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
