// Attention and RMSNorm kernels of the LM serving path for Hopper (sm_90a),
// bound through ctypes.
//
// They replace three Pallas kernels of the JAX reference package:
//   flash_attention_tc_kernel (bf16), flash_attention_kernel (fp32)
//                           <- src/repro/kernels/flash_attention.py _flash_kernel
//   decode_split_kernel + decode_combine_kernel
//                           <- src/repro/kernels/decode_attention.py _decode_kernel
//   rmsnorm_vec_kernel (rmsnorm_kernel for rows it cannot take)
//                           <- src/repro/kernels/fused_rmsnorm.py _rms_kernel
//
// Every kernel computes in fp32: loads convert to float, sums and the
// online-softmax state are fp32, and the result is rounded once, to nearest
// even, on the store.  The bf16 prefill kernel also rounds the softmax
// weights P to bf16 for the P.V product, as the tensor cores take it, and
// exponentiates with ex2.approx.ftz.  Build without --use_fast_math: the
// other kernels' expf, exp2f and divisions are the IEEE ones.  rsqrtf
// differs from torch.rsqrt in the last ulp, so the norm matches its plain
// version to 2e-5 in fp32, not bit for bit.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing (the decode scratch comes from the wrapper), and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  The bf16 prefill kernel is warp-specialised: a TMA producer fills
// a four-stage K/V ring behind mbarriers, and two consumer warpgroups run
// both products on the tensor cores (wgmma) with Q and P in registers.
// Decode splits the cache across CTAs and reads it with 16-byte loads
// straight into registers, as RMSNorm reads its rows.  The fp32 prefill
// kernel is an FMA loop.
#include <cuda.h>              // CUtensorMap (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeadDim = 128;        // every registry arch has hd <= 128
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
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
// Hopper building blocks: mbarriers, TMA, wgmma.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  For a K-major
// operand LBO is unused (16) and SBO = 1024 steps between 8-row groups; for
// the MN-major V operand LBO steps between 64-column blocks and SBO between
// groups of 8 keys.  The tile bases are 1024-byte aligned.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
         | (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {   // all but the newest
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// mbarriers in shared memory: init (one thread), arrive, and wait for the
// phase of the given parity to complete.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// Hand registers back to the pool / take them from it, per warpgroup.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// 2^x in one MUFU op, results below 2^-126 flushed to 0.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma reads and writes its registers asynchronously: these empty asms
// pin them, so that the compiler neither reads an accumulator before the
// wait nor reuses an operand register while the product is in flight.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D16(i) WG_D4(i), WG_D4(i + 4), WG_D4(i + 8), WG_D4(i + 12)

// d[64 x N] (+)= A[64 x 16] . B[16 x N], N = 64 (d[32]) or 128 (d[64]):
// A in registers (four bf16x2: the accumulator layout of a 64 x 16 slice),
// B in shared memory, K-major (kTransB = 0) or MN-major (kTransB = 1).
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_D16(0), WG_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, %70;\n}\n"
      : WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(kTransB));
}

#undef WG_D16
#undef WG_D4

// (x, y) as bf16x2 pairs hi + lo, hi = bf16(x) and lo = bf16(x - hi): 16
// bits of mantissa between them, x in the low half of each word
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// Prefill attention, bf16, on the tensor cores.  Replaces _flash_kernel
// (flash_attention.py:30) for bf16 inputs.
//
// One CTA per (128 query rows, query head, batch row): two consumer
// warpgroups of 64 rows each and a producer warpgroup, which hands most of
// its registers to the consumers (setmaxnreg: 24 against 240 a thread).  The loop over KV
// tiles of 64 keys takes the place of the TPU grid's sequential innermost
// axis.
//
// Producer: one thread issues TMA copies of K and V tiles (64 keys x 64
// columns a copy, zero-filled past T and hd, with the 128-byte swizzle
// that the wgmma descriptors name) into a ring of four stages (128 KB at
// HD = 128), each completing on its stage's "full" mbarrier; it reuses a
// stage once both warpgroups have arrived on its "empty" mbarrier.  The
// consumers issue no copies and meet at no __syncthreads in the loop.
//
// Consumers: each holds its 64 rows of Q in registers, as the register-A
// fragments of the S product (32 registers a thread at HD = 128, read
// once).  Per tile j+1 (FA3's order, no product in flight across
// iterations): issue S_{j+1} = Q.K^T (wgmma m64n64k16, K K-major in shared
// memory), rescale the fp32 output accumulator, issue O += P_j.V_j (wgmma
// m64nHDk16, P from registers: the accumulator's fragment layout is
// wgmma's register-A layout once packed to bf16x2; V MN-major, transpose
// bit set); wait for S_{j+1} and run its online softmax while P_j.V_j is
// still on the tensor cores; wait for that; pack P_{j+1}; release tile j.
// P goes in as two bf16 parts, P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// two products into the same accumulator: 16 bits of P's mantissa, close
// to the plain route's fp32 P.  P_hi alone (SDPA's rounding) is about 15 %
// faster but 4x further from the plain version, and flips one near-tied
// argmax of qwen3-1.7b's prefill logits (random weights, seed 0) against
// the plain route; at seeds 1 and 2 neither form flips one
// (tools/flash_p_rounding.py builds and reads both).
// Scores are pre-scaled by scale * log2(e) and exponentiated with
// ex2.approx.ftz (one MUFU op; results below 2^-126 flush to 0, which
// bf16 P could not carry against a row sum >= 1 anyway); row max and row
// sum over the 4 lanes that share a row.  Softmax state and the 64 x HD
// accumulator stay in registers for the whole loop.
//
// GQA: query head h reads KV head h / (H / KV), with no replication (the
// tensor map's KV-head coordinate).  Causal masking is decided from token
// positions (query i sees key j iff j <= i + T - S): no tile past the
// CTA's last visible key is loaded, a warpgroup computes no tile past its
// own last visible key (it only releases it), and only tiles that
// straddle the diagonal or the ragged end of T are masked.  q tiles are
// launched longest first (grid.y reversed, heads and batch rows fastest).
// HD is 64 or 128; a smaller hd (a multiple of 8: TMA strides are whole
// 16 bytes) is zero-filled by the copies and in Q's fragments.
//
// What bounds it on an H100: operations.  At the slice's shapes (S = T =
// 1024, hd = 128) the causal work is 4*B*H*S*T*hd/2 flops over a few MB
// read, far above the card's 295 flops per byte, against 989 TFLOP/s of
// bf16 tensor cores.  Timed with its products taken out, an earlier
// design of this kernel (all 256 threads issuing cp.async, one
// __syncthreads a tile) kept most of its time: the copies, the barrier and
// the softmax on the same warps, not the tensor cores, set its pace.
// Hence the TMA producer, the mbarrier ring and the overlap of each
// softmax with the previous tile's P.V; the producer warpgroup's registers
// go to the consumers, without which ptxas serialises the wgmma.  The
// split P doubles the P.V products and costs time for its accuracy.
constexpr int kTcConsumers = 2;               // consumer warpgroups a CTA
constexpr int kTcThreads = 128 * (kTcConsumers + 1);  // + the producer
// registers a thread: the producer warpgroup gives its share to the
// consumers (128 * (24 + 2 * 240) <= 65,536)
constexpr int kTcProducerRegs = 24;
constexpr int kTcConsumerRegs = 240;
constexpr int kTcBQ = 64 * kTcConsumers;      // query rows a CTA
constexpr int kTcBK = 64;                     // keys a KV tile
constexpr int kTcStages = 4;                  // depth of the K/V ring
static_assert(kTcBK == 64, "S (float[32]) and P (uint32_t[16]) hold 64 keys");

template <int HD>
constexpr size_t tc_smem_bytes() {
  // one extra KB to align the tiles to the 1024-byte swizzle atom
  return 1024 + sizeof(bf16) * HD * 2 * kTcStages * kTcBK;
}

// TMA: one 4-D box of `map` at coordinates (c0 .. c3), innermost first,
// into shared memory at dst, completing `bytes` on the mbarrier bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const bf16* __restrict__ q, bf16* __restrict__ out,
                          int S, int T_len, int H, int KV, int hd, int causal,
                          float scale_log2) {
  constexpr uint32_t kKVBlock = kTcBK * 128;   // one 64-column block
  constexpr uint32_t kTile = kTcBK * HD * 2;   // one K or V tile
  constexpr int kO = HD / 2;                   // accumulator floats a thread
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // stage st's "full" and "empty" barriers
  __shared__ __align__(8) uint64_t bars[2 * kTcStages];
  const uint32_t kv_s = (smem_addr(smem_raw) + 1023u) & ~1023u;  // K, V
  const uint32_t full0 = smem_addr(&bars[0]);
  const uint32_t empty0 = smem_addr(&bars[kTcStages]);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;   // longest first
  const int kvh = h / (H / KV);
  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const bf16* qb = q + static_cast<int64_t>(b) * S * q_row
                   + static_cast<int64_t>(h) * hd;
  const int offset = T_len - S;
  const int kv_end = causal ? min(T_len, min(i0 + kTcBQ, S) + offset)
                            : T_len;
  const int n_tiles = (kv_end + kTcBK - 1) / kTcBK;

  if (tid == 0) {
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 128 * kTcConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == kTcConsumers) {
    // ------------------------------------------------------ producer
    reg_dealloc<kTcProducerRegs>();
    if (tid == 128 * kTcConsumers) {
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kTcStages;
        if (t >= kTcStages)
          mbar_wait(empty0 + 8 * st, (t / kTcStages - 1) & 1);
        const uint32_t full = full0 + 8 * st, dst = kv_s + 2 * st * kTile;
        mbar_arrive_tx(full, 2 * kTile);
#pragma unroll
        for (int blk = 0; blk < HD / 64; ++blk) {
          tma_load_4d(dst + blk * kKVBlock, &k_map, 64 * blk, kvh,
                      t * kTcBK, b, full);
          tma_load_4d(dst + kTile + blk * kKVBlock, &v_map, 64 * blk, kvh,
                      t * kTcBK, b, full);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  reg_alloc<kTcConsumerRegs>();
  // this warpgroup's first row, and how many tiles its rows see
  const int w0 = i0 + wg * 64;
  const bool w_live = w0 < S;
  const int w_last_key = causal ? min(w0 + 63, S - 1) + offset : T_len - 1;
  const int n_run = w_live ? min(n_tiles, w_last_key / kTcBK + 1) : 0;
  auto wait_tile = [&](int t) {
    mbar_wait(full0 + 8 * (t % kTcStages), (t / kTcStages) & 1);
  };
  auto release = [&](int t) { mbar_arrive(empty0 + 8 * (t % kTcStages)); };

  const int r0 = w0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  // Q's register-A fragments: qa[4kk + i] holds rows r0 (i even) / r1 (i
  // odd) at columns 16kk + cq (i < 2) / 16kk + 8 + cq (i >= 2), as bf16x2
  uint32_t qa[HD / 4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? r1 : r0;
      const int col = 16 * kk + cq + ((i & 2) ? 8 : 0);
      qa[4 * kk + i] = (row < S && col < hd)
          ? __ldg(reinterpret_cast<const unsigned int*>(qb + row * q_row
                                                        + col))
          : 0u;
    }
  }

  // S = Q.K_j^T into s, issued and committed, not waited for
  float s[32];
  auto issue_s = [&](int j) {
    const uint32_t k_t = kv_s + 2 * (j % kTcStages) * kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_rs<0>(
          s, qa + 4 * kk,
          wgmma_desc(k_t + (kk >> 2) * kKVBlock + (kk & 3) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
  };
  // O += P.V_j as P_hi.V_j + P_lo.V_j, issued and committed, not waited for
  uint32_t p[16], p_lo[16];              // P: four register-A fragments each
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.0f;
  auto issue_pv = [&](int j) {
    const uint32_t v_t = kv_s + (2 * (j % kTcStages) + 1) * kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      const uint64_t dv = wgmma_desc(v_t + kk * 16 * 128, kKVBlock, 1024);
      wgmma_rs<1>(o, p + 4 * kk, dv, 1);
      wgmma_rs<1>(o, p_lo + 4 * kk, dv, 1);
    }
    wgmma_commit();
  };
  // Online softmax of S_j (in s): s becomes P_j in fp32, a0/a1 the factor
  // that rescales O before P_j.V_j is added.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float a0 = 0.0f, a1 = 0.0f;
  auto softmax = [&](int j) {
    const int j0 = j * kTcBK;
    // s[4c + e] is (row r0, key j0 + 8c + cq + e); s[4c + 2 + e] is row r1
    if (j0 + kTcBK > T_len || (causal && j0 + kTcBK - 1 > w0 + offset)) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j0 + 8 * c + cq + e;
          const bool in = col < T_len;
          if (!in || (causal && col > r0 + offset)) s[4 * c + e] = -INFINITY;
          if (!in || (causal && col > r1 + offset))
            s[4 * c + 2 + e] = -INFINITY;
        }
      }
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      x0 = fmaxf(x0, fmaxf(s[4 * c], s[4 * c + 1]));
      x1 = fmaxf(x1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
    x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 2));
    const float n0 = fmaxf(m0, x0 * scale_log2);
    const float n1 = fmaxf(m1, x1 * scale_log2);
    const float u0 = n0 == -INFINITY ? 0.0f : n0;   // a row with no key yet
    const float u1 = n1 == -INFINITY ? 0.0f : n1;
    a0 = ex2_ftz(m0 - u0);               // 0 on the row's first tile
    a1 = ex2_ftz(m1 - u1);
    m0 = n0;
    m1 = n1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s[4 * c] = ex2_ftz(fmaf(s[4 * c], scale_log2, -u0));
      s[4 * c + 1] = ex2_ftz(fmaf(s[4 * c + 1], scale_log2, -u0));
      s[4 * c + 2] = ex2_ftz(fmaf(s[4 * c + 2], scale_log2, -u1));
      s[4 * c + 3] = ex2_ftz(fmaf(s[4 * c + 3], scale_log2, -u1));
      rs0 += s[4 * c] + s[4 * c + 1];
      rs1 += s[4 * c + 2] + s[4 * c + 3];
    }
    l0 = l0 * a0 + rs0;                  // a partial sum: this lane's keys
    l1 = l1 * a1 + rs1;
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      split_bf16x2(s[4 * c], s[4 * c + 1], p[2 * c], p_lo[2 * c]);
      split_bf16x2(s[4 * c + 2], s[4 * c + 3], p[2 * c + 1], p_lo[2 * c + 1]);
    }
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      o[4 * c] *= a0;
      o[4 * c + 1] *= a0;
      o[4 * c + 2] *= a1;
      o[4 * c + 3] *= a1;
    }
  };

  if (n_run > 0) {
    wait_tile(0);
    issue_s(0);
    wgmma_wait_all();
    pin(s);
    softmax(0);
    pack_p();
    for (int j = 0; j + 1 < n_run; ++j) {
      wait_tile(j + 1);
      issue_s(j + 1);
      rescale_o();
      issue_pv(j);
      wgmma_wait_one();                  // S_{j+1} done, P_j.V_j may run on
      pin(s);
      softmax(j + 1);
      wgmma_wait_all();
      pin(o);
      pin(p);
      pin(p_lo);
      pack_p();
      release(j);
    }
    rescale_o();
    issue_pv(n_run - 1);
    wgmma_wait_all();
    pin(o);
    pin(p);
    pin(p_lo);
    release(n_run - 1);
  }
  // tiles past this warpgroup's last key: released in order, so that the
  // empty barriers count one arrival a warpgroup a tile
  for (int t = n_run; t < n_tiles; ++t) {
    wait_tile(t);
    release(t);
  }
  if (!w_live) return;

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  bf16* ob = out + static_cast<int64_t>(b) * S * q_row
             + static_cast<int64_t>(h) * hd;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const int col = 8 * c + cq;
    if (col >= hd) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * q_row + col) =
          __floats2bfloat162_rn(o[4 * c] * inv0, o[4 * c + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * q_row + col) =
          __floats2bfloat162_rn(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// Prefill attention, fp32.  Replaces _flash_kernel (flash_attention.py:30)
// for fp32 inputs.
//
// It stays an FMA kernel on purpose: the tensor cores take fp32 only as
// TF32, whose 10-bit mantissa would break the fp32 gates (2e-5 against the
// plain version, 2e-4 end to end, TF32 off).  fp32 runs only in those
// checks; serving runs bf16 on the kernel above.
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
// distinct banks.  GQA and the causal rule as in the bf16 kernel; ragged
// edges are masked, any hd <= 128.
//
// What bounds it on an H100: operations, here against the 67 TFLOP/s fp32
// rate outside the tensor cores; the score loop does 8 shared-memory loads
// for every 16 FMAs, so shared-memory bandwidth sets its pace.
constexpr int kFlashThreads = 128;
constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kColsPerThread = kMaxHeadDim / 8;

size_t flash_smem_bytes(int hd) {
  const size_t ld = hd + 1;
  return sizeof(float) * (kBQ * ld + kBK * ld + kBK * hd + kBQ * (kBK + 1));
}

__global__ void __launch_bounds__(kFlashThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S, int T_len, int H, int KV, int hd, int causal,
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
  const float* qb = q + static_cast<int64_t>(b) * S * q_row
                + static_cast<int64_t>(h) * hd;
  const float* kb = k + static_cast<int64_t>(b) * T_len * kv_row
                + static_cast<int64_t>(kvh) * hd;
  const float* vb = v + static_cast<int64_t>(b) * T_len * kv_row
                + static_cast<int64_t>(kvh) * hd;

  for (int e = tid; e < kBQ * hd; e += kFlashThreads) {
    const int r = e / hd, d = e - r * hd;
    q_s[r * ld + d] = (i0 + r < S)
        ? qb[static_cast<int64_t>(i0 + r) * q_row + d] : 0.0f;
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
      k_s[r * ld + d] = ok ? kb[g] : 0.0f;
      v_s[r * hd + d] = ok ? vb[g] : 0.0f;
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

  float* ob = out + static_cast<int64_t>(b) * S * q_row
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
        ob[static_cast<int64_t>(row) * q_row + d] = acc[i][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// Cached decode attention, split across the sequence (flash-decoding).
// Replaces _decode_kernel (decode_attention.py:26).
//
// decode_split_kernel: grid (splits, KV, B), 4 warps a CTA.  A CTA takes
// the positions [split * chunk, min(n_pos, (split + 1) * chunk)) of its
// (batch row, KV head) and all G = H / KV query rows of that head, GR rows
// at a time (GR = 1, 2 or 4; larger G loops).  Each row of K and V is read
// by a group of lanes with 16-byte loads (8 bf16 or 4 fp32 a lane: 16
// lanes cover an hd = 128 bf16 row, so a warp reads two positions a load)
// straight into registers, kDecUnroll positions a lane a step, so 2 x
// kDecUnroll loads a lane are in flight; no shared-memory staging, no
// __syncthreads in the loop.  q sits in registers as fp32; a dot product
// reduces over the row's lanes with shuffles, the softmax max over the
// whole warp, so every warp keeps one online-softmax state (m, l, o) a
// query row.  The four warps merge through shared memory at the end, and
// the CTA writes its partial (m, l, unnormalised o) in fp32 to scratch.
// A CTA with no positions writes m = -inf, l = 0, o = 0.
//
// decode_combine_kernel: grid (B * H).  m = max m_i, l = sum l_i e^(m_i -
// m), o = sum o_i e^(m_i - m) / l, written in the input dtype; a split
// with m_i = -inf adds nothing.  Scores are in the log2 domain (scaled by
// scale * log2 e) in both kernels.
//
// The loop stops at pos: positions past it are neither read nor masked,
// where the TPU grid swept all of Smax and predicated.  The wrapper picks
// the split count (about four waves of CTAs on the card, at least about 64
// positions a split, never more splits than positions).
//
// What bounds it on an H100: bytes, the k and v rows 0..pos (each read
// once) plus q and o, at 3.35 TB/s; the flops are 4 per cached element
// and query row.  The split fills the card where one CTA per (b, KV head)
// gave 64 CTAs on 132 SMs, and the 16-byte loads keep several KB a warp in
// flight.
constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecUnroll = 4;

// 16 bytes of T as fp32
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void to_f32(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec16<bf16> {
  static constexpr int kN = 8;
  __device__ static void to_f32(const uint4& u, float (&f)[8]) {
    pair(u.x, f[0], f[1]);
    pair(u.y, f[2], f[3]);
    pair(u.z, f[4], f[5]);
    pair(u.w, f[6], f[7]);
  }
  // two bf16 in a word, the first in the low half; a bf16 is the top half
  // of an fp32
  __device__ static void pair(uint32_t w, float& lo, float& hi) {
    lo = __uint_as_float(w << 16);
    hi = __uint_as_float(w & 0xffff0000u);
  }
};

__device__ __forceinline__ uint4 load16(const void* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

template <typename T, int GR>
__global__ void __launch_bounds__(kDecThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int H, int KV, int Smax,
                    int hd, int n_pos, int chunk, int lpr_log2,
                    float scale_log2) {
  constexpr int VEC = Vec16<T>::kN;
  __shared__ float o_s[kDecWarps][GR][kMaxHeadDim];
  __shared__ float m_s[kDecWarps][GR], l_s[kDecWarps][GR];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lpr = 1 << lpr_log2;         // lanes a cache row
  const int rpw = 32 >> lpr_log2;        // cache rows a warp load
  const int rw = lane >> lpr_log2;       // this lane's row of the load
  const int col = (lane & (lpr - 1)) * VEC;
  const bool active = col < hd;
  const int G = H / KV;
  const int start = split * chunk, end = min(n_pos, start + chunk);
  const int64_t row = static_cast<int64_t>(KV) * hd;
  const int64_t base = static_cast<int64_t>(b) * Smax * row
                       + static_cast<int64_t>(kvh) * hd + col;
  const T* kb = kc + base;
  const T* vb = vc + base;
  const int step = rpw * kDecUnroll;     // positions a warp takes a step

  for (int g0 = 0; g0 < G; g0 += GR) {
    float qf[GR][VEC], o[GR][VEC], m[GR], l[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const int64_t qi = (static_cast<int64_t>(b) * H + kvh * G + g0 + g) * hd;
      Vec16<T>::to_f32(load16(q + qi + col, active && g0 + g < G), qf[g]);
      m[g] = -INFINITY;
      l[g] = 0.0f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[g][e] = 0.0f;
    }

    for (int p0 = start + warp * step; p0 < end; p0 += kDecWarps * step) {
      uint4 ku[kDecUnroll], vu[kDecUnroll];
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        const int p = p0 + u * rpw + rw;
        const bool ok = active && p < end;
        ku[u] = load16(kb + p * row, ok);
        vu[u] = load16(vb + p * row, ok);
      }
      float s[GR][kDecUnroll];
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        float kf[VEC];
        Vec16<T>::to_f32(ku[u], kf);
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          float d = 0.0f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qf[g][e], kf[e], d);
          s[g][u] = d;
        }
      }
#pragma unroll
      for (int g = 0; g < GR; ++g)
#pragma unroll
        for (int u = 0; u < kDecUnroll; ++u)
          for (int off = 1; off < lpr; off <<= 1)
            s[g][u] += __shfl_xor_sync(kFull, s[g][u], off);
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < kDecUnroll; ++u) {
          const bool ok = p0 + u * rpw + rw < end;
          s[g][u] = ok ? s[g][u] * scale_log2 : -INFINITY;
          mx = fmaxf(mx, s[g][u]);
        }
        for (int off = lpr; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float mn = fmaxf(m[g], mx);      // finite: position p0 < end
        const float a = exp2f(m[g] - mn);      // 0 on the warp's first step
        m[g] = mn;
        l[g] *= a;
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[g][e] *= a;
#pragma unroll
        for (int u = 0; u < kDecUnroll; ++u) {
          s[g][u] = exp2f(s[g][u] - mn);
          l[g] += s[g][u];
        }
      }
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        float vf[VEC];
        Vec16<T>::to_f32(vu[u], vf);
#pragma unroll
        for (int g = 0; g < GR; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[g][e] = fmaf(s[g][u], vf[e], o[g][e]);
      }
    }

    // l and o are partial over this lane's rows of the loads: sum them over
    // the warp's row groups (m is the same on every lane)
#pragma unroll
    for (int g = 0; g < GR; ++g)
      for (int off = lpr; off < 32; off <<= 1) {
        l[g] += __shfl_xor_sync(kFull, l[g], off);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[g][e] += __shfl_xor_sync(kFull, o[g][e], off);
      }
    if (rw == 0 && active) {
#pragma unroll
      for (int g = 0; g < GR; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) o_s[warp][g][col + e] = o[g][e];
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < GR * hd; e += kDecThreads) {
      const int g = e / hd, d = e - g * hd;
      if (g0 + g >= G) break;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
      float oo = 0.0f, ll = 0.0f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        if (m_s[w][g] == -INFINITY) continue;   // a warp with no positions
        const float wt = exp2f(m_s[w][g] - mx);
        oo = fmaf(o_s[w][g][d], wt, oo);
        ll = fmaf(l_s[w][g], wt, ll);
      }
      const int64_t slot =
          (static_cast<int64_t>(b) * H + kvh * G + g0 + g) * splits + split;
      part_o[slot * hd + d] = oo;
      if (d == 0) {
        part_ml[2 * slot] = mx;
        part_ml[2 * slot + 1] = ll;
      }
    }
    __syncthreads();                     // before the next rows reuse o_s
  }
}

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
decode_combine_kernel(const float* __restrict__ part_o,
                      const float* __restrict__ part_ml, T* __restrict__ out,
                      int splits, int hd) {
  const int64_t bh = blockIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  const float* po = part_o + bh * splits * hd;
  // every warp takes the max over the splits, 32 at a time
  float mx = -INFINITY;
  for (int i = threadIdx.x & 31; i < splits; i += 32) mx = fmaxf(mx, ml[2 * i]);
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  // a split with no positions has m_i = -inf, l_i = 0, o_i = 0: its weight
  // exp2(-inf) is 0, so no branch keeps the loads below apart
  for (int d = threadIdx.x; d < hd; d += kDecThreads) {
    float o = 0.0f, l = 0.0f;
#pragma unroll 4
    for (int i = 0; i < splits; ++i) {
      const float w = exp2f(ml[2 * i] - mx);
      l = fmaf(ml[2 * i + 1], w, l);
      o = fmaf(po[static_cast<int64_t>(i) * hd + d], w, o);
    }
    out[bh * hd + d] = from_f32<T>(o / fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// RMSNorm.  Replaces _rms_kernel (fused_rmsnorm.py:16).
//
// What bounds it on an H100: bytes, 2 * rows * d * itemsize (one read, one
// write) at 3.35 TB/s; a few flops per element.
//
// rmsnorm_vec_kernel<T, S, LANES, NV>: LANES threads a row, each holding
// NV 16-byte vectors of it (8 bf16 or 4 fp32) in registers from the sum
// of squares to the write, so x leaves device memory once.  LANES is 16
// (a half warp a row: d = 128, the qk-norm), 32 (a warp: d = 2048 bf16)
// or 64-256 (several warps, their partial sums met in shared memory: d =
// 4096, and fp32 rows that would need more than 32 registers of x a
// lane).  A thread's columns are the same in every row, so it loads its
// share of ``scale`` once, raw, and reuses it over the rows its CTA walks:
// the grid is the CTAs the card keeps resident, striding over the rows.
// Needs d % 8 (bf16) or d % 4 (fp32) == 0 and x, scale and out 16-byte
// aligned.
//
// rmsnorm_kernel, the scalar path for any other d or pointer: one warp a
// row, 8 rows a CTA; the lanes stride the row by 32 for a fp32 sum of
// squares, then read it again (from L1) for the write.
//
// Both sum in fp32 and take rsqrtf(mean + eps); the result is
// (x * r) * scale, rounded once on the store.
constexpr int kNormThreads = 256;
constexpr int kMaxDevices = 64;

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

// Elements of type E packed in 32-bit words, the first in the low bits.
template <typename E>
struct Packed;
template <>
struct Packed<float> {
  static constexpr int kPerWord = 1;
  __device__ static float get(const uint32_t* w, int e) {
    return __uint_as_float(w[e]);
  }
  __device__ static uint32_t put(float lo, float) { return __float_as_uint(lo); }
};
template <>
struct Packed<bf16> {
  static constexpr int kPerWord = 2;
  // a bf16 is the top half of an fp32
  __device__ static float get(const uint32_t* w, int e) {
    const uint32_t u = w[e >> 1];
    return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  __device__ static uint32_t put(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

// W words from 16-byte (W % 4 == 0) or 8-byte (W == 2) aligned p.
template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[k];
      w[4 * k] = u.x;
      w[4 * k + 1] = u.y;
      w[4 * k + 2] = u.z;
      w[4 * k + 3] = u.w;
    }
  } else {
    static_assert(W == 2, "scale vectors are 8 bytes or multiples of 16");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x;
    w[1] = u.y;
  }
}

template <typename T, typename S, int LANES, int NV>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_vec_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ out, int64_t rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);             // elements a vector
  constexpr int SW = VEC * sizeof(S) / 4;         // scale words a vector
  constexpr int RPC = kNormThreads / LANES;       // rows a CTA step
  __shared__ float red[kNormThreads / 32];
  const int g = threadIdx.x / LANES, l = threadIdx.x % LANES;
  const int nvec = d / VEC;

  uint32_t sw[NV][SW];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = j * LANES + l;
    if (c < nvec) {
      load_words<SW>(scale + static_cast<int64_t>(c) * VEC, sw[j]);
    } else {
#pragma unroll
      for (int k = 0; k < SW; ++k) sw[j][k] = 0;
    }
  }
  // every thread of the CTA takes the same trips (the barriers below)
  const int64_t step = static_cast<int64_t>(gridDim.x) * RPC;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * RPC; r0 < rows;
       r0 += step) {
    const int64_t r = r0 + g;
    const bool row_ok = r < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * d);
    uint32_t xw[NV][4];
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = j * LANES + l;
      if (row_ok && c < nvec) {
        const uint4 u = xr[c];
        xw[j][0] = u.x;
        xw[j][1] = u.y;
        xw[j][2] = u.z;
        xw[j][3] = u.w;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = Packed<T>::get(xw[j], e);
          ss = fmaf(v, v, ss);
        }
      }
    }
    if constexpr (LANES <= 32) {
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        ss += __shfl_xor_sync(kFull, ss, off);
    } else {
      constexpr int WPR = LANES / 32;             // warps a row
      ss = warp_sum(ss);
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
      __syncthreads();
      ss = 0.0f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) ss += red[g * WPR + w];
      __syncthreads();
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    uint4* yr = reinterpret_cast<uint4*>(out + r * d);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = j * LANES + l;
      if (row_ok && c < nvec) {
        uint32_t o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          constexpr int P = Packed<T>::kPerWord;
          float f[2] = {0.0f, 0.0f};
#pragma unroll
          for (int h = 0; h < P; ++h) {
            const int e = k * P + h;
            f[h] = Packed<T>::get(xw[j], e) * inv * Packed<S>::get(sw[j], e);
          }
          o[k] = Packed<T>::put(f[0], f[1]);
        }
        yr[c] = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda that the runtime has
// loaded (so the build needs no -lcuda); null where libcuda lacks it.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess
        || found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A (B, T, KV, hd) bf16 tensor, for TMA boxes of kTcBK keys x 64 columns
// of one KV head with the 128-byte swizzle; out-of-range elements read as 0.
cudaError_t kv_tensor_map(CUtensorMap* map, const void* ptr, int B,
                          int T_len, int KV, int hd) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * KV, row * KV * T_len};   // bytes
  const cuuint32_t box[4] = {64, 1, kTcBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_flash_tc(const void* q, const void* k, const void* v,
                            void* out, int B, int S, int T_len, int H, int KV,
                            int hd, int causal, float scale,
                            cudaStream_t stream) {
  CUtensorMap k_map, v_map;
  cudaError_t err = kv_tensor_map(&k_map, k, B, T_len, KV, hd);
  if (err == cudaSuccess) err = kv_tensor_map(&v_map, v, B, T_len, KV, hd);
  constexpr size_t smem = tc_smem_bytes<HD>();
  if (err == cudaSuccess) err = allow_smem(flash_attention_tc_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kTcBQ - 1) / kTcBQ);
  flash_attention_tc_kernel<HD><<<grid, kTcThreads, smem, stream>>>(
      k_map, v_map, static_cast<const bf16*>(q), static_cast<bf16*>(out), S,
      T_len, H, KV, hd, causal, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int GR>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc,
                          void* out, float* part_o, float* part_ml, int B,
                          int H, int KV, int Smax, int hd, int pos,
                          int splits, float scale, cudaStream_t stream) {
  constexpr int VEC = Vec16<T>::kN;
  int lpr_log2 = 0;
  while ((VEC << lpr_log2) < hd) ++lpr_log2;
  const int n_pos = pos + 1;
  const int chunk = (n_pos + splits - 1) / splits;
  decode_split_kernel<T, GR><<<dim3(splits, KV, B), kDecThreads, 0,
                               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), part_o, part_ml, H, KV, Smax, hd, n_pos,
      chunk, lpr_log2, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * H, kDecThreads, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(out), splits, hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode_rows(const void* q, const void* kc, const void* vc,
                               void* out, float* part_o, float* part_ml,
                               int B, int H, int KV, int Smax, int hd,
                               int pos, int splits, float scale,
                               cudaStream_t stream) {
  const int G = H / KV;
  if (G == 1)
    return launch_decode<T, 1>(q, kc, vc, out, part_o, part_ml, B, H, KV,
                               Smax, hd, pos, splits, scale, stream);
  if (G == 2)
    return launch_decode<T, 2>(q, kc, vc, out, part_o, part_ml, B, H, KV,
                               Smax, hd, pos, splits, scale, stream);
  return launch_decode<T, 4>(q, kc, vc, out, part_o, part_ml, B, H, KV, Smax,
                             hd, pos, splits, scale, stream);
}

template <typename T, typename S, int LANES, int NV>
cudaError_t launch_rmsnorm_vec(const void* x, const void* scale, void* out,
                               int64_t rows, int d, float eps,
                               cudaStream_t stream) {
  const auto kernel = rmsnorm_vec_kernel<T, S, LANES, NV>;
  static int resident[kMaxDevices];      // CTAs the card keeps resident
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int most = dev < kMaxDevices ? resident[dev] : 0;
  if (most == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kNormThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    most = per_sm * sms > 0 ? per_sm * sms : 1;
    if (dev < kMaxDevices) resident[dev] = most;
  }
  constexpr int kRows = kNormThreads / LANES;
  const int64_t groups = (rows + kRows - 1) / kRows;
  const unsigned grid = static_cast<unsigned>(groups < most ? groups : most);
  kernel<<<grid, kNormThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_rmsnorm(const void* x, const void* scale, void* out,
                           int64_t rows, int d, float eps,
                           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x)
                         | reinterpret_cast<uintptr_t>(scale)
                         | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int nv = d / VEC;
  if (aligned && d % VEC == 0 && nv <= 2048) {
    if (nv <= 16)
      return launch_rmsnorm_vec<T, S, 16, 1>(x, scale, out, rows, d, eps,
                                             stream);
    if (nv <= 32)
      return launch_rmsnorm_vec<T, S, 16, 2>(x, scale, out, rows, d, eps,
                                             stream);
    if (nv <= 256)
      return launch_rmsnorm_vec<T, S, 32, 8>(x, scale, out, rows, d, eps,
                                             stream);
    if (nv <= 512)
      return launch_rmsnorm_vec<T, S, 64, 8>(x, scale, out, rows, d, eps,
                                             stream);
    if (nv <= 1024)
      return launch_rmsnorm_vec<T, S, 128, 8>(x, scale, out, rows, d, eps,
                                              stream);
    return launch_rmsnorm_vec<T, S, 256, 8>(x, scale, out, rows, d, eps,
                                            stream);
  }
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

// bf16 q (B,S,H,hd), k/v (B,T,KV,hd) -> out (B,S,H,hd), all contiguous and
// 16-byte aligned, on the tensor cores.  Needs hd <= 128 with hd % 8 == 0,
// H % KV == 0 and, when causal, T >= S.
int lm_flash_attention_bf16(const void* q, const void* k, const void* v,
                            void* out, int B, int S, int T_len, int H,
                            int KV, int hd, int causal, float scale,
                            void* stream) {
  if (hd < 8 || hd > kMaxHeadDim || hd % 8 != 0 || KV < 1 || H % KV != 0
      || (causal && T_len < S))
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (T_len == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch_flash_tc<64>(q, k, v, out, B, S, T_len, H, KV, hd, causal,
                               scale, s);
  return launch_flash_tc<128>(q, k, v, out, B, S, T_len, H, KV, hd, causal,
                              scale, s);
}

// fp32 q (B,S,H,hd), k/v (B,T,KV,hd) -> out (B,S,H,hd), all contiguous, on
// the FMA kernel.  Needs hd <= 128, H % KV == 0 and, when causal, T >= S.
int lm_flash_attention_f32(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int T_len, int H, int KV,
                           int hd, int causal, float scale, void* stream) {
  if (hd < 1 || hd > kMaxHeadDim || KV < 1 || H % KV != 0
      || (causal && T_len < S))
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return cudaSuccess;
  if (T_len == 0) return cudaErrorInvalidValue;
  const size_t smem = flash_smem_bytes(hd);
  cudaError_t err = allow_smem(flash_attention_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<<<grid, kFlashThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T_len, H,
      KV, hd, causal, scale);
  return cudaGetLastError();
}

// q (B,H,hd), caches (B,Smax,KV,hd) -> out (B,H,hd); attends 0..pos in
// `splits` ranges.  part_o holds B*H*splits*hd floats, part_ml
// B*H*splits*2.  Rows must be whole 16-byte vectors (hd % 8 == 0 in bf16,
// hd % 4 == 0 in fp32) and 16-byte aligned.
int lm_decode_attention(const void* q, const void* kc, const void* vc,
                        void* out, void* part_o, void* part_ml, int B, int H,
                        int KV, int Smax, int hd, int pos, int splits,
                        float scale, int dtype, void* stream) {
  const int vec = dtype == kBF16 ? 8 : 4;
  if (hd < 1 || hd > kMaxHeadDim || hd % vec != 0 || KV < 1 || H % KV != 0
      || pos < 0 || pos >= Smax || splits < 1)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == kF32)
    return launch_decode_rows<float>(q, kc, vc, out, po, pm, B, H, KV, Smax,
                                     hd, pos, splits, scale, s);
  if (dtype == kBF16)
    return launch_decode_rows<bf16>(q, kc, vc, out, po, pm, B, H, KV, Smax,
                                    hd, pos, splits, scale, s);
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
    return launch_rmsnorm<float, bf16>(x, scale, out, rows, d, eps, s);
  if (x_dtype == kBF16 && s_dtype == kF32)
    return launch_rmsnorm<bf16, float>(x, scale, out, rows, d, eps, s);
  if (x_dtype == kBF16 && s_dtype == kBF16)
    return launch_rmsnorm<bf16, bf16>(x, scale, out, rows, d, eps, s);
  return cudaErrorInvalidValue;
}

const char* lm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
