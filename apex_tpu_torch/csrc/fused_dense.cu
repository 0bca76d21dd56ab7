// Fused dense forward for Hopper (sm_90a), plain C interface:
// y = act(x w + b), x (M, K) and w (K, N) row-major (the JAX package's
// layout), b (N) fp32 or none, y (M, N) row-major in x's dtype.  The
// product accumulates in fp32; the bias is added in fp32 before the
// activation (none, relu, tanh-gelu, sigmoid); the result is rounded
// once to the output dtype.
//
// Replaces: apex_tpu/ops/fused_dense.py:_matmul_kernel (launched by
// _matmul_pallas): the same contract, the epilogue fused into the
// GEMM's last step (the TPU kernel's k == k_steps - 1 branch).
//
// What bounds it on an H100: at GPT-350M's MLP shapes ((12288, 1024) x
// (1024, 4096) and (12288, 4096) x (4096, 1024), bf16) it does 1.03e11
// flop against ~0.13 GB: 0.104 ms at 989 TF/s against 0.04 ms of bytes,
// so the tensor cores bound it, and only wgmma reaches their full rate.
// Four kernels; the caller picks one by dtype, shape and alignment
// (ops/fused_dense.py gemm_route) and this file refuses a route whose
// conditions do not hold, never taking another in its place:
//   * gemv (any dtype, N <= 8: apex's MLP ends in N = 1).  A warp owns a
//     row of x and keeps N fp32 sums a lane; w's K x N, as fp32, waits in
//     shared memory ([n][k], 1024 rows of K at a time).  x is read once,
//     16 bytes a lane where every row starts on a 16-byte boundary, else
//     one element a lane; the 16-bit products are exact in fp32.  The
//     warp's sums meet by a shuffle butterfly (the same order, so the
//     same bits, on every run).  What bounds it: the bytes of x (1 MB at
//     the MLP's 1024 x 256 fp32 layer, 0.3 us), so the launch does.
//   * wgmma (bf16 / fp16, K and N multiples of 8, x and w 16-byte aligned:
//     what TMA can address).  One block of three warpgroups an SM walks
//     128 x kWgBN tiles of y.  Warpgroup 2 is the producer: one of its
//     threads keeps a ring of kWgStages depth slices (64 deep) in flight
//     by TMA, each stage an x box (128 x 64, K-major) and kWgBN / 64 w
//     boxes (64 x 64); w stays (K, N) row-major and is the MN-major B
//     operand (the descriptor's transpose bit), so no transposed copy
//     exists.  TMA swizzles by 128 bytes and zero-fills rows, columns and
//     depth past M, N and K.  Warpgroups 0 and 1 each own 64 rows and
//     issue wgmma m64n{kWgBN}k16 from shared memory, keeping one stage's
//     products in flight while the next is issued; a stage goes back to
//     the producer on an mbarrier once its products are done.  setmaxnreg
//     gives the producer's registers to the consumers.  The epilogue
//     (bias, activation, rounding) runs on the fp32 accumulators in
//     registers and leaves through shared memory by TMA stores, while the
//     producer already loads the next tile's slices.  The tensor maps are
//     built on the host for each call.
//   * mma.sync (bf16 / fp16, the other shapes with N > 8: misaligned
//     views, N not a multiple of 8): a block of 8 warps computes a 128 x
//     128 tile, each warp 64 x 32 of it as 4 x 4 mma.sync m16n8k16
//     products; 32-deep slices of x and w are staged element by element
//     in a 4-stage ring of padded shared-memory tiles (rows and depth past
//     M, N and K read as zero), the A fragments through ldmatrix, the B
//     fragments through ldmatrix.trans.
//   * fp32 (N > 8): full fp32 FMAs (not TF32, so it matches the plain
//     version's fp32 product).  A block of 256 threads computes a 128 x
//     128 or 128 x 64 tile, each thread 8 x 8 or 8 x 4 outputs, over its
//     share of K: the host plan (ops/fused_dense.py f32_plan) picks the
//     tile and splits K among `split` blocks (1 to 8) of one thread-block
//     cluster, so that the MLP's layers, 8 to 64 tiles of 128 x 128, fill the
//     card's 132 SMs, one block an SM.  16-deep slices of x and w stream
//     into a 4-stage ring by 16-byte cp.async (4-byte copies where K or N
//     is not a multiple of 4 or a base is not 16-byte aligned: the host's
//     `vec` flag), 3 slices ahead of the FMAs, each thread's copy pointers
//     and bounds worked out once; x's 16-byte chunks are swizzled by row
//     so that neither the copies nor the 8-row reads conflict.  The
//     cluster's partial tiles then meet in shared memory: each block sums
//     its 128 / split rows of every block's tile through distributed
//     shared memory, in rank order (the same bits on every run), and runs
//     the epilogue on them.  What bounds it: the FMAs (2 M N K at 67 TF/s;
//     0.032 ms at 1024^3), of which this loop issues some two thirds.
// Every kernel's epilogue is in registers: bias, activation, rounding,
// store; the pre-activation never reaches device memory unless the
// caller asks for it (the autograd forward launches with act = none).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSigmoid = 3 };

// tanh on the special-function unit, one instruction (relative error
// below 2^-10): the wgmma kernel's gelu in bf16, whose 2^-8 rounding
// hides it; tanhf costs some 20 instructions, which at K = 1024 made the
// epilogue a third of the wgmma kernel's time.  fp16 (2^-11) keeps tanhf
__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// FAST: tanh_fast (the wgmma kernel in bf16); the others keep tanhf
template <int ACT, bool FAST>
__device__ __forceinline__ float apply_act(float y) {
  if (ACT == kRelu) return y < 0.f ? 0.f : y;  // NaN stays NaN
  if (ACT == kGelu) {                          // tanh approximation
    const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
    return 0.5f * y * (1.f + (FAST ? tanh_fast(u) : tanhf(u)));
  }
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-y));
  return y;
}

// ------------------------------------------ 16-bit: mma.sync (any shape) --

constexpr int kBM = 128;        // rows of y per block
constexpr int kBN = 128;        // columns of y per block
constexpr int kBK = 32;         // depth per stage
constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kSA = kBK + 8;    // x tile row stride (elements): 80 bytes
constexpr int kSB = kBN + 8;    // w tile row stride (elements): 272 bytes
constexpr int kStages = 4;      // shared-memory ring of depth slices
constexpr int kStageA = kBM * kSA;
constexpr int kStageB = kBK * kSB;
// 75,776 bytes: above the 48 KB default, so an opt-in at the first launch
constexpr size_t kSmem16 = size_t(kStages) * (kStageA + kStageB) * 2;

// four 8x8 b16 matrices; lanes 8i..8i+7 address matrix i's rows
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a)
      : "memory");
}

// four 8x8 b16 matrices, transposed; lanes 8i..8i+7 address matrix i's rows
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a)
      : "memory");
}

// c (16x8 fp32) += a (16x16, row) * b (16x8, col), bf16 or fp16 operands
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, bf16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ bf16 to_out<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half to_out<__half>(float v) {
  return __float2half_rn(v);
}

// stage the depth slice [k0, k0 + kBK) of x's rows [m0, m0 + kBM) and of
// w's columns [n0, n0 + kBN) into shared memory element by element, zero
// past M, N and K
__device__ __forceinline__ void load_stage(uint16_t* as, uint16_t* bs,
                                           const uint16_t* x,
                                           const uint16_t* w, int M, int N,
                                           int K, int m0, int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < kBM * kBK / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kBK, col = e % kBK;
    const bool ok = m0 + r < M && k0 + col < K;
    as[r * kSA + col] = ok ? x[(long long)(m0 + r) * K + k0 + col] : 0;
  }
#pragma unroll 4
  for (int i = 0; i < kBK * kBN / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kBN, col = e % kBN;
    const bool ok = k0 + r < K && n0 + col < N;
    bs[r * kSB + col] = ok ? w[(long long)(k0 + r) * N + n0 + col] : 0;
  }
}

template <typename T, int ACT, bool BIAS>
__global__ void __launch_bounds__(kThreads, 2)
    dense_mma_kernel(const uint16_t* __restrict__ x,
                     const uint16_t* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ y,
                     int M, int N, int K) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sa = smem;                        // [kStages][kStageA]
  uint16_t* sb = smem + kStages * kStageA;    // [kStages][kStageB]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * 64;   // the warp's rows within the tile
  const int wn = (warp & 3) * 32;    // the warp's columns within the tile
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // slice s lives in stage s % kStages, written kStages - 1 slices ahead
  const int n_k = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s)
    if (s < n_k)
      load_stage(sa + s * kStageA, sb + s * kStageB, x, w, M, N, K, m0, n0,
                 s * kBK);
  for (int kt = 0; kt < n_k; ++kt) {
    // slice kt is visible to every thread, and every thread is done with
    // slice kt - 1, whose stage the next slice overwrites
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < n_k) {
      const int s = nk % kStages;
      load_stage(sa + s * kStageA, sb + s * kStageB, x, w, M, N, K, m0, n0,
                 nk * kBK);
    }
    const uint16_t* as = sa + (kt % kStages) * kStageA;
    const uint16_t* bs = sb + (kt % kStages) * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                as + (wm + mi * 16 + (lane & 15)) * kSA + kk +
                    (lane >> 4) * 8);
      const uint16_t* base = bs +
                             (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kSB +
                             wn + (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3, base + np * 16);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma16816<T>(acc[mi][2 * np], a[mi], b0, b1);
          mma16816<T>(acc[mi][2 * np + 1], a[mi], b2, b3);
        }
      }
    }
  }
  // epilogue: c[0], c[1] at row g, columns 2 t4, 2 t4 + 1; c[2], c[3] at
  // row g + 8
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t4;
    float b0 = 0.f, b1 = 0.f;
    if (BIAS) {
      if (col < N) b0 = bias[col];
      if (col + 1 < N) b1 = bias[col + 1];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + 8 * h;
        if (row >= M) continue;
        const T v0 =
            to_out<T>(apply_act<ACT, false>(acc[mi][ni][2 * h] + b0));
        const T v1 =
            to_out<T>(apply_act<ACT, false>(acc[mi][ni][2 * h + 1] + b1));
        T* out = y + (long long)row * N + col;
        if (col < N) out[0] = v0;
        if (col + 1 < N) out[1] = v1;
      }
    }
  }
}

// ------------------------- 16-bit: wgmma + TMA (K, N % 8 == 0, aligned) --

constexpr int kWgBM = 128;       // rows of y per block: two warpgroups of 64
// -D overrides of the tile's width and the ring's depth build
// scripts/port_hopper_ablation.py's variants; the defaults are the kernel
#ifndef APEX_GEMM_WG_BN
#define APEX_GEMM_WG_BN 256
#endif
#ifndef APEX_GEMM_WG_STAGES
#define APEX_GEMM_WG_STAGES 4
#endif
constexpr int kWgBN = APEX_GEMM_WG_BN;  // columns of y per block
constexpr int kWgBK = 64;        // depth per stage: one 128-byte x row
constexpr int kWgStages = APEX_GEMM_WG_STAGES;  // the TMA ring
constexpr int kWgThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kWgConsumerWarps = 8;  // each arrives once past its wait
constexpr int kWgA = kWgBM * kWgBK * 2;  // an x box: 16 KB
constexpr int kWgBox = kWgBK * 64 * 2;   // a w box, 64 x 64: 8 KB
constexpr int kWgStage = kWgA + kWgBN / 64 * kWgBox;
// a 64 x 64 block of y on its way out; two a consumer warpgroup
constexpr int kWgOut = 64 * 64 * 2;
// the ring, the output blocks, the ring's full and empty barriers, and the
// slack that aligns the ring to 1024 bytes: 230,464 bytes at 128 x 256
constexpr size_t kWgSmem = size_t(kWgStages) * kWgStage + 4 * kWgOut +
                           2 * kWgStages * sizeof(uint64_t) + 1024;

// acc (64 x kWgBN) [+]= a (64 x 16, K-major) b (16 x kWgBN, MN-major)
template <typename T>
__device__ __forceinline__ void wgmma_tile(float (&acc)[kWgBN / 2],
                                           uint64_t a, uint64_t b,
                                           int accumulate) {
  if constexpr (std::is_same<T, bf16>::value)
    hopper::wgmma_ss_bf16<0, 1>(acc, a, b, accumulate);
  else
    hopper::wgmma_ss_f16<0, 1>(acc, a, b, accumulate);
}

// One block an SM walks the output tiles blockIdx.x, + gridDim.x, ... (row
// by row, so neighbouring blocks share x's rows in L2).  The producer runs
// on into the next tile's slices while the consumers finish a tile, so a
// tile's first slices are in shared memory before its products start.
// The epilogue writes y through shared memory and TMA stores, 64 x 64 at
// a time: stored straight from the accumulators' layout, each warp store
// covered 16 bytes of 8 rows, and at the up projection (100 MB of y)
// those stores took more time than every product of the kernel.
template <typename T, int ACT, bool BIAS>
__global__ void __launch_bounds__(kWgThreads, 1)
    dense_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_y,
                       const float* __restrict__ bias, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  unsigned char* out = ring + kWgStages * kWgStage;  // [2 warpgroups][2]
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 4 * kWgOut);
  uint64_t* empty = full + kWgStages;
  const int wg = threadIdx.x / 128;
  const int n_k = (K + kWgBK - 1) / kWgBK;
  const int n_n = (N + kWgBN - 1) / kWgBN;
  const int n_tiles = (M + kWgBM - 1) / kWgBM * n_n;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWgConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int c = 0;  // slices issued so far: slice c uses stage c % kWgStages
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int m0 = t / n_n * kWgBM, n0 = t % n_n * kWgBN;
        for (int kt = 0; kt < n_k; ++kt, ++c) {
          const int s = c % kWgStages;
          // the stage's previous slice has been consumed
          if (c >= kWgStages)
            hopper::mbar_wait(&empty[s], (c / kWgStages - 1) & 1);
          unsigned char* st = ring + s * kWgStage;
          hopper::mbar_arrive_expect_tx(&full[s], kWgStage);
          hopper::tma_load_2d(st, &map_x, &full[s], kt * kWgBK, m0);
#pragma unroll
          for (int j = 0; j < kWgBN / 64; ++j)
            hopper::tma_load_2d(st + kWgA + j * kWgBox, &map_w, &full[s],
                                n0 + 64 * j, kt * kWgBK);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  hopper::setmaxnreg_inc<232>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[kWgBN / 2];
  // slice c's products; a tile's first overwrites acc (no zeroing: K > 0
  // on this route)
  auto slice = [&](int c, bool first) {
    const int s = c % kWgStages;
    hopper::mbar_wait(&full[s], (c / kWgStages) & 1);
    const unsigned char* a = ring + s * kWgStage + wg * 64 * 128;
    const unsigned char* b = ring + s * kWgStage + kWgA;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      wgmma_tile<T>(acc, hopper::wgmma_desc(a + 32 * kk, 16, 1024),
                    hopper::wgmma_desc(b + 2048 * kk, kWgBox, 1024),
                    !first || kk > 0);
    hopper::wgmma_commit();
  };
  // the warp is done with slice c: its stage goes back
  auto release = [&](int c) {
    if (lane == 0) hopper::mbar_arrive(&empty[c % kWgStages]);
    __syncwarp();  // no lane waits on the next stage alone
  };
  int c = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int m0 = t / n_n * kWgBM, n0 = t % n_n * kWgBN;
    // no instruction but a wgmma touches acc until the last wait: with a
    // slice's products in flight across the loop's back edge, one that
    // defines acc (a register fence, a zeroing) makes ptxas serialise
    // every wgmma (C7515)
    slice(c++, true);
    for (int kt = 1; kt < n_k; ++kt, ++c) {
      slice(c, false);
      // at most this slice's products in flight: the previous slice's are
      // done
      hopper::wgmma_wait<1>();
      release(c - 1);
    }
    hopper::wgmma_wait<0>();
    release(c - 1);
    hopper::fence_regs(acc);

    // epilogue: acc[4j], acc[4j + 1] at row g, columns 8j + 2 t4 and + 1;
    // acc[4j + 2], acc[4j + 3] at row g + 8 of the warp's 16 rows.  Bias,
    // activation and rounding in registers; each 64-column block into a
    // shared buffer in the layout a 128-byte-swizzled TMA map reads (the
    // 16-byte chunk c of row r at chunk c ^ (r % 8): the warp's writes hit
    // 32 banks), then one thread stores it; rows and columns past M and N
    // are dropped by the store.
    constexpr bool kFast = std::is_same<T, bf16>::value;
#pragma unroll
    for (int h = 0; h < kWgBN / 64; ++h) {
      unsigned char* buf = out + (2 * wg + (h & 1)) * kWgOut;
      // the store that last read this buffer is done
      if ((threadIdx.x & 127) == 0) hopper::bulk_wait_read<1>();
      hopper::named_barrier_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * h + jj;
        const int col = n0 + 8 * j + 2 * t4;
        float b0 = 0.f, b1 = 0.f;
        if (BIAS && col < N) {  // N is even: col + 1 < N too
          b0 = bias[col];
          b1 = bias[col + 1];
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = warp * 16 + g + 8 * hh;  // row of the block
          T pair[2] = {
              to_out<T>(apply_act<ACT, kFast>(acc[4 * j + 2 * hh] + b0)),
              to_out<T>(apply_act<ACT, kFast>(acc[4 * j + 2 * hh + 1] + b1))};
          *reinterpret_cast<uint32_t*>(buf + r * 128 + ((jj ^ (r & 7)) << 4) +
                                       4 * t4) =
              *reinterpret_cast<const uint32_t*>(pair);
        }
      }
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1 + wg, 128);
      if ((threadIdx.x & 127) == 0) {
        hopper::tma_store_2d(&map_y, buf, n0 + 64 * h, m0 + 64 * wg);
        hopper::bulk_commit();
      }
    }
  }
  if ((threadIdx.x & 127) == 0) hopper::bulk_wait_all();
}

// ------------------------------------------- fp32: FMA tiles, K split ----

// -D overrides build scripts/port_hopper_ablation.py's variants; the
// defaults are the kernel.  STAGES: the ring's depth (1: no copy overlaps
// the FMAs).  Timed, not checked: READS 0 reads each slice's x and w
// values from shared memory once and reuses them (the FMAs without most
// of their reads); MATH 0 adds the values read instead of multiplying
// them (the reads without most of the FMAs)
#ifndef APEX_GEMM_F32_STAGES
#define APEX_GEMM_F32_STAGES 4
#endif
#ifndef APEX_GEMM_F32_READS
#define APEX_GEMM_F32_READS 1
#endif
#ifndef APEX_GEMM_F32_MATH
#define APEX_GEMM_F32_MATH 1
#endif
constexpr int kF32M = 128;       // rows of y per block; its columns, BN,
                                 // are 128 or 64 (the plan's tile)
constexpr int kF32K = 16;        // depth per slice
constexpr int kF32MaxSplit = 8;  // a portable cluster
constexpr int kF32Stages = APEX_GEMM_F32_STAGES;
constexpr int kF32StageA = kF32M * kF32K;  // floats of x's slice

// more than half an SM's 228 KB of shared memory: one block an SM (the
// BN = 64 kernel's 113 registers would let two share one, and the cluster
// scheduler then packed some SMs with two while others idled)
constexpr size_t kF32OneBlock = 118 * 1024;

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// the ring, then the partial tile in the same bytes (65,536 at 4 stages
// and BN = 128, 49,152 at BN = 64), or kF32OneBlock
constexpr size_t f32_smem(int bn) {
  return cmax(cmax(size_t(kF32Stages) * (kF32StageA + kF32K * bn) * 4,
                   size_t(kF32M) * bn * 4),
              kF32OneBlock);
}

// 16 (4) bytes from device memory at `src` to the shared address `dst` by
// cp.async, or zeros (nothing read) where `valid` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// every thread of every block of the cluster: the writes to shared memory
// before it are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes at the shared-memory address `a` of the cluster's block `rank`
__device__ __forceinline__ float4 ld_cluster4(uint32_t a, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(a), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// thread (ty, tx) of a 16 x 16 grid owns rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, and the same pattern of columns with tx (the first
// four only at BN = 64): a quarter warp reads 32 consecutive floats of a
// shared row, with no bank conflict
__device__ __forceinline__ int f32_offset(int t, int i) {
  return t * 4 + (i & 3) + (i >> 2) * 64;
}

// x's slice is 128 rows of four 16-byte chunks; chunk c of row r sits at
// chunk c ^ ((r >> 2) & 3).  A warp's reads take rows r and r + 4 (its
// two values of ty), which the swizzle puts on different banks; its
// copies fill whole rows, which it only permutes
__device__ __forceinline__ int f32_a_index(int r, int k) {
  return r * kF32K + (((k >> 2) ^ ((r >> 2) & 3)) << 2) + (k & 3);
}

// A thread's share of the copies of each slice of x's rows [m0, m0 + 128)
// and w's columns [n0, n0 + BN) into the ring, one slice after another
// from depth kb (`next`), zeros past M, N and the block's depth end ke.
// VEC: 16-byte copies (K and N multiples of 4, 16-byte aligned bases, so a
// chunk is all in or all out), each thread's pointers, offsets and row /
// column bounds worked out once; else 4-byte copies, element by element.
template <bool VEC, int BN>
struct F32Copies {
  static constexpr int kStageB = kF32K * BN;             // floats of w's
  static constexpr int kXc = kF32K / 4;                  // chunks an x row
  static constexpr int kXPer = kF32StageA / 4 / kThreads;  // x chunks
  static constexpr int kWPer = kStageB / 4 / kThreads;     // w chunks
  static constexpr int kXGap = kThreads / kXc;       // rows between x chunks
  static constexpr int kWGap = kThreads / (BN / 4);  // rows between w chunks
  const float *x, *w, *xp, *wp;  // xp, wp: this thread's next chunks
  long long xg, wg;              // elements between its x / w chunks
  int M, N, K, m0, n0, k0, ke;
  int xk, wr;       // the x chunk's depth, the w chunk's row, in a slice
  uint32_t xs, ws;  // their byte offsets in a stage
  uint32_t xin;     // bit i: the thread's i-th x row lies in M
  bool win;         // its w column lies in N

  __device__ F32Copies(const float* x_, const float* w_, int M_, int N_,
                       int K_, int m0_, int n0_, int kb, int ke_)
      : x(x_), w(w_), M(M_), N(N_), K(K_), m0(m0_), n0(n0_), k0(kb),
        ke(ke_) {
    const int tid = threadIdx.x;
    const int r = tid / kXc, wc = 4 * (tid % (BN / 4));
    xk = 4 * (tid % kXc);
    wr = tid / (BN / 4);
    xs = 4 * f32_a_index(r, xk);
    ws = 4 * (wr * BN + wc);
    xin = 0;
#pragma unroll
    for (int i = 0; i < kXPer; ++i)
      if (m0 + r + i * kXGap < M) xin |= 1u << i;
    win = n0 + wc < N;
    xg = (long long)kXGap * K;
    wg = (long long)kWGap * N;
    xp = x + (long long)(m0 + r) * K + kb + xk;
    wp = w + (long long)(kb + wr) * N + n0 + wc;
  }

  // the next slice into the stage at shared addresses a (x) and b (w)
  __device__ __forceinline__ void next(uint32_t a, uint32_t b) {
    if constexpr (VEC) {
      const bool kx = k0 + xk < ke;
#pragma unroll
      for (int i = 0; i < kXPer; ++i) {
        const bool ok = kx && (xin >> i & 1);
        cp_async16(a + xs + i * kXGap * kF32K * 4, ok ? xp + i * xg : x, ok);
      }
#pragma unroll
      for (int i = 0; i < kWPer; ++i) {
        const bool ok = win && k0 + wr + i * kWGap < ke;
        cp_async16(b + ws + i * kWGap * BN * 4, ok ? wp + i * wg : w, ok);
      }
      xp += kF32K;
      wp += (long long)kF32K * N;
    } else {
      const int tid = threadIdx.x;
#pragma unroll
      for (int i = 0; i < kF32StageA / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / kF32K, kk = e % kF32K;
        const bool ok = m0 + r < M && k0 + kk < ke;
        cp_async4(a + 4 * f32_a_index(r, kk),
                  ok ? x + (long long)(m0 + r) * K + k0 + kk : x, ok);
      }
#pragma unroll
      for (int i = 0; i < kStageB / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / BN, c = e % BN;
        const bool ok = k0 + r < ke && n0 + c < N;
        cp_async4(b + 4 * (r * BN + c),
                  ok ? w + (long long)(k0 + r) * N + n0 + c : w, ok);
      }
    }
    k0 += kF32K;
  }
};

// acc += one stage's slice: per 4-deep chunk, each thread reads its 8 rows'
// 16-byte chunks of x (32 values), then per depth its BN / 16 columns of
// w, and does 8 x BN / 16 FMAs.  The rows' swizzle, (r >> 2) & 3, is
// ty & 3 for all of them, so a chunk's reads share one column offset
template <int BN>
__device__ __forceinline__ void f32_slice(float (&acc)[8][BN / 16],
                                          const float* as, const float* bs,
                                          int tx, int ty) {
  constexpr int kJ = BN / 16;  // columns a thread
  const float* arow = as + ty * 4 * kF32K;
  const int sw = ty & 3;
  float a[8][4], b[kJ];
#pragma unroll
  for (int c = 0; c < kF32K / 4; ++c) {
    if (APEX_GEMM_F32_READS || c == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            arow + ((i & 3) + (i >> 2) * 64) * kF32K + 4 * (c ^ sw));
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (APEX_GEMM_F32_READS || (c == 0 && kk == 0)) {
#pragma unroll
        for (int h = 0; h < kJ / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs + (4 * c + kk) * BN + 64 * h + tx * 4);
          b[4 * h] = v.x; b[4 * h + 1] = v.y; b[4 * h + 2] = v.z;
          b[4 * h + 3] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (APEX_GEMM_F32_MATH) {
#pragma unroll
          for (int j = 0; j < kJ; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
        } else {
          acc[i][0] += a[i][kk];
          acc[0][i % kJ] += b[i % kJ];
        }
      }
    }
  }
}

// The grid is (split, N tiles, M tiles) in clusters of (split, 1, 1): block
// `rank` of a cluster sums depth [rank k_split, (rank + 1) k_split) of its
// 128 x BN tile.  Then every block's partial tile goes to its shared
// memory, and block `rank` sums rows [rank 128 / split, (rank + 1) 128 /
// split) of all of them, rank 0 first, and stores act(sum + b).  A split
// of 1 is a cluster of one block.
template <int ACT, bool BIAS, bool VEC, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    dense_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int M, int N, int K, int k_split) {
  constexpr int kStageB = kF32K * BN;
  constexpr int kJ = BN / 16;
  extern __shared__ __align__(16) float fsm[];
  float* sa = fsm;                        // [kF32Stages][kF32StageA]
  float* sb = fsm + kF32Stages * kF32StageA;  // [kF32Stages][kStageB]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int split = gridDim.x, rank = blockIdx.x;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * kF32M;
  const int kb = rank * k_split;
  const int ke = min(K, kb + k_split);
  const int n_k = ke > kb ? (ke - kb + kF32K - 1) / kF32K : 0;
  float acc[8][kJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;

  // slice s lives in stage s % kF32Stages, copied kF32Stages - 1 slices
  // ahead; every thread commits one group a slice, empty or not, so the
  // wait's count is the same on every iteration
  F32Copies<VEC, BN> copies(x, w, M, N, K, m0, n0, kb, ke);
  const uint32_t ring_a = hopper::smem_u32(sa), ring_b = hopper::smem_u32(sb);
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < n_k)
      copies.next(ring_a + s * kF32StageA * 4, ring_b + s * kStageB * 4);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    if (kF32Stages == 1) {
      copies.next(ring_a, ring_b);
      cp_async_commit();
    }
    // slice kt has landed for this thread; after the barrier for all of
    // them, and every thread is done with slice kt - 1, whose stage the
    // next copy overwrites
    cp_async_wait<(kF32Stages > 1 ? kF32Stages - 2 : 0)>();
    __syncthreads();
    if (kF32Stages > 1) {
      const int nk = kt + kF32Stages - 1;
      if (nk < n_k) {
        const int s = nk % kF32Stages;
        copies.next(ring_a + s * kF32StageA * 4, ring_b + s * kStageB * 4);
      }
      cp_async_commit();
    }
    const int s = kt % kF32Stages;
    f32_slice<BN>(acc, sa + s * kF32StageA, sb + s * kStageB, tx, ty);
    if (kF32Stages == 1) __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial tile takes its bytes

  float* part = fsm;  // [kF32M][BN]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < kJ / 4; ++h)
      *reinterpret_cast<float4*>(part + f32_offset(ty, i) * BN + 64 * h +
                                 4 * tx) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  cluster_sync();  // every block's partial tile is in place

  // rows [r0, r1) of the tile, BN / 4 chunks of 4 columns a row: a warp
  // reads and stores whole rows, a thread two chunks at a time with every
  // block's loads of both in flight together
  constexpr int kC = BN / 4;
  const int r0 = rank * kF32M / split, r1 = (rank + 1) * kF32M / split;
  const int e1 = r1 * kC;
  const uint32_t base = hopper::smem_u32(part);
  for (int e0 = r0 * kC + tid; e0 < e1; e0 += 2 * kThreads) {
    float4 p[2][kF32MaxSplit];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + h * kThreads;
      const uint32_t a = base + e * 16;  // row e / kC, column 4 (e % kC)
#pragma unroll
      for (int q = 0; q < kF32MaxSplit; ++q)
        if (e < e1 && q < split) p[h][q] = ld_cluster4(a, q);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + h * kThreads;
      const int row = m0 + e / kC, col = n0 + 4 * (e % kC);
      if (e >= e1 || row >= M || col >= N) continue;
      float v[4] = {p[h][0].x, p[h][0].y, p[h][0].z, p[h][0].w};
#pragma unroll
      for (int q = 1; q < kF32MaxSplit; ++q)
        if (q < split) {
          v[0] += p[h][q].x; v[1] += p[h][q].y;
          v[2] += p[h][q].z; v[3] += p[h][q].w;
        }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float bt = BIAS && col + t < N ? bias[col + t] : 0.f;
        v[t] = apply_act<ACT, false>(v[t] + bt);
      }
      float* out = y + (long long)row * N + col;
      if (VEC) {  // N % 4 == 0: the chunk is all in
        *reinterpret_cast<float4*>(out) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (col + t < N) out[t] = v[t];
      }
    }
  }
  cluster_sync();  // no block leaves while another reads its tile
}

// --------------------------------------------- any dtype: N <= 8, GEMV ----

constexpr int kGvWarps = 8;        // rows of y per block: a warp a row
constexpr int kGvMaxN = 8;
constexpr int kGvChunk = 1024;     // rows of w staged at a time
constexpr int kGvStride = kGvChunk + 4;  // [n][k]: 4 banks apart by n

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }

// the V = 16 / sizeof(T) elements of a 16-byte piece as fp32, exactly
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float* v) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      v[i] = __uint_as_float(u[i]);
    } else if constexpr (std::is_same<T, bf16>::value) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    } else {
      v[2 * i] = __half2float(__ushort_as_half(u[i] & 0xffffu));
      v[2 * i + 1] = __half2float(__ushort_as_half(u[i] >> 16));
    }
  }
}

// acc[j] += xv * w[k][j] for j < N, w's row k at ws[j * kGvStride + k]
__device__ __forceinline__ void gv_fma(float (&acc)[kGvMaxN], float xv,
                                       const float* ws, int k, int N) {
#pragma unroll
  for (int j = 0; j < kGvMaxN; ++j)
    if (j < N) acc[j] = fmaf(xv, ws[j * kGvStride + k], acc[j]);
}

// y[m, :] = act(x[m, :] w + b) with warp `warp` of block b on row m = 8 b +
// warp.  Lane l takes, of each chunk of K, the 16-byte pieces l, l + 32,
// ... (`vec`: every row starts 16-byte aligned and K fills whole pieces)
// or the elements l, l + 32, ...; every lane sums its products in order,
// then the butterfly adds lane pairs (both partners get the same bits).
template <typename T, int ACT, bool BIAS>
__global__ void __launch_bounds__(kGvWarps * 32)
    dense_gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int M, int N, int K, bool vec) {
  __shared__ __align__(16) float ws[kGvMaxN * kGvStride];
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int U = 4;               // pieces of a lane in flight at once
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = (long long)blockIdx.x * kGvWarps + warp;
  const T* xr = x + (m < M ? m : 0) * K;
  float acc[kGvMaxN];
#pragma unroll
  for (int j = 0; j < kGvMaxN; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < K; c0 += kGvChunk) {
    const int kc = min(kGvChunk, K - c0);
    __syncthreads();  // every warp is done with the previous chunk
    for (int e = threadIdx.x; e < kc * N; e += kGvWarps * 32)
      ws[(e % N) * kGvStride + e / N] =
          to_f32<T>(w[(long long)c0 * N + e]);
    __syncthreads();
    if (m >= M) continue;
    if (vec) {
      const int np = kc / V;  // whole 16-byte pieces of the chunk
      for (int p0 = lane; p0 < np; p0 += 32 * U) {
        uint4 raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (p0 + 32 * u < np)
            raw[u] = __ldg(reinterpret_cast<const uint4*>(
                xr + c0 + (long long)(p0 + 32 * u) * V));
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (p0 + 32 * u >= np) break;
          float xv[V];
          unpack16<T>(raw[u], xv);
          const int k = (p0 + 32 * u) * V;
#pragma unroll
          for (int q = 0; q < V; q += 4) {
#pragma unroll
            for (int j = 0; j < kGvMaxN; ++j) {
              if (j >= N) break;
              const float4 wv = *reinterpret_cast<const float4*>(
                  ws + j * kGvStride + k + q);
              acc[j] = fmaf(xv[q], wv.x, acc[j]);
              acc[j] = fmaf(xv[q + 1], wv.y, acc[j]);
              acc[j] = fmaf(xv[q + 2], wv.z, acc[j]);
              acc[j] = fmaf(xv[q + 3], wv.w, acc[j]);
            }
          }
        }
      }
    } else {
      for (int k = lane; k < kc; k += 32)
        gv_fma(acc, to_f32<T>(xr[c0 + k]), ws, k, N);
    }
  }
  if (m >= M) return;
#pragma unroll
  for (int j = 0; j < kGvMaxN; ++j) {
    if (j >= N) break;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
#pragma unroll
  for (int j = 0; j < kGvMaxN; ++j)
    if (j < N && lane == j)
      y[m * N + j] =
          to_out<T>(apply_act<ACT, false>(acc[j] + (BIAS ? bias[j] : 0.f)));
}

// ------------------------------------------------------------ launch ----

enum Route { kFma = 0, kMma = 1, kWgmma = 2, kGemv = 3 };

// dynamic shared memory above the 48 KB default needs an opt-in, once
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) done = true;
  return e;
}

template <typename T, int ACT, bool BIAS>
cudaError_t launch_mma(const void* x, const void* w, const float* b, void* y,
                       int M, int N, int K, cudaStream_t stream) {
  static bool opted = false;
  const auto kernel = dense_mma_kernel<T, ACT, BIAS>;
  const cudaError_t e = opt_in(kernel, kSmem16, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmem16, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), b,
      static_cast<T*>(y), M, N, K);
  return cudaGetLastError();
}

// the tensor maps of x (M, K) and w (K, N), built for each call: x in
// kWgBM x kWgBK boxes, w in kWgBK x 64 boxes
template <typename T, int ACT, bool BIAS>
int launch_wgmma(const void* x, const void* w, const float* b, void* y,
                 int M, int N, int K, cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<T, bf16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap map_x, map_w;
  const cuuint64_t dx[2] = {cuuint64_t(K), cuuint64_t(M)};
  const cuuint64_t sx[1] = {cuuint64_t(K) * 2};
  const cuuint32_t bx[2] = {kWgBK, kWgBM};
  int err = hopper::make_tensor_map(&map_x, type, 2, x, dx, sx, bx);
  if (err != 0) return err;
  const cuuint64_t dw[2] = {cuuint64_t(N), cuuint64_t(K)};
  const cuuint64_t sw[1] = {cuuint64_t(N) * 2};
  const cuuint32_t bw[2] = {64, kWgBK};
  err = hopper::make_tensor_map(&map_w, type, 2, w, dw, sw, bw);
  if (err != 0) return err;
  CUtensorMap map_y;
  const cuuint64_t dy[2] = {cuuint64_t(N), cuuint64_t(M)};
  const cuuint32_t by[2] = {64, 64};
  err = hopper::make_tensor_map(&map_y, type, 2, y, dy, sw, by);
  if (err != 0) return err;
  static bool opted = false;
  const auto kernel = dense_wgmma_kernel<T, ACT, BIAS>;
  const cudaError_t e = opt_in(kernel, kWgSmem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (long long)((M + kWgBM - 1) / kWgBM) *
                          ((N + kWgBN - 1) / kWgBN);
  const int sms = hopper::sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kWgThreads, kWgSmem, stream>>>(map_x, map_w, map_y, b, M,
                                                N, K);
  return static_cast<int>(cudaGetLastError());
}

// the launch of the fp32 kernel's 128 x BN tiles under a split of K among
// `split` blocks: clusters of `split` blocks along the grid's x
template <int BN>
cudaLaunchConfig_t f32_config(int M, int N, int split, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + BN - 1) / BN, (M + kF32M - 1) / kF32M);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = f32_smem(BN);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int ACT, bool BIAS, bool VEC, int BN>
int launch_f32(const void* x, const void* w, const float* b, void* y, int M,
               int N, int K, int split, int k_split, cudaStream_t stream) {
  static bool opted = false;
  const auto kernel = dense_f32_kernel<ACT, BIAS, VEC, BN>;
  const cudaError_t e = opt_in(kernel, f32_smem(BN), opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = f32_config<BN>(M, N, split, stream, &attr);
  const cudaError_t l = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(x),
      static_cast<const float*>(w), b, static_cast<float*>(y), M, N, K,
      k_split);
  if (l != cudaSuccess) return static_cast<int>(l);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACT, bool BIAS>
int launch_gemv(const void* x, const void* w, const float* b, void* y, int M,
                int N, int K, bool vec, cudaStream_t stream) {
  const unsigned grid = (static_cast<unsigned>(M) + kGvWarps - 1) / kGvWarps;
  dense_gemv_kernel<T, ACT, BIAS><<<grid, kGvWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), b,
      static_cast<T*>(y), M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int ACT, bool BIAS>
int launch(int route, int dtype, const void* x, const void* w, const float* b,
           void* y, int M, int N, int K, int tile_n, int split, int k_split,
           int vec, cudaStream_t stream) {
  const int el = dtype == 0 ? 4 : 2;
  if (route == kGemv) {
    // every row starts on a 16-byte boundary and K fills whole pieces
    const bool rows16 = aligned16(x) && (long long)K * el % 16 == 0;
    if (N > kGvMaxN || split != 1 || (vec && !rows16))
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
      return launch_gemv<float, ACT, BIAS>(x, w, b, y, M, N, K, vec, stream);
    if (dtype == 1)
      return launch_gemv<bf16, ACT, BIAS>(x, w, b, y, M, N, K, vec, stream);
    if (dtype == 2)
      return launch_gemv<__half, ACT, BIAS>(x, w, b, y, M, N, K, vec,
                                            stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kFma && dtype == 0) {
    // the plan: 128 x 128 or 128 x 64 tiles, 1 to 8 blocks a cluster
    // whose depth ranges, whole slices, cover K; 16-byte copies only where
    // every chunk is all in or all out
    const bool ok =
        N > kGvMaxN && (tile_n == 128 || tile_n == 64) && split >= 1 &&
        split <= kF32MaxSplit && k_split >= 0 && k_split % kF32K == 0 &&
        (long long)split * k_split >= K &&
        (N + tile_n - 1) / tile_n <= 65535 &&
        (!vec || (K % 4 == 0 && N % 4 == 0 && aligned16(x) &&
                  aligned16(w) && aligned16(y)));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    if (tile_n == 64)
      return vec ? launch_f32<ACT, BIAS, true, 64>(x, w, b, y, M, N, K, split,
                                                   k_split, stream)
                 : launch_f32<ACT, BIAS, false, 64>(x, w, b, y, M, N, K,
                                                    split, k_split, stream);
    return vec ? launch_f32<ACT, BIAS, true, 128>(x, w, b, y, M, N, K, split,
                                                  k_split, stream)
               : launch_f32<ACT, BIAS, false, 128>(x, w, b, y, M, N, K,
                                                   split, k_split, stream);
  }
  // the 16-bit routes: N > 8, one block's depth is all of K
  if (N <= kGvMaxN || split != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kMma && dtype == 1)
    return launch_mma<bf16, ACT, BIAS>(x, w, b, y, M, N, K, stream);
  if (route == kMma && dtype == 2)
    return launch_mma<__half, ACT, BIAS>(x, w, b, y, M, N, K, stream);
  // what TMA addresses: 16-byte aligned bases and row strides
  const bool tma = K > 0 && K % 8 == 0 && N % 8 == 0 && aligned16(x) &&
                   aligned16(w) && aligned16(y);
  if (route == kWgmma && dtype == 1 && tma)
    return launch_wgmma<bf16, ACT, BIAS>(x, w, b, y, M, N, K, stream);
  if (route == kWgmma && dtype == 2 && tma)
    return launch_wgmma<__half, ACT, BIAS>(x, w, b, y, M, N, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int ACT>
int launch_act(int route, int dtype, const void* x, const void* w,
               const float* b, void* y, int M, int N, int K, int tile_n,
               int split, int k_split, int vec, cudaStream_t stream) {
  return b ? launch<ACT, true>(route, dtype, x, w, b, y, M, N, K, tile_n,
                               split, k_split, vec, stream)
           : launch<ACT, false>(route, dtype, x, w, b, y, M, N, K, tile_n,
                                split, k_split, vec, stream);
}

}  // namespace

// the clusters of `split` blocks of the fp32 kernel's 128 x `tile_n` tiles
// the current device holds at once (cudaOccupancyMaxActiveClusters), or a
// negative CUDA error
extern "C" int apex_fused_dense_f32_clusters(int tile_n, int split) {
  if (split < 1 || split > kF32MaxSplit || (tile_n != 128 && tile_n != 64))
    return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  cudaLaunchAttribute attr;
  cudaError_t e;
  if (tile_n == 128) {
    static bool opted = false;
    const auto kernel = dense_f32_kernel<kRelu, true, true, 128>;
    e = opt_in(kernel, f32_smem(128), opted);
    const cudaLaunchConfig_t cfg = f32_config<128>(8192, 8192, split, 0,
                                                   &attr);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  } else {
    static bool opted = false;
    const auto kernel = dense_f32_kernel<kRelu, true, true, 64>;
    e = opt_in(kernel, f32_smem(64), opted);
    const cudaLaunchConfig_t cfg = f32_config<64>(8192, 8192, split, 0,
                                                  &attr);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  }
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// y (M, N) = act(x (M, K) w (K, N) + b (N)), all row-major and contiguous,
// x, w and y of one dtype (0 fp32, 1 bf16, 2 fp16); b fp32 or null for no
// bias; act 0 none, 1 relu, 2 tanh-gelu, 3 sigmoid.  `route` names the
// kernel: 3 the GEMV kernel (any dtype, N <= 8), 0 the fp32 FMA kernel
// (fp32, N > 8), 1 the mma.sync kernel (16-bit, N > 8), 2 the wgmma + TMA
// kernel (16-bit, N > 8, K > 0 and K, N multiples of 8, x, w and y 16-byte
// aligned).  The plan: the fp32 route's tiles are 128 x `tile_n` (128 or
// 64; the others ignore it), `split` blocks share each tile's depth,
// `k_split` of it each (a multiple of 16 with split * k_split >= K; the
// fp32 route takes split 1 to 8, the others 1), and `vec` asks for
// 16-byte loads
// (fp32 route: K and N multiples of 4, x, w and y 16-byte aligned; GEMV
// route: x 16-byte aligned and K * element size a multiple of 16; ignored
// by the others).  A route or plan whose conditions do not hold is
// cudaErrorInvalidValue, with nothing launched.  M, N > 0.  Launches on
// `stream`; returns 0 when launched, else the CUDA error, or
// hopper::kTensorMapError + cuTensorMapEncodeTiled's CUresult when it
// refused a TMA tensor map.
extern "C" int apex_fused_dense_fwd(int route, int dtype, int act,
                                    const void* x, const void* w,
                                    const void* b, void* y, int M, int N,
                                    int K, int tile_n, int split, int k_split,
                                    int vec, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* bias = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kNone:
      return launch_act<kNone>(route, dtype, x, w, bias, y, M, N, K, tile_n,
                               split, k_split, vec, s);
    case kRelu:
      return launch_act<kRelu>(route, dtype, x, w, bias, y, M, N, K, tile_n,
                               split, k_split, vec, s);
    case kGelu:
      return launch_act<kGelu>(route, dtype, x, w, bias, y, M, N, K, tile_n,
                               split, k_split, vec, s);
    case kSigmoid:
      return launch_act<kSigmoid>(route, dtype, x, w, bias, y, M, N, K,
                                  tile_n, split, k_split, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
