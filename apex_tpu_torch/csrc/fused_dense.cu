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
// Three kernels; the caller picks one by dtype, shape and alignment
// (ops/fused_dense.py gemm_route) and this file refuses a route whose
// conditions do not hold, never taking another in its place:
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
//   * mma.sync (bf16 / fp16, any other shape: apex's MLP ends in N = 1): a
//     block of 8 warps computes a 128 x 128 tile, each warp 64 x 32 of it
//     as 4 x 4 mma.sync m16n8k16 products; 32-deep slices of x and w are
//     staged element by element in a 4-stage ring of padded shared-memory
//     tiles (rows and depth past M, N and K read as zero), the A fragments
//     through ldmatrix, the B fragments through ldmatrix.trans.
//   * fp32: full fp32 FMAs (not TF32, so it matches the plain version's
//     fp32 product): a block of 256 threads computes a 128 x 128 tile,
//     each thread 8 x 8 outputs, from 8-deep slices in shared memory.
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

// ----------------------------------------------------- fp32 FMA tiles ----

constexpr int kFK = 8;  // depth per slice of the fp32 kernel

// thread (ty, tx) of a 16 x 16 grid owns rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, and the same pattern of columns with tx: a quarter
// warp reads 32 consecutive floats of a shared row, with no bank conflict
__device__ __forceinline__ int f32_offset(int t, int i) {
  return t * 4 + (i & 3) + (i >> 2) * 64;
}

template <int ACT, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    dense_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int M, int N, int K) {
  __shared__ __align__(16) float sa[kFK][kBM];  // x slice, transposed
  __shared__ __align__(16) float sb[kFK][kBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < kBM * kFK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kFK, c = e % kFK;
      const bool ok = m0 + r < M && k0 + c < K;
      sa[c][r] = ok ? x[(long long)(m0 + r) * K + k0 + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kFK * kBN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBN, c = e % kBN;
      const bool ok = k0 + r < K && n0 + c < N;
      sb[r][c] = ok ? w[(long long)(k0 + r) * N + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sa[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sb[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + f32_offset(tx, j);
    if (col >= N) continue;
    const float bj = BIAS ? bias[col] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + f32_offset(ty, i);
      if (row < M)
        y[(long long)row * N + col] = apply_act<ACT, false>(acc[i][j] + bj);
    }
  }
}

// ------------------------------------------------------------ launch ----

enum Route { kFma = 0, kMma = 1, kWgmma = 2 };

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

template <int ACT, bool BIAS>
int launch(int route, int dtype, const void* x, const void* w, const float* b,
           void* y, int M, int N, int K, cudaStream_t stream) {
  if (route == kFma && dtype == 0) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    dense_f32_kernel<ACT, BIAS><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b,
        static_cast<float*>(y), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (route == kMma && dtype == 1)
    return launch_mma<bf16, ACT, BIAS>(x, w, b, y, M, N, K, stream);
  if (route == kMma && dtype == 2)
    return launch_mma<__half, ACT, BIAS>(x, w, b, y, M, N, K, stream);
  // what TMA addresses: 16-byte aligned bases and row strides
  const bool tma = K > 0 && K % 8 == 0 && N % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (route == kWgmma && dtype == 1 && tma)
    return launch_wgmma<bf16, ACT, BIAS>(x, w, b, y, M, N, K, stream);
  if (route == kWgmma && dtype == 2 && tma)
    return launch_wgmma<__half, ACT, BIAS>(x, w, b, y, M, N, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int ACT>
int launch_act(int route, int dtype, const void* x, const void* w,
               const float* b, void* y, int M, int N, int K,
               cudaStream_t stream) {
  return b ? launch<ACT, true>(route, dtype, x, w, b, y, M, N, K, stream)
           : launch<ACT, false>(route, dtype, x, w, b, y, M, N, K, stream);
}

}  // namespace

// y (M, N) = act(x (M, K) w (K, N) + b (N)), all row-major and contiguous,
// x, w and y of one dtype (0 fp32, 1 bf16, 2 fp16); b fp32 or null for no
// bias; act 0 none, 1 relu, 2 tanh-gelu, 3 sigmoid.  `route` names the
// kernel: 0 the fp32 FMA kernel (fp32 only), 1 the mma.sync kernel (16-bit,
// any shape), 2 the wgmma + TMA kernel (16-bit, K > 0 and K, N multiples
// of 8, x and w 16-byte aligned); a route whose conditions do not hold is
// cudaErrorInvalidValue, with nothing launched.  M, N > 0.  Launches on
// `stream`; returns 0 when launched, else the CUDA error, or
// hopper::kTensorMapError + cuTensorMapEncodeTiled's CUresult when it
// refused a TMA tensor map.
extern "C" int apex_fused_dense_fwd(int route, int dtype, int act,
                                    const void* x, const void* w,
                                    const void* b, void* y, int M, int N,
                                    int K, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* bias = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kNone:
      return launch_act<kNone>(route, dtype, x, w, bias, y, M, N, K, s);
    case kRelu:
      return launch_act<kRelu>(route, dtype, x, w, bias, y, M, N, K, s);
    case kGelu:
      return launch_act<kGelu>(route, dtype, x, w, bias, y, M, N, K, s);
    case kSigmoid:
      return launch_act<kSigmoid>(route, dtype, x, w, bias, y, M, N, K, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
