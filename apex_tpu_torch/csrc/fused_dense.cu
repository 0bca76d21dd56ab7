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
// so the tensor cores bound it.  Design, simple and right before fast:
//   * bf16 / fp16: a block of 8 warps computes a 128 x 128 tile of y,
//     each warp 64 x 32 of it as 4 x 4 mma.sync m16n8k16 products (16-bit
//     in, fp32 accumulate), so every product is on the tensor cores.  The
//     loop over K walks 32-deep slices of x and w staged in shared memory
//     in a ring of four stages: three slices are in flight by cp.async
//     while one is used, with one barrier a slice.  Tile rows are padded
//     by 16 bytes so the ldmatrix loads of the A fragments and the
//     ldmatrix.trans loads of the B fragments hit 32 distinct banks; w
//     stays row-major (K, N) and ldmatrix.trans turns it into the mma's
//     column operand, so no transposed copy exists.  (The first version,
//     two stages, two barriers a slice and 32-bit A fragment loads, took
//     0.427 ms at the up projection on an H100 80GB HBM3 at 700 W; root
//     PERF.md has this one's time.  Both are far from the bound: wgmma,
//     TMA and larger warp tiles are the levers.)
//   * fp32: full fp32 FMAs (not TF32, so it matches the plain version's
//     fp32 product): a block of 256 threads computes a 128 x 128 tile,
//     each thread 8 x 8 outputs, from 8-deep slices in shared memory.
//   * ragged shapes: rows, columns and depth past M, N and K are
//     zero-filled on load and never stored, so any M, N and K work with no
//     padded copies (apex's MLP ends in N = 1).  When K and N are
//     multiples of 16 bytes' worth of elements and x and w are 16-byte
//     aligned, the 16-bit kernel loads by cp.async in 16-byte pieces;
//     otherwise element by element (the ALIGNED template flag).
//   * epilogue in registers: bias, activation, rounding, store; the
//     pre-activation never reaches device memory unless the caller asks
//     for it (the autograd forward launches with act = none).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSigmoid = 3 };

template <int ACT>
__device__ __forceinline__ float apply_act(float y) {
  if (ACT == kRelu) return y < 0.f ? 0.f : y;  // NaN stays NaN
  if (ACT == kGelu)                            // tanh approximation
    return 0.5f * y *
           (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-y));
  return y;
}

// ------------------------------------------------ 16-bit tensor cores ----

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
// w's columns [n0, n0 + kBN) into shared memory, zero past M, N and K
template <bool ALIGNED>
__device__ __forceinline__ void load_stage(uint16_t* as, uint16_t* bs,
                                           const uint16_t* x,
                                           const uint16_t* w, int M, int N,
                                           int K, int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  if constexpr (ALIGNED) {
    // 16-byte pieces: x rows hold kBK / 8 = 4 pieces, w rows kBN / 8 = 16
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, col = (c & 3) * 8;
      const bool ok = m0 + r < M && k0 + col < K;
      const uint16_t* src = ok ? x + (long long)(m0 + r) * K + k0 + col : x;
      cp_async16(as + r * kSA + col, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 4, col = (c & 15) * 8;
      const bool ok = k0 + r < K && n0 + col < N;
      const uint16_t* src = ok ? w + (long long)(k0 + r) * N + n0 + col : w;
      cp_async16(bs + r * kSB + col, src, ok);
    }
  } else {
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
}

template <typename T, int ACT, bool BIAS, bool ALIGNED>
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

  // slice s lives in stage s % kStages; one commit group per slice (empty
  // past the last), so waiting for all but kStages - 2 groups means the
  // slice about to be used has landed
  const int n_k = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k)
      load_stage<ALIGNED>(sa + s * kStageA, sb + s * kStageB, x, w, M, N, K,
                          m0, n0, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    // slice kt is visible to every thread, and every thread is done with
    // slice kt - 1, whose stage the next copy overwrites
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < n_k) {
      const int s = nk % kStages;
      load_stage<ALIGNED>(sa + s * kStageA, sb + s * kStageB, x, w, M, N, K,
                          m0, n0, nk * kBK);
    }
    cp_async_commit();
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
  cp_async_wait<0>();  // only empty groups remain; none outlives the block

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
        const T v0 = to_out<T>(apply_act<ACT>(acc[mi][ni][2 * h] + b0));
        const T v1 = to_out<T>(apply_act<ACT>(acc[mi][ni][2 * h + 1] + b1));
        T* out = y + (long long)row * N + col;
        if (ALIGNED && col + 1 < N) {  // N even: a 4-byte aligned pair
          T pair[2] = {v0, v1};
          *reinterpret_cast<uint32_t*>(out) =
              *reinterpret_cast<const uint32_t*>(pair);
        } else {
          if (col < N) out[0] = v0;
          if (col + 1 < N) out[1] = v1;
        }
      }
    }
  }
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
      if (row < M) y[(long long)row * N + col] = apply_act<ACT>(acc[i][j] + bj);
    }
  }
}

// ------------------------------------------------------------ launch ----

// one 16-bit instantiation's launch, with its dynamic shared memory
// opted in once
template <typename T, int ACT, bool BIAS, bool ALIGNED>
cudaError_t launch_mma(dim3 grid, const void* x, const void* w,
                       const float* b, void* y, int M, int N, int K,
                       cudaStream_t stream) {
  static bool opted = false;
  const auto kernel = dense_mma_kernel<T, ACT, BIAS, ALIGNED>;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem16));
    if (e != cudaSuccess) return e;
    opted = true;
  }
  kernel<<<grid, kThreads, kSmem16, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), b,
      static_cast<T*>(y), M, N, K);
  return cudaGetLastError();
}

template <int ACT, bool BIAS>
cudaError_t launch(int dtype, const void* x, const void* w, const float* b,
                   void* y, int M, int N, int K, bool aligned,
                   cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (dtype == 0) {
    dense_f32_kernel<ACT, BIAS><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b,
        static_cast<float*>(y), M, N, K);
    return cudaGetLastError();
  }
  if (dtype == 1)
    return aligned ? launch_mma<bf16, ACT, BIAS, true>(grid, x, w, b, y, M, N,
                                                       K, stream)
                   : launch_mma<bf16, ACT, BIAS, false>(grid, x, w, b, y, M,
                                                        N, K, stream);
  if (dtype == 2)
    return aligned ? launch_mma<__half, ACT, BIAS, true>(grid, x, w, b, y, M,
                                                         N, K, stream)
                   : launch_mma<__half, ACT, BIAS, false>(grid, x, w, b, y,
                                                          M, N, K, stream);
  return cudaErrorInvalidValue;
}

template <int ACT>
cudaError_t launch_act(int dtype, const void* x, const void* w,
                       const float* b, void* y, int M, int N, int K,
                       bool aligned, cudaStream_t stream) {
  return b ? launch<ACT, true>(dtype, x, w, b, y, M, N, K, aligned, stream)
           : launch<ACT, false>(dtype, x, w, b, y, M, N, K, aligned, stream);
}

}  // namespace

// y (M, N) = act(x (M, K) w (K, N) + b (N)), all row-major and contiguous,
// x, w and y of one dtype (0 fp32, 1 bf16, 2 fp16); b fp32 or null for no
// bias; act 0 none, 1 relu, 2 tanh-gelu, 3 sigmoid.  `aligned` (16-bit
// only): K and N are multiples of 8 and x, w 16-byte aligned.  M, N > 0.
// Launches on `stream`; returns the CUDA error of the launch (0 =
// launched).
extern "C" int apex_fused_dense_fwd(int dtype, int act, const void* x,
                                    const void* w, const void* b, void* y,
                                    int M, int N, int K, int aligned,
                                    void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* bias = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = aligned != 0;
  cudaError_t e = cudaErrorInvalidValue;
  switch (act) {
    case kNone: e = launch_act<kNone>(dtype, x, w, bias, y, M, N, K, al, s);
      break;
    case kRelu: e = launch_act<kRelu>(dtype, x, w, bias, y, M, N, K, al, s);
      break;
    case kGelu: e = launch_act<kGelu>(dtype, x, w, bias, y, M, N, K, al, s);
      break;
    case kSigmoid:
      e = launch_act<kSigmoid>(dtype, x, w, bias, y, M, N, K, al, s);
      break;
    default: break;
  }
  return static_cast<int>(e);
}
