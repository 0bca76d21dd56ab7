// Flash attention forward and backward for Hopper (sm_90a), plain C
// interface.  Layout (b, h, s, d), bf16, head_dim 64 or 128, causal or
// not, with or without segment ids; no bias, no dropout (the training
// steps' surface).
//
// Replaces: apex_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _fwd_impl) and :_bwd_fused_kernel (launched by _bwd_impl).  Same
// contract: o = softmax(scale * q k^T [causal: key j visible to query i
// iff j <= i]) v with an fp32 lse = m + log(l) per query row; the
// backward recomputes p = exp(scale * q k^T - lse) once and takes dv, dk
// and dq from it, with delta = sum(do * o) computed by the caller in fp32
// (as _bwd_impl does).
//
// What bounds them on an H100: at the training shape (b 12, h 16, s 1024,
// d 64, causal) the forward moves ~101 MB and does ~2.6e10 flop, the
// backward ~178 MB and ~6.4e10 flop: both sit near the ridge of the
// card's 989 TF/s bf16 and 3.35 TB/s, so a kernel that is not on the
// tensor cores is bound by its own arithmetic, long before the bytes.
// The design therefore puts every product on the tensor cores and keeps
// the (s x s) scores out of device memory:
//   * products are mma.sync m16n8k16 (bf16 in, fp32 accumulate), written
//     into the kernel as inline PTX.  Operands come from shared memory
//     whose rows are padded by 16 bytes, so the 32-bit fragment loads and
//     the ldmatrix(.trans) loads of a warp hit 32 distinct banks.
//   * forward (FlashAttention-2 shape): one block of 4 warps per
//     (batch*head, 64 query rows), each warp owning 16 rows; the loop over
//     64-key blocks takes the place of the TPU grid's k axis, with the next
//     K/V block copied in by cp.async while the current one is used.  The
//     online softmax (m, l in fp32, exp2 of log2e-scaled scores) lives in
//     registers, and p is rounded to bf16 before P.V, as the TPU kernel
//     casts p to v's dtype.  Causal: key blocks above the diagonal are
//     never visited and only blocks that cross it are masked
//     (_causal_dispatch).  l is guarded with max(l, 1e-30).
//   * backward: the TPU kernel carries dk/dv across its outer q loop in
//     VMEM; on the card nothing carries between blocks, so the loop is
//     turned inside out (FlashAttention-2): one block per (batch*head, 64
//     keys) walks the q blocks at or below the diagonal, keeping dk and dv
//     in registers.  p_v and ds are rounded to bf16 before their products,
//     as on the TPU; `scale` multiplies ds for dk and dq.  dq is summed
//     across key blocks with fp32 atomics into a zeroed scratch buffer
//     that the caller casts once: the order of those sums changes from run
//     to run, so dq is not bitwise reproducible (dk, dv are).  Scalar
//     atomics were ~45 % of the first version's time (measured by removing
//     them); 2-wide ones (float2, red.global.add.v2.f32) take a third off
//     the kernel.  Measured and not kept: 4-wide atomics (the lane-pair
//     shuffle that feeds them costs more than it saves) and ldmatrix
//     fragment loads (no faster than 32-bit loads from the padded tiles).
// Rows past sq and keys past sk are zero-filled on load and masked, so any
// sequence length works.  wgmma and TMA are for a later version.
//
// Segment ids (the SEG instantiations; BERT's padding mask): query i sees
// key j only where q_seg[i] == kv_seg[j], the mask applied before the
// causal one, as _mask_bias orders them.  A masked score is the JAX
// package's finite _NEG_INF (-1e30), not -inf, so a query row whose keys
// are all masked comes out as attention_reference gives it: uniform
// weights over the sk keys, o = mean(v), no NaN.  For that row to see all
// sk keys, the SEG kernels visit every key block even when causal (the
// blocks above the diagonal are then fully masked: twice the work of the
// causal kernel, a combination no training path of the port runs).  The
// backward recomputes masked entries explicitly: p = 1/sk where the row
// is fully masked (its lse is about -1e30), else 0, and ds = 0, as the
// gradient of a masked_fill is.  Each block loads its key block's ids
// (forward) or its q block's ids (backward) next to the tiles; passing
// null ids launches the unsegmented kernels, whose code is unchanged.
// A warp whose 16 rows and 64 keys all carry one id, in a tile that does
// not cross the diagonal, takes the unsegmented masking (a warp vote per
// tile): the per-score compares cost the backward half its time again,
// and in BERT's batches most tiles are one segment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBr = 64;       // query rows per block (fwd) / per step (bwd)
constexpr int kBc = 64;       // keys per step (fwd) / per block (bwd)
constexpr int kThreads = 128;  // 4 warps, 16 rows (or keys) each
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the JAX package's finite _NEG_INF (-1e30) in the kernels' log2 units
constexpr float kMaskedLog2 = -1.0e30f * kLog2e;
// an lse (log2 units) below this belongs to a row whose keys are all
// masked: real scores are nowhere near -1e29
constexpr float kDeadLse = -1.0e29f;

// a (64, D) bf16 tile in shared memory, rows padded by 8 elements
template <int D>
struct Tile {
  static constexpr int kStride = D + 8;
  static constexpr int kElems = 64 * kStride;
};

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

// rows [row0, row0 + 64) of a (rows, D) matrix whose row stride is `rs`
// elements into a padded tile; rows at or past n_rows are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long rs, int row0,
                                          int n_rows) {
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
  constexpr int kIters = 64 * kPieces / kThreads;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int c = i * kThreads + threadIdx.x;
    const int r = c / kPieces, col = (c % kPieces) * 8;
    const bool ok = row0 + r < n_rows;
    const bf16* src = ok ? g + (long long)(row0 + r) * rs + col : g;
    cp_async16(s + r * Tile<D>::kStride + col, src, ok);
  }
}

// true in every lane when `same` holds in every lane of the warp: with
// `same` = "my ids equal the tile's first id", the warp's tile is one
// segment
__device__ __forceinline__ bool warp_one_segment(bool same) {
  return __all_sync(kFull, same);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 b16 matrices, transposed; lanes 8i..8i+7 address matrix i's rows
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a)
      : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r, r+16) x cols [c, c+16) of a padded tile, read
// straight from its rows (the tile holds A row-major)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r, int c, int g, int t4) {
  constexpr int S = Tile<D>::kStride;
  const bf16* p = tile + (r + g) * S + c + 2 * t4;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * S);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * S + 8);
}

// acc[2np], acc[2np+1] += a * tile[k0 : k0+16, 16np : 16np+16] for every
// np: the tile holds B row-major (k, n), so its fragments come through
// ldmatrix.trans
template <int S, int NP>
__device__ __forceinline__ void mma_tile_b(float (*acc)[4],
                                           const uint32_t (&a)[4],
                                           const bf16* tile, int k0,
                                           int lane) {
  const bf16* base =
      tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_t(b0, b1, b2, b3, base + np * 16);
    mma16816(acc[2 * np], a, b0, b1);
    mma16816(acc[2 * np + 1], a, b2, b3);
  }
}

// ------------------------------------------------------------ forward ----

template <int D, bool SEG>
constexpr size_t fwd_smem() {
  // Q, K[2], V[2], and with SEG the key ids [2][64]
  return size_t(5) * Tile<D>::kElems * sizeof(bf16) +
         (SEG ? 2 * kBc * sizeof(int) : 0);
}

template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, int h, int sq, int sk, float scale_log2, int causal,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    long long q_seg_sb, long long kv_seg_sb) {
  constexpr int S = Tile<D>::kStride;
  constexpr int E = Tile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + E;      // two stages
  bf16* v_s = k_s + 2 * E;  // two stages
  int* kid_s = reinterpret_cast<int*>(v_s + 2 * E);  // SEG: two stages

  const int nq = (sq + kBr - 1) / kBr;
  const int jq = nq - 1 - blockIdx.x;  // causal: the longest rows first
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const bf16* qg = q + b * q_sb + hh * q_sh;
  const bf16* kg = k + b * k_sb + hh * k_sh;
  const bf16* vg = v + b * v_sb + hh * v_sh;
  const int q0 = jq * kBr;
  int n_kv = (sk + kBc - 1) / kBc;
  if (causal && !SEG) n_kv = min(n_kv, (min(q0 + kBr, sq) - 1) / kBc + 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  const int* kidg = SEG ? kv_seg + b * kv_seg_sb : nullptr;
  int qid_a = 0, qid_b = 0;
  if (SEG) {
    const int* qidg = q_seg + b * q_seg_sb;
    if (row_a < sq) qid_a = qidg[row_a];
    if (row_b < sq) qid_b = qidg[row_b];
    const int t = threadIdx.x;
    if (t < kBc) kid_s[t] = t < sk ? kidg[t] : 0;
  }

  load_tile<D>(q_s, qg, q_ss, q0, sq);
  load_tile<D>(k_s, kg, k_ss, 0, sk);
  load_tile<D>(v_s, vg, v_ss, 0, sk);
  cp_async_commit();

  uint32_t qa[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int st = it & 1;
    if (it + 1 < n_kv) {  // the next K/V block flies while this one is used
      load_tile<D>(k_s + (st ^ 1) * E, kg, k_ss, (it + 1) * kBc, sk);
      load_tile<D>(v_s + (st ^ 1) * E, vg, v_ss, (it + 1) * kBc, sk);
      const int t = threadIdx.x;
      if (SEG && t < kBc) {
        const int key = (it + 1) * kBc + t;
        kid_s[(st ^ 1) * kBc + t] = key < sk ? kidg[key] : 0;
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        load_a<D>(qa[kk], q_s, warp * 16, kk * 16, g, t4);
    }
    const bf16* ks = k_s + st * E;
    const bf16* vs = v_s + st * E;

    // scores: 16 rows x 64 keys per warp, 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* kr = ks + (n * 8 + g) * S + kk * 16 + 2 * t4;
        mma16816(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale into log2 units; mask only blocks that cross the diagonal or
    // the ragged end of the keys (warp-uniform test)
    const int k0 = it * kBc;
    bool per_score = false;  // SEG: this warp's tile needs the id compares
    if (SEG) {
      const int* kid = kid_s + st * kBc;
      const int c = kid[0];
      per_score = !warp_one_segment(kid[lane] == c && kid[lane + 32] == c &&
                                    qid_a == c && qid_b == c) ||
                  (causal && k0 + kBc - 1 > q0 + warp * 16);
    }
    if (per_score) {  // every score: the segment compare, then the causal one
      const int* kid = kid_s + st * kBc;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = n * 8 + 2 * t4 + (e & 1);
          const int key = k0 + kc;
          const int row = e < 2 ? row_a : row_b;
          float x = s[n][e] * scale_log2;
          if (key >= sk)
            x = -INFINITY;  // not a key: no weight, even in a masked row
          else if (kid[kc] != (e < 2 ? qid_a : qid_b) ||
                   (causal && key > row))
            x = kMaskedLog2;
          s[n][e] = x;
        }
      }
    } else {
      const bool edge =
          (k0 + kBc > sk) || (causal && k0 + kBc - 1 > q0 + warp * 16);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (edge) {
            const int key = k0 + n * 8 + 2 * t4 + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (key >= sk || (causal && key > row)) x = -INFINITY;
          }
          s[n][e] = x;
        }
      }
    }

    // online softmax; a quad of lanes shares each row
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, o_));
    }
    const float mu_a = mx_a == -INFINITY ? 0.f : mx_a;
    const float mu_b = mx_b == -INFINITY ? 0.f : mx_b;
    const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
    m_a = mx_a;
    m_b = mx_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mu_a);
      s[n][1] = exp2f(s[n][1] - mu_a);
      s[n][2] = exp2f(s[n][2] - mu_b);
      s[n][3] = exp2f(s[n][3] - mu_b);
      rs_a += s[n][0] + s[n][1];
      rs_b += s[n][2] + s[n][3];
    }
    l_a = l_a * al_a + rs_a;  // this lane's share; summed over the quad last
    l_b = l_b * al_b + rs_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }

    // O += P V, p rounded to bf16 (the score tile is the A fragment)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_tile_b<S, D / 16>(acc, pa, vs, kk * 16, lane);
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, o_);
    l_b += __shfl_xor_sync(kFull, l_b, o_);
  }
  const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
  bf16* og = o + (long long)bh * sq * D;
  if (row_a < sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(og + (long long)row_a * D + n * 8 +
                                   2 * t4) =
          pack_bf16(acc[n][0] / la, acc[n][1] / la);
    if (t4 == 0) lse[(long long)bh * sq + row_a] = (m_a + log2f(la)) * kLn2;
  }
  if (row_b < sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(og + (long long)row_b * D + n * 8 +
                                   2 * t4) =
          pack_bf16(acc[n][2] / lb, acc[n][3] / lb);
    if (t4 == 0) lse[(long long)bh * sq + row_b] = (m_b + log2f(lb)) * kLn2;
  }
}

// ----------------------------------------------------------- backward ----

constexpr int kDsStride = kBr + 8;  // ds tile: 64 keys x 64 queries, padded

template <int D, bool SEG>
constexpr size_t bwd_smem() {
  // K, V, Q[2], dO[2], dS, lse[2], delta[2], and with SEG the q ids [2]
  return size_t(6) * Tile<D>::kElems * sizeof(bf16) +
         size_t(kBc) * kDsStride * sizeof(bf16) + 4 * kBr * sizeof(float) +
         (SEG ? 2 * kBr * sizeof(int) : 0);
}

template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss, int h,
    int sq, int sk, float scale, float scale_log2, int causal,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    long long q_seg_sb, long long kv_seg_sb) {
  constexpr int S = Tile<D>::kStride;
  constexpr int E = Tile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + E;
  bf16* q_s = v_s + E;       // two stages
  bf16* do_s = q_s + 2 * E;  // two stages
  bf16* ds_s = do_s + 2 * E;
  float* lse_s = reinterpret_cast<float*>(ds_s + kBc * kDsStride);  // [2][64]
  float* dl_s = lse_s + 2 * kBr;                                    // [2][64]
  int* qid_s = reinterpret_cast<int*>(dl_s + 2 * kBr);  // SEG: [2][64]

  const int tk = blockIdx.x;  // causal: low key blocks have the most work
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const bf16* qg = q + b * q_sb + hh * q_sh;
  const bf16* kg = k + b * k_sb + hh * k_sh;
  const bf16* vg = v + b * v_sb + hh * v_sh;
  const bf16* dog = dout + b * o_sb + hh * o_sh;
  const float* lseg = lse + (long long)bh * sq;
  const float* dlg = delta + (long long)bh * sq;
  const int k0 = tk * kBc;
  const int nq = (sq + kBr - 1) / kBr;
  // first q block that sees a key here (SEG: every q block, see the top)
  const int j0 = causal && !SEG ? k0 / kBr : 0;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int key_a = k0 + warp * 16 + g;  // this thread's two keys
  const int key_b = key_a + 8;
  const int* qidg = SEG ? q_seg + b * q_seg_sb : nullptr;
  int kid_a = 0, kid_b = 0;
  if (SEG) {
    const int* kidg = kv_seg + b * kv_seg_sb;
    if (key_a < sk) kid_a = kidg[key_a];
    if (key_b < sk) kid_b = kidg[key_b];
  }
  const float inv_sk = 1.f / sk;  // a fully masked row's weight per key

  auto load_step = [&](int j, int st) {
    load_tile<D>(q_s + st * E, qg, q_ss, j * kBr, sq);
    load_tile<D>(do_s + st * E, dog, o_ss, j * kBr, sq);
    if (tid < kBr) {
      const int r = j * kBr + tid;
      lse_s[st * kBr + tid] = r < sq ? lseg[r] * kLog2e : 0.f;
      dl_s[st * kBr + tid] = r < sq ? dlg[r] : 0.f;
      if (SEG) qid_s[st * kBr + tid] = r < sq ? qidg[r] : 0;
    }
  };

  load_tile<D>(k_s, kg, k_ss, k0, sk);
  load_tile<D>(v_s, vg, v_ss, k0, sk);
  if (j0 < nq) load_step(j0, 0);
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int j = j0; j < nq; ++j) {
    const int st = (j - j0) & 1;
    if (j + 1 < nq) load_step(j + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qs = q_s + st * E;
    const bf16* dos = do_s + st * E;
    const float* ls = lse_s + st * kBr;
    const float* dls = dl_s + st * kBr;
    const int q0 = j * kBr;

    // s^T = K Q^T: 16 keys x 64 queries per warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a<D>(a, k_s, warp * 16, kk * 16, g, t4);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* qr = qs + (n * 8 + g) * S + kk * 16 + 2 * t4;
        mma16816(s[n], a, ld32(qr), ld32(qr + 8));
      }
    }

    // p^T = exp(scale s - lse), zero where masked (warp-uniform test)
    uint32_t masked = 0;  // SEG: bit 4n+e set where ds must be 0
    bool per_score = false;  // SEG: this warp's tile needs the id compares
    if (SEG) {
      const int* qid = qid_s + st * kBr;
      const int c = qid[0];
      per_score = !warp_one_segment(qid[lane] == c && qid[lane + 32] == c &&
                                    kid_a == c && kid_b == c) ||
                  (causal && k0 + warp * 16 + 15 > q0);
    }
    if (per_score) {
      const int* qid = qid_s + st * kBr;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t4 + (e & 1);
          const int key = e < 2 ? key_a : key_b;
          float p;
          if (key >= sk || q0 + qc >= sq) {
            p = 0.f;
            masked |= 1u << (4 * n + e);
          } else if ((e < 2 ? kid_a : kid_b) != qid[qc] ||
                     (causal && key > q0 + qc)) {
            p = ls[qc] < kDeadLse ? inv_sk : 0.f;
            masked |= 1u << (4 * n + e);
          } else {
            p = exp2f(s[n][e] * scale_log2 - ls[qc]);
          }
          s[n][e] = p;
        }
      }
    } else {
      const bool edge = (k0 + kBc > sk) || (q0 + kBr > sq) ||
                        (causal && k0 + warp * 16 + 15 > q0);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t4 + (e & 1);
          float p = exp2f(s[n][e] * scale_log2 - ls[qc]);
          if (edge) {
            const int key = e < 2 ? key_a : key_b;
            if (key >= sk || q0 + qc >= sq || (causal && key > q0 + qc))
              p = 0.f;
          }
          s[n][e] = p;
        }
      }
    }

    // dV += P^T dO, p rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_tile_b<S, D / 16>(dva, pa, dos, kk * 16, lane);
    }

    // dP^T = V dO^T
    float dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a<D>(a, v_s, warp * 16, kk * 16, g, t4);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* dr = dos + (n * 8 + g) * S + kk * 16 + 2 * t4;
        mma16816(dp[n], a, ld32(dr), ld32(dr + 8));
      }
    }

    // dS^T = P (dP - delta), fp32 p; 0 where masked
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = SEG && (masked >> (4 * n + e)) & 1u
                       ? 0.f
                       : s[n][e] * (dp[n][e] - dls[n * 8 + 2 * t4 + (e & 1)]);

    // dK += dS^T Q (ds rounded to bf16; scale applied at the end)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
      mma_tile_b<S, D / 16>(dka, da, qs, kk * 16, lane);
    }

    // dS^T to shared memory: dQ needs it with queries as rows
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(ds_s + (warp * 16 + g) * kDsStride + c) =
          pack_bf16(dp[n][0], dp[n][1]);
      *reinterpret_cast<uint32_t*>(ds_s + (warp * 16 + g + 8) * kDsStride +
                                   c) = pack_bf16(dp[n][2], dp[n][3]);
    }
    __syncthreads();

    // dQ (this warp's 16 queries) += scale dS K, summed across key blocks
    // with atomics
    float dqa[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a[0], a[1], a[2], a[3],
                ds_s + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kDsStride +
                    warp * 16 + ((lane >> 3) & 1) * 8);
      mma_tile_b<S, D / 16>(dqa, a, k_s, kk * 16, lane);
    }
    // 2-wide atomics (red.global.add.v2.f32): a lane's two adjacent
    // columns of each row go in one instruction
    const int qr_a = q0 + warp * 16 + g, qr_b = qr_a + 8;
    float* dqg = dq_acc + (long long)bh * sq * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (qr_a < sq)
        atomicAdd(reinterpret_cast<float2*>(dqg + (long long)qr_a * D + n * 8),
                  make_float2(scale * dqa[n][0], scale * dqa[n][1]));
      if (qr_b < sq)
        atomicAdd(reinterpret_cast<float2*>(dqg + (long long)qr_b * D + n * 8),
                  make_float2(scale * dqa[n][2], scale * dqa[n][3]));
    }
    __syncthreads();  // ds_s and this stage are rewritten next iteration
  }
  cp_async_wait<0>();  // a block with no q step still has copies in flight

  bf16* dkg = dk + (long long)bh * sk * D;
  bf16* dvg = dv + (long long)bh * sk * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (key_a < sk) {
      *reinterpret_cast<uint32_t*>(dkg + (long long)key_a * D + c) =
          pack_bf16(scale * dka[n][0], scale * dka[n][1]);
      *reinterpret_cast<uint32_t*>(dvg + (long long)key_a * D + c) =
          pack_bf16(dva[n][0], dva[n][1]);
    }
    if (key_b < sk) {
      *reinterpret_cast<uint32_t*>(dkg + (long long)key_b * D + c) =
          pack_bf16(scale * dka[n][2], scale * dka[n][3]);
      *reinterpret_cast<uint32_t*>(dvg + (long long)key_b * D + c) =
          pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// dynamic shared memory above the 48 KB default needs an opt-in, once
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, bool& done) {
  if (done || smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) done = true;
  return e;
}

// the segment ids of one call: both null (no segments) or both set
struct Seg {
  const int* q;
  const int* kv;
  long long q_sb, kv_sb;
};

template <int D, bool SEG>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const long long* st, int b, int h, int sq,
                       int sk, float scale, int causal, Seg seg,
                       cudaStream_t stream) {
  static bool opted = false;
  constexpr size_t smem = fwd_smem<D, SEG>();
  cudaError_t e = opt_in(flash_fwd_kernel<D, SEG>, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + kBr - 1) / kBr, b * h);
  flash_fwd_kernel<D, SEG><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], h, sq, sk, scale * kLog2e, causal, seg.q, seg.kv,
      seg.q_sb, seg.kv_sb);
  return cudaGetLastError();
}

template <int D, bool SEG>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq_acc, void* dk, void* dv, const long long* st,
                       int b, int h, int sq, int sk, float scale, int causal,
                       Seg seg, cudaStream_t stream) {
  static bool opted = false;
  constexpr size_t smem = bwd_smem<D, SEG>();
  cudaError_t e = opt_in(flash_bwd_kernel<D, SEG>, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((sk + kBc - 1) / kBc, b * h);
  flash_bwd_kernel<D, SEG><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], h, sq, sk, scale, scale * kLog2e,
      causal, seg.q, seg.kv, seg.q_sb, seg.kv_sb);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (b, h, s, d) with d contiguous, every row 16-byte aligned;
// `strides` holds (batch, head, seq) strides in elements for q, k, v (9
// values).  o (b, h, sq, d) bf16 and lse (b, h, sq) fp32 are contiguous.
// q_seg (b, sq) and kv_seg (b, sk): int32 segment ids, contiguous along the
// sequence, with batch strides q_seg_sb / kv_seg_sb; both null for none.
// Launches on `stream`; returns the CUDA error of the launch (0 = launched).
extern "C" int apex_flash_attn_fwd(int head_dim, const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const long long* strides, int b, int h,
                                   int sq, int sk, float scale, int causal,
                                   const void* q_seg, const void* kv_seg,
                                   long long q_seg_sb, long long kv_seg_sb,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Seg seg{static_cast<const int*>(q_seg),
                static_cast<const int*>(kv_seg), q_seg_sb, kv_seg_sb};
  if ((q_seg == nullptr) != (kv_seg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool has_seg = q_seg != nullptr;
  if (head_dim == 64)
    return static_cast<int>(
        has_seg ? launch_fwd<64, true>(q, k, v, o, lse, strides, b, h, sq, sk,
                                       scale, causal, seg, s)
                : launch_fwd<64, false>(q, k, v, o, lse, strides, b, h, sq,
                                        sk, scale, causal, seg, s));
  if (head_dim == 128)
    return static_cast<int>(
        has_seg ? launch_fwd<128, true>(q, k, v, o, lse, strides, b, h, sq,
                                        sk, scale, causal, seg, s)
                : launch_fwd<128, false>(q, k, v, o, lse, strides, b, h, sq,
                                         sk, scale, causal, seg, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, plus dout (strided like q; its strides follow q, k, v's in
// `strides`, 12 values), lse and delta (b, h, sq) fp32 contiguous, dq_acc
// (b, h, sq, d) fp32 contiguous and ZEROED (dq is added into it, scaled),
// dk and dv (b, h, sk, d) bf16 contiguous.
extern "C" int apex_flash_attn_bwd(int head_dim, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq_acc, void* dk, void* dv,
                                   const long long* strides, int b, int h,
                                   int sq, int sk, float scale, int causal,
                                   const void* q_seg, const void* kv_seg,
                                   long long q_seg_sb, long long kv_seg_sb,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Seg seg{static_cast<const int*>(q_seg),
                static_cast<const int*>(kv_seg), q_seg_sb, kv_seg_sb};
  if ((q_seg == nullptr) != (kv_seg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool has_seg = q_seg != nullptr;
  if (head_dim == 64)
    return static_cast<int>(
        has_seg ? launch_bwd<64, true>(q, k, v, dout, lse, delta, dq_acc, dk,
                                       dv, strides, b, h, sq, sk, scale,
                                       causal, seg, s)
                : launch_bwd<64, false>(q, k, v, dout, lse, delta, dq_acc, dk,
                                        dv, strides, b, h, sq, sk, scale,
                                        causal, seg, s));
  if (head_dim == 128)
    return static_cast<int>(
        has_seg ? launch_bwd<128, true>(q, k, v, dout, lse, delta, dq_acc, dk,
                                        dv, strides, b, h, sq, sk, scale,
                                        causal, seg, s)
                : launch_bwd<128, false>(q, k, v, dout, lse, delta, dq_acc,
                                         dk, dv, strides, b, h, sq, sk, scale,
                                         causal, seg, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
