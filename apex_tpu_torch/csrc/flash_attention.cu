// Flash attention forward and backward for Hopper (sm_90a), plain C
// interface.  Layout (b, h, s, d), bf16, head_dim 64 or 128, causal or
// not, with or without segment ids; no bias, no dropout (the training
// steps' surface).
//
// Replaces: apex_tpu/ops/flash_attention.py:_fwd_kernel and
// :_fwd_kernel_packed (launched by _fwd_impl), :_bwd_fused_kernel,
// :_bwd_fused_kernel_packed, :_bwd_dq_kernel and :_bwd_dkv_kernel
// (launched by _bwd_impl).  Same contract: o = softmax(scale * q k^T
// [causal: key j visible to query i iff j <= i]) v with an fp32 lse =
// m + log(l) per query row; the backward recomputes p = exp(scale * q k^T
// - lse) and takes dv, dk and dq from it, with delta = sum(do * o)
// computed by the caller in fp32 (as _bwd_impl does).  The caller picks
// the backward as _bwd_impl does: the fused kernel while sk * d <= 256k,
// else the split pair (the dq pass, then the dk/dv pass); with heads packed
// (heads_per_step = hp > 1), the packed fused kernel while also
// hp * sk * d <= 512k.
//
// What bounds them on an H100: at the training shape (b 12, h 16, s 1024,
// d 64, causal) the forward moves ~101 MB and does ~2.6e10 flop, the
// backward ~178 MB and ~6.4e10 flop: both sit near the ridge of the
// card's 989 TF/s bf16 and 3.35 TB/s, so a kernel that is not on the
// tensor cores is bound by its own arithmetic, long before the bytes.
// At long context (b 1, h 8, s 32768, d 64, causal) the arithmetic grows
// with s^2 and the bytes with s: the dq pass does 1.65e12 flop and the
// dk/dv pass 2.20e12 against ~0.2 GB, bound by operations alone.
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
//     as on the TPU; `scale` multiplies ds for dk and dq.  The fused
//     kernel sums dq across key blocks with fp32 atomics into a zeroed
//     scratch buffer that the caller casts once: the order of those sums
//     changes from run to run, so its dq is not bitwise reproducible (dk,
//     dv are).  Scalar atomics were ~45 % of the first version's time
//     (measured by removing them); 2-wide ones (float2,
//     red.global.add.v2.f32) take a third off the kernel.  Measured and
//     not kept: 4-wide atomics (the lane-pair shuffle that feeds them
//     costs more than it saves) and ldmatrix fragment loads (no faster
//     than 32-bit loads from the padded tiles).
//   * split backward (long context, where the TPU's (sk, d) dk/dv scratch
//     would not fit VMEM): the dk/dv pass is the fused kernel's body with
//     its dq part compiled out (the DQ template flag), so its dk and dv
//     are the fused kernel's bit for bit.  The dq pass has the forward's
//     shape: one block per (batch*head, 64 query rows) keeps its q and dO
//     tiles and its rows' lse and delta resident, walks the 64-key blocks
//     up to the diagonal with K/V double-buffered by cp.async, recomputes
//     s = q k^T and dp = dO v^T, rounds ds = p (dp - delta) to bf16 and
//     adds ds k into registers.  Each dq row is written once: no atomics,
//     no scratch buffer, the same bits from run to run.  It pays the
//     recomputation of s and dp a second time (3 products a pair in the
//     dq pass and 4 in the dk/dv pass, against the fused kernel's 5).
//   * head packing (_fwd_kernel_packed, _bwd_fused_kernel_packed): the TPU
//     kernels stack hp heads into one grid step to fill its vregs and the
//     128-deep MXU that a d=64 head half fills; the per-head math stays
//     separate and bit-identical.  On the card a head is already a whole
//     tile of 4 warps, so packing is a choice of what one block walks, not
//     a second copy of the math: the packed kernels run the unpacked
//     kernels' per-head bodies (fwd_heads, bwd_heads) for hp heads of one
//     batch row in turn, in b*h/hp blocks instead of b*h.  Per head, o and
//     lse (forward) and dk, dv (backward) are the unpacked kernels' bit for
//     bit; dq is summed by the same atomics.  What a block shares across
//     its heads: the query ids (forward) or key ids (backward) of its
//     rows, loaded once; and in the forward the key ids of the whole batch
//     row, resident in shared memory while sk <= 8192 (32 KB), so they are
//     read once per key block for the group, not once per head; and the
//     next head's Q tile and first K/V stage (backward: K/V tiles and
//     first q step), issued by cp.async before the current head's
//     epilogue.  nvcc schedules this head loop very differently for small
//     changes of its form: with the first head's prologue inside the loop
//     (`p == 0`, as here) the prefetch is the fastest of the three forms
//     scripts/port_flash_packed_ablation.py times; with it before the
//     loop, slower than no prefetch at all (PERF.md § 6).  Shared memory
//     stays the unpacked kernels' (fwd ~46 KB,
//     fused bwd ~65 KB at d=64, plus the resident ids), so every hp that
//     the JAX route admits runs: any divisor of h in the forward, and
//     hp * sk * d <= 512k in the backward.  A block per head and warpgroup
//     would need hp times that and could not hold the backward past hp=3.
//     The trade: fewer, longer blocks (GPT's forward has 3072 blocks of 64
//     rows for 132 SMs, so the card is full either way).
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
// gradient of a masked_fill is.  (The TPU kernels take p = exp(0) = 1 and
// keep ds there, which attention_reference's gradient does not.)  Since
// ds = 0 at every masked score, the dq pass stops at the diagonal even
// with segment ids; the dk/dv pass cannot, because a dead row's uniform p
// reaches dv for every key.  Each block loads its key block's ids
// (forward, dq pass) or its q block's ids (dk/dv) next to the tiles;
// passing null ids launches the unsegmented kernels, whose code is
// unchanged.  A warp whose 16 rows and 64 keys all carry one id, in a
// tile that does not cross the diagonal, takes the unsegmented masking (a
// warp vote per tile): the per-score compares cost the backward half its
// time again, and in BERT's batches most tiles are one segment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// keys whose segment ids the packed forward keeps resident for its whole
// head group (32 KB); past it the ids are staged per key block and head
// as the unpacked kernel stages them
constexpr int kIdCache = 8192;

template <int D, bool SEG>
__host__ __device__ constexpr size_t fwd_smem() {
  // Q, K[2], V[2], and with SEG the key ids [2][64]
  return size_t(5) * Tile<D>::kElems * sizeof(bf16) +
         (SEG ? 2 * kBc * sizeof(int) : 0);
}

// One block's forward over the 64 query rows of block `jq` for `hp` heads
// in turn, flat (batch * head) indices bh0 .. bh0 + hp - 1 of one batch
// row.  Each head is the unpacked kernel's body, so its o and lse are that
// kernel's bit for bit.  `kid_res`: the batch row's key ids resident in
// shared memory (padded to whole key blocks with 0), or null to stage
// them per key block.  The next head's Q tile and first K/V stage are
// issued by cp.async before this head's epilogue.
template <int D, bool SEG>
__device__ __forceinline__ void fwd_heads(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, int h, int sq, int sk, float scale_log2, int causal,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    long long q_seg_sb, long long kv_seg_sb, int bh0, int hp, int jq,
    unsigned char* smem_raw, const int* kid_res) {
  constexpr int S = Tile<D>::kStride;
  constexpr int E = Tile<D>::kElems;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + E;      // two stages
  bf16* v_s = k_s + 2 * E;  // two stages
  int* kid_s = reinterpret_cast<int*>(v_s + 2 * E);  // SEG: two stages

  const int b = bh0 / h;  // every head of the group is in this batch row
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
  }

  // one head's Q tile, first K/V stage and (staged ids) first key ids
  auto prologue = [&](int bh) {
    const int hh = bh % h;
    load_tile<D>(q_s, q + b * q_sb + hh * q_sh, q_ss, q0, sq);
    load_tile<D>(k_s, k + b * k_sb + hh * k_sh, k_ss, 0, sk);
    load_tile<D>(v_s, v + b * v_sb + hh * v_sh, v_ss, 0, sk);
    const int t = threadIdx.x;
    if (SEG && kid_res == nullptr && t < kBc)
      kid_s[t] = t < sk ? kidg[t] : 0;
    cp_async_commit();
  };
  for (int p = 0; p < hp; ++p) {
    const int bh = bh0 + p;
    const int hh = bh % h;
    if (p == 0) prologue(bh);
    const bf16* kg = k + b * k_sb + hh * k_sh;
    const bf16* vg = v + b * v_sb + hh * v_sh;

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
        if (SEG && kid_res == nullptr && t < kBc) {
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
      const int* kid =
          kid_res != nullptr ? kid_res + k0 : kid_s + st * kBc;
      bool per_score = false;  // SEG: this warp's tile needs the id compares
      if (SEG) {
        const int c = kid[0];
        per_score = !warp_one_segment(kid[lane] == c && kid[lane + 32] == c &&
                                      qid_a == c && qid_b == c) ||
                    (causal && k0 + kBc - 1 > q0 + warp * 16);
      }
      if (per_score) {  // every score: the segment compare, then the causal
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

    // the next head's tiles fly while this head's rows are written
    if (p + 1 < hp) prologue(bh + 1);

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
}

#define FWD_PARAMS                                                           \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                   \
      const bf16 *__restrict__ v, bf16 *__restrict__ o,                     \
      float *__restrict__ lse, long long q_sb, long long q_sh, long long q_ss, \
      long long k_sb, long long k_sh, long long k_ss, long long v_sb,       \
      long long v_sh, long long v_ss, int h, int sq, int sk,                \
      float scale_log2, int causal, const int *__restrict__ q_seg,          \
      const int *__restrict__ kv_seg, long long q_seg_sb, long long kv_seg_sb
#define FWD_ARGS                                                             \
  q, k, v, o, lse, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, h,  \
      sq, sk, scale_log2, causal, q_seg, kv_seg, q_seg_sb, kv_seg_sb

// one block per (64 query rows, batch*head)
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FWD_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nq = (sq + kBr - 1) / kBr;
  fwd_heads<D, SEG>(FWD_ARGS, blockIdx.y, 1,
                    nq - 1 - blockIdx.x,  // causal: the longest rows first
                    smem_raw, nullptr);
}

// the port of _fwd_kernel_packed: one block per (64 query rows, group of
// hp heads of one batch row), the heads walked in turn; `res_ids`: the
// key ids are resident (SEG, sk <= kIdCache), in shared memory after the
// unpacked kernel's
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_packed_kernel(FWD_PARAMS, int hp, int res_ids) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nq = (sq + kBr - 1) / kBr;
  int* kid_res = nullptr;
  if (SEG && res_ids) {
    kid_res = reinterpret_cast<int*>(smem_raw + fwd_smem<D, SEG>());
    const int* kidg = kv_seg + (long long)(blockIdx.y * hp / h) * kv_seg_sb;
    const int n = (sk + kBc - 1) / kBc * kBc;
    for (int t = threadIdx.x; t < n; t += kThreads)
      kid_res[t] = t < sk ? kidg[t] : 0;  // read after the first barrier
  }
  fwd_heads<D, SEG>(FWD_ARGS, blockIdx.y * hp, hp, nq - 1 - blockIdx.x,
                    smem_raw, kid_res);
}

// ----------------------------------------------------------- backward ----

constexpr int kDsStride = kBr + 8;  // ds tile: 64 keys x 64 queries, padded

template <int D, bool SEG, bool DQ>
__host__ __device__ constexpr size_t bwd_smem() {
  // K, V, Q[2], dO[2], with DQ dS, lse[2], delta[2], and with SEG the q
  // ids [2]
  return size_t(6) * Tile<D>::kElems * sizeof(bf16) +
         (DQ ? size_t(kBc) * kDsStride * sizeof(bf16) : 0) +
         4 * kBr * sizeof(float) + (SEG ? 2 * kBr * sizeof(int) : 0);
}

// One block's backward over the 64 keys of block `tk` for `hp` heads in
// turn, flat (batch * head) indices bh0 .. bh0 + hp - 1 of one batch row,
// dk and dv in registers per head.  DQ: the fused kernel (dq summed by
// atomics into dq_acc); without it the split route's dk/dv pass (dq_acc
// unused), whose dk and dv are the same arithmetic.  Each head is the
// unpacked kernel's body, so its dk and dv are that kernel's bit for bit.
// The next head's K/V tiles and first q step are issued by cp.async before
// this head's dk and dv are written.
template <int D, bool SEG, bool DQ>
__device__ __forceinline__ void bwd_heads(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss, int h,
    int sq, int sk, float scale, float scale_log2, int causal,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    long long q_seg_sb, long long kv_seg_sb, int bh0, int hp, int tk,
    unsigned char* smem_raw) {
  constexpr int S = Tile<D>::kStride;
  constexpr int E = Tile<D>::kElems;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + E;
  bf16* q_s = v_s + E;       // two stages
  bf16* do_s = q_s + 2 * E;  // two stages
  bf16* ds_s = do_s + 2 * E;  // DQ only
  float* lse_s =
      reinterpret_cast<float*>(ds_s + (DQ ? kBc * kDsStride : 0));  // [2][64]
  float* dl_s = lse_s + 2 * kBr;                                    // [2][64]
  int* qid_s = reinterpret_cast<int*>(dl_s + 2 * kBr);  // SEG: [2][64]

  const int b = bh0 / h;  // every head of the group is in this batch row
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

  // one head's q step j into stage st: Q, dO, the rows' lse, delta, ids
  auto load_step = [&](int bh, int j, int st) {
    const int hh = bh % h;
    load_tile<D>(q_s + st * E, q + b * q_sb + hh * q_sh, q_ss, j * kBr, sq);
    load_tile<D>(do_s + st * E, dout + b * o_sb + hh * o_sh, o_ss, j * kBr,
                 sq);
    if (tid < kBr) {
      const int r = j * kBr + tid;
      lse_s[st * kBr + tid] = r < sq ? lse[(long long)bh * sq + r] * kLog2e
                                     : 0.f;
      dl_s[st * kBr + tid] = r < sq ? delta[(long long)bh * sq + r] : 0.f;
      if (SEG) qid_s[st * kBr + tid] = r < sq ? qidg[r] : 0;
    }
  };
  // one head's K and V tiles and its first q step
  auto prologue = [&](int bh) {
    const int hh = bh % h;
    load_tile<D>(k_s, k + b * k_sb + hh * k_sh, k_ss, k0, sk);
    load_tile<D>(v_s, v + b * v_sb + hh * v_sh, v_ss, k0, sk);
    if (j0 < nq) load_step(bh, j0, 0);
    cp_async_commit();
  };
  for (int p = 0; p < hp; ++p) {
    const int bh = bh0 + p;
    if (p == 0) prologue(bh);

    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

    for (int j = j0; j < nq; ++j) {
      const int st = (j - j0) & 1;
      if (j + 1 < nq) load_step(bh, j + 1, st ^ 1);
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
            float p_;
            if (key >= sk || q0 + qc >= sq) {
              p_ = 0.f;
              masked |= 1u << (4 * n + e);
            } else if ((e < 2 ? kid_a : kid_b) != qid[qc] ||
                       (causal && key > q0 + qc)) {
              p_ = ls[qc] < kDeadLse ? inv_sk : 0.f;
              masked |= 1u << (4 * n + e);
            } else {
              p_ = exp2f(s[n][e] * scale_log2 - ls[qc]);
            }
            s[n][e] = p_;
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
            float p_ = exp2f(s[n][e] * scale_log2 - ls[qc]);
            if (edge) {
              const int key = e < 2 ? key_a : key_b;
              if (key >= sk || q0 + qc >= sq || (causal && key > q0 + qc))
                p_ = 0.f;
            }
            s[n][e] = p_;
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

      if constexpr (DQ) {
        // dS^T to shared memory: dQ needs it with queries as rows
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = n * 8 + 2 * t4;
          bf16* row = ds_s + (warp * 16 + g) * kDsStride + c;
          *reinterpret_cast<uint32_t*>(row) = pack_bf16(dp[n][0], dp[n][1]);
          *reinterpret_cast<uint32_t*>(row + 8 * kDsStride) =
              pack_bf16(dp[n][2], dp[n][3]);
        }
        __syncthreads();

        // dQ (this warp's 16 queries) += scale dS K, summed across key
        // blocks with atomics
        float dqa[D / 8][4];
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[4];
          ldsm_x4_t(a[0], a[1], a[2], a[3],
                    ds_s + (kk * 16 + (lane & 7) + (lane >> 4) * 8) *
                               kDsStride +
                        warp * 16 + ((lane >> 3) & 1) * 8);
          mma_tile_b<S, D / 16>(dqa, a, k_s, kk * 16, lane);
        }
        // 2-wide atomics (red.global.add.v2.f32): a lane's two adjacent
        // columns of each row go in one instruction
        const int qr_a = q0 + warp * 16 + g, qr_b = qr_a + 8;
        float* dqg = dq_acc + (long long)bh * sq * D + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          float* ra = dqg + (long long)qr_a * D + n * 8;
          float* rb = dqg + (long long)qr_b * D + n * 8;
          if (qr_a < sq)
            atomicAdd(reinterpret_cast<float2*>(ra),
                      make_float2(scale * dqa[n][0], scale * dqa[n][1]));
          if (qr_b < sq)
            atomicAdd(reinterpret_cast<float2*>(rb),
                      make_float2(scale * dqa[n][2], scale * dqa[n][3]));
        }
      }
      __syncthreads();  // ds_s and this stage are rewritten next iteration
    }
    cp_async_wait<0>();  // a head with no q step still has copies in flight

    // the next head's tiles fly while this head's dk and dv are written
    if (p + 1 < hp) prologue(bh + 1);

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
}

#define BWD_PARAMS                                                           \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                   \
      const bf16 *__restrict__ v, const bf16 *__restrict__ dout,            \
      const float *__restrict__ lse, const float *__restrict__ delta,       \
      float *__restrict__ dq_acc, bf16 *__restrict__ dk,                    \
      bf16 *__restrict__ dv, long long q_sb, long long q_sh, long long q_ss, \
      long long k_sb, long long k_sh, long long k_ss, long long v_sb,       \
      long long v_sh, long long v_ss, long long o_sb, long long o_sh,       \
      long long o_ss, int h, int sq, int sk, float scale, float scale_log2, \
      int causal, const int *__restrict__ q_seg,                            \
      const int *__restrict__ kv_seg, long long q_seg_sb, long long kv_seg_sb
#define BWD_ARGS                                                             \
  q, k, v, dout, lse, delta, dq_acc, dk, dv, q_sb, q_sh, q_ss, k_sb, k_sh,   \
      k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, h, sq, sk, scale,           \
      scale_log2, causal, q_seg, kv_seg, q_seg_sb, kv_seg_sb

// one block per (64 keys, batch*head); causal: low key blocks have the
// most work
template <int D, bool SEG, bool DQ>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(BWD_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_heads<D, SEG, DQ>(BWD_ARGS, blockIdx.y, 1, blockIdx.x, smem_raw);
}

// the port of _bwd_fused_kernel_packed: one block per (64 keys, group of
// hp heads of one batch row), the heads walked in turn, dq by atomics
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_packed_kernel(BWD_PARAMS, int hp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bwd_heads<D, SEG, true>(BWD_ARGS, blockIdx.y * hp, hp, blockIdx.x,
                          smem_raw);
}

// ---------------------------------------------------- backward, dq pass ----

template <int D, bool SEG>
__host__ __device__ constexpr size_t bwd_dq_smem() {
  // Q, dO, K[2], V[2], and with SEG the key ids [2][64]
  return size_t(6) * Tile<D>::kElems * sizeof(bf16) +
         (SEG ? 2 * kBc * sizeof(int) : 0);
}

template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int h, int sq, int sk, float scale, float scale_log2,
    int causal, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, long long q_seg_sb,
    long long kv_seg_sb) {
  constexpr int S = Tile<D>::kStride;
  constexpr int E = Tile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + E;
  bf16* k_s = do_s + E;     // two stages
  bf16* v_s = k_s + 2 * E;  // two stages
  int* kid_s = reinterpret_cast<int*>(v_s + 2 * E);  // SEG: two stages

  const int nq = (sq + kBr - 1) / kBr;
  const int jq = nq - 1 - blockIdx.x;  // causal: the longest rows first
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const bf16* qg = q + b * q_sb + hh * q_sh;
  const bf16* kg = k + b * k_sb + hh * k_sh;
  const bf16* vg = v + b * v_sb + hh * v_sh;
  const bf16* dog = dout + b * o_sb + hh * o_sh;
  const int q0 = jq * kBr;
  // ds = 0 past the diagonal, segment ids or not (see the top)
  int n_kv = (sk + kBc - 1) / kBc;
  if (causal) n_kv = min(n_kv, (min(q0 + kBr, sq) - 1) / kBc + 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  const float* lseg = lse + (long long)bh * sq;
  const float* dlg = delta + (long long)bh * sq;
  // the rows' lse (log2 units) and delta stay in registers
  const float lse_a = row_a < sq ? lseg[row_a] * kLog2e : 0.f;
  const float lse_b = row_b < sq ? lseg[row_b] * kLog2e : 0.f;
  const float dl_a = row_a < sq ? dlg[row_a] : 0.f;
  const float dl_b = row_b < sq ? dlg[row_b] : 0.f;
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
  load_tile<D>(do_s, dog, o_ss, q0, sq);
  load_tile<D>(k_s, kg, k_ss, 0, sk);
  load_tile<D>(v_s, vg, v_ss, 0, sk);
  cp_async_commit();

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

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
    const bf16* ks = k_s + st * E;
    const bf16* vs = v_s + st * E;

    // s = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<D>(qa, q_s, warp * 16, kk * 16, g, t4);
      load_a<D>(da, do_s, warp * 16, kk * 16, g, t4);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* kr = ks + (n * 8 + g) * S + kk * 16 + 2 * t4;
        const bf16* vr = vs + (n * 8 + g) * S + kk * 16 + 2 * t4;
        mma16816(s[n], qa, ld32(kr), ld32(kr + 8));
        mma16816(dp[n], da, ld32(vr), ld32(vr + 8));
      }
    }

    // dS = P (dP - delta), fp32 p; 0 where masked.  Only tiles that
    // cross the diagonal or the ragged end of the keys, or (SEG) hold
    // more than one id, test each score (warp-uniform test)
    const int k0 = it * kBc;
    const int* kid = kid_s + st * kBc;
    bool edge = (k0 + kBc > sk) || (causal && k0 + kBc - 1 > q0 + warp * 16);
    if (SEG) {
      const int c = kid[0];
      edge = edge || !warp_one_segment(kid[lane] == c &&
                                       kid[lane + 32] == c && qid_a == c &&
                                       qid_b == c);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool top = e < 2;
        const float p =
            exp2f(s[n][e] * scale_log2 - (top ? lse_a : lse_b));
        float ds = p * (dp[n][e] - (top ? dl_a : dl_b));
        if (edge) {
          const int kc = n * 8 + 2 * t4 + (e & 1);
          const int key = k0 + kc;
          if (key >= sk || (causal && key > (top ? row_a : row_b)) ||
              (SEG && kid[kc] != (top ? qid_a : qid_b)))
            ds = 0.f;
        }
        s[n][e] = ds;
      }
    }

    // dQ += dS K, ds rounded to bf16 (the ds tile is the A fragment;
    // scale applied at the end)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_tile_b<S, D / 16>(dqa, pa, ks, kk * 16, lane);
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // each row once: no atomics, the same bits on every run
  bf16* dqg = dq + (long long)bh * sq * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t4;
    if (row_a < sq)
      *reinterpret_cast<uint32_t*>(dqg + (long long)row_a * D + c) =
          pack_bf16(scale * dqa[n][0], scale * dqa[n][1]);
    if (row_b < sq)
      *reinterpret_cast<uint32_t*>(dqg + (long long)row_b * D + c) =
          pack_bf16(scale * dqa[n][2], scale * dqa[n][3]);
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
cudaError_t launch_fwd_packed(const void* q, const void* k, const void* v,
                              void* o, void* lse, const long long* st, int b,
                              int h, int sq, int sk, float scale, int causal,
                              int hp, Seg seg, cudaStream_t stream) {
  static bool opted = false;
  constexpr size_t base = fwd_smem<D, SEG>();
  // opted in once at the most it can take: resident ids for kIdCache keys
  constexpr size_t most = base + (SEG ? size_t(kIdCache) * sizeof(int) : 0);
  cudaError_t e = opt_in(flash_fwd_packed_kernel<D, SEG>, most, opted);
  if (e != cudaSuccess) return e;
  const int res_ids = SEG && sk <= kIdCache;
  const size_t smem =
      base + (res_ids ? size_t((sk + kBc - 1) / kBc * kBc) * sizeof(int) : 0);
  const dim3 grid((sq + kBr - 1) / kBr, b * h / hp);
  flash_fwd_packed_kernel<D, SEG><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], h, sq, sk, scale * kLog2e, causal, seg.q, seg.kv,
      seg.q_sb, seg.kv_sb, hp, res_ids);
  return cudaGetLastError();
}

template <int D, bool SEG, bool DQ>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq_acc, void* dk, void* dv, const long long* st,
                       int b, int h, int sq, int sk, float scale, int causal,
                       Seg seg, cudaStream_t stream) {
  static bool opted = false;
  constexpr size_t smem = bwd_smem<D, SEG, DQ>();
  cudaError_t e = opt_in(flash_bwd_kernel<D, SEG, DQ>, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((sk + kBc - 1) / kBc, b * h);
  flash_bwd_kernel<D, SEG, DQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], h, sq, sk, scale, scale * kLog2e,
      causal, seg.q, seg.kv, seg.q_sb, seg.kv_sb);
  return cudaGetLastError();
}

template <int D, bool SEG>
cudaError_t launch_bwd_packed(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq_acc, void* dk,
                              void* dv, const long long* st, int b, int h,
                              int sq, int sk, float scale, int causal, int hp,
                              Seg seg, cudaStream_t stream) {
  static bool opted = false;
  constexpr size_t smem = bwd_smem<D, SEG, true>();
  cudaError_t e = opt_in(flash_bwd_packed_kernel<D, SEG>, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((sk + kBc - 1) / kBc, b * h / hp);
  flash_bwd_packed_kernel<D, SEG><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], h, sq, sk, scale, scale * kLog2e,
      causal, seg.q, seg.kv, seg.q_sb, seg.kv_sb, hp);
  return cudaGetLastError();
}

template <int D, bool SEG>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, const long long* st,
                          int b, int h, int sq, int sk, float scale,
                          int causal, Seg seg, cudaStream_t stream) {
  static bool opted = false;
  constexpr size_t smem = bwd_dq_smem<D, SEG>();
  cudaError_t e = opt_in(flash_bwd_dq_kernel<D, SEG>, smem, opted);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + kBr - 1) / kBr, b * h);
  flash_bwd_dq_kernel<D, SEG><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], h, sq, sk, scale,
      scale * kLog2e, causal, seg.q, seg.kv, seg.q_sb, seg.kv_sb);
  return cudaGetLastError();
}

template <int D>
using Dim = std::integral_constant<int, D>;
template <bool B>
using Flag = std::integral_constant<bool, B>;

// launch(Dim<head_dim>, Flag<has segment ids>) for one call's head_dim (64
// or 128) and segment ids (both null or both set); anything else is
// cudaErrorInvalidValue, with nothing launched
template <typename F>
int dispatch(int head_dim, const void* q_seg, const void* kv_seg,
             F launch) {
  if ((q_seg == nullptr) != (kv_seg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool seg = q_seg != nullptr;
  cudaError_t e = cudaErrorInvalidValue;
  if (head_dim == 64)
    e = seg ? launch(Dim<64>{}, Flag<true>{})
            : launch(Dim<64>{}, Flag<false>{});
  else if (head_dim == 128)
    e = seg ? launch(Dim<128>{}, Flag<true>{})
            : launch(Dim<128>{}, Flag<false>{});
  return static_cast<int>(e);
}

Seg make_seg(const void* q_seg, const void* kv_seg, long long q_seg_sb,
             long long kv_seg_sb) {
  return Seg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
             q_seg_sb, kv_seg_sb};
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
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(head_dim, q_seg, kv_seg, [&](auto d, auto has_seg) {
    return launch_fwd<decltype(d)::value, decltype(has_seg)::value>(
        q, k, v, o, lse, strides, b, h, sq, sk, scale, causal, seg, s);
  });
}

// The fused backward: as above, plus dout (strided like q; its strides
// follow q, k, v's in `strides`, 12 values), lse and delta (b, h, sq) fp32
// contiguous, dq_acc (b, h, sq, d) fp32 contiguous and ZEROED (dq is added
// into it, scaled), dk and dv (b, h, sk, d) bf16 contiguous.
extern "C" int apex_flash_attn_bwd(int head_dim, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq_acc, void* dk, void* dv,
                                   const long long* strides, int b, int h,
                                   int sq, int sk, float scale, int causal,
                                   const void* q_seg, const void* kv_seg,
                                   long long q_seg_sb, long long kv_seg_sb,
                                   void* stream) {
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(head_dim, q_seg, kv_seg, [&](auto d, auto has_seg) {
    return launch_bwd<decltype(d)::value, decltype(has_seg)::value, true>(
        q, k, v, dout, lse, delta, dq_acc, dk, dv, strides, b, h, sq, sk,
        scale, causal, seg, s);
  });
}

// The split backward's dq pass: the fused backward's arguments, with dq
// (b, h, sq, d) bf16 contiguous, written once (no zeroing), in place of
// dq_acc, dk and dv.
extern "C" int apex_flash_attn_bwd_dq(int head_dim, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq,
                                      const long long* strides, int b, int h,
                                      int sq, int sk, float scale, int causal,
                                      const void* q_seg, const void* kv_seg,
                                      long long q_seg_sb, long long kv_seg_sb,
                                      void* stream) {
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(head_dim, q_seg, kv_seg, [&](auto d, auto has_seg) {
    return launch_bwd_dq<decltype(d)::value, decltype(has_seg)::value>(
        q, k, v, dout, lse, delta, dq, strides, b, h, sq, sk, scale, causal,
        seg, s);
  });
}

// The split backward's dk/dv pass: the fused backward's arguments without
// dq_acc.
extern "C" int apex_flash_attn_bwd_dkv(int head_dim, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       const long long* strides, int b,
                                       int h, int sq, int sk, float scale,
                                       int causal, const void* q_seg,
                                       const void* kv_seg, long long q_seg_sb,
                                       long long kv_seg_sb, void* stream) {
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(head_dim, q_seg, kv_seg, [&](auto d, auto has_seg) {
    return launch_bwd<decltype(d)::value, decltype(has_seg)::value, false>(
        q, k, v, dout, lse, delta, nullptr, dk, dv, strides, b, h, sq, sk,
        scale, causal, seg, s);
  });
}

// The packed forward (_fwd_kernel_packed): apex_flash_attn_fwd's arguments
// and `hp`, the heads one block walks, which must divide h (else
// cudaErrorInvalidValue, nothing launched).  o and lse are the unpacked
// forward's bit for bit.
extern "C" int apex_flash_attn_fwd_packed(
    int head_dim, const void* q, const void* k, const void* v, void* o,
    void* lse, const long long* strides, int b, int h, int sq, int sk,
    float scale, int causal, int hp, const void* q_seg, const void* kv_seg,
    long long q_seg_sb, long long kv_seg_sb, void* stream) {
  if (hp < 1 || h % hp) return static_cast<int>(cudaErrorInvalidValue);
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(head_dim, q_seg, kv_seg, [&](auto d, auto has_seg) {
    return launch_fwd_packed<decltype(d)::value, decltype(has_seg)::value>(
        q, k, v, o, lse, strides, b, h, sq, sk, scale, causal, hp, seg, s);
  });
}

// The packed fused backward (_bwd_fused_kernel_packed): apex_flash_attn_bwd's
// arguments and `hp` (dividing h).  dk and dv are the unpacked fused
// kernel's bit for bit; dq is summed by the same atomics.
extern "C" int apex_flash_attn_bwd_packed(
    int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dq_acc,
    void* dk, void* dv, const long long* strides, int b, int h, int sq,
    int sk, float scale, int causal, int hp, const void* q_seg,
    const void* kv_seg, long long q_seg_sb, long long kv_seg_sb,
    void* stream) {
  if (hp < 1 || h % hp) return static_cast<int>(cudaErrorInvalidValue);
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(head_dim, q_seg, kv_seg, [&](auto d, auto has_seg) {
    return launch_bwd_packed<decltype(d)::value, decltype(has_seg)::value>(
        q, k, v, dout, lse, delta, dq_acc, dk, dv, strides, b, h, sq, sk,
        scale, causal, hp, seg, s);
  });
}
