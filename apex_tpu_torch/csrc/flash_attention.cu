// Flash attention forward and backward for Hopper (sm_90a), plain C
// interface.  Layout (b, h, s, d), bf16, head_dim 64 or 128, causal or
// not, with or without segment ids, with or without dropout, and (the
// unpacked kernels, without segment ids) with or without an additive
// fp32 score bias and its gradient.
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
//   * forward (sm_90a: wgmma and TMA, hopper.cuh): one block an SM walks
//     work items of (batch*head, 192 query rows at d=64, 128 at d=128).
//     A producer warp loads each item's Q tile (double-buffered) and walks
//     its key tiles (128 keys) through a ring of K and V tiles by TMA,
//     into 128-byte swizzled shared memory, each load completing on an
//     mbarrier; q, k and v are read through 4-D tensor maps of their
//     strided (b, h, s, d) views, and rows past sq and keys past sk arrive
//     as zeros.  Three (two) consumer warpgroups own 64 query rows each:
//     S = Q K^T by wgmma m64n128k16
//     from shared memory, then the online softmax (m, l in fp32, exp2 of
//     log2e-scaled scores) in registers (a wgmma accumulator gives each
//     thread rows g and g + 8, as an m16n8 tile does, so a row's max and
//     sum take a 4-lane shuffle), then O += P V by wgmma with P, rounded
//     to bf16 as the TPU kernel casts p to v's dtype, in registers and V
//     (keys x d, row-major) as the MN-major operand.  A tile goes back to
//     the producer on an mbarrier when every warpgroup is done with it.
//     The loop over key tiles takes the place of the TPU grid's k axis.
//     Causal: key tiles above the diagonal are never visited and only
//     tiles that cross it are masked (_causal_dispatch); the longest rows
//     go first.  l is guarded with max(l, 1e-30).
//   * backward (sm_90a: wgmma and TMA): the TPU kernel carries dk/dv across
//     its outer q loop in VMEM; on the card nothing carries between
//     blocks, so the loop is turned inside out (FlashAttention-2): one
//     block an SM walks work items of (batch*head, 128 keys), keeping dK
//     and dV in registers, and each item walks the 64-row q steps from the
//     first that sees its keys.  A block takes its items in turn from a
//     counter in device memory (atomicAdd), so blocks with short causal
//     items take more; the items go in chunks of a few heads, the longest
//     key tiles first within a chunk, so the blocks at work share those
//     heads' Q, dO and dq rows in L2 and the last items are short.  One
//     warp feeds the block: it loads each item's K and V (double-buffered
//     at d=64) and each q step's Q and dO through a ring (2 stages) by
//     TMA, through the same 4-D maps as the forward, with the rows' lse
//     and delta (and query ids) copied beside them by cp.async; each
//     completes on an mbarrier.  At d=64 that warp is a producer
//     warpgroup's (setmaxnreg: 40 registers there, 232 for the
//     consumers); at d=128 it is warp 0 of the consumers, between its own
//     steps, since an SM's four register quadrants hold any block of more
//     than 8 warps to 168 registers a thread, where the d=128 consumers
//     spilled.  Two consumer warpgroups own 64 keys each (keys are the
//     wgmma M dimension): S^T = K Q^T and dP^T = V dO^T
//     by wgmma m64n64k16 from shared memory, P^T and dS^T = P^T (dP^T -
//     delta) in registers (the mask only on tiles that cross the diagonal
//     or the ragged ends; a warpgroup skips a causal tile above all its
//     rows), then dV += P^T dO and dK += dS^T Q by wgmma with the bf16 A
//     operand in registers and dO, Q as MN-major operands.  p and ds are
//     rounded to bf16 before their products, as on the TPU; `scale`
//     multiplies ds for dk and dq.  dk and dv leave through shared memory
//     by TMA stores.  The fused kernel also takes dQ = dS K by wgmma from
//     dS^T in shared memory (dS^T and K as MN-major operands): at d=64
//     each warpgroup over its own 64 keys, at d=128 half of the columns
//     over both warpgroups' 128 keys (a named barrier a step); each warp
//     adds its 16 rows into a zeroed fp32 scratch buffer that the caller
//     casts once, by one bulk tensor reduce-add
//     (cp.reduce.async.bulk.tensor ... .add) per 32 columns from its own
//     slice of shared memory: the L2 sums them, with no per-thread
//     atomics or address math.  The order of those sums changes from run
//     to run, so dq is not bitwise reproducible (dk, dv are).  At d=128 a
//     consumer thread holds dK and dV (128 fp32) beside the step's tiles:
//     each q step is taken in two parts of 32 rows there, and the dQ
//     product waits for dV's and dK's.
//   * split backward (long context, where the TPU's (sk, d) dk/dv scratch
//     would not fit VMEM): the dk/dv pass is the fused kernel's body with
//     its dq part compiled out (the DQ template flag), so its dk and dv
//     are the fused kernel's bit for bit.  The dq pass (sm_90a: wgmma and
//     TMA) has the forward's shape with three products for two, and is
//     built from its pieces (FwdItem's work items, load_rows, the 4-D
//     maps, the mbarrier ring): one block an SM takes work items of
//     (batch*head, 192 query rows at d=64, 128 at d=128) from a counter in
//     device memory, the longest causal rows first.  A producer warp loads
//     each item's Q and dO tiles by TMA (double-buffered), with the rows'
//     lse and delta (and query ids) copied beside them by cp.async, and
//     walks its key tiles (64 keys) up to the diagonal through a ring of
//     K and V tiles (key ids staged beside them).  Three consumer
//     warpgroups (two at d=128) own 64 query rows each: S = Q K^T and dP
//     = dO V^T by wgmma m64n64k16 from shared memory, P and dS = P (dP -
//     delta) in registers (the mask only on tiles that cross the diagonal
//     or the ragged end, or hold more than one segment), then dQ += dS K
//     by wgmma with dS, rounded to bf16, in registers and K as the
//     MN-major operand.  dQ stays in registers over all of the item's key
//     tiles and leaves scaled, each row once, through the warpgroup's rows
//     of the Q buffer and a TMA store: no atomics, no scratch buffer, the
//     same bits from run to run.  It pays the recomputation of s and dp a
//     second time (3 products a pair in the dq pass and 4 in the dk/dv
//     pass, against the fused kernel's 5).
//   * head packing (_fwd_kernel_packed, _bwd_fused_kernel_packed): the TPU
//     kernels stack hp heads into one grid step to fill its vregs and the
//     128-deep MXU that a d=64 head half fills; the per-head math stays
//     separate and bit-identical.  On the card a head already fills a
//     block, so packing is a choice of what one block walks, not a second
//     copy of the math: the packed kernels run the unpacked kernels'
//     per-head bodies (fwd_items, bwd_items) for hp heads of one batch row
//     in turn (their work items hold hp heads).  Per head, o and lse
//     (forward) and dk, dv (backward) are the unpacked kernels' bit for
//     bit; dq is summed by the same reduce-adds.  What a block shares
//     across its heads: the query ids (forward) or key ids (backward) of
//     its rows, loaded once; in the forward the key ids of the whole batch
//     row, resident in shared memory while sk <= 8192 (32 KB), so they are
//     read once per key tile for the group, not once per head; and the
//     producer's rings, which run on into the next head's tiles while
//     this head's last ones are used.  Shared memory stays the unpacked
//     kernels' (fwd ~179 KB at d=64 and ~194 KB at d=128, the fused bwd
//     ~193 KB at d=64 and ~226 KB at d=128, plus the forward's resident
//     ids), so every hp that the JAX route admits runs: any divisor of h
//     in the forward, and hp * sk * d <= 512k in the backward.
// Rows past sq and keys past sk are zero-filled on load and masked, so any
// sequence length works.
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
// reaches dv for every key.  Each block loads its key tile's ids
// (forward: the producer stages them beside K; dq pass) or each q step's
// ids (fused and dk/dv: the producer writes them beside Q and dO, the
// consumers read their keys' ids once an item); passing null ids launches
// the unsegmented kernels, whose code is unchanged.  A forward warp whose 16
// rows and whose tile's 128 keys all carry one id, or a backward
// warpgroup whose 64 keys (voted once an item) and whose step's 64 rows
// all carry one id, in a tile that does not cross the diagonal, takes
// the unsegmented masking: the per-score compares cost the backward half
// its time again, and in BERT's batches most tiles are one segment.
//
// Dropout (the DROP instantiations; _dropout_keep, the TPU kernels'
// counter hash): a score of head i (batch * h + head), global query row q
// and global key k is kept where fmix32(seed * 1000003 + i + k *
// 0x9e3779b1 + q * 0x85ebca77) (32-bit, wrapping, logical shifts) has its
// low 31 bits >= the host's int(rate * 2^31); q and k are the launch's
// q_off / k_off plus the row and key.  The bits are a pure function of the
// score's coordinates, so every kernel, tile, route and packing computes
// the same mask, and the backward regenerates the forward's without
// storing it.  Each thread hashes the scores it holds in its wgmma
// accumulator fragment: the forward drops the fp32 p (not l, which stays
// the softmax sum) and scales it by 1 / (1 - rate) before its rounding for
// P V; the backward drops and scales p for dV and dP before dS = P (dP -
// delta), as the TPU kernels do.  About 12 integer operations a score on
// the hot loop, no memory.  Rate 0 launches the !DROP instantiations,
// which are the kernels as they were before dropout.
//
// Additive bias (the BIAS instantiations of the forward, the fused kernel,
// the dk/dv pass and the dq pass: flash_*_bias_kernel; _mask_bias and
// want_dbias in the TPU kernels): an fp32 bias of shape (b|1, h|1, sq|1, sk)
// is added to the scaled scores before the causal mask, as _mask_bias orders
// it; a broadcast dimension has stride 0, so a key-compact (.., 1, sk) bias
// ("sk") is the same code as a full one ("full"), its query stride 0. A
// query-compact bias is not passed: softmax cancels it, so the caller
// launches the kernels without one. The kernels take scale * (q k + bias /
// scale) = scale * q k + bias: each thread loads its score fragment's bias
// values (8-byte pairs of keys where the fragment holds key pairs: the
// forward and the dq pass), times 1 / scale, into the score product's
// accumulator registers before the product is issued, and the product
// accumulates q k onto them. So the biased scores leave the product with the
// bias in them, and the rest of the kernel (the masks, the log2-unit
// exponent, the tile skips) is the unbiased kernel's code: the masks still
// follow the bias, as _mask_bias orders them. The loads are issued while no
// product is in flight (ptxas serialises wgmma otherwise); a broadcast (1, 1,
// sq, sk) bias of a few MB stays in the L2. The gradient with respect to the
// bias is ds = p (dp - delta), the gradient with respect to the whole
// pre-softmax score s * scale + bias, which the backward already forms before
// its products (in fp32, before the bf16 rounding): BIAS 2 writes it. The
// fused kernel and the dq pass write "full" dbias as a (b * h, sq, sk) fp32
// partial, each thread its own scores (a causal tile that no query sees is
// not visited: the caller zeroes the partial); the dk/dv pass writes "sk"
// dbias, ds summed over every query of the item's keys, as a (b * h, sk) fp32
// partial: each thread sums its two keys over its rows and q steps in
// registers, the four lanes that share a key add theirs by shuffles, and one
// lane stores the key's sum at the item's end (a key tile belongs to one
// item, and a warpgroup owns its 64 keys: no atomics). The caller sums the
// partials over the bias's broadcast dimensions. Bias with segment ids, with
// fp32 outputs or with heads packed is refused (cudaErrorInvalidValue): no
// instantiation takes them.
//
// fp32 gradients (the F32 instantiations of the fused kernel, the dk/dv
// pass and the dq pass; _bwd_impl's grad_dtype=float32, which the ring
// attention of parallel/context_parallel.py asks for so that a chunk's
// partials add up across ring steps in fp32 and are rounded once): the
// same bodies, with dk and dv (and the dq pass's dq) written as fp32
// straight from the accumulator registers by 8-byte global stores, each
// thread its column pairs of its two rows, in place of the bf16 rounding
// and the TMA stores through shared memory (whose slices are sized for
// bf16).  The values are the ones the bf16 kernels round, so a bf16
// launch's output is the F32 launch's rounded to bf16, bit for bit.  The
// fused kernel's dq is already the fp32 dq_acc.  The flag is a template
// argument, so no run-time branch sits in the product loop and the bf16
// instantiations are the code they were.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the JAX package's finite _NEG_INF (-1e30) in the kernels' log2 units
constexpr float kMaskedLog2 = -1.0e30f * kLog2e;
// an lse (log2 units) below this belongs to a row whose keys are all
// masked: real scores are nowhere near -1e29
constexpr float kDeadLse = -1.0e29f;

// true in every lane when `same` holds in every lane of the warp: with
// `same` = "my ids equal the tile's first id", the warp's tile is one
// segment
__device__ __forceinline__ bool warp_one_segment(bool same) {
  return __all_sync(kFull, same);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// one launch's dropout (see the top): the seed and offsets as 32-bit
// words, the keep threshold on the hash's low 31 bits, 1 / (1 - rate)
struct Drop {
  uint32_t seed, q_off, k_off, thresh;
  float inv;
};

// one launch's additive bias (see the top): the element of head hh of
// batch row b, query row q and key k is p[b sb + hh sh + q sq + k] (strides
// in elements, 0 on a broadcast dimension, all even, p 8-byte aligned,
// rows readable to an even length: the caller pads an odd sk), so a pair
// of keys 2j, 2j + 1 is one 8-byte load; db: the dbias partial a BIAS 2
// instantiation writes, fp32, (b * h, sq, sk) from the fused kernel and
// the dq pass, (b * h, sk) from the dk/dv pass
struct Bias {
  const float* p;
  float* db;
  long long sb, sh, sq;
};

// head bh's bias (bh = batch * h + head)
__device__ __forceinline__ const float* bias_head(const Bias& bs, int bh,
                                                  int h) {
  return bs.p + (long long)(bh / h) * bs.sb + (long long)(bh % h) * bs.sh;
}

// keys key and key + 1 (key even) of the bias row `row` of a head: 0 past
// sk or sq
__device__ __forceinline__ float2 bias_pair(const float* row, int key,
                                            bool in) {
  return in ? __ldg(reinterpret_cast<const float2*>(row + key))
            : make_float2(0.f, 0.f);
}

// murmur3's finalizer
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

// the hash's terms of head bh, query row q and key k: they add up (mod
// 2^32) to the word fmix32 takes
__device__ __forceinline__ uint32_t drop_head(const Drop& d, int bh) {
  return d.seed * 1000003u + static_cast<uint32_t>(bh);
}
__device__ __forceinline__ uint32_t drop_row(const Drop& d, int q) {
  return (d.q_off + static_cast<uint32_t>(q)) * 0x85ebca77u;
}
__device__ __forceinline__ uint32_t drop_key(const Drop& d, int k) {
  return (d.k_off + static_cast<uint32_t>(k)) * 0x9e3779b1u;
}

// whether the score whose terms sum to `w` is kept
__device__ __forceinline__ bool drop_keep(const Drop& d, uint32_t w) {
  return (fmix32(w) & 0x7fffffffu) >= d.thresh;
}

// the backward's dropout of one score, kept where bit `i` of `bits` is
// set: pv = p for dV and dpv = dP, each dropped and scaled; p itself goes
// into dS = P (dP - delta) undropped.  The backward kernels hash a tile's
// scores into `bits` before its products, so that the hash's temporaries
// never sit beside the products' accumulators (beside them the d=64
// kernels spilled).
__device__ __forceinline__ void drop_pair(const Drop& d, uint32_t bits, int i,
                                          float p, float& pv, float& dpv) {
  const bool kp = (bits >> i) & 1u;
  pv = kp ? p * d.inv : 0.f;
  dpv = kp ? dpv * d.inv : 0.f;
}

// ------------------------------------------------------------ forward ----

constexpr int kFwdKeys = 128;  // keys per K/V tile

// keys whose segment ids the packed forward keeps resident for a batch row
// (32 KB); past it the producer stages them per key tile
constexpr int kIdCache = 8192;

// The forward's shape at head_dim D: kWgs consumer warpgroups of 64 query
// rows each (three at d=64: a third warp on each SMSP hides the softmax's
// latencies, and each K/V tile serves 192 rows; two at d=128, whose
// accumulators leave no room for a third), one producer warpgroup, and
// setmaxnreg's split of the register file between them.  Shared memory
// from its 1024-byte aligned start: Q[2], then kStages of K and of V, each
// tile D / 64 column blocks of its rows x 64 (128-byte swizzled rows, as
// TMA lands them), then the barriers, then with SEG the staged key ids
// [kStages][kFwdKeys]; the packed kernel's resident ids follow.  The ring
// is as deep as shared memory allows at one block an SM: 4 stages at d=64
// (179 KB), 2 at d=128 (194 KB), with 32 KB of resident ids.
// -D overrides that build scripts/port_hopper_ablation.py's variants of
// the forward; the defaults are the kernel.  The two that make o garbage
// (no products and softmax, no stores of o) switch their code off at run
// time (`|| sq < 0`), not at compile time, so the rest stays the same code.
#ifndef APEX_FWD_WGS64  // consumer warpgroups at d=64
#define APEX_FWD_WGS64 3
#endif
#ifndef APEX_FWD_STAGES64  // the K/V ring's depth at d=64
#define APEX_FWD_STAGES64 4
#endif
#ifndef APEX_FWD_TILE_SKIP  // 0: every warpgroup runs every key tile
#define APEX_FWD_TILE_SKIP 1
#endif
#ifndef APEX_FWD_MATH  // 0: the pipeline alone
#define APEX_FWD_MATH 1
#endif
#ifndef APEX_FWD_STORE_O  // 0: o is not stored
#define APEX_FWD_STORE_O 1
#endif

template <int D, bool SEG>
struct FwdSmem {
  static constexpr int kWgs = D == 64 ? APEX_FWD_WGS64 : 2;
  static constexpr int kRows = 64 * kWgs;  // query rows per work item
  static constexpr int kThreads = 128 * (kWgs + 1);
  // a consumer warp arrives once its lanes are past a wgmma wait
  static constexpr int kConsumerWarps = 4 * kWgs;
  static constexpr int kProducerRegs = kWgs == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kWgs == 3 ? 160 : 232;
  static constexpr int kStages = D == 64 ? APEX_FWD_STAGES64 : 2;
  static constexpr int kQBlock = kRows * 128;      // 64 columns of Q
  static constexpr int kKBlock = kFwdKeys * 128;   // of K or V: 16 KB
  static constexpr int kQTile = D / 64 * kQBlock;
  static constexpr int kKTile = D / 64 * kKBlock;
  static constexpr int kQ = 0, kK = 2 * kQTile;
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBar = kV + kStages * kKTile;
  static constexpr int kIds = kBar + (4 + 3 * kStages) * 8;
  static constexpr int kEnd = kIds + (SEG ? kStages * kFwdKeys * 4 : 0);
  // the dynamic shared memory, with the alignment slack
  static constexpr size_t kBytes = size_t(kEnd) + 1024;
};

// one forward launch's arguments: 4-D TMA maps of the (b, h, s, d) views q,
// k and v, and in `order_*` each map's dimension slots of s, h and b (bits
// 0-1, 2-3 and 4-5; d is slot 0; see map_bhsd); `groups`: b * h / hp
struct FwdArgs {
  CUtensorMap q, k, v;
  int order_q, order_k, order_v;
  bf16* o;
  float* lse;
  int h, sq, sk, groups;
  float scale_log2;
  int causal;
  const int* q_seg;
  const int* kv_seg;
  long long q_seg_sb, kv_seg_sb;
  Drop drop;  // DROP instantiations
  Bias bias;  // BIAS instantiations
};

// 2^x in one special-function instruction (ex2.approx.ftz: subnormal
// results flush to 0, which a softmax weight below 2^-126 never misses);
// exp2f adds a range test and two multiplies around it
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the box of rows [row, row + 128) x columns [d0, d0 + 64) of head hh of
// batch row b into shared memory at dst, completing on bar
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map,
                                          int order, uint64_t* bar, int d0,
                                          int row, int hh, int b) {
  const int ps = order & 3, ph = (order >> 2) & 3;
  const int c1 = ps == 1 ? row : ph == 1 ? hh : b;
  const int c2 = ps == 2 ? row : ph == 2 ? hh : b;
  const int c3 = ps == 3 ? row : ph == 3 ? hh : b;
  hopper::tma_load_4d(dst, map, bar, d0, c1, c2, c3);
}

// work item w of a forward launch: query block jq = nq - 1 - w / groups
// (all groups' longest causal rows first) of `rows` query rows, of head
// group w % groups, the hp heads (batch * head) bh0 .. bh0 + hp - 1 of one
// batch row
struct FwdItem {
  int jq, bh0, b, q0, n_kv;
  __device__ __forceinline__ FwdItem(const FwdArgs& a, int w, int hp, int nq,
                                     int rows, bool seg,
                                     int keys = kFwdKeys) {
    jq = nq - 1 - w / a.groups;
    bh0 = (w % a.groups) * hp;
    b = bh0 / a.h;
    q0 = jq * rows;
    // key tiles of `keys`: up to the diagonal when causal, every one with
    // segment ids (a row whose keys are all masked sees all sk of them)
    n_kv = (a.sk + keys - 1) / keys;
    if (a.causal && !seg)
      n_kv = min(n_kv, (min(q0 + rows, a.sq) - 1) / keys + 1);
  }
};

// A block's share of the forward: the work items blockIdx.x, blockIdx.x +
// gridDim.x, ... (one block an SM, for all of the launch), each 128 query
// rows of `hp` heads in turn.  Each head is the unpacked kernel's body, so
// its o and lse are that kernel's bit for bit.  `res_ids` (SEG): the key
// ids of an item's batch row are resident in shared memory (padded to
// whole key tiles with 0), else the producer stages them per key tile.
//
// Warpgroup 2 is the producer: one warp walks the items, heads and key
// tiles in the consumers' order, loading each head's Q tile into one of
// two buffers and the K and V tiles into a ring, by TMA, each on its own
// mbarrier.  Both run on across heads and items, so the next head's Q and
// first tiles load while this head ends: a block's fixed costs (launch,
// barrier set-up, the first loads' latency) are paid once, not once per
// 128 rows.  Warpgroups 0 and 1 own 64 query rows each and share every
// tile: per key tile, S = Q K^T by wgmma from shared memory (K K-major),
// the mask and online softmax in registers, then O += P V by wgmma with P
// in registers (V, keys x d row-major, is MN-major).  BIAS (hp = 1, no
// segment ids): the bias is added to every score before the masks.
template <int D, bool SEG, bool DROP, int BIAS = 0>
__device__ __forceinline__ void fwd_items(const FwdArgs& a, int hp,
                                          bool res_ids, unsigned char* smem) {
  static_assert(!(SEG && BIAS), "no instantiation takes bias and ids");
  using L = FwdSmem<D, SEG>;
  constexpr int kStages = L::kStages, kWgs = L::kWgs;
  unsigned char* q_s = smem + L::kQ;  // [2]
  unsigned char* k_s = smem + L::kK;  // [kStages]
  unsigned char* v_s = smem + L::kV;  // [kStages]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bar;                   // [2]
  uint64_t* q_empty = bar + 2;              // [2]
  uint64_t* k_full = bar + 4;               // [kStages]
  uint64_t* v_full = k_full + kStages;      // [kStages]
  uint64_t* kv_empty = v_full + kStages;    // [kStages]
  int* kid_s = reinterpret_cast<int*>(smem + L::kIds);  // SEG: [kStages][128]
  int* kid_res = reinterpret_cast<int*>(smem + L::kEnd);  // res_ids
  const bool staged = SEG && !res_ids;

  const int h = a.h, sq = a.sq, sk = a.sk;
  const bool causal = a.causal != 0;
  const int nq = (sq + L::kRows - 1) / L::kRows;
  const int n_items = nq * a.groups;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], L::kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      // staged ids: every producer lane arrives after writing its ids
      hopper::mbar_init(&k_full[s], staged ? 32 : 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&kv_empty[s], L::kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();  // the barriers are visible

  if (wg == kWgs) {  // --------------------------------------- producer
    hopper::setmaxnreg_dec<L::kProducerRegs>();
    if (threadIdx.x >= 128 * kWgs + 32) return;  // one warp produces
    const int lane = threadIdx.x & 31;
    int fill = 0;  // K/V tiles issued so far: tile f uses stage f % kStages
    int qc = 0;    // Q tiles issued so far: Q f uses buffer f & 1
    // the warp's lanes wait together and reconverge after lane 0 issues
    // the loads
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const FwdItem t(a, w, hp, nq, L::kRows, SEG);
      const int* kidg = SEG ? a.kv_seg + t.b * a.kv_seg_sb : nullptr;
      for (int p = 0; p < hp; ++p, ++qc) {
        const int hh = (t.bh0 + p) % h;
        const int qb = qc & 1;
        // the last score product of the head that held this buffer is done
        if (qc >= 2) hopper::mbar_wait(&q_empty[qb], ((qc >> 1) - 1) & 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&q_full[qb], L::kQTile);
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            load_rows(q_s + qb * L::kQTile + c * L::kQBlock, &a.q, a.order_q,
                      &q_full[qb], 64 * c, t.q0, hh, t.b);
        }
        __syncwarp();
        for (int it = 0; it < t.n_kv; ++it, ++fill) {
          const int s = fill % kStages;
          // both consumers are done with the tile this stage held
          if (fill >= kStages)
            hopper::mbar_wait(&kv_empty[s], (fill / kStages - 1) & 1);
          const int k0 = it * kFwdKeys;
          if (staged) {
#pragma unroll
            for (int i = lane; i < kFwdKeys; i += 32)
              kid_s[s * kFwdKeys + i] = k0 + i < sk ? kidg[k0 + i] : 0;
            if (lane != 0) hopper::mbar_arrive(&k_full[s]);
          }
          if (lane == 0) {
            hopper::mbar_arrive_expect_tx(&k_full[s], L::kKTile);
#pragma unroll
            for (int c = 0; c < D / 64; ++c)
              load_rows(k_s + s * L::kKTile + c * L::kKBlock, &a.k, a.order_k,
                        &k_full[s], 64 * c, k0, hh, t.b);
            hopper::mbar_arrive_expect_tx(&v_full[s], L::kKTile);
#pragma unroll
            for (int c = 0; c < D / 64; ++c)
              load_rows(v_s + s * L::kKTile + c * L::kKBlock, &a.v, a.order_v,
                        &v_full[s], 64 * c, k0, hh, t.b);
          }
          __syncwarp();
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  hopper::setmaxnreg_inc<L::kConsumerRegs>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = a.scale_log2;
  int fill = 0, qc = 0;
  int ids_row = -1;  // res_ids: the batch row whose key ids are resident
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const FwdItem t(a, w, hp, nq, L::kRows, SEG);
    const int n_kv = t.n_kv, q0 = t.q0;
    if (SEG && res_ids && t.b != ids_row) {
      // both consumer warpgroups are done with the previous row's ids
      hopper::named_barrier_sync(1, 128 * kWgs);
      const int* kidg = a.kv_seg + t.b * a.kv_seg_sb;
      for (int i = threadIdx.x; i < n_kv * kFwdKeys; i += 128 * kWgs)
        kid_res[i] = i < sk ? kidg[i] : 0;
      hopper::named_barrier_sync(1, 128 * kWgs);
      ids_row = t.b;
    }
    const int wrow0 = q0 + wg * 64;  // the warpgroup's first query row
    const int r0 = wrow0 + warp * 16;  // the warp's first query row
    const int row_a = r0 + g;                 // this thread's two query rows
    const int row_b = row_a + 8;
    int qid_a = 0, qid_b = 0;
    if (SEG) {
      const int* qidg = a.q_seg + t.b * a.q_seg_sb;
      if (row_a < sq) qid_a = qidg[row_a];
      if (row_b < sq) qid_b = qidg[row_b];
    }
    for (int p = 0; p < hp; ++p, ++qc) {
      const int bh = t.bh0 + p;
      const int qb = qc & 1;
      const unsigned char* qs = q_s + qb * L::kQTile;
      // BIAS: this thread's two rows of the head's bias, and 1 / scale
      const float* bias_a = nullptr;
      const float* bias_b = nullptr;
      if (BIAS) {
        const float* hb = bias_head(a.bias, bh, h);
        bias_a = hb + (long long)row_a * a.bias.sq;
        bias_b = hb + (long long)row_b * a.bias.sq;
      }
      const float inv_scale = kLog2e / scale_log2;
      // acc[4n + e]: rows g (e < 2) and g + 8 of the warp's 16, d column
      // 8n + 2 t4 + (e & 1)
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      // the running max (log2 units) and this lane's share of the sum
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
      // scores of the warpgroup's 64 rows x 128 keys: sc[4n + e] is key
      // 8n + 2 t4 + (e & 1) of row g (e < 2) or g + 8; pa: the tile's p,
      // rounded to bf16, as the m16n8k16 A fragments of keys 16kk .. 16kk
      // + 15
      float sc[64];
      uint32_t pa[8][4];
      float al_a = 1.f, al_b = 1.f;  // the tile's rescale of O

      // S = Q K^T of the key tile that `fill` names, from shared memory
      auto scores = [&](int f) {
        const unsigned char* ks = k_s + (f % kStages) * L::kKTile;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int qo = (kk / 4) * L::kQBlock + wg * 64 * 128 + (kk % 4) * 32;
          const int ko = (kk / 4) * L::kKBlock + (kk % 4) * 32;
          hopper::wgmma_ss_bf16<0, 0>(
              sc, hopper::wgmma_desc(qs + qo, 16, 1024),
              hopper::wgmma_desc(ks + ko, 16, 1024), BIAS != 0 || kk > 0);
        }
      };
      // BIAS: sc = the bias of key tile `it` / scale, for the score
      // product to accumulate onto (keys 8n + 2 t4 and + 1: one pair)
      auto load_bias = [&](int it) {
        const int kc = it * kFwdKeys + 2 * t4;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const int key = kc + 8 * n;
          const float2 ba = bias_pair(bias_a, key, key < sk && row_a < sq);
          const float2 bb = bias_pair(bias_b, key, key < sk && row_b < sq);
          sc[4 * n] = ba.x * inv_scale;
          sc[4 * n + 1] = ba.y * inv_scale;
          sc[4 * n + 2] = bb.x * inv_scale;
          sc[4 * n + 3] = bb.y * inv_scale;
        }
      };
      // O += P V for the tile that `f` names, P from registers
      auto pv = [&](int f) {
        const unsigned char* vs = v_s + (f % kStages) * L::kKTile;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          hopper::wgmma_rs_bf16<1>(
              acc, pa[kk],
              hopper::wgmma_desc(vs + kk * 2048, L::kKBlock, 1024), 1);
      };
      // the row max of sc over this thread's 32 scores of each row (four
      // chains, for instruction-level parallelism), then over the quad of
      // lanes that shares the row
      auto row_max = [&](float& mx_a, float& mx_b) {
        float ma[4], mb[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          ma[n] = fmaxf(sc[4 * n], sc[4 * n + 1]);
          mb[n] = fmaxf(sc[4 * n + 2], sc[4 * n + 3]);
        }
#pragma unroll
        for (int n = 4; n < 16; ++n) {
          ma[n % 4] = fmaxf(ma[n % 4], fmaxf(sc[4 * n], sc[4 * n + 1]));
          mb[n % 4] = fmaxf(mb[n % 4], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
        }
        mx_a = fmaxf(fmaxf(ma[0], ma[1]), fmaxf(ma[2], ma[3]));
        mx_b = fmaxf(fmaxf(mb[0], mb[1]), fmaxf(mb[2], mb[3]));
#pragma unroll
        for (int o_ = 1; o_ <= 2; o_ <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, o_));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, o_));
        }
      };
      // sc = exp2(sl * sc - mu) and this lane's row sums (four chains);
      // then l and m move on with the rescale al = exp2(m - mu)
      auto exp_sum = [&](float mx_a, float mx_b, float sl) {
        const float mu_a = mx_a == -INFINITY ? 0.f : mx_a;
        const float mu_b = mx_b == -INFINITY ? 0.f : mx_b;
        al_a = ex2(m_a - mu_a);
        al_b = ex2(m_b - mu_b);
        m_a = mx_a;
        m_b = mx_b;
        float ra[4] = {0.f, 0.f, 0.f, 0.f}, rb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          sc[4 * n] = ex2(fmaf(sc[4 * n], sl, -mu_a));
          sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], sl, -mu_a));
          sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], sl, -mu_b));
          sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], sl, -mu_b));
          ra[n % 4] += sc[4 * n] + sc[4 * n + 1];
          rb[n % 4] += sc[4 * n + 2] + sc[4 * n + 3];
        }
        // this lane's share; summed over the quad last
        l_a = l_a * al_a + ((ra[0] + ra[1]) + (ra[2] + ra[3]));
        l_b = l_b * al_b + ((rb[0] + rb[1]) + (rb[2] + rb[3]));
      };
      // the mask and the online softmax of key tile `it` (stage s): sc
      // becomes p (fp32); m, l and al_* move on.  Masks apply only to
      // tiles that cross the diagonal or the ragged end of the keys, or
      // (SEG) hold more than one segment id (warp-uniform tests).
      auto softmax = [&](int it, int s) {
        const int k0 = it * kFwdKeys;
        const int* kid = res_ids ? kid_res + k0 : kid_s + s * kFwdKeys;
        bool per_score = false;  // SEG: this warp's tile needs id compares
        if (SEG) {  // no short-circuit: branches here diverge the warp
          const int c = kid[0];
          per_score =
              !warp_one_segment((kid[lane] == c) & (kid[lane + 32] == c) &
                                (kid[lane + 64] == c) & (kid[lane + 96] == c) &
                                (qid_a == c) & (qid_b == c)) ||
              (causal && k0 + kFwdKeys - 1 > r0);
        }
        float sl = scale_log2;  // the scale still to apply to sc
        if (per_score) {
          // every score: the segment compare, then the causal; sc is
          // scaled before the exponent, so a row whose scores so far are
          // all the finite masked value gets exp2(0) = 1 for each exactly
          // (an FMA's unrounded product would leave ~1e23 in the exponent)
          // selects, not branches: a branch per score (each around its id
          // load) made this loop the slowest part of BERT's tiles
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            const int kc = n * 8 + 2 * t4;
            const int2 ids = *reinterpret_cast<const int2*>(kid + kc);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + kc + (e & 1);
              const int row = e < 2 ? row_a : row_b;
              const bool masked = ((e & 1) ? ids.y : ids.x) !=
                                      (e < 2 ? qid_a : qid_b) ||
                                  (causal && key > row);
              float x = sc[4 * n + e] * scale_log2;
              x = masked ? kMaskedLog2 : x;
              // not a key: no weight, even in a masked row
              sc[4 * n + e] = key >= sk ? -INFINITY : x;
            }
          }
          sl = 1.f;
        } else if ((k0 + kFwdKeys > sk) ||
                   (causal && k0 + kFwdKeys - 1 > r0)) {
            // the whole loop under the test: a test per score inside one
            // loop became predicated code that every tile ran
#pragma unroll
          for (int n = 0; n < 16; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + n * 8 + 2 * t4 + (e & 1);
              const int row = e < 2 ? row_a : row_b;
              sc[4 * n + e] = key >= sk || (causal && key > row)
                                  ? -INFINITY
                                  : sc[4 * n + e];
            }
          }
        }
        // otherwise the scale goes into the exponent, an FMA; scale > 0,
        // so the scaled max is the max of the scaled scores
        float mx_a, mx_b;
        row_max(mx_a, mx_b);
        exp_sum(fmaxf(m_a, mx_a * sl), fmaxf(m_b, mx_b * sl), sl);
      };
      // DROP: p of key tile `it` dropped and scaled by the hash of its
      // coordinates, as the TPU kernel's where(keep, p, 0) / (1 - rate); l
      // keeps the undropped sum
      auto drop_p = [&](int it) {
        const Drop& dr = a.drop;
        const uint32_t ha = drop_head(dr, bh) + drop_row(dr, row_a);
        const uint32_t hb = drop_head(dr, bh) + drop_row(dr, row_b);
        const int kc0 = it * kFwdKeys + 2 * t4;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t kt = drop_key(dr, kc0 + 8 * n + e);
            sc[4 * n + e] =
                drop_keep(dr, ha + kt) ? sc[4 * n + e] * dr.inv : 0.f;
            sc[4 * n + 2 + e] =
                drop_keep(dr, hb + kt) ? sc[4 * n + 2 + e] * dr.inv : 0.f;
          }
        }
      };
      // p to bf16 (as the TPU kernel casts p to v's dtype) and O rescaled
      auto to_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n] *= al_a;
          acc[4 * n + 1] *= al_a;
          acc[4 * n + 2] *= al_b;
          acc[4 * n + 3] *= al_b;
        }
      };
      // Q is read once the head's last score product is done: its buffer
      // may take the head after next
      auto q_read = [&]() {
        if (lane == 0) hopper::mbar_arrive(&q_empty[qb]);
        __syncwarp();  // the lanes wait together (see the producer)
      };
      // the warp is done with the tile that `f` names: its stage may be
      // refilled
      auto release = [&](int f) {
        if (lane == 0) hopper::mbar_arrive(&kv_empty[f % kStages]);
        __syncwarp();
      };

      hopper::mbar_wait(&q_full[qb], (qc >> 1) & 1);
      // per key tile: S, its softmax, then O += P V, each product waited
      // for before the registers it writes are touched.  (Overlapping a
      // tile's softmax with the previous tile's P V saved 3 % at GPT's
      // shape, and in some instantiations made ptxas wait after every
      // wgmma, which cost 60 %.)
      for (int it = 0; it < n_kv; ++it, ++fill) {
        const int s = fill % kStages;
        const uint32_t parity = (fill / kStages) & 1;
        // a tile this warpgroup's rows never see (all past sq, or all
        // keys above their diagonal without segment ids) is only released
        // (once it has landed: a release ahead of the producer would count
        // towards the stage's previous use): it would add p = 0 everywhere
        const bool unseen = wrow0 >= sq || (APEX_FWD_TILE_SKIP && causal &&
                                            !SEG &&
                                            it * kFwdKeys > wrow0 + 63);
        if (BIAS && !unseen) load_bias(it);
        hopper::mbar_wait(&k_full[s], parity);
        if (unseen) {
          if (it == n_kv - 1) q_read();
          release(fill);
          continue;
        }
        hopper::wgmma_fence();
        if (APEX_FWD_MATH || sq < 0) scores(fill);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (it == n_kv - 1) q_read();
        if (APEX_FWD_MATH || sq < 0) softmax(it, s);
        if constexpr (DROP)
          if (APEX_FWD_MATH || sq < 0) drop_p(it);
        if (APEX_FWD_MATH || sq < 0) to_p();
        hopper::mbar_wait(&v_full[s], parity);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();  // P and the rescaled O are in registers
        if (APEX_FWD_MATH || sq < 0) pv(fill);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(fill);
      }

#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        l_a += __shfl_xor_sync(kFull, l_a, o_);
        l_b += __shfl_xor_sync(kFull, l_b, o_);
      }
      const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
      bf16* og = a.o + (long long)bh * sq * D;
      if (row_a < sq) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          if (APEX_FWD_STORE_O || sq < 0)
            *reinterpret_cast<uint32_t*>(og + (long long)row_a * D + n * 8 +
                                         2 * t4) =
                pack_bf16(acc[4 * n] / la, acc[4 * n + 1] / la);
        if (t4 == 0)
          a.lse[(long long)bh * sq + row_a] = (m_a + log2f(la)) * kLn2;
      }
      if (row_b < sq) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          if (APEX_FWD_STORE_O || sq < 0)
            *reinterpret_cast<uint32_t*>(og + (long long)row_b * D + n * 8 +
                                         2 * t4) =
                pack_bf16(acc[4 * n + 2] / lb, acc[4 * n + 3] / lb);
        if (t4 == 0)
          a.lse[(long long)bh * sq + row_b] = (m_b + log2f(lb)) * kLn2;
      }
    }
  }
}

// one block an SM, walking the work items of (FwdSmem::kRows query rows,
// batch*head)
template <int D, bool SEG, bool DROP>
__global__ void __launch_bounds__(FwdSmem<D, SEG>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  fwd_items<D, SEG, DROP>(a, 1, false, hopper::align1024(smem_raw));
}

// the forward with an additive bias (no segment ids)
template <int D, bool DROP>
__global__ void __launch_bounds__(FwdSmem<D, false>::kThreads, 1)
    flash_fwd_bias_kernel(const __grid_constant__ FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  fwd_items<D, false, DROP, 1>(a, 1, false, hopper::align1024(smem_raw));
}

// the port of _fwd_kernel_packed: one block an SM, walking the work items
// of (FwdSmem::kRows query rows, group of hp heads of one batch row), the
// heads in turn; `res_ids`: the key ids are resident (SEG, sk <=
// kIdCache), in shared memory after the unpacked kernel's
template <int D, bool SEG, bool DROP>
__global__ void __launch_bounds__(FwdSmem<D, SEG>::kThreads, 1)
    flash_fwd_packed_kernel(const __grid_constant__ FwdArgs a, int hp,
                            int res_ids) {
  extern __shared__ unsigned char smem_raw[];
  fwd_items<D, SEG, DROP>(a, hp, SEG && res_ids, hopper::align1024(smem_raw));
}

// ----------------------------------------------------------- backward ----

constexpr int kBwdKeys = 128;  // keys per work item: 64 per consumer warpgroup
constexpr int kBwdRows = 64;   // query rows per q step

// The backward's shape, at both head dims: two consumer warpgroups of 64
// keys each (the wgmma M dimension is keys) and one feeding warp (see the
// top).  At d=128 a consumer thread holds dK and dV (128 fp32) beside a q
// step's S^T, dP^T and their bf16 copies, so there the step is taken in
// two parts of 32 rows (48 registers, not 96); a third warpgroup or wider
// key tiles do not fit.  Shared memory from its 1024-byte aligned start:
// kKvBufs K and V tiles (128 keys, D / 64 column blocks of 128 rows x 128
// bytes, as TMA lands them in 128-byte swizzled rows), kStages Q and dO
// tiles (64 rows), with DQ two dS^T tiles (128 keys x 64 queries, bf16,
// swizzled), then the consumer warps' output slices, then the rows' lse,
// delta and (SEG) ids per stage, then the barriers and the item indices.
// d=64: two K/V buffers and a 2-stage ring (about 193 KB with DQ); d=128:
// one K/V buffer and 2 stages (about 226 KB); apex_flash_attn_bwd_smem
// gives each.
// -D overrides that build scripts/port_hopper_ablation.py's variants; the
// defaults are the kernel.  The two that make dq garbage (no products and
// math, no dq store) switch their code off at run time (`|| sq < 0`), as
// the forward's do.
#ifndef APEX_BWD_STAGES64  // the Q/dO ring's depth at d=64
#define APEX_BWD_STAGES64 2
#endif
#ifndef APEX_BWD_DQ_RED  // 1: dq leaves by per-thread red.global.add.v2.f32
#define APEX_BWD_DQ_RED 0
#endif
#ifndef APEX_BWD_MATH  // 0: the pipeline alone
#define APEX_BWD_MATH 1
#endif
#ifndef APEX_BWD_STORE_DQ  // 0: dq is not stored
#define APEX_BWD_STORE_DQ 1
#endif
#ifndef APEX_BWD_CHUNK  // head groups a chunk of work items (0: as many
#define APEX_BWD_CHUNK 0    // as give the grid one item each)
#endif
#ifndef APEX_BWD_DQ_OWN64  // 0: dQ's columns split between the warpgroups
#define APEX_BWD_DQ_OWN64 1
#endif

template <int D, bool SEG, bool DQ>
struct BwdSmem {
  // d=64: two consumer warpgroups and a producer warpgroup, one warp of
  // which feeds (384 threads; setmaxnreg gives the consumers 232
  // registers, the producers 40).  d=128: the consumers' warp 0 also
  // issues the loads (256 threads).  An SM's registers sit in four
  // quadrants of 16K, so a block of more than 8 warps holds each thread
  // to 168 at launch; there the d=128 consumers spilled, and ptxas gave
  // them no more after setmaxnreg.  At d=64 a feeding warp 0 cost 20 %
  // (it holds its warpgroup back).
  static constexpr bool kProducerWg = D == 64;
  static constexpr int kThreads = kProducerWg ? 384 : 256;
  static constexpr int kConsumerWarps = 8;
  // dQ's product issued while dV's and dK's run (d=128: after them, fewer
  // registers live at once; chosen while its consumers were held to 168)
  static constexpr bool kOverlap = D == 64;
  // a q step's 64 rows in kHalves parts of kQc rows: S^T, dP^T, P^T, dS^T
  // and their bf16 copies hold kQc / 2 + kQc / 2 + kQc / 4 + kQc / 4
  // registers a thread (d=128: 2 parts, so that they fit beside dK, dV)
  static constexpr int kHalves = D == 64 ? 1 : 2;
  static constexpr int kQc = kBwdRows / kHalves;
  static constexpr int kStages = D == 64 ? APEX_BWD_STAGES64 : 2;
  static constexpr int kKvBufs = D == 64 ? 2 : 1;
  static constexpr int kQBlock = kBwdRows * 128;  // 64 columns of Q or dO
  static constexpr int kKBlock = kBwdKeys * 128;  // of K or V: 16 KB
  static constexpr int kQTile = D / 64 * kQBlock;
  static constexpr int kKTile = D / 64 * kKBlock;
  static constexpr int kDsTile = kBwdKeys * 128;  // dS^T of both warpgroups
  // a consumer warp's output slice: dk and dv of its 16 keys (bf16, 64 D
  // bytes) at a head's end, between them kDqBufs fp32 dq tiles of its 16
  // query rows and its warpgroup's kDqCols columns, in boxes of 16 rows x
  // 128 bytes (2 KB, swizzled)
  static constexpr int kDqBufs = 2;
  // dQ = dS K: at d=64 (kDqOwn) each warpgroup takes every column over its
  // own 64 keys (no exchange between the warpgroups, twice the sums into
  // dq_acc: 5 % faster at GPT's and MHA's shapes); at d=128 half of the
  // columns over all 128 keys, the two exchanging dS^T through shared
  // memory (its dQ tile would not fit the registers there)
  static constexpr bool kDqOwn = D == 64 && APEX_BWD_DQ_OWN64;
  static constexpr int kDqCols = kDqOwn ? D : D / 2;
  static constexpr int kSlice = kDqBufs * 64 * kDqCols > 64 * D
                                    ? kDqBufs * 64 * kDqCols
                                    : 64 * D;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvBufs * kKTile;
  static constexpr int kQ = kV + kKvBufs * kKTile;
  static constexpr int kDo = kQ + kStages * kQTile;
  static constexpr int kDs = kDo + kStages * kQTile;
  static constexpr int kOut = kDs + (DQ ? 2 * kDsTile : 0);
  static constexpr int kLse = kOut + kConsumerWarps * kSlice;  // [kStages][64]
  static constexpr int kDelta = kLse + kStages * kBwdRows * 4;
  static constexpr int kQid = kDelta + kStages * kBwdRows * 4;  // SEG
  static constexpr int kBar = kQid + (SEG ? kStages * kBwdRows * 4 : 0);
  // the head each K/V buffer holds, item * hp + head (-1: no more)
  static constexpr int kItem = kBar + 8 * (2 * kKvBufs + 2 * kStages);
  static constexpr int kEnd = kItem + 4 * kKvBufs;
  static constexpr size_t kBytes = size_t(kEnd) + 1024;
};

// one backward launch's arguments: 4-D TMA maps of the (b, h, s, d) views
// q, k, v and dout (loads), of the contiguous dk and dv (stores, boxes of
// 16 rows) and of the fp32 dq_acc (reduce-adds, 32 columns x 16 rows;
// DQ only), each map's `order_*` as FwdArgs has them (dk and dv share
// theirs); `groups`: b * h / hp; `work`: the launch's zeroed item counter;
// F32 instantiations: dk32 and dv32, the contiguous fp32 dk and dv, in
// place of the dk and dv maps
struct BwdArgs {
  CUtensorMap q, k, v, dout, dk, dv, dq;
  int order_q, order_k, order_v, order_do, order_dkv, order_dq;
  const float* lse;
  const float* delta;
  float* dq_acc;
  float* dk32;
  float* dv32;
  int* work;
  int h, sq, sk, groups;
  float scale, scale_log2;
  int causal;
  const int* q_seg;
  const int* kv_seg;
  long long q_seg_sb, kv_seg_sb;
  Drop drop;  // DROP instantiations
  Bias bias;  // BIAS instantiations
};

// work item w of a backward launch: the items go in chunks of `chunk`
// head groups (about one item per block of the grid: APEX_BWD_CHUNK = 0),
// key tile by key tile within a chunk (the longest causal walks first), so
// the blocks at work share a few heads' Q, dO and dq_acc rows in the L2
// and the last items taken are short.  An item is key tile tk of the hp
// heads (batch * head) bh0 .. bh0 + hp - 1 of one batch row; j0: the
// first q step that sees one of its keys (SEG: every step, see the top).
struct BwdItem {
  int bh0, b, k0, j0;
  __device__ __forceinline__ BwdItem(const BwdArgs& a, int w, int hp,
                                     bool seg) {
    const int n_kt = (a.sk + kBwdKeys - 1) / kBwdKeys;
    int chunk = APEX_BWD_CHUNK > 0 ? APEX_BWD_CHUNK
                                   : static_cast<int>(gridDim.x) / n_kt;
    chunk = max(1, min(chunk, a.groups));
    const int c = w / (chunk * n_kt);  // the chunk, and its head groups
    const int first = c * chunk, in_c = min(chunk, a.groups - first);
    const int r = w - c * chunk * n_kt;
    const int tk = r / in_c;
    bh0 = (first + r % in_c) * hp;
    b = bh0 / a.h;
    k0 = tk * kBwdKeys;
    j0 = a.causal && !seg ? k0 / kBwdRows : 0;
  }
};

// the 4-byte word at row r (of 64, 128-byte rows) and 16-byte chunk c of a
// swizzled tile whose 1024-byte groups of 8 rows start at `base`
__device__ __forceinline__ unsigned char* swz(unsigned char* base, int r,
                                              int c) {
  return base + r * 128 + ((c ^ (r & 7)) << 4);
}

// the box at `src` to rows [row, row + 16) x columns [d0, ...) of head hh
// of batch row b through `map` (a store, or with `add` a reduce-add)
__device__ __forceinline__ void put_rows(const CUtensorMap* map, int order,
                                         const void* src, int d0, int row,
                                         int hh, int b, bool add) {
  const int ps = order & 3, ph = (order >> 2) & 3;
  const int c1 = ps == 1 ? row : ph == 1 ? hh : b;
  const int c2 = ps == 2 ? row : ph == 2 ? hh : b;
  const int c3 = ps == 3 ? row : ph == 3 ? hh : b;
  if (add)
    hopper::tma_reduce_add_4d(map, src, d0, c1, c2, c3);
  else
    hopper::tma_store_4d(map, src, d0, c1, c2, c3);
}

// A block's share of the backward (one block an SM, for all of the
// launch): work items taken in order from the launch's counter, so a
// block that finishes early takes the next (causal items differ up to
// sk / 64 q steps), each 128 keys of `hp` heads in turn.  Each head is
// the same code whatever hp and DQ are, so its dk and dv are bit for bit
// the same in the fused kernel, the packed kernel and the dk/dv pass
// (which leaves out the dq part: DQ).
//
// One warp feeds the block (`feed`; d=64: warp 0 of a producer
// warpgroup, d=128: warp 0 of the consumers): it loads each head's K and
// V tiles (kKvBufs buffers) and then, for each q step from the first that
// sees the tile, the Q and dO tiles into a ring of kStages, by TMA, with
// the rows' lse, delta and (SEG) query ids copied beside them by its
// lanes' cp.async; each completes on an mbarrier, and the feed runs ahead
// across heads and items as far as the ring and the K/V buffers allow.
// Warpgroups 0 and 1 own 64 keys each, dK and dV in registers.  Per q
// step: S^T = K Q^T and dP^T = V dO^T by wgmma from shared memory; P^T and
// dS^T = P^T (dP^T - delta) in registers, with the mask; dV += P^T dO and
// dK += dS^T Q by wgmma with P^T and dS^T (bf16) in registers and dO, Q as
// MN-major operands.  DQ: dS^T goes to shared memory (double-buffered)
// and dQ = dS K is taken by wgmma (dS^T the MN-major A operand, K the
// MN-major B): at d=64 each warpgroup over its own 64 keys and every
// column, at d=128 each over both warpgroups' 128 keys and half of the
// columns (a named barrier a step between them); each warp scales its 16
// rows into its output slice and reduce-adds them into dq_acc with one
// bulk tensor reduce-add per 32 columns (APEX_BWD_DQ_RED: per-thread
// red.global instead).  At a head's end each warp stores its 16 keys of dk
// (scaled) and dv through its slice by TMA (F32: each thread its own
// column pairs as fp32, straight from its registers).  BIAS (hp = 1, no
// segment ids, bf16 outputs): the bias in every recomputed score; BIAS 2
// writes dbias, "full" with DQ (each score's ds), "sk" without (ds summed
// over the queries, one float a key at the item's end).
template <int D, bool SEG, bool DQ, bool F32, bool DROP, int BIAS = 0>
__device__ __forceinline__ void bwd_items(const BwdArgs& a, int hp,
                                          unsigned char* smem) {
  static_assert(!(BIAS && (SEG || F32)), "no such bias instantiation");
  using L = BwdSmem<D, SEG, DQ>;
  constexpr int kStages = L::kStages, kKvBufs = L::kKvBufs;
  unsigned char* k_s = smem + L::kK;    // [kKvBufs]
  unsigned char* v_s = smem + L::kV;    // [kKvBufs]
  unsigned char* q_s = smem + L::kQ;    // [kStages]
  unsigned char* do_s = smem + L::kDo;  // [kStages]
  unsigned char* ds_s = smem + L::kDs;  // DQ: [2]
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);  // [kStages][64]
  float* dl_s = reinterpret_cast<float*>(smem + L::kDelta);
  int* qid_s = reinterpret_cast<int*>(smem + L::kQid);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = bar;                    // [kKvBufs]
  uint64_t* kv_empty = kv_full + kKvBufs;     // [kKvBufs]
  uint64_t* q_full = kv_empty + kKvBufs;      // [kStages]
  uint64_t* q_empty = q_full + kStages;       // [kStages]
  int* item_s = reinterpret_cast<int*>(smem + L::kItem);  // [kKvBufs]

  const int h = a.h, sq = a.sq, sk = a.sk;
  const bool causal = a.causal != 0;
  const int nq = (sq + kBwdRows - 1) / kBwdRows;
  const int n_items = (sk + kBwdKeys - 1) / kBwdKeys * a.groups;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kKvBufs; ++i) {
      hopper::mbar_init(&kv_full[i], 1);
      hopper::mbar_init(&kv_empty[i], L::kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      // every lane of warp 0 arrives once its rows' lse and delta land
      hopper::mbar_init(&q_full[s], 32);
      hopper::mbar_init(&q_empty[s], L::kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();  // the barriers are visible

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r_a = warp * 16 + g;  // this thread's accumulator rows r_a, r_a + 8

  // ----------------------------------------------------------------- feed
  // Warp 0 issues every load, ahead of both warpgroups: its place in the
  // sequence of heads and q steps (item f_w, head f_p of it, next step
  // f_j; f_bh, f_b: that head and its batch row) and the K/V tiles (f_ki)
  // and q steps (f_qi) issued so far.  feed(q_lim, kv_lim) issues q steps
  // below q_lim and K/V tiles below kv_lim, taking the next item from the
  // launch's counter where a head's steps run out, each once both
  // warpgroups have released the stage or buffer it takes (a producer
  // warp: with no limits, ahead as far as those allow; warp 0 of the
  // consumers: the ring's depth ahead, so that it waits only for a user
  // its own warpgroup is already past).
  int f_w = -1, f_p = 0, f_j = nq, f_bh = 0, f_b = 0, f_ki = 0, f_qi = 0;
  bool f_done = false;
  auto feed = [&](int q_lim, int kv_lim) {
    while (!f_done) {
      if (f_j >= nq) {  // the next head's K and V (or the end)
        if (f_ki >= kv_lim) return;
        const int kb = f_ki % kKvBufs;
        // both warpgroups are done with the head this buffer held
        if (f_ki >= kKvBufs)
          hopper::mbar_wait(&kv_empty[kb], (f_ki / kKvBufs - 1) & 1);
        int w = f_w;
        if (f_w < 0 || f_p + 1 >= hp) {
          if (lane == 0) w = atomicAdd(a.work, 1);
          w = __shfl_sync(kFull, w, 0);
        }
        ++f_ki;
        if (w >= n_items) {  // no more: the consumers read -1
          if (lane == 0) {
            item_s[kb] = -1;
            hopper::mbar_arrive(&kv_full[kb]);
          }
          __syncwarp();
          f_done = true;
          return;
        }
        f_p = w == f_w ? f_p + 1 : 0;
        f_w = w;
        const BwdItem t(a, w, hp, SEG);
        f_bh = t.bh0 + f_p;
        f_b = t.b;
        f_j = t.j0;
        if (lane == 0) {
          item_s[kb] = w * hp + f_p;
          hopper::mbar_arrive_expect_tx(&kv_full[kb], 2 * L::kKTile);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            load_rows(k_s + kb * L::kKTile + c * L::kKBlock, &a.k, a.order_k,
                      &kv_full[kb], 64 * c, t.k0, f_bh % h, t.b);
            load_rows(v_s + kb * L::kKTile + c * L::kKBlock, &a.v, a.order_v,
                      &kv_full[kb], 64 * c, t.k0, f_bh % h, t.b);
          }
        }
        __syncwarp();
        continue;
      }
      if (f_qi >= q_lim) return;
      // q step f_j of head f_bh into stage f_qi % kStages, once both
      // warpgroups are done with the step it held
      const int st = f_qi % kStages;
      if (f_qi >= kStages)
        hopper::mbar_wait(&q_empty[st], (f_qi / kStages - 1) & 1);
      const int q0 = f_j * kBwdRows, hh = f_bh % h;
      if (lane == 0) {
        hopper::mbar_expect_tx(&q_full[st], 2 * L::kQTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          load_rows(q_s + st * L::kQTile + c * L::kQBlock, &a.q, a.order_q,
                    &q_full[st], 64 * c, q0, hh, f_b);
          load_rows(do_s + st * L::kQTile + c * L::kQBlock, &a.dout,
                    a.order_do, &q_full[st], 64 * c, q0, hh, f_b);
        }
      }
      // the rows' lse, delta and ids by cp.async (zeros past sq), each
      // lane's arrival once its copies land: the warp does not wait for
      // them
      const float* lseg = a.lse + (long long)f_bh * sq;
      const float* dlg = a.delta + (long long)f_bh * sq;
      const int* qidg = SEG ? a.q_seg + f_b * a.q_seg_sb : nullptr;
#pragma unroll
      for (int i = lane; i < kBwdRows; i += 32) {
        const bool in = q0 + i < sq;
        const int r = in ? q0 + i : 0;
        hopper::cp_async4(lse_s + st * kBwdRows + i, lseg + r, in);
        hopper::cp_async4(dl_s + st * kBwdRows + i, dlg + r, in);
        if (SEG) hopper::cp_async4(qid_s + st * kBwdRows + i, qidg + r, in);
      }
      hopper::cp_async_mbar_arrive(&q_full[st]);
      __syncwarp();
      ++f_qi;
      ++f_j;
    }
  };
  // ------------------------------------------------------------ consumers
  // feeder: warp 0, where no producer warpgroup feeds
  auto consume = [&](bool feeder) {
    const bool math = APEX_BWD_MATH || sq < 0;
    const bool store_dq = APEX_BWD_STORE_DQ || sq < 0;
    const float scale = a.scale, sl = a.scale_log2;
    const float inv_sk = 1.f / sk;  // a fully masked row's weight per key
    const int c0 = L::kDqOwn ? 0 : wg * (D / 2);  // its first dQ column
    // this warp's output slice (boxes of 16 rows x 128 bytes)
    unsigned char* out_w = smem + L::kOut + (wg * 4 + warp) * L::kSlice;
    int kvc = 0, qc = 0, dqc = 0;
    for (;; ++kvc) {
      if (feeder) feed(qc + kStages, kvc + kKvBufs);
      // the head the next K/V buffer holds: head v % hp of item v / hp
      // (-1: none); one head a pass, so the packed kernel's loop is the
      // unpacked kernel's
      const int kb = kvc % kKvBufs;
      hopper::mbar_wait(&kv_full[kb], (kvc / kKvBufs) & 1);
      const int v = item_s[kb];
      if (v < 0) break;
      const BwdItem t(a, v / hp, hp, SEG);
      const int bh = t.bh0 + v % hp, hh = bh % h;
      const int k0w = t.k0 + wg * 64;  // the warpgroup's first key
      const int key_a = k0w + r_a, key_b = key_a + 8;  // this thread's keys
      // SEG: the keys' ids, and whether the warpgroup's 64 keys (those
      // before sk) all carry one id kc (every warp reads all 64: the same
      // answer in every warp of the warpgroup)
      int kid_a = 0, kid_b = 0, kc = 0;
      bool keys_one = false;
      if (SEG) {
        const int* kidg = a.kv_seg + t.b * a.kv_seg_sb;
        if (key_a < sk) kid_a = kidg[key_a];
        if (key_b < sk) kid_b = kidg[key_b];
        kc = k0w < sk ? kidg[k0w] : 0;
        const int x = k0w + lane, y = x + 32;
        const int ix = x < sk ? kidg[x] : kc, iy = y < sk ? kidg[y] : kc;
        keys_one = __all_sync(kFull, (ix == kc) & (iy == kc));
      }
      const unsigned char* ks = k_s + kb * L::kKTile;
      const unsigned char* vs = v_s + kb * L::kKTile;
      // BIAS: the head's bias and 1 / scale; BIAS 2 with DQ: its "full"
      // dbias partial, without: this thread's sums of its two keys' ds
      // ("sk")
      const float* hb = BIAS ? bias_head(a.bias, bh, h) : nullptr;
      const float inv_scale = 1.f / scale;
      float* dbh = BIAS == 2 && DQ ? a.bias.db + (long long)bh * sq * sk
                                   : nullptr;
      float db_a = 0.f, db_b = 0.f;
      // dk[4n + e], dv[4n + e]: keys r_a (e < 2) and r_a + 8 of the
      // warpgroup's 64, d column 8n + 2 t4 + (e & 1)
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

      for (int j = t.j0; j < nq; ++j, ++qc) {
        const int s = qc % kStages;
        const int q0 = j * kBwdRows;
        const unsigned char* qs = q_s + s * L::kQTile;
        const unsigned char* dos = do_s + s * L::kQTile;
        unsigned char* dsb = ds_s + (qc & 1) * L::kDsTile;
        if (feeder) feed(qc + kStages, kvc + kKvBufs);
        hopper::mbar_wait(&q_full[s], (qc / kStages) & 1);
        // a tile none of whose scores counts (all its keys past sk, or
        // above the diagonal of all its rows without segment ids) adds 0
        // everywhere: no products, and with DQ a zero dS^T
        const bool skip =
            !math || k0w >= sk ||
            (causal && !SEG && k0w > q0 + 63);
        const float* ls = lse_s + s * kBwdRows;
        const float* dls = dl_s + s * kBwdRows;
        const int* qid = qid_s + s * kBwdRows;
        bool per_score = false;  // SEG: the tile needs the id compares
        bool edge = false;       // the tile crosses the diagonal or an end
        if (!skip) {
          if (SEG) {  // warpgroup-uniform: the same smem and registers
            const bool q_one = __all_sync(
                kFull, (q0 + lane >= sq || qid[lane] == kc) &
                           (q0 + lane + 32 >= sq || qid[lane + 32] == kc));
            per_score = !(keys_one && q_one) || (causal && k0w + 63 > q0);
          }
          edge = (k0w + 64 > sk) || (q0 + kBwdRows > sq) ||
                 (causal && k0w + 63 > q0);
        }
        // DQ: this warpgroup's dS^T
        unsigned char* dsw = dsb + wg * 64 * 128;
        // the step's kHalves parts of kQc query rows, in turn (DROP: two
        // parts at d=64 too; in one, ptxas spilled at the 168 registers a
        // thread has, even with the keep bits taken before the products)
        constexpr int kHalves = DROP ? 2 : L::kHalves;
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          constexpr int kQc = kBwdRows / kHalves;
          const int qh = hf * kQc;  // the part's first row in the step
          // P^T and dS^T rounded to bf16, as the m16n8k16 A fragments of
          // the part's queries 16kk .. 16kk + 15
          uint32_t pa[kQc / 16][4], da[kQc / 16][4];
          if (!skip) {
            // DROP: the part's keep bits, bit 4n + e for score 4n + e
            // (a rolled loop: few of the hash's temporaries live at once)
            uint32_t kbits = 0;
            if constexpr (DROP) {
              const uint32_t hd = drop_head(a.drop, bh);
#pragma unroll 1
              for (int n = 0; n < kQc / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  kbits |= uint32_t(drop_keep(
                               a.drop, hd + drop_key(a.drop, e < 2 ? key_a
                                                                   : key_b) +
                                           drop_row(a.drop, q0 + qh + 8 * n +
                                                                2 * t4 +
                                                                (e & 1))))
                           << (4 * n + e);
            }
            // sc[4n + e], dp[4n + e]: keys r_a (e < 2) and r_a + 8, query
            // qh + 8n + 2 t4 + (e & 1) of the step
            float sc[kQc / 2], dp[kQc / 2];
            if (BIAS) {
              // S^T accumulates onto bias^T / scale (see the top): keys
              // key_a, key_b, queries qh + 8n + 2 t4 (+ 1)
#pragma unroll
              for (int n = 0; n < kQc / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int row = q0 + qh + 8 * n + 2 * t4 + (e & 1);
                  const int key = e < 2 ? key_a : key_b;
                  sc[4 * n + e] =
                      key < sk && row < sq
                          ? __ldg(hb + (long long)row * a.bias.sq + key) *
                                inv_scale
                          : 0.f;
                }
              }
            }
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              const int ko =
                  (kk / 4) * L::kKBlock + wg * 64 * 128 + (kk % 4) * 32;
              const int qo = (kk / 4) * L::kQBlock + qh * 128 + (kk % 4) * 32;
              hopper::wgmma_ss_bf16<0, 0>(
                  sc, hopper::wgmma_desc(ks + ko, 16, 1024),
                  hopper::wgmma_desc(qs + qo, 16, 1024), BIAS != 0 || kk > 0);
            }
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              const int ko =
                  (kk / 4) * L::kKBlock + wg * 64 * 128 + (kk % 4) * 32;
              const int qo = (kk / 4) * L::kQBlock + qh * 128 + (kk % 4) * 32;
              hopper::wgmma_ss_bf16<0, 0>(
                  dp, hopper::wgmma_desc(vs + ko, 16, 1024),
                  hopper::wgmma_desc(dos + qo, 16, 1024), kk > 0);
            }
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(sc);
            hopper::fence_regs(dp);

            if (per_score) {
              // selects, not branches (see the forward)
#pragma unroll
              for (int n = 0; n < kQc / 8; ++n) {
                const int qcol = qh + 8 * n + 2 * t4;
                const float2 l2 =
                    *reinterpret_cast<const float2*>(ls + qcol);
                const float2 d2 =
                    *reinterpret_cast<const float2*>(dls + qcol);
                const int2 i2 = *reinterpret_cast<const int2*>(qid + qcol);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int row = q0 + qcol + (e & 1);
                  const int key = e < 2 ? key_a : key_b;
                  // the row's lse in log2 units
                  const float l = ((e & 1) ? l2.y : l2.x) * kLog2e;
                  const bool out = key >= sk || row >= sq;
                  const bool msk = out ||
                                   (e < 2 ? kid_a : kid_b) !=
                                       ((e & 1) ? i2.y : i2.x) ||
                                   (causal && key > row);
                  float p_ = ex2(fmaf(sc[4 * n + e], sl, -l));
                  p_ = msk ? (!out && l < kDeadLse ? inv_sk : 0.f) : p_;
                  float pv = p_, dpv = dp[4 * n + e];
                  if constexpr (DROP)
                    drop_pair(a.drop, kbits, 4 * n + e, p_, pv, dpv);
                  dp[4 * n + e] =
                      msk ? 0.f : p_ * (dpv - ((e & 1) ? d2.y : d2.x));
                  sc[4 * n + e] = pv;
                }
              }
            } else if (edge) {
              // the whole loop under the test, as in the forward
#pragma unroll
              for (int n = 0; n < kQc / 8; ++n) {
                const int qcol = qh + 8 * n + 2 * t4;
                const float2 l2 =
                    *reinterpret_cast<const float2*>(ls + qcol);
                const float2 d2 =
                    *reinterpret_cast<const float2*>(dls + qcol);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int row = q0 + qcol + (e & 1);
                  const int key = e < 2 ? key_a : key_b;
                  float p_ = ex2(fmaf(sc[4 * n + e], sl,
                                      -((e & 1) ? l2.y : l2.x) * kLog2e));
                  p_ = key >= sk || row >= sq || (causal && key > row) ? 0.f
                                                                        : p_;
                  float pv = p_, dpv = dp[4 * n + e];
                  if constexpr (DROP)
                    drop_pair(a.drop, kbits, 4 * n + e, p_, pv, dpv);
                  dp[4 * n + e] = p_ * (dpv - ((e & 1) ? d2.y : d2.x));
                  sc[4 * n + e] = pv;
                }
              }
            } else {
#pragma unroll
              for (int n = 0; n < kQc / 8; ++n) {
                const int qcol = qh + 8 * n + 2 * t4;
                const float2 l2 =
                    *reinterpret_cast<const float2*>(ls + qcol);
                const float2 d2 =
                    *reinterpret_cast<const float2*>(dls + qcol);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float p_ =
                      ex2(fmaf(sc[4 * n + e], sl,
                               -((e & 1) ? l2.y : l2.x) * kLog2e));
                  float pv = p_, dpv = dp[4 * n + e];
                  if constexpr (DROP)
                    drop_pair(a.drop, kbits, 4 * n + e, p_, pv, dpv);
                  dp[4 * n + e] = p_ * (dpv - ((e & 1) ? d2.y : d2.x));
                  sc[4 * n + e] = pv;
                }
              }
            }
            if (BIAS == 2) {
              // dbias: ds (0 wherever masked), the "full" partial's score
              // (DQ) or the "sk" sums of this thread's two keys
#pragma unroll
              for (int n = 0; n < kQc / 8; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int row = q0 + qh + 8 * n + 2 * t4 + (e & 1);
                  const int key = e < 2 ? key_a : key_b;
                  if (DQ) {
                    if (key < sk && row < sq)
                      dbh[(long long)row * sk + key] = dp[4 * n + e];
                  } else if (e < 2) {
                    db_a += dp[4 * n + e];
                  } else {
                    db_b += dp[4 * n + e];
                  }
                }
              }
            }
#pragma unroll
            for (int kk = 0; kk < kQc / 16; ++kk) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                pa[kk][i] =
                    pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
                da[kk][i] =
                    pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
              }
            }
          }
          if constexpr (DQ) {
            // dS^T to shared memory: row r_a (+8) of the warpgroup's keys,
            // queries qh + 16kk + 8 (i >> 1) + 2 t4 (chunk qh / 8 + 2kk +
            // (i >> 1))
#pragma unroll
            for (int kk = 0; kk < kQc / 16; ++kk)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                *reinterpret_cast<uint32_t*>(
                    swz(dsw, r_a + (i & 1) * 8, qh / 8 + 2 * kk + (i >> 1)) +
                    4 * t4) = skip ? 0u : da[kk][i];
          }
          if (!skip) {
            hopper::fence_regs(dk);
            hopper::fence_regs(dv);
            hopper::wgmma_fence();  // P^T, dS^T and dK, dV are in registers
#pragma unroll
            for (int kk = 0; kk < kQc / 16; ++kk)
              hopper::wgmma_rs_bf16<1>(
                  dv, pa[kk],
                  hopper::wgmma_desc(dos + (qh / 16 + kk) * 2048, L::kQBlock,
                                     1024),
                  1);
#pragma unroll
            for (int kk = 0; kk < kQc / 16; ++kk)
              hopper::wgmma_rs_bf16<1>(
                  dk, da[kk],
                  hopper::wgmma_desc(qs + (qh / 16 + kk) * 2048, L::kQBlock,
                                     1024),
                  1);
            hopper::wgmma_commit();
            // the next part redefines pa and da: this part's products
            // must have read them
            if (hf + 1 < kHalves) {
              hopper::wgmma_wait<0>();
              hopper::fence_regs(dk);
              hopper::fence_regs(dv);
            }
          }
        }
        if constexpr (DQ) hopper::fence_proxy_async();  // for wgmma's reads
        // dq[4n + e]: query rows r_a (e < 2) and r_a + 8 of the step,
        // column c0 + 8n + 2 t4 + (e & 1)
        float dq[L::kDqCols / 2];
        if constexpr (DQ) {
          if (!L::kOverlap) {
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dk);
            hopper::fence_regs(dv);
          }
          // both warpgroups' dS^T are in shared memory
          if (L::kDqOwn)
            hopper::named_barrier_sync(1 + wg, 128);
          else
            hopper::named_barrier_sync(1, 256);
          if (math) {
            // kDqOwn: the warpgroup's own dS^T rows and K rows
            const int own = L::kDqOwn ? wg * 64 * 128 : 0;
            const unsigned char* kc0 =
                ks + (c0 / 64) * L::kKBlock + (c0 % 64) * 2 + own;
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < (L::kDqOwn ? 64 : kBwdKeys) / 16; ++kk)
              hopper::wgmma_ss_bf16<1, 1>(
                  dq,
                  hopper::wgmma_desc(dsb + own + kk * 2048, L::kDsTile,
                                     1024),
                  hopper::wgmma_desc(kc0 + kk * 2048, L::kKBlock, 1024),
                  kk > 0);
            hopper::wgmma_commit();
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dk);
        hopper::fence_regs(dv);
        if constexpr (DQ) hopper::fence_regs(dq);
        // Q and dO are read: the stage may be refilled
        if (lane == 0) hopper::mbar_arrive(&q_empty[s]);
        __syncwarp();

        if constexpr (DQ) {
          if (store_dq) {
            const int qa = q0 + r_a;
            if (APEX_BWD_DQ_RED) {
              float* dqg =
                  a.dq_acc + ((long long)bh * sq) * D + c0 + 2 * t4;
#pragma unroll
              for (int n = 0; n < L::kDqCols / 8; ++n) {
                if (qa < sq)
                  atomicAdd(reinterpret_cast<float2*>(
                                dqg + (long long)qa * D + 8 * n),
                            make_float2(scale * dq[4 * n],
                                        scale * dq[4 * n + 1]));
                if (qa + 8 < sq)
                  atomicAdd(reinterpret_cast<float2*>(
                                dqg + (long long)(qa + 8) * D + 8 * n),
                            make_float2(scale * dq[4 * n + 2],
                                        scale * dq[4 * n + 3]));
              }
            } else {
              // the slice's buffer is free once the reduce-add that read it
              // kDqBufs steps ago (or the previous head's stores) has
              if (lane == 0) {
                if (j == t.j0)
                  hopper::bulk_wait_read<0>();
                else
                  hopper::bulk_wait_read<L::kDqBufs - 1>();
              }
              __syncwarp();
              // fp32 boxes of 32 columns x 16 rows; column c0 + 8n + 2 t4
              // is in box n / 4, chunk 2 (n % 4) + (t4 >> 1)
              unsigned char* buf =
                  out_w + (dqc % L::kDqBufs) * (L::kDqCols / 32) * 2048;
#pragma unroll
              for (int n = 0; n < L::kDqCols / 8; ++n) {
                unsigned char* box = buf + (n / 4) * 2048;
                const int ch = 2 * (n % 4) + (t4 >> 1);
                *reinterpret_cast<float2*>(swz(box, g, ch) + 8 * (t4 & 1)) =
                    make_float2(scale * dq[4 * n], scale * dq[4 * n + 1]);
                *reinterpret_cast<float2*>(swz(box, g + 8, ch) +
                                           8 * (t4 & 1)) =
                    make_float2(scale * dq[4 * n + 2], scale * dq[4 * n + 3]);
              }
              hopper::fence_proxy_async();
              __syncwarp();
              if (lane == 0) {
#pragma unroll
                for (int x = 0; x < L::kDqCols / 32; ++x)
                  put_rows(&a.dq, a.order_dq, buf + x * 2048, c0 + 32 * x,
                           q0 + warp * 16, hh, t.b, true);
                hopper::bulk_commit();
              }
              __syncwarp();
              ++dqc;
            }
          }
        }
      }
      // K and V are no longer read (the head's last products are done)
      if (lane == 0) hopper::mbar_arrive(&kv_empty[kb]);
      __syncwarp();
      if (BIAS == 2 && !DQ) {
        // "sk" dbias: the four lanes of a key add their sums, one stores
#pragma unroll
        for (int o_ = 1; o_ <= 2; o_ <<= 1) {
          db_a += __shfl_xor_sync(kFull, db_a, o_);
          db_b += __shfl_xor_sync(kFull, db_b, o_);
        }
        float* dbg = a.bias.db + (long long)bh * sk;
        if (t4 == 0 && key_a < sk) dbg[key_a] = db_a;
        if (t4 == 0 && key_b < sk) dbg[key_b] = db_b;
      }

      if constexpr (F32) {
        // dk (scaled) and dv as fp32: columns 8n + 2 t4 and + 1 of keys
        // key_a and key_b, one 8-byte store each (keys past sk are not
        // written); the slice is not used
        float* dkg = a.dk32 + (long long)bh * sk * D + 2 * t4;
        float* dvg = a.dv32 + (long long)bh * sk * D + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          if (key_a < sk) {
            *reinterpret_cast<float2*>(dkg + (long long)key_a * D + 8 * n) =
                make_float2(scale * dk[4 * n], scale * dk[4 * n + 1]);
            *reinterpret_cast<float2*>(dvg + (long long)key_a * D + 8 * n) =
                make_float2(dv[4 * n], dv[4 * n + 1]);
          }
          if (key_b < sk) {
            *reinterpret_cast<float2*>(dkg + (long long)key_b * D + 8 * n) =
                make_float2(scale * dk[4 * n + 2], scale * dk[4 * n + 3]);
            *reinterpret_cast<float2*>(dvg + (long long)key_b * D + 8 * n) =
                make_float2(dv[4 * n + 2], dv[4 * n + 3]);
          }
        }
        continue;
      }
      // dk (scaled) and dv: this warp's 16 keys through its slice, boxes
      // of 64 columns x 16 rows; column 8n + 2 t4 is in box n / 8, chunk
      // n % 8
      if (lane == 0) hopper::bulk_wait_read<0>();
      __syncwarp();
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        unsigned char* bk = out_w + (n / 8) * 2048;
        unsigned char* bv = bk + (D / 64) * 2048;
        *reinterpret_cast<uint32_t*>(swz(bk, g, n % 8) + 4 * t4) =
            pack_bf16(scale * dk[4 * n], scale * dk[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(swz(bk, g + 8, n % 8) + 4 * t4) =
            pack_bf16(scale * dk[4 * n + 2], scale * dk[4 * n + 3]);
        *reinterpret_cast<uint32_t*>(swz(bv, g, n % 8) + 4 * t4) =
            pack_bf16(dv[4 * n], dv[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(swz(bv, g + 8, n % 8) + 4 * t4) =
            pack_bf16(dv[4 * n + 2], dv[4 * n + 3]);
      }
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          put_rows(&a.dk, a.order_dkv, out_w + x * 2048, 64 * x,
                   k0w + warp * 16, hh, t.b, false);
          put_rows(&a.dv, a.order_dkv, out_w + (D / 64 + x) * 2048, 64 * x,
                   k0w + warp * 16, hh, t.b, false);
        }
        hopper::bulk_commit();
      }
      __syncwarp();
    }
    if (lane == 0) hopper::bulk_wait_all();  // the last stores are complete
  };

  if constexpr (L::kProducerWg) {
    // the role from warp 0's lane: warp-uniform to the compiler, and the
    // two branches apart to the end, so ptxas keeps the consumers' code
    // free of spills
    const int role = __shfl_sync(kFull, static_cast<int>(threadIdx.x / 128),
                                 0);
    if (role == 2) {
      // one warp feeds until the items run out, waiting on the empty
      // barriers alone
      hopper::setmaxnreg_dec<40>();
      if (threadIdx.x < 256 + 32) feed(1 << 30, 1 << 30);
    } else {
      hopper::setmaxnreg_inc<232>();
      consume(false);
    }
  } else {
    consume(threadIdx.x < 32);
  }
}

// one block an SM, walking the work items of (128 keys, batch*head); DQ:
// the fused kernel, else the split route's dk/dv pass; F32: dk and dv in
// fp32
template <int D, bool SEG, bool DQ, bool F32, bool DROP>
__global__ void __launch_bounds__(BwdSmem<D, SEG, DQ>::kThreads, 1)
    flash_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  bwd_items<D, SEG, DQ, F32, DROP>(a, 1, hopper::align1024(smem_raw));
}

// the fused kernel (DQ) or the dk/dv pass with an additive bias (hp = 1,
// no segment ids, bf16 outputs); BIAS 2: and its dbias
template <int D, bool DQ, bool DROP, int BIAS>
__global__ void __launch_bounds__(BwdSmem<D, false, DQ>::kThreads, 1)
    flash_bwd_bias_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  bwd_items<D, false, DQ, false, DROP, BIAS>(a, 1,
                                             hopper::align1024(smem_raw));
}

// the port of _bwd_fused_kernel_packed: one block an SM, walking the work
// items of (128 keys, group of hp heads of one batch row), the heads in
// turn, dq by the same reduce-adds
template <int D, bool SEG, bool DROP>
__global__ void __launch_bounds__(BwdSmem<D, SEG, true>::kThreads, 1)
    flash_bwd_packed_kernel(const __grid_constant__ BwdArgs a, int hp) {
  extern __shared__ unsigned char smem_raw[];
  bwd_items<D, SEG, true, false, DROP>(a, hp, hopper::align1024(smem_raw));
}

// ---------------------------------------------------- backward, dq pass ----

// The dq pass's shape at head_dim D: kWgs consumer warpgroups of 64 query
// rows each (the wgmma M dimension is rows, as in the forward) and one
// producer warpgroup, with the forward's setmaxnreg split; key tiles of
// kKeys keys.  A consumer thread holds dQ (D / 2 fp32) over an item's key
// tiles beside a tile's S and dP (kKeys / 2 each) and dS in bf16 (kKeys /
// 4): at 64 keys 96 registers at d=64 and 128 at d=128.  d=64 takes three
// consumer warpgroups (512 threads, so 128 registers a thread: no spills),
// each K and V tile serving 192 rows (faster than two: PERF.md); d=128's
// dQ leaves room for two.  128-key tiles spilled at d=64.
// Shared memory from its 1024-byte aligned start: Q[2] and dO[2] (an
// item's kRows rows, D / 64 column blocks of 128-byte swizzled rows, as
// TMA lands them), kStages K and V tiles, the rows' lse, delta and (SEG)
// query ids [2][kRows], (SEG) the staged key ids [kStages][kKeys], then the
// barriers and each Q buffer's item.  A warpgroup's dq leaves through its
// own rows of the item's Q buffer, which its score products have read by
// then, by TMA stores.  d=64: 6 stages (about 199 KB); d=128: 2 (about
// 196 KB); apex_flash_attn_bwd_dq_smem gives each.  -D overrides that
// build scripts/port_hopper_ablation.py's variants; the defaults are the
// kernel.  The two that make dq garbage (no products and math, no dq
// store) switch their code off at run time (`|| sq < 0`), as the
// forward's do.
#ifndef APEX_DQ_KEYS64  // keys per K/V tile at d=64
#define APEX_DQ_KEYS64 64
#endif
#ifndef APEX_DQ_WGS64  // consumer warpgroups at d=64
#define APEX_DQ_WGS64 3
#endif
#ifndef APEX_DQ_STAGES64  // the K/V ring's depth at d=64
#define APEX_DQ_STAGES64 6
#endif
#ifndef APEX_DQ_MATH  // 0: the pipeline alone
#define APEX_DQ_MATH 1
#endif
#ifndef APEX_DQ_STORE  // 0: dq is not stored
#define APEX_DQ_STORE 1
#endif

// DROP at d=128 takes key tiles of 32 (its dQ, S and dP with 64 keys
// spilled at 168 registers); its dynamic shared memory is then less than
// apex_flash_attn_bwd_dq_smem gives
template <int D, bool SEG, bool DROP = false>
struct DqSmem {
  static constexpr int kWgs = D == 64 ? APEX_DQ_WGS64 : 2;
  static constexpr int kRows = 64 * kWgs;  // query rows per work item
  static constexpr int kKeys = D == 64 ? APEX_DQ_KEYS64 : DROP ? 32 : 64;
  static constexpr int kThreads = 128 * (kWgs + 1);
  static constexpr int kConsumerWarps = 4 * kWgs;
  static constexpr int kProducerRegs = kWgs == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kWgs == 3 ? 160 : 232;
  static constexpr int kStages = D == 64 ? APEX_DQ_STAGES64 : 2;
  static constexpr int kQBlock = kRows * 128;  // 64 columns of Q or dO
  static constexpr int kKBlock = kKeys * 128;  // of K or V
  static constexpr int kQTile = D / 64 * kQBlock;
  static constexpr int kKTile = D / 64 * kKBlock;
  static constexpr int kQ = 0, kDo = 2 * kQTile;
  static constexpr int kK = kDo + 2 * kQTile;
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kStats = kV + kStages * kKTile;
  static constexpr int kKid = kStats + (SEG ? 3 : 2) * 2 * kRows * 4;
  static constexpr int kBar = kKid + (SEG ? kStages * kKeys * 4 : 0);
  static constexpr int kItem = kBar + (4 + 2 * kStages) * 8;
  static constexpr int kEnd = kItem + 2 * 4;
  // the dynamic shared memory, with the alignment slack
  static constexpr size_t kBytes = size_t(kEnd) + 1024;
};

// one dq-pass launch's arguments: the forward's (the q, k and v maps, lse,
// the shape and the segment ids; o is not used), 4-D TMA maps of the (b, h,
// s, d) view dout (loads) and of the contiguous dq (stores, boxes of 64
// rows), each map's `order_*` as FwdArgs has them, the rows' delta and the
// launch's zeroed item counter; F32 instantiations: dq32, the contiguous
// fp32 dq, in place of the dq map
struct DqArgs : FwdArgs {
  CUtensorMap dout, dq;
  int order_do, order_dq;
  const float* delta;
  float* dq32;
  int* work;
  float scale;
};

// A block's share of the dq pass (one block an SM, for all of the launch):
// work items of kRows query rows of one head, taken in order from the
// launch's counter (FwdItem's order: the longest causal rows first, so a
// block that finishes early takes the next), each walked over its key
// tiles up to the diagonal when causal, with segment ids too (ds = 0 at
// every masked score; see the top).  The forward's pipeline: warpgroup
// kWgs produces, one warp loading each item's Q and dO into one of two
// buffers by TMA with the rows' lse, delta and (SEG) query ids beside them
// by 4-byte cp.async, and the item's K and V tiles through a ring (SEG:
// their key ids staged beside them), each completing on an mbarrier.
// Consumer warpgroup wg owns the item's rows wg * 64 .. wg * 64 + 63: per
// key tile, S = Q K^T and dP = dO V^T by wgmma from shared memory, then P
// and dS = P (dP - delta) in registers (the mask only on tiles that cross
// the diagonal or the ragged end of the keys, or (SEG) hold more than one
// id: warp-uniform tests), then dQ += bf16(dS) K by wgmma with dS in
// registers and K (keys x d, row-major) as the MN-major operand, as the
// forward's P V takes V.  dQ stays in registers over the item's tiles and
// leaves scaled, each row once: no atomics, no scratch buffer, the same
// bits on every run (F32: as fp32, each thread its own column pairs
// straight from its registers).  BIAS (no segment ids, bf16 dq): the
// bias in every recomputed score; BIAS 2 writes each score's ds as the
// "full" dbias partial.
template <int D, bool SEG, bool F32, bool DROP, int BIAS = 0>
__device__ __forceinline__ void dq_items(const DqArgs& a,
                                         unsigned char* smem) {
  static_assert(!(BIAS && (SEG || F32)), "no such bias instantiation");
  using L = DqSmem<D, SEG, DROP>;
  constexpr int kStages = L::kStages, kWgs = L::kWgs, kKeys = L::kKeys;
  constexpr int kRows = L::kRows;
  unsigned char* q_s = smem + L::kQ;    // [2]
  unsigned char* do_s = smem + L::kDo;  // [2]
  unsigned char* k_s = smem + L::kK;    // [kStages]
  unsigned char* v_s = smem + L::kV;    // [kStages]
  float* lse_s = reinterpret_cast<float*>(smem + L::kStats);  // [2][kRows]
  float* dl_s = lse_s + 2 * kRows;                            // [2][kRows]
  int* qid_s = reinterpret_cast<int*>(dl_s + 2 * kRows);      // SEG
  int* kid_s = reinterpret_cast<int*>(smem + L::kKid);  // SEG: [kStages][kKeys]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bar;                  // [2]
  uint64_t* q_empty = bar + 2;             // [2]
  uint64_t* kv_full = bar + 4;             // [kStages]
  uint64_t* kv_empty = kv_full + kStages;  // [kStages]
  int* item_s = reinterpret_cast<int*>(smem + L::kItem);  // [2]: -1, no more

  const int h = a.h, sq = a.sq, sk = a.sk;
  const bool causal = a.causal != 0;
  const int nq = (sq + kRows - 1) / kRows;
  const int n_items = nq * a.groups;
  // the warpgroup, and below the item and the tiles a warpgroup computes,
  // through a shuffle from lane 0: warp-uniform to the compiler, so ptxas
  // does not take the branches around the products for divergent paths
  // (where it serialised every wgmma: note C7520)
  const int wg = __shfl_sync(kFull, static_cast<int>(threadIdx.x / 128), 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      // every producer lane arrives once its cp.async copies land, lane 0
      // once more with the item and the TMA bytes
      hopper::mbar_init(&q_full[i], 33);
      // each consumer warpgroup once its dq stores have read the buffer
      hopper::mbar_init(&q_empty[i], kWgs);
    }
    for (int s = 0; s < kStages; ++s) {
      // staged ids: every producer lane arrives after writing its ids
      hopper::mbar_init(&kv_full[s], SEG ? 32 : 1);
      hopper::mbar_init(&kv_empty[s], L::kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();  // the barriers are visible

  if (wg == kWgs) {  // --------------------------------------- producer
    hopper::setmaxnreg_dec<L::kProducerRegs>();
    if (threadIdx.x >= 128 * kWgs + 32) return;  // one warp produces
    const int lane = threadIdx.x & 31;
    int fill = 0;  // K/V tiles issued so far: tile f uses stage f % kStages
    // item qc into Q buffer qc & 1, once both warpgroups are done with the
    // item it held; the last one is the -1 that ends the consumers
    for (int qc = 0;; ++qc) {
      const int qb = qc & 1;
      if (qc >= 2) hopper::mbar_wait(&q_empty[qb], ((qc >> 1) - 1) & 1);
      int w = 0;
      if (lane == 0) w = atomicAdd(a.work, 1);
      w = __shfl_sync(kFull, w, 0);
      const bool done = w >= n_items;
      const FwdItem t(a, done ? 0 : w, 1, nq, kRows, false, kKeys);
      const int hh = t.bh0 % h;
      if (!done) {
        // the rows' lse, delta and ids (zeros past sq); the warp does not
        // wait for them
        const float* lseg = a.lse + (long long)t.bh0 * sq;
        const float* dlg = a.delta + (long long)t.bh0 * sq;
        const int* qidg = SEG ? a.q_seg + t.b * a.q_seg_sb : nullptr;
#pragma unroll
        for (int i = lane; i < kRows; i += 32) {
          const bool in = t.q0 + i < sq;
          const int r = in ? t.q0 + i : 0;
          hopper::cp_async4(lse_s + qb * kRows + i, lseg + r, in);
          hopper::cp_async4(dl_s + qb * kRows + i, dlg + r, in);
          if (SEG) hopper::cp_async4(qid_s + qb * kRows + i, qidg + r, in);
        }
      }
      hopper::cp_async_mbar_arrive(&q_full[qb]);
      if (lane == 0) {
        item_s[qb] = done ? -1 : w;
        hopper::mbar_arrive_expect_tx(&q_full[qb], done ? 0 : 2 * L::kQTile);
        if (!done) {
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            load_rows(q_s + qb * L::kQTile + c * L::kQBlock, &a.q, a.order_q,
                      &q_full[qb], 64 * c, t.q0, hh, t.b);
            load_rows(do_s + qb * L::kQTile + c * L::kQBlock, &a.dout,
                      a.order_do, &q_full[qb], 64 * c, t.q0, hh, t.b);
          }
        }
      }
      __syncwarp();
      if (done) break;
      const int* kidg = SEG ? a.kv_seg + t.b * a.kv_seg_sb : nullptr;
      for (int it = 0; it < t.n_kv; ++it, ++fill) {
        const int s = fill % kStages;
        // both consumers are done with the tile this stage held
        if (fill >= kStages)
          hopper::mbar_wait(&kv_empty[s], (fill / kStages - 1) & 1);
        const int k0 = it * kKeys;
        if (SEG) {
#pragma unroll
          for (int i = lane; i < kKeys; i += 32)
            kid_s[s * kKeys + i] = k0 + i < sk ? kidg[k0 + i] : 0;
          if (lane != 0) hopper::mbar_arrive(&kv_full[s]);
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&kv_full[s], 2 * L::kKTile);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            load_rows(k_s + s * L::kKTile + c * L::kKBlock, &a.k, a.order_k,
                      &kv_full[s], 64 * c, k0, hh, t.b);
            load_rows(v_s + s * L::kKTile + c * L::kKBlock, &a.v, a.order_v,
                      &kv_full[s], 64 * c, k0, hh, t.b);
          }
        }
        __syncwarp();
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  hopper::setmaxnreg_inc<L::kConsumerRegs>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool math = APEX_DQ_MATH || sq < 0;
  const bool store = APEX_DQ_STORE || sq < 0;
  const float sl = a.scale_log2, scale = a.scale;
  // the warp is done with the tile in stage s: it may be refilled
  auto release = [&](int s) {
    if (lane == 0) hopper::mbar_arrive(&kv_empty[s]);
    __syncwarp();
  };
  int fill = 0;
  for (int qc = 0;; ++qc) {
    const int qb = qc & 1;
    hopper::mbar_wait(&q_full[qb], (qc >> 1) & 1);
    const int w = __shfl_sync(kFull, item_s[qb], 0);
    if (w < 0) break;
    const FwdItem t(a, w, 1, nq, kRows, false, kKeys);
    const int hh = t.bh0 % h;
    const int wrow0 = t.q0 + wg * 64;  // the warpgroup's first query row
    const int r0 = wrow0 + warp * 16;  // the warp's first query row
    const int ra = wg * 64 + warp * 16 + g;  // this thread's rows ra, ra + 8
    const int row_a = t.q0 + ra, row_b = row_a + 8;  // of the item
    // the rows' lse (log2 units), delta and ids, from the item's buffer
    const float lse_a = lse_s[qb * kRows + ra] * kLog2e;
    const float lse_b = lse_s[qb * kRows + ra + 8] * kLog2e;
    const float dl_a = dl_s[qb * kRows + ra], dl_b = dl_s[qb * kRows + ra + 8];
    int qid_a = 0, qid_b = 0;
    if (SEG) {
      qid_a = qid_s[qb * kRows + ra];
      qid_b = qid_s[qb * kRows + ra + 8];
    }
    // DROP: the hash's head and row terms of this thread's two rows
    uint32_t hr_a = 0, hr_b = 0;
    if constexpr (DROP) {
      hr_a = drop_head(a.drop, t.bh0) + drop_row(a.drop, row_a);
      hr_b = drop_head(a.drop, t.bh0) + drop_row(a.drop, row_b);
    }
    const unsigned char* qs = q_s + qb * L::kQTile;
    const unsigned char* dos = do_s + qb * L::kQTile;
    // BIAS: this thread's two rows of the head's bias, 1 / scale, and (2)
    // the head's "full" dbias partial
    const float* bias_a = nullptr;
    const float* bias_b = nullptr;
    float* dbh = nullptr;
    if (BIAS) {
      const float* hb = bias_head(a.bias, t.bh0, h);
      bias_a = hb + (long long)row_a * a.bias.sq;
      bias_b = hb + (long long)row_b * a.bias.sq;
      if (BIAS == 2) dbh = a.bias.db + (long long)t.bh0 * sq * sk;
    }
    const float inv_scale = 1.f / scale;
    // dq[4n + e]: row ra (e < 2) or ra + 8, d column 8n + 2 t4 + (e & 1)
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    // the tiles this warpgroup computes: the item's, up to the first whose
    // keys all sit above its rows' diagonal (none when its rows are all
    // past sq); the rest would add 0 and are only released, each once it
    // has landed (a release ahead of the producer would count towards the
    // stage's previous use)
    int n_mine = math && wrow0 < sq ? t.n_kv : 0;
    if (causal) n_mine = min(n_mine, (wrow0 + 63) / kKeys + 1);
    n_mine = __shfl_sync(kFull, n_mine, 0);
    // sc[4n + e], dp[4n + e]: row ra (e < 2) or ra + 8, key k0 + 8n + 2 t4
    // + (e & 1) of the tile; da: its dS in bf16
    float sc[kKeys / 2], dp[kKeys / 2];
    uint32_t da[kKeys / 16][4];
    // S = Q K^T and dP = dO V^T of the tile in stage s, by wgmma from
    // shared memory
    auto scores = [&](int s) {
      const unsigned char* ks = k_s + s * L::kKTile;
      const unsigned char* vs = v_s + s * L::kKTile;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int qo = (kk / 4) * L::kQBlock + wg * 64 * 128 + (kk % 4) * 32;
        const int ko = (kk / 4) * L::kKBlock + (kk % 4) * 32;
        hopper::wgmma_ss_bf16<0, 0>(sc, hopper::wgmma_desc(qs + qo, 16, 1024),
                                    hopper::wgmma_desc(ks + ko, 16, 1024),
                                    BIAS != 0 || kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int qo = (kk / 4) * L::kQBlock + wg * 64 * 128 + (kk % 4) * 32;
        const int ko = (kk / 4) * L::kKBlock + (kk % 4) * 32;
        hopper::wgmma_ss_bf16<0, 0>(dp,
                                    hopper::wgmma_desc(dos + qo, 16, 1024),
                                    hopper::wgmma_desc(vs + ko, 16, 1024),
                                    kk > 0);
      }
    };
    // BIAS: sc = the bias of key tile `it` / scale, for the score product
    // to accumulate onto (keys 8n + 2 t4 and + 1: one pair), loaded while
    // no product is in flight
    auto load_bias = [&](int it) {
      if constexpr (BIAS != 0) {
        const int kc = it * kKeys + 2 * t4;
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
          const int key = kc + 8 * n;
          const float2 ba = bias_pair(bias_a, key, key < sk && row_a < sq);
          const float2 bb = bias_pair(bias_b, key, key < sk && row_b < sq);
          sc[4 * n] = ba.x * inv_scale;
          sc[4 * n + 1] = ba.y * inv_scale;
          sc[4 * n + 2] = bb.x * inv_scale;
          sc[4 * n + 3] = bb.y * inv_scale;
        }
      }
    };
    // dQ += dS K for the tile in stage s, dS (da) from registers and K as
    // the MN-major operand
    auto dq_product = [&](int s) {
      const unsigned char* ks = k_s + s * L::kKTile;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        hopper::wgmma_rs_bf16<1>(
            dq, da[kk], hopper::wgmma_desc(ks + kk * 2048, L::kKBlock, 1024),
            1);
    };
    // until the tile that `f` names has landed (waited on with no product
    // in flight)
    auto land = [&](int f) {
      hopper::mbar_wait(&kv_full[f % kStages], (f / kStages) & 1);
    };
    // DROP: tile `it`'s keep bits, bit 4n + e for score 4n + e, taken
    // while no product is in flight and before S and dP are (beside them
    // the hash's temporaries spilled)
    uint32_t kbits = 0;
    auto keep_bits = [&](int it) {
      if constexpr (DROP) {
        kbits = 0;
#pragma unroll 1
        for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            kbits |= uint32_t(drop_keep(
                         a.drop, (e < 2 ? hr_a : hr_b) +
                                     drop_key(a.drop, it * kKeys + 8 * n +
                                                          2 * t4 + (e & 1))))
                     << (4 * n + e);
      }
    };
    // dS = P (dP - delta) of tile `it` (stage s) into da, 0 wherever
    // masked.  The mask only on tiles that cross the ragged end of the
    // keys or the diagonal of the warp's rows, or (SEG) whose keys and rows
    // carry more than one id (warp-uniform tests)
    auto to_ds = [&](int it, int s) {
      const int k0 = it * kKeys;
      const int* kid = kid_s + s * kKeys;
      bool edge = (k0 + kKeys > sk) || (causal && k0 + kKeys - 1 > r0);
      if (SEG) {  // no short-circuit: branches here diverge the warp
        const int c = kid[0];
        bool same = (qid_a == c) & (qid_b == c);
#pragma unroll
        for (int i = 0; i < kKeys / 32; ++i) same &= kid[lane + 32 * i] == c;
        edge = edge || !warp_one_segment(same);
      }
      if (edge) {
        // the whole loop under the test, as in the forward; selects, not
        // branches, and a masked score's p (inf in a dead row) never
        // reaches ds
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
          const int kc = 8 * n + 2 * t4;
          const int2 ids = SEG ? *reinterpret_cast<const int2*>(kid + kc)
                               : make_int2(0, 0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool top = e < 2;
            const int key = k0 + kc + (e & 1);
            const bool masked =
                key >= sk || (causal && key > (top ? row_a : row_b)) ||
                (SEG && ((e & 1) ? ids.y : ids.x) != (top ? qid_a : qid_b));
            const float p =
                ex2(fmaf(sc[4 * n + e], sl, -(top ? lse_a : lse_b)));
            float dpv = dp[4 * n + e];
            if constexpr (DROP)
              dpv = (kbits >> (4 * n + e)) & 1u ? dpv * a.drop.inv : 0.f;
            const float ds = p * (dpv - (top ? dl_a : dl_b));
            dp[4 * n + e] = masked ? 0.f : ds;
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool top = e < 2;
            const float p =
                ex2(fmaf(sc[4 * n + e], sl, -(top ? lse_a : lse_b)));
            float dpv = dp[4 * n + e];
            if constexpr (DROP)
              dpv = (kbits >> (4 * n + e)) & 1u ? dpv * a.drop.inv : 0.f;
            dp[4 * n + e] = p * (dpv - (top ? dl_a : dl_b));
          }
        }
      }
      if (BIAS == 2) {
        // "full" dbias: ds (0 wherever masked) of every score
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * t4 + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (key < sk && row < sq)
              dbh[(long long)row * sk + key] = dp[4 * n + e];
          }
        }
      }
      // rounded to bf16 (as the TPU kernel rounds ds before its product),
      // as the m16n8k16 A fragments of keys 16kk .. 16kk + 15
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        da[kk][0] = pack_bf16(dp[8 * kk], dp[8 * kk + 1]);
        da[kk][1] = pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]);
        da[kk][2] = pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]);
        da[kk][3] = pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]);
      }
    };
    auto wait_products = [&]() {
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::fence_regs(dq);
    };
    // Per tile: S and dP, dS in registers, dQ += dS K.  Each product group
    // is issued and waited for in one straight stretch of code (a product
    // in flight across a branch or a barrier wait made ptxas serialise
    // every wgmma: notes C7518, C7520).
    if (n_mine > 0) {
      land(fill);
      keep_bits(0);
      load_bias(0);
      hopper::wgmma_fence();
      scores(fill % kStages);
      wait_products();
      to_ds(0, fill % kStages);
      for (int it = 1; it < n_mine; ++it) {
        const int f = fill + it;
        land(f);
        hopper::wgmma_fence();  // dS, and sc, dp read by to_ds
        dq_product((f - 1) % kStages);
        wait_products();
        keep_bits(it);
        load_bias(it);
        hopper::wgmma_fence();
        scores(f % kStages);
        wait_products();
        release((f - 1) % kStages);
        to_ds(it, f % kStages);
      }
      hopper::wgmma_fence();
      dq_product((fill + n_mine - 1) % kStages);
      wait_products();
      release((fill + n_mine - 1) % kStages);
    }
    for (int it = n_mine; it < t.n_kv; ++it) {
      land(fill + it);
      release((fill + it) % kStages);
    }
    fill += t.n_kv;

    // dq (scaled, bf16) into this warpgroup's rows of the item's Q buffer
    // (its score products are done with them), then one TMA store per 64
    // columns (rows past sq are dropped); the buffer goes back to the
    // producer once the stores have read it
    unsigned char* ob = q_s + qb * L::kQTile + wg * 64 * 128;
    const bool out = store && wrow0 < sq;
    if constexpr (F32) {
      // F32: columns 8n + 2 t4 and + 1 of rows row_a and row_b as fp32,
      // one 8-byte store each (rows past sq are not written); the Q
      // buffer is not written
      if (out) {
        float* dqg = a.dq32 + (long long)t.bh0 * sq * D + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          if (row_a < sq)
            *reinterpret_cast<float2*>(dqg + (long long)row_a * D + 8 * n) =
                make_float2(scale * dq[4 * n], scale * dq[4 * n + 1]);
          if (row_b < sq)
            *reinterpret_cast<float2*>(dqg + (long long)row_b * D + 8 * n) =
                make_float2(scale * dq[4 * n + 2], scale * dq[4 * n + 3]);
        }
      }
    } else if (out) {
      const int rw = warp * 16 + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        unsigned char* blk = ob + (n / 8) * L::kQBlock;
        *reinterpret_cast<uint32_t*>(swz(blk, rw, n % 8) + 4 * t4) =
            pack_bf16(scale * dq[4 * n], scale * dq[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(swz(blk, rw + 8, n % 8) + 4 * t4) =
            pack_bf16(scale * dq[4 * n + 2], scale * dq[4 * n + 3]);
      }
      hopper::fence_proxy_async();
    }
    hopper::named_barrier_sync(1 + wg, 128);  // the warpgroup's rows are in
    if (threadIdx.x % 128 == 0) {
      if (!F32 && out) {
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          put_rows(&a.dq, a.order_dq, ob + c * L::kQBlock, 64 * c, wrow0, hh,
                   t.b, false);
        hopper::bulk_commit();
        hopper::bulk_wait_read<0>();
      }
      hopper::mbar_arrive(&q_empty[qb]);
    }
    __syncwarp();
  }
  if (threadIdx.x % 128 == 0) hopper::bulk_wait_all();  // the last stores
}

// one block an SM, walking the work items of (DqSmem::kRows query rows,
// batch*head); F32: dq in fp32
template <int D, bool SEG, bool F32, bool DROP>
__global__ void __launch_bounds__(DqSmem<D, SEG, DROP>::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ DqArgs a) {
  extern __shared__ unsigned char smem_raw[];
  dq_items<D, SEG, F32, DROP>(a, hopper::align1024(smem_raw));
}

// the dq pass with an additive bias (no segment ids, bf16 dq); BIAS 2:
// and its "full" dbias
template <int D, bool DROP, int BIAS>
__global__ void __launch_bounds__(DqSmem<D, false, DROP>::kThreads, 1)
    flash_bwd_dq_bias_kernel(const __grid_constant__ DqArgs a) {
  extern __shared__ unsigned char smem_raw[];
  dq_items<D, false, false, DROP, BIAS>(a, hopper::align1024(smem_raw));
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

// The 4-D TMA map of a (b, h, s, d) bf16 view whose (batch, head, seq)
// strides in elements are st[0..2], boxes of 64 d x `rows` rows.  Its
// dimensions, innermost first, are d, then s, h and b in increasing order
// of their strides, an extent of 1 last (given a nested stride: it is only
// read at 0), so the map nests however the view is strided (the training
// path's q, k and v are views of one packed qkv, with the head stride
// below the sequence stride).  `order` gets the slots of s, h and b, as
// load_rows reads them.  `type`: bf16, or fp32 (dq_acc: boxes of 32
// columns, 128 bytes as a bf16 box's 64).  0, or hopper::kTensorMapError +
// the CUresult.
int map_bhsd(CUtensorMap* map, int* order, const void* base,
             const long long* st, int b, int h, int s, int D, int rows,
             CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const int es = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  struct Axis {
    cuuint64_t n, stride;
    int which;  // 0 s, 1 h, 2 b
  };
  Axis ax[3] = {{cuuint64_t(s), cuuint64_t(st[2]) * es, 0},
                {cuuint64_t(h), cuuint64_t(st[1]) * es, 1},
                {cuuint64_t(b), cuuint64_t(st[0]) * es, 2}};
  auto later = [](const Axis& x, const Axis& y) {
    return (x.n == 1) != (y.n == 1) ? x.n == 1 : x.stride > y.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && later(ax[j - 1], ax[j]); --j) {
      const Axis t = ax[j - 1];
      ax[j - 1] = ax[j];
      ax[j] = t;
    }
  cuuint64_t dims[4] = {cuuint64_t(D), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {cuuint32_t(128 / es), 1, 1, 1};
  cuuint64_t span = cuuint64_t(D) * es;
  int ord = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = ax[i].n;
    strides[i] = ax[i].n == 1 ? span : ax[i].stride;
    span = strides[i] * ax[i].n;
    if (ax[i].which == 0) box[i + 1] = rows;
    ord |= (i + 1) << (2 * ax[i].which);
  }
  *order = ord;
  return hopper::make_tensor_map(map, type, 4, base, dims, strides, box);
}

// the segment ids of one call: both null (no segments) or both set
struct Seg {
  const int* q;
  const int* kv;
  long long q_sb, kv_sb;
};

// one forward launch's arguments, its tensor maps built for this call:
// boxes of `rows` query rows and `keys` keys
int fwd_args(FwdArgs* a, int D, int rows, const void* q, const void* k,
             const void* v, void* o, void* lse, const long long* st, int b,
             int h, int sq, int sk, float scale, int causal, int hp, Seg seg,
             Drop drop, int keys = kFwdKeys, Bias bias = Bias{}) {
  int e = map_bhsd(&a->q, &a->order_q, q, st, b, h, sq, D, rows);
  if (e == 0)
    e = map_bhsd(&a->k, &a->order_k, k, st + 3, b, h, sk, D, keys);
  if (e == 0)
    e = map_bhsd(&a->v, &a->order_v, v, st + 6, b, h, sk, D, keys);
  a->o = static_cast<bf16*>(o);
  a->lse = static_cast<float*>(lse);
  a->h = h;
  a->sq = sq;
  a->sk = sk;
  a->groups = b * h / hp;
  a->scale_log2 = scale * kLog2e;
  a->causal = causal;
  a->q_seg = seg.q;
  a->kv_seg = seg.kv;
  a->q_seg_sb = seg.q_sb;
  a->kv_seg_sb = seg.kv_sb;
  a->drop = drop;
  a->bias = bias;
  return e;
}

// a persistent grid over work items of `rows` rows of s (query rows in
// the forward, keys in the backward) x groups of hp heads: one block an
// SM, or one a work item when there are fewer; 0 when the device cannot be
// asked
int item_grid(int b, int h, int s, int hp, int rows) {
  const int sms = hopper::sm_count();
  const long long items = (long long)((s + rows - 1) / rows) * (b * h / hp);
  return static_cast<int>(items < sms ? items : sms);
}

// BIAS: the bias kernel (no segment ids)
template <int D, bool SEG, bool DROP, int BIAS = 0>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const long long* st, int b, int h, int sq, int sk,
               float scale, int causal, Seg seg, Drop drop,
               cudaStream_t stream, Bias bias = Bias{}) {
  using L = FwdSmem<D, SEG>;
  FwdArgs a;
  const int e = fwd_args(&a, D, L::kRows, q, k, v, o, lse, st, b, h, sq, sk,
                         scale, causal, 1, seg, drop, kFwdKeys, bias);
  if (e != 0) return e;
  static bool opted = false;
  constexpr size_t smem = L::kBytes;
  auto kernel = flash_fwd_kernel<D, SEG, DROP>;
  if constexpr (BIAS != 0) kernel = flash_fwd_bias_kernel<D, DROP>;
  const cudaError_t ce = opt_in(kernel, smem, opted);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const int grid = item_grid(b, h, sq, 1, L::kRows);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, L::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool SEG, bool DROP>
int launch_fwd_packed(const void* q, const void* k, const void* v, void* o,
                      void* lse, const long long* st, int b, int h, int sq,
                      int sk, float scale, int causal, int hp, Seg seg,
                      Drop drop, cudaStream_t stream) {
  using L = FwdSmem<D, SEG>;
  FwdArgs a;
  const int e = fwd_args(&a, D, L::kRows, q, k, v, o, lse, st, b, h, sq, sk,
                         scale, causal, hp, seg, drop);
  if (e != 0) return e;
  static bool opted = false;
  constexpr size_t base = L::kBytes;
  // opted in once at the most it can take: resident ids for kIdCache keys
  constexpr size_t most = base + (SEG ? size_t(kIdCache) * sizeof(int) : 0);
  const cudaError_t ce =
      opt_in(flash_fwd_packed_kernel<D, SEG, DROP>, most, opted);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const int res_ids = SEG && sk <= kIdCache;
  const size_t smem =
      base + (res_ids ? size_t((sk + kFwdKeys - 1) / kFwdKeys * kFwdKeys) *
                            sizeof(int)
                      : 0);
  const int grid = item_grid(b, h, sq, hp, L::kRows);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_packed_kernel<D, SEG, DROP><<<grid, L::kThreads, smem, stream>>>(
      a, hp, res_ids);
  return static_cast<int>(cudaGetLastError());
}

// one backward launch's arguments, its tensor maps built for this call:
// q, k, v, dout strided as `st` gives them (12 values), dk, dv (and with
// dq_acc, dq) contiguous; `f32`: dk and dv are fp32, written without maps
int bwd_args(BwdArgs* a, int D, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta,
             void* dq_acc, void* dk, void* dv, void* work,
             const long long* st, int b, int h, int sq, int sk, float scale,
             int causal, int hp, Seg seg, Drop drop, bool f32,
             Bias bias = Bias{}) {
  *a = BwdArgs{};
  int e = map_bhsd(&a->q, &a->order_q, q, st, b, h, sq, D, kBwdRows);
  if (e == 0)
    e = map_bhsd(&a->k, &a->order_k, k, st + 3, b, h, sk, D, kBwdKeys);
  if (e == 0)
    e = map_bhsd(&a->v, &a->order_v, v, st + 6, b, h, sk, D, kBwdKeys);
  if (e == 0)
    e = map_bhsd(&a->dout, &a->order_do, dout, st + 9, b, h, sq, D,
                 kBwdRows);
  // the output slices' boxes: 16 rows of one consumer warp
  const long long ok[3] = {(long long)h * sk * D, (long long)sk * D, D};
  if (f32) {
    a->dk32 = static_cast<float*>(dk);
    a->dv32 = static_cast<float*>(dv);
  } else {
    if (e == 0) e = map_bhsd(&a->dk, &a->order_dkv, dk, ok, b, h, sk, D, 16);
    int order_dv = 0;
    if (e == 0) e = map_bhsd(&a->dv, &order_dv, dv, ok, b, h, sk, D, 16);
  }
  if (e == 0 && dq_acc != nullptr) {
    const long long oq[3] = {(long long)h * sq * D, (long long)sq * D, D};
    e = map_bhsd(&a->dq, &a->order_dq, dq_acc, oq, b, h, sq, D, 16,
                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  }
  a->lse = static_cast<const float*>(lse);
  a->delta = static_cast<const float*>(delta);
  a->dq_acc = static_cast<float*>(dq_acc);
  a->work = static_cast<int*>(work);
  a->h = h;
  a->sq = sq;
  a->sk = sk;
  a->groups = b * h / hp;
  a->scale = scale;
  a->scale_log2 = scale * kLog2e;
  a->causal = causal;
  a->q_seg = seg.q;
  a->kv_seg = seg.kv;
  a->q_seg_sb = seg.q_sb;
  a->kv_seg_sb = seg.kv_sb;
  a->drop = drop;
  a->bias = bias;
  return e;
}

// DQ: the fused kernel (hp = 1) or the packed one (hp > 1); else the
// dk/dv pass (hp = 1); F32 (hp = 1): dk and dv in fp32; BIAS (hp = 1, no
// segment ids, bf16): the bias kernel
template <int D, bool SEG, bool DQ, bool F32, bool DROP, int BIAS = 0>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq_acc, void* dk,
               void* dv, void* work, const long long* st, int b, int h,
               int sq, int sk, float scale, int causal, int hp, Seg seg,
               Drop drop, cudaStream_t stream, Bias bias = Bias{}) {
  using L = BwdSmem<D, SEG, DQ>;
  if (((!DQ || F32 || BIAS) && hp != 1) || work == nullptr ||
      (BIAS == 2 && bias.db == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  const int e = bwd_args(&a, D, q, k, v, dout, lse, delta,
                         DQ ? dq_acc : nullptr, dk, dv, work, st, b, h, sq,
                         sk, scale, causal, hp, seg, drop, F32, bias);
  if (e != 0) return e;
  const int grid = item_grid(b, h, sk, hp, kBwdKeys);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = L::kBytes;
  cudaError_t ce;
  if constexpr (BIAS != 0) {
    static bool opted = false;
    ce = opt_in(flash_bwd_bias_kernel<D, DQ, DROP, BIAS>, smem, opted);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    flash_bwd_bias_kernel<D, DQ, DROP, BIAS>
        <<<grid, L::kThreads, smem, stream>>>(a);
  } else if (hp == 1) {
    static bool opted = false;
    ce = opt_in(flash_bwd_kernel<D, SEG, DQ, F32, DROP>, smem, opted);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    flash_bwd_kernel<D, SEG, DQ, F32, DROP>
        <<<grid, L::kThreads, smem, stream>>>(a);
  } else if constexpr (DQ && !F32) {
    static bool opted = false;
    ce = opt_in(flash_bwd_packed_kernel<D, SEG, DROP>, smem, opted);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    flash_bwd_packed_kernel<D, SEG, DROP>
        <<<grid, L::kThreads, smem, stream>>>(a, hp);
  }
  return static_cast<int>(cudaGetLastError());
}

// one dq-pass launch's arguments, its tensor maps built for this call:
// q, k, v, dout strided as `st` gives them (12 values; boxes of `rows`
// query rows and `keys` keys), dq contiguous (boxes of 64 rows; `f32`: an
// fp32 dq, written without a map)
int dq_args(DqArgs* a, int D, int rows, int keys, const void* q,
            const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dq, void* work, const long long* st,
            int b, int h, int sq, int sk, float scale, int causal, Seg seg,
            Drop drop, bool f32, Bias bias = Bias{}) {
  *a = DqArgs{};
  int e = fwd_args(a, D, rows, q, k, v, nullptr, const_cast<void*>(lse), st,
                   b, h, sq, sk, scale, causal, 1, seg, drop, keys, bias);
  if (e == 0)
    e = map_bhsd(&a->dout, &a->order_do, dout, st + 9, b, h, sq, D, rows);
  const long long oq[3] = {(long long)h * sq * D, (long long)sq * D, D};
  if (f32)
    a->dq32 = static_cast<float*>(dq);
  else if (e == 0)
    e = map_bhsd(&a->dq, &a->order_dq, dq, oq, b, h, sq, D, 64);
  a->delta = static_cast<const float*>(delta);
  a->work = static_cast<int*>(work);
  a->scale = scale;
  return e;
}

// BIAS (no segment ids, bf16 dq): the bias kernel
template <int D, bool SEG, bool F32, bool DROP, int BIAS = 0>
int launch_bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, void* work, const long long* st, int b, int h,
                  int sq, int sk, float scale, int causal, Seg seg, Drop drop,
                  cudaStream_t stream, Bias bias = Bias{}) {
  using L = DqSmem<D, SEG, DROP>;
  if (work == nullptr || (BIAS == 2 && bias.db == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DqArgs a;
  const int e = dq_args(&a, D, L::kRows, L::kKeys, q, k, v, dout, lse, delta,
                        dq, work, st, b, h, sq, sk, scale, causal, seg, drop,
                        F32, bias);
  if (e != 0) return e;
  static bool opted = false;
  constexpr size_t smem = L::kBytes;
  auto kernel = flash_bwd_dq_kernel<D, SEG, F32, DROP>;
  if constexpr (BIAS != 0) kernel = flash_bwd_dq_bias_kernel<D, DROP, BIAS>;
  const cudaError_t ce = opt_in(kernel, smem, opted);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const int grid = item_grid(b, h, sq, 1, L::kRows);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, L::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
using Dim = std::integral_constant<int, D>;
template <bool B>
using Flag = std::integral_constant<bool, B>;

// launch(Dim<head_dim>, Flag<has segment ids>, Flag<dropout>) for one
// call's head_dim (64 or 128), segment ids (both null or both set) and
// dropout flag; anything else is cudaErrorInvalidValue, with nothing
// launched
template <typename F>
int dispatch(int head_dim, const void* q_seg, const void* kv_seg, int dropout,
             F launch) {
  if ((q_seg == nullptr) != (kv_seg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool seg = q_seg != nullptr;
  auto by_drop = [&](auto d, auto has_seg) {
    return dropout ? launch(d, has_seg, Flag<true>{})
                   : launch(d, has_seg, Flag<false>{});
  };
  int e = cudaErrorInvalidValue;
  if (head_dim == 64)
    e = seg ? by_drop(Dim<64>{}, Flag<true>{})
            : by_drop(Dim<64>{}, Flag<false>{});
  else if (head_dim == 128)
    e = seg ? by_drop(Dim<128>{}, Flag<true>{})
            : by_drop(Dim<128>{}, Flag<false>{});
  return static_cast<int>(e);
}

template <int N>
using Mode = std::integral_constant<int, N>;

// launch(Dim<head_dim>, Flag<dropout>, Mode<bias_mode>) for a biased
// call: bias_mode 1 reads the bias, 2 also writes dbias (`most`: the
// highest mode the kernel takes); segment ids, fp32 outputs, another
// mode, or a bias the kernels cannot read by 8-byte pairs of keys (key
// stride other than 1, an odd stride, a base off 8 bytes) are
// cudaErrorInvalidValue, with nothing launched
template <typename F>
int dispatch_bias(int head_dim, const void* q_seg, const void* kv_seg,
                  int dropout, int out_f32, int bias_mode, int most,
                  const void* bias, const long long* st, F launch) {
  if (q_seg != nullptr || kv_seg != nullptr || out_f32 || bias_mode < 1 ||
      bias_mode > most || bias == nullptr || st == nullptr || st[3] != 1 ||
      (st[0] | st[1] | st[2]) & 1 ||
      reinterpret_cast<uintptr_t>(bias) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto by_mode = [&](auto d, auto drops) {
    return bias_mode == 2 ? launch(d, drops, Mode<2>{})
                          : launch(d, drops, Mode<1>{});
  };
  auto by_drop = [&](auto d) {
    return dropout ? by_mode(d, Flag<true>{}) : by_mode(d, Flag<false>{});
  };
  if (head_dim == 64) return by_drop(Dim<64>{});
  if (head_dim == 128) return by_drop(Dim<128>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// the C entries' bias arguments as one launch's Bias: the fp32 bias, its
// (batch, head, query) strides in elements (0 on a broadcast dimension;
// the key stride is 1, which dispatch_bias checks) and the dbias partial
Bias make_bias(const void* bias, const long long* st, void* dbias) {
  if (bias == nullptr || st == nullptr) return Bias{};
  return Bias{static_cast<const float*>(bias), static_cast<float*>(dbias),
              st[0], st[1], st[2]};
}

Seg make_seg(const void* q_seg, const void* kv_seg, long long q_seg_sb,
             long long kv_seg_sb) {
  return Seg{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
             q_seg_sb, kv_seg_sb};
}

// the C entries' dropout arguments as one launch's Drop: the seed and
// offsets as 32-bit words (wrapping), the threshold int(rate * 2^31),
// 1 / (1 - rate)
Drop make_drop(float inv, int thresh, int seed, int q_off, int k_off) {
  return Drop{static_cast<uint32_t>(seed), static_cast<uint32_t>(q_off),
              static_cast<uint32_t>(k_off), static_cast<uint32_t>(thresh),
              inv};
}

}  // namespace

// q, k, v: bf16 (b, h, s, d) with d contiguous, every row 16-byte aligned;
// `strides` holds (batch, head, seq) strides in elements for q, k, v (9
// values).  o (b, h, sq, d) bf16 and lse (b, h, sq) fp32 are contiguous.
// Dropout: `dropout` 0 launches the kernels without it; else a score is
// kept where the hash of (seed, batch * h + head, q_off + query row,
// k_off + key) clears `thresh` (int(rate * 2^31)) and survivors are scaled
// by `inv` (1 / (1 - rate)); the backward entries take the forward's.
// q_seg (b, sq) and kv_seg (b, sk): int32 segment ids, contiguous along the
// sequence, with batch strides q_seg_sb / kv_seg_sb; both null for none.
// Bias (these four unpacked entries): `bias_mode` 0 launches the kernels
// without one; 1 adds the fp32 `bias`, whose element (batch, head, query,
// key) is at the strides `bias_st` (4 values in elements: 0 on a broadcast
// dimension, the key stride 1, the others even; the base 8-byte aligned,
// rows readable to an even number of keys), to the scaled scores; the
// backward entries take 2 to also write dbias's fp32 partial into
// `dbias` (see each entry).  A bias with segment ids or fp32 outputs is
// cudaErrorInvalidValue.
// Launches on `stream`; returns the CUDA error of the launch (0 = launched).
extern "C" int apex_flash_attn_fwd(int head_dim, const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const long long* strides, int b, int h,
                                   int sq, int sk, float scale, int causal,
                                   int dropout, float inv, int thresh,
                                   int seed, int q_off, int k_off,
                                   const void* q_seg, const void* kv_seg,
                                   long long q_seg_sb, long long kv_seg_sb,
                                   const void* bias, const long long* bias_st,
                                   int bias_mode, void* stream) {
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  const Drop drop = make_drop(inv, thresh, seed, q_off, k_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias_mode != 0) {
    const Bias bs = make_bias(bias, bias_st, nullptr);
    return dispatch_bias(head_dim, q_seg, kv_seg, dropout, 0, bias_mode, 1,
                         bias, bias_st, [&](auto d, auto drops, auto mode) {
      return launch_fwd<decltype(d)::value, false, decltype(drops)::value,
                        decltype(mode)::value>(q, k, v, o, lse, strides, b, h,
                                               sq, sk, scale, causal, seg,
                                               drop, s, bs);
    });
  }
  return dispatch(head_dim, q_seg, kv_seg, dropout,
                  [&](auto d, auto has_seg, auto drops) {
    return launch_fwd<decltype(d)::value, decltype(has_seg)::value,
                      decltype(drops)::value>(
        q, k, v, o, lse, strides, b, h, sq, sk, scale, causal, seg, drop, s);
  });
}

// The fused backward: as above, plus dout (strided like q; its strides
// follow q, k, v's in `strides`, 12 values), lse and delta (b, h, sq) fp32
// contiguous, dq_acc (b, h, sq, d) fp32 contiguous and ZEROED (dq is added
// into it, scaled), dk and dv (b, h, sk, d) contiguous, bf16 (or fp32 when
// `out_f32` is 1: the F32 instantiations), and `work`, one ZEROED int32
// (the launch's work-item counter).  bias_mode 2: `dbias` is a ZEROED
// (b * h, sq, sk) fp32 partial that gets each score's ds ("full" dbias).
extern "C" int apex_flash_attn_bwd(int head_dim, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq_acc, void* dk, void* dv,
                                   void* work, const long long* strides,
                                   int b, int h,
                                   int sq, int sk, float scale, int causal,
                                   int out_f32,
                                   int dropout, float inv, int thresh,
                                   int seed, int q_off, int k_off,
                                   const void* q_seg, const void* kv_seg,
                                   long long q_seg_sb, long long kv_seg_sb,
                                   const void* bias, const long long* bias_st,
                                   int bias_mode, void* dbias, void* stream) {
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  const Drop drop = make_drop(inv, thresh, seed, q_off, k_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias_mode != 0) {
    const Bias bs = make_bias(bias, bias_st, dbias);
    return dispatch_bias(head_dim, q_seg, kv_seg, dropout, out_f32,
                         bias_mode, 2, bias, bias_st,
                         [&](auto d, auto drops, auto mode) {
      return launch_bwd<decltype(d)::value, false, true, false,
                        decltype(drops)::value, decltype(mode)::value>(
          q, k, v, dout, lse, delta, dq_acc, dk, dv, work, strides, b, h, sq,
          sk, scale, causal, 1, seg, drop, s, bs);
    });
  }
  return dispatch(head_dim, q_seg, kv_seg, dropout,
                  [&](auto d, auto has_seg, auto drops) {
    constexpr int D = decltype(d)::value;
    constexpr bool G = decltype(has_seg)::value, R = decltype(drops)::value;
    return out_f32 ? launch_bwd<D, G, true, true, R>(
                         q, k, v, dout, lse, delta, dq_acc, dk, dv, work,
                         strides, b, h, sq, sk, scale, causal, 1, seg, drop,
                         s)
                   : launch_bwd<D, G, true, false, R>(
                         q, k, v, dout, lse, delta, dq_acc, dk, dv, work,
                         strides, b, h, sq, sk, scale, causal, 1, seg, drop,
                         s);
  });
}

// The split backward's dq pass: the fused backward's arguments, with dq
// (b, h, sq, d) contiguous, bf16 (fp32 with `out_f32`), written once (no
// zeroing), in place of dq_acc, dk and dv, and `work`, one ZEROED int32
// (the launch's work-item counter).  bias_mode 2: `dbias` is a ZEROED
// (b * h, sq, sk) fp32 partial that gets each score's ds ("full" dbias).
extern "C" int apex_flash_attn_bwd_dq(int head_dim, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq, void* work,
                                      const long long* strides, int b, int h,
                                      int sq, int sk, float scale, int causal,
                                      int out_f32,
                                      int dropout, float inv, int thresh,
                                      int seed, int q_off, int k_off,
                                      const void* q_seg, const void* kv_seg,
                                      long long q_seg_sb, long long kv_seg_sb,
                                      const void* bias,
                                      const long long* bias_st, int bias_mode,
                                      void* dbias, void* stream) {
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  const Drop drop = make_drop(inv, thresh, seed, q_off, k_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias_mode != 0) {
    const Bias bs = make_bias(bias, bias_st, dbias);
    return dispatch_bias(head_dim, q_seg, kv_seg, dropout, out_f32,
                         bias_mode, 2, bias, bias_st,
                         [&](auto d, auto drops, auto mode) {
      return launch_bwd_dq<decltype(d)::value, false, false,
                           decltype(drops)::value, decltype(mode)::value>(
          q, k, v, dout, lse, delta, dq, work, strides, b, h, sq, sk, scale,
          causal, seg, drop, s, bs);
    });
  }
  return dispatch(head_dim, q_seg, kv_seg, dropout,
                  [&](auto d, auto has_seg, auto drops) {
    constexpr int D = decltype(d)::value;
    constexpr bool G = decltype(has_seg)::value, R = decltype(drops)::value;
    return out_f32 ? launch_bwd_dq<D, G, true, R>(
                         q, k, v, dout, lse, delta, dq, work, strides, b, h,
                         sq, sk, scale, causal, seg, drop, s)
                   : launch_bwd_dq<D, G, false, R>(
                         q, k, v, dout, lse, delta, dq, work, strides, b, h,
                         sq, sk, scale, causal, seg, drop, s);
  });
}

// The dynamic shared memory a dq-pass launch asks for (head_dim 64 or 128;
// `seg`: with segment ids), in bytes; -1 for another head_dim.
extern "C" int apex_flash_attn_bwd_dq_smem(int head_dim, int seg) {
  auto of = [&](auto d) {
    constexpr int D = decltype(d)::value;
    return static_cast<int>(seg ? DqSmem<D, true>::kBytes
                                : DqSmem<D, false>::kBytes);
  };
  return head_dim == 64 ? of(Dim<64>{}) : head_dim == 128 ? of(Dim<128>{}) : -1;
}

// The split backward's dk/dv pass: the fused backward's arguments without
// dq_acc (dk and dv fp32 with `out_f32`).  bias_mode 2: `dbias` is a
// (b * h, sk) fp32 partial that gets each key's ds summed over the queries
// ("sk" dbias; every key written).
extern "C" int apex_flash_attn_bwd_dkv(int head_dim, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       void* work, const long long* strides,
                                       int b,
                                       int h, int sq, int sk, float scale,
                                       int causal, int out_f32,
                                       int dropout, float inv,
                                       int thresh, int seed, int q_off,
                                       int k_off, const void* q_seg,
                                       const void* kv_seg, long long q_seg_sb,
                                       long long kv_seg_sb, const void* bias,
                                       const long long* bias_st,
                                       int bias_mode, void* dbias,
                                       void* stream) {
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  const Drop drop = make_drop(inv, thresh, seed, q_off, k_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias_mode != 0) {
    const Bias bs = make_bias(bias, bias_st, dbias);
    return dispatch_bias(head_dim, q_seg, kv_seg, dropout, out_f32,
                         bias_mode, 2, bias, bias_st,
                         [&](auto d, auto drops, auto mode) {
      return launch_bwd<decltype(d)::value, false, false, false,
                        decltype(drops)::value, decltype(mode)::value>(
          q, k, v, dout, lse, delta, nullptr, dk, dv, work, strides, b, h,
          sq, sk, scale, causal, 1, seg, drop, s, bs);
    });
  }
  return dispatch(head_dim, q_seg, kv_seg, dropout,
                  [&](auto d, auto has_seg, auto drops) {
    constexpr int D = decltype(d)::value;
    constexpr bool G = decltype(has_seg)::value, R = decltype(drops)::value;
    return out_f32 ? launch_bwd<D, G, false, true, R>(
                         q, k, v, dout, lse, delta, nullptr, dk, dv, work,
                         strides, b, h, sq, sk, scale, causal, 1, seg, drop,
                         s)
                   : launch_bwd<D, G, false, false, R>(
                         q, k, v, dout, lse, delta, nullptr, dk, dv, work,
                         strides, b, h, sq, sk, scale, causal, 1, seg, drop,
                         s);
  });
}

// The dynamic shared memory a backward launch asks for (head_dim 64 or
// 128; `seg`: with segment ids; `dq`: the fused and packed kernels, else
// the dk/dv pass), in bytes; -1 for another head_dim.
extern "C" int apex_flash_attn_bwd_smem(int head_dim, int seg, int dq) {
  auto of = [&](auto d) {
    constexpr int D = decltype(d)::value;
    return static_cast<int>(
        seg ? (dq ? BwdSmem<D, true, true>::kBytes
                  : BwdSmem<D, true, false>::kBytes)
            : (dq ? BwdSmem<D, false, true>::kBytes
                  : BwdSmem<D, false, false>::kBytes));
  };
  return head_dim == 64 ? of(Dim<64>{}) : head_dim == 128 ? of(Dim<128>{}) : -1;
}

// The packed forward (_fwd_kernel_packed): apex_flash_attn_fwd's arguments
// and `hp`, the heads one block walks, which must divide h (else
// cudaErrorInvalidValue, nothing launched).  o and lse are the unpacked
// forward's bit for bit.
extern "C" int apex_flash_attn_fwd_packed(
    int head_dim, const void* q, const void* k, const void* v, void* o,
    void* lse, const long long* strides, int b, int h, int sq, int sk,
    float scale, int causal, int hp, int dropout, float inv, int thresh,
    int seed, int q_off, int k_off, const void* q_seg, const void* kv_seg,
    long long q_seg_sb, long long kv_seg_sb, void* stream) {
  if (hp < 1 || h % hp) return static_cast<int>(cudaErrorInvalidValue);
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  const Drop drop = make_drop(inv, thresh, seed, q_off, k_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(head_dim, q_seg, kv_seg, dropout,
                  [&](auto d, auto has_seg, auto drops) {
    return launch_fwd_packed<decltype(d)::value, decltype(has_seg)::value,
                             decltype(drops)::value>(
        q, k, v, o, lse, strides, b, h, sq, sk, scale, causal, hp, seg, drop,
        s);
  });
}

// The packed fused backward (_bwd_fused_kernel_packed): apex_flash_attn_bwd's
// arguments and `hp` (dividing h).  dk and dv are the unpacked fused
// kernel's bit for bit; dq is summed by the same atomics.
extern "C" int apex_flash_attn_bwd_packed(
    int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dq_acc,
    void* dk, void* dv, void* work, const long long* strides, int b, int h,
    int sq, int sk, float scale, int causal, int hp, int dropout, float inv,
    int thresh, int seed, int q_off, int k_off, const void* q_seg,
    const void* kv_seg, long long q_seg_sb, long long kv_seg_sb,
    void* stream) {
  if (hp < 1 || h % hp) return static_cast<int>(cudaErrorInvalidValue);
  const Seg seg = make_seg(q_seg, kv_seg, q_seg_sb, kv_seg_sb);
  const Drop drop = make_drop(inv, thresh, seed, q_off, k_off);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(head_dim, q_seg, kv_seg, dropout,
                  [&](auto d, auto has_seg, auto drops) {
    return launch_bwd<decltype(d)::value, decltype(has_seg)::value, true,
                      false, decltype(drops)::value>(
        q, k, v, dout, lse, delta, dq_acc, dk, dv, work, strides, b, h, sq,
        sk, scale, causal, hp, seg, drop, s);
  });
}
