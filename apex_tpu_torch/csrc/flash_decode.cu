// Paged flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: apex_tpu/ops/flash_decode.py:_decode_kernel (launched by
// _decode_pallas).  Same contract: q (n_slots, q_len, hq, d) against a
// paged cache k/v_pages (hkv, n_pages, page, d) through block_table
// (n_slots, max_pages) int32, lengths (n_slots,) int32 counting the
// q_len new tokens.  Query row i of slot s sees positions
// p < lengths[s] - q_len + 1 + i; query head h reads kv head h / G.
// Rows with no visible position are exact zeros.
//
// What bounds it on an H100: bytes.  Each visible K/V row is read once
// and used for G*q_len query rows (usually 1), about 1 flop per byte
// read, far under the ~295 flop/byte at which the tensor cores become
// the limit; so the design spends nothing on tensor cores.  At serving's
// shape (64 slots x 16 heads, lengths up to 256) a launch reads ~34 MB,
// 0.0095 ms at 3.35 TB/s, and what keeps a block from it is the chain of
// dependent reads before its bytes fly (length and table, then K/V) and
// the bytes it keeps in flight.  The design (the host plan
// `ops.flash_decode.decode_plan` picks its sizes):
//   * one block of 4 warps per (slot, group of `hp` kv heads, tile of 1
//     or 8 query rows), `hp` the caller's heads_per_step, the tuner's, or
//     the plan's rule.  The block reads lengths[s], its table entries and
//     q's rows in one trip (the table is read whatever the length), then
//     asks for all of its visible K and V at once: the visible prefix of a
//     page of one head is contiguous in the (hkv, n_pages, page, d)
//     layout, so a page and head takes one 1-D bulk copy of K and one of
//     V (cp.async.bulk, the TMA without a tensor map), completing on the
//     slot's mbarrier.  Rows past lengths[s] are never read.  When a
//     block's keys outgrow its shared memory, its chunks of `chunk` keys
//     (at most a page) stream through a ring of `stages` slots.
//   * a slot with few blocks (slots x hkv / hp under the SM count) and
//     more than one page splits its pages among the `split` blocks of a
//     thread-block cluster (at most 8); the blocks merge their softmax
//     states through distributed shared memory in rank order, so the
//     same bits come out on every run.
//   * in a chunk, each warp scores keys in passes of 32 / (d / E) keys, E
//     the elements of 16 bytes: a key's d / E lanes each load 16 bytes of
//     its row (a warp reads 512 contiguous bytes: no bank conflicts on the
//     unswizzled rows the bulk copy lands) and meet by shuffles.  With a
//     one-row tile a warp's softmax update takes 8 passes (32 keys at d
//     64 in bf16), so its max, sum and rescale are paid once for them;
//     an update whose keys are all in the chunk and all visible takes a
//     copy of the code with no key checked.  Each warp keeps its own
//     online softmax (m, l, acc in fp32) per query row, acc in d / 32
//     columns a lane, and the four warps merge once a head through
//     shared memory in warp order.
//   * the row tile is a template parameter: 1 when G * q_len = 1 (the
//     decode path holds one row's registers), else 8.
//   * masked keys (position >= the row's visibility) are skipped, not
//     multiplied by 0: a recycled page may hold anything.  The final
//     divide uses max(l, 1e-30) as the TPU kernel does.
// Rounding follows the TPU kernel: scores are fp32 dots scaled in fp32,
// and p is rounded to the cache dtype before the P.V product
// (flash_decode.py:245).  That rounding is why, in bf16, this kernel
// sits further from the fp32 plain version than the fp32 kernel does.
// A head's keys meet in the same warps and order whatever hp is, so hp
// keeps the bits as long as the plan's split stays the same; but hp sets
// the block count, from which the plan picks the split (serving's 64
// slots x 16 heads split 2 at hp 16), and another split merges in
// another order.  -DAPEX_FD_BULK=0 builds the copies as
// 16-byte cp.async by every thread into the same ring instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

#ifndef APEX_FD_MATH
#define APEX_FD_MATH 1  // 0: the keys stream through, nothing computed
#endif

#ifndef APEX_FD_BULK
#define APEX_FD_BULK 1  // 1: a bulk copy a chunk and head; 0: cp.async
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplit = 8;
constexpr int kMaxSmem = 232448 - 1024;  // and the static length_s
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  long long q_s_slot, q_s_pos, q_s_head;  // elements
  const void* k_pages;
  const void* v_pages;
  const int* block_table;
  const int* lengths;
  void* out;
  int q_len, hq, hkv, n_pages, page, max_pages;
  float scale;
  int hp, split, stages, chunk, pps;  // pps: pages a rank of the split
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes (4 fp32 or 8 bf16) as floats
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// a lane's d/32 consecutive output columns of one V row
__device__ __forceinline__ void load_cols(const float* p, float (&f)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  f[0] = a.x; f[1] = a.y;
}
__device__ __forceinline__ void load_cols(const float* p, float (&f)[4]) {
  load16(p, f);
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&f)[2]) {
  const float2 t =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  f[0] = t.x; f[1] = t.y;
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

#if !APEX_FD_BULK
// 16-byte global -> shared copy that bypasses the registers (and L1)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
#endif

// every thread of every block of the cluster: the writes to shared memory
// before it are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float at shared-memory address `a` of the cluster's block `rank`
__device__ __forceinline__ float ld_cluster(uint32_t a, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(a), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

__host__ __device__ __forceinline__ int round16(long long b) {
  return static_cast<int>((b + 15) / 16 * 16);
}

// The dynamic shared memory of a block, in this order: the ring
// (`stages` slots of a chunk's K rows then its V rows), q's rows (hp x
// rows x d of the cache dtype), this rank's table entries, the warps'
// softmax states for a head's merge (4 x rows x (d + 2) floats), with a
// split the block's merged states (hp x rows x (d + 2): acc, m, l), the
// mbarriers.
struct Layout {
  int chunk, slot_bytes, q, tbl, merge, state, bars, total;
  __host__ __device__ Layout(int d, int el, int rows, int hp, int split,
                             int stages, int pps, int chunk_) {
    chunk = chunk_;
    slot_bytes = 2 * chunk * d * el;
    q = stages * slot_bytes;
    tbl = q + round16((long long)hp * rows * d * el);
    merge = tbl + round16((long long)pps * 4);
    state = merge + kWarps * rows * (d + 2) * 4;
    bars = round16(state + (split > 1 ? hp * rows * (d + 2) * 4 : 0));
    total = bars + stages * 8;
  }
};

// a ring item: head h of the block's, page pi of the rank's run, keys
// [k0, k0 + nk) of it
struct Item {
  int h, pi, k0, nk;
};

// One softmax update of a warp over keys [jb, jb + NP KPP) of a staged
// chunk (K rows at ks, V rows at vs, nk of them, key 0 at position
// base): the scores, m, l and acc of every row of the tile.  FULL: every
// key lies in the chunk and every row sees it (no key is checked).
template <typename T, int D, int ROWS, bool FULL>
__device__ __forceinline__ void update(
    const T* ks, const T* vs, int jb, int nk, int base,
    const int (&vis)[ROWS], int nr, const float (&qf)[ROWS][16 / sizeof(T)],
    float scale, float (&m)[ROWS], float (&l)[ROWS],
    float (&acc)[ROWS][D / 32], int lane) {
  constexpr int E = 16 / sizeof(T);
  constexpr int LPK = D / E;
  constexpr int KPP = 32 / LPK;
  constexpr int COLS = D / 32;
  constexpr int NP = ROWS == 1 ? 32 / kWarps : 1;
  const int kg = lane / LPK, kl = lane % LPK;  // key group, piece
  float sc[NP][ROWS];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int kk = jb + p * KPP + kg;
    float kf[E];
    if (FULL || kk < nk) {
      load16(ks + kk * D + kl * E, kf);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) kf[e] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qf[r][e], kf[e], d);
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
      // the scaled score, or -inf for a key out of the chunk or past the
      // row's visibility
      sc[p][r] = FULL || (kk < nk && base + kk < vis[r]) ? d * scale
                                                          : -INFINITY;
    }
  }
  // online softmax per row over the update's keys: cmax, the sum and
  // every m, l are the same in all lanes
  float pc[NP][ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int p = 0; p < NP; ++p) pc[p][r] = 0.f;
    if (r < nr) {
      float cmax = -INFINITY;
#pragma unroll
      for (int p = 0; p < NP; ++p) cmax = fmaxf(cmax, sc[p][r]);
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        cmax = fmaxf(cmax, __shfl_xor_sync(kFull, cmax, o));
      if (cmax != -INFINITY) {
        const float m_new = fmaxf(m[r], cmax);
        const float alpha = expf(m[r] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float e = expf(sc[p][r] - m_new);  // 0 where masked
          psum += e;
          pc[p][r] = to_float(from_float<T>(e));  // P.V in the cache dtype
        }
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          psum += __shfl_xor_sync(kFull, psum, o);
        l[r] = l[r] * alpha + psum;
        m[r] = m_new;
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc) acc[r][cc] *= alpha;
      }
    }
  }
  // P.V: key g of pass p's V row, p from its group's first lane; keys a
  // row cannot see are skipped
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int g = 0; g < KPP; ++g) {
      const int k2 = jb + p * KPP + g;
      if (FULL || k2 < nk) {
        float vf[COLS];
        load_cols(vs + k2 * D + lane * COLS, vf);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nr) {
            const float pj = __shfl_sync(kFull, pc[p][r], g * LPK);
            if (FULL || base + k2 < vis[r]) {
#pragma unroll
              for (int cc = 0; cc < COLS; ++cc)
                acc[r][cc] = fmaf(pj, vf[cc], acc[r][cc]);
            }
          }
        }
      }
    }
  }
}

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(Args a) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte piece
  constexpr int LPK = D / E;         // lanes a key
  constexpr int KPP = 32 / LPK;      // keys a warp pass
  constexpr int COLS = D / 32;       // output columns a lane
  constexpr int NP = ROWS == 1 ? 32 / kWarps : 1;  // passes an update
  constexpr int KB = NP * KPP;           // keys a warp's update
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int length_s;

  const int split = a.split, hp = a.hp, S = a.stages;
  const int s = blockIdx.x / split, rank = blockIdx.x % split;
  const int kvh0 = blockIdx.y * hp;
  const int G = a.hq / a.hkv;
  const int r0 = blockIdx.z * ROWS;
  const int nr = min(ROWS, G * a.q_len - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Layout L(D, sizeof(T), ROWS, hp, split, S, a.pps, a.chunk);
  T* ring = reinterpret_cast<T*>(smem);
  T* q_s = reinterpret_cast<T*>(smem + L.q);
  int* tbl_s = reinterpret_cast<int*>(smem + L.tbl);
  float* merge = reinterpret_cast<float*>(smem + L.merge);
  float* state = reinterpret_cast<float*>(smem + L.state);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);

  // one trip: the slot's length, this rank's table entries, q's rows
  const int p_begin = rank * a.pps;
  const int n_tbl = max(0, min(a.pps, a.max_pages - p_begin));
  if (tid == 0) {
    length_s = a.lengths[s];
    for (int i = 0; i < S; ++i)
      hopper::mbar_init(&full[i], APEX_FD_BULK ? 1 : kThreads);
    hopper::mbar_fence_init();
  }
  for (int i = tid; i < n_tbl; i += kThreads)
    tbl_s[i] = a.block_table[(long long)s * a.max_pages + p_begin + i];
  const T* q = static_cast<const T*>(a.q);
  for (int e = tid; e < hp * nr * D; e += kThreads) {
    const int h = e / (nr * D), r = (e / D) % nr, col = e % D;
    const int rr = r0 + r, g = rr / a.q_len, i = rr % a.q_len;
    q_s[(h * ROWS + r) * D + col] =
        q[s * a.q_s_slot + i * a.q_s_pos +
          ((long long)(kvh0 + h) * G + g) * a.q_s_head + col];
  }
  __syncthreads();
  const int length = length_s;

  // out is (n_slots, q_len, hq, D) contiguous
  T* out = static_cast<T*>(a.out);
  auto out_at = [&](int h, int r, int col) -> T* {
    const int rr = r0 + r, g = rr / a.q_len, i = rr % a.q_len;
    return out + (((long long)s * a.q_len + i) * a.hq +
                  (long long)(kvh0 + h) * G + g) *
                     D +
           col;
  };
  auto visible = [&](int r) {
    return length - a.q_len + 1 + (r0 + r) % a.q_len;
  };
  // keys past the table's capacity are never visited (the TPU grid ends
  // at max_pages); every visible position is below `length`.  An inactive
  // slot (length <= 0) has no keys: its rows come out as exact zeros
  const int kv_end = max(0, min(length, a.max_pages * a.page));
  const int p_end = min(p_begin + a.pps, (kv_end + a.page - 1) / a.page);
  const int np = max(0, p_end - p_begin);  // this rank's pages
  const int chunk = L.chunk;
  const int cpp = (a.page + chunk - 1) / chunk;  // chunks of a full page
  const int last_keys =
      np > 0 ? min(a.page, kv_end - (p_end - 1) * a.page) : 0;
  // a head's chunks: cpp for every page but the last, which may be short
  const int per_head =
      np > 0 ? (np - 1) * cpp + (last_keys + chunk - 1) / chunk : 0;
  const int n_items = hp * per_head;
  const int slot_el = L.slot_bytes / static_cast<int>(sizeof(T));
  const long long page_el = (long long)a.page * D;
  const T* kp = static_cast<const T*>(a.k_pages);
  const T* vp = static_cast<const T*>(a.v_pages);

  // item i: chunk c = i % per_head of head i / per_head: page pi of this
  // rank's run, keys [k0, k0 + nk) of it
  auto item = [&](int i) {
    Item it;
    it.h = i / per_head;
    const int c = i % per_head;
    it.pi = c / cpp;
    it.k0 = (c % cpp) * chunk;
    it.nk = min(chunk, (it.pi == np - 1 ? last_keys : a.page) - it.k0);
    return it;
  };
  // the copies of item i into its slot, by every thread (cp.async) or by
  // thread 0 (two bulk copies)
  auto fetch = [&](int i) {
    const Item it = item(i);
    const int nk = it.nk;
    const int st = i % S;
    const long long off =
        ((long long)(kvh0 + it.h) * a.n_pages + tbl_s[it.pi]) * page_el +
        (long long)it.k0 * D;
    T* ks = ring + st * slot_el;
    T* vs = ks + chunk * D;
#if APEX_FD_BULK
    if (tid == 0) {
      const uint32_t bytes = static_cast<uint32_t>(nk * D * sizeof(T));
      hopper::mbar_arrive_expect_tx(&full[st], 2 * bytes);
      hopper::bulk_load(ks, kp + off, bytes, &full[st]);
      hopper::bulk_load(vs, vp + off, bytes, &full[st]);
    }
#else
    for (int p = tid; p < nk * D / E; p += kThreads) {
      cp_async16(ks + p * E, kp + off + p * E);
      cp_async16(vs + p * E, vp + off + p * E);
    }
    hopper::cp_async_mbar_arrive(&full[st]);
#endif
  };
  for (int i = 0; i < min(S, n_items); ++i) fetch(i);

  const int kl = lane % LPK;  // a lane's piece of a key row
  const float scale = a.scale;
  for (int h = 0; h < hp; ++h) {
    float m[ROWS], l[ROWS], acc[ROWS][COLS], qf[ROWS][E];
    int vis[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
      vis[r] = r < nr ? visible(r) : 0;
      if (r < nr) {
        load16(q_s + (h * ROWS + r) * D + kl * E, qf[r]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) qf[r][e] = 0.f;
      }
    }

    int vmin = vis[0];  // the keys every row of the tile sees
#pragma unroll
    for (int r = 1; r < ROWS; ++r)
      if (r < nr) vmin = min(vmin, vis[r]);

    for (int c = 0; c < per_head; ++c) {
      const int i = h * per_head + c;
      const Item it = item(i);
      const int nk = it.nk;
      const int st = i % S;
      hopper::mbar_wait(&full[st], (i / S) & 1);
      const T* ks = ring + st * slot_el;
      const T* vs = ks + chunk * D;
      const int base = (p_begin + it.pi) * a.page + it.k0;  // key 0's

      // a warp's updates of its online softmax take NP passes of KPP keys,
      // keys [jb, jb + KB); nk, jb, vmin and so each branch on them are
      // warp-uniform.  An update whose keys all lie in the chunk and are
      // seen by every row takes the branch-free copy
      for (int jb = warp * KB; APEX_FD_MATH && jb < nk; jb += kWarps * KB) {
        if (jb + KB <= nk && base + jb + KB <= vmin)
          update<T, D, ROWS, true>(ks, vs, jb, nk, base, vis, nr, qf, scale,
                                   m, l, acc, lane);
        else
          update<T, D, ROWS, false>(ks, vs, jb, nk, base, vis, nr, qf, scale,
                                    m, l, acc, lane);
      }
      if (i + S < n_items) {  // the slot is read: refill it
        __syncthreads();
        fetch(i + S);
      }
    }

    // merge the four warps' states of head h in warp order
    float* m_s = merge;                   // [kWarps][ROWS]
    float* l_s = m_s + kWarps * ROWS;     // [kWarps][ROWS]
    float* acc_s = l_s + kWarps * ROWS;   // [kWarps][ROWS][D]
    __syncthreads();  // the previous head's merge is read
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nr) {
        if (lane == 0) {
          m_s[warp * ROWS + r] = m[r];
          l_s[warp * ROWS + r] = l[r];
        }
#pragma unroll
        for (int cc = 0; cc < COLS; ++cc)
          acc_s[(warp * ROWS + r) * D + lane * COLS + cc] = acc[r][cc];
      }
    }
    __syncthreads();
    for (int e = tid; e < nr * D; e += kThreads) {
      const int r = e / D, col = e % D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * ROWS + r]);
      float lsum = 0.f, av = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = m_s[w * ROWS + r];
        if (mw != -INFINITY) {
          const float f = expf(mw - mx);
          lsum += l_s[w * ROWS + r] * f;
          av += acc_s[(w * ROWS + r) * D + col] * f;
        }
      }
      if (split == 1) {
        // rows with no visible position stay exact zeros
        const float o = visible(r) > 0 ? av / fmaxf(lsum, 1e-30f) : 0.f;
        *out_at(h, r, col) = from_float<T>(o);
      } else {
        float* st = state + (h * ROWS + r) * (D + 2);
        st[col] = av;
        if (col == 0) {
          st[D] = mx;
          st[D + 1] = lsum;
        }
      }
    }
  }
  if (split == 1) return;

  // the cluster's ranks merge their states in rank order, each block a
  // share of the outputs
  cluster_sync();
  for (int e = rank * kThreads + tid; e < hp * nr * D;
       e += split * kThreads) {
    const int h = e / (nr * D), r = (e / D) % nr, col = e % D;
    const uint32_t at = hopper::smem_u32(state + (h * ROWS + r) * (D + 2));
    float mx = -INFINITY;
    for (int k = 0; k < split; ++k)
      mx = fmaxf(mx, ld_cluster(at + D * 4, k));
    float lsum = 0.f, av = 0.f;
    for (int k = 0; k < split; ++k) {
      const float mk = ld_cluster(at + D * 4, k);
      if (mk != -INFINITY) {
        const float f = expf(mk - mx);
        lsum += ld_cluster(at + (D + 1) * 4, k) * f;
        av += ld_cluster(at + col * 4, k) * f;
      }
    }
    const float o = visible(r) > 0 ? av / fmaxf(lsum, 1e-30f) : 0.f;
    *out_at(h, r, col) = from_float<T>(o);
  }
  cluster_sync();  // no block leaves while another reads its states
}

template <typename T, int D, int ROWS>
int launch(const Args& a, int n_slots, int rows, int smem,
           cudaStream_t stream) {
  const auto kernel = decode_kernel<T, D, ROWS>;
  static int opted = 0;  // the largest dynamic shared memory opted into
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const dim3 grid(n_slots * a.split, a.hkv / a.hp, (rows + ROWS - 1) / ROWS);
  if (a.split == 1) {
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(&cfg, kernel, a);
  if (l != cudaSuccess) return static_cast<int>(l);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory (bytes) a block of the plan takes, or -1 for
// a plan no block can hold.  The host plan sizes its ring by a copy of
// Layout (ops.flash_decode.decode_smem), which must match it: a drift
// shows as a refused launch.
int block_smem(int el, int head_dim, int row_tile, int hp, int split,
               int stages, int chunk, int max_pages) {
  const int pps = (max_pages + split - 1) / split;
  const Layout L(head_dim, el, row_tile, hp, split, stages, pps, chunk);
  return L.total <= kMaxSmem ? L.total : -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128.  q strides are
// in elements (its last dim must be contiguous); the pages (16-byte
// aligned), table, lengths and out are contiguous.  The plan
// (ops.flash_decode.decode_plan): `hp` kv heads a block (dividing hkv),
// the pages of a slot split among `split` blocks of a cluster (1-8),
// `stages` ring slots (>= 1) of `chunk` keys (a multiple of 8, at most a
// page), `row_tile` query rows a block (1 or 8).  A
// plan or input it cannot run is cudaErrorInvalidValue with nothing
// launched.  Launches on `stream` and returns the CUDA error of the
// launch (0 = launched).
extern "C" int apex_flash_decode(int dtype, int head_dim, const void* q,
                                 long long q_s_slot, long long q_s_pos,
                                 long long q_s_head, const void* k_pages,
                                 const void* v_pages, const void* block_table,
                                 const void* lengths, void* out, int n_slots,
                                 int q_len, int hq, int hkv, int n_pages,
                                 int page, int max_pages, float scale, int hp,
                                 int split, int stages, int row_tile,
                                 int chunk, void* stream) {
  const int rows = hkv > 0 ? hq / hkv * q_len : 0;
  const bool ok =
      (dtype == 0 || dtype == 1) && (head_dim == 64 || head_dim == 128) &&
      n_slots > 0 && q_len > 0 && hkv > 0 && hq % hkv == 0 && page > 0 &&
      page % 8 == 0 && max_pages > 0 && n_pages > 0 && hp >= 1 &&
      hkv % hp == 0 && hkv / hp <= 65535 && split >= 1 &&
      split <= kMaxSplit && (long long)n_slots * split <= 0x7fffffff &&
      stages >= 1 && (row_tile == 1 || row_tile == 8) && chunk >= 8 &&
      chunk % 8 == 0 && chunk <= page &&
      (rows + row_tile - 1) / row_tile <= 65535 &&
      reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  const int smem = ok ? block_smem(dtype == 0 ? 4 : 2, head_dim, row_tile, hp,
                                  split, stages, chunk, max_pages)
                      : -1;
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.q_s_slot = q_s_slot;
  a.q_s_pos = q_s_pos;
  a.q_s_head = q_s_head;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.block_table = static_cast<const int*>(block_table);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.q_len = q_len;
  a.hq = hq;
  a.hkv = hkv;
  a.n_pages = n_pages;
  a.page = page;
  a.max_pages = max_pages;
  a.scale = scale;
  a.hp = hp;
  a.split = split;
  a.stages = stages;
  a.chunk = chunk;
  a.pps = (max_pages + split - 1) / split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define APEX_FD_LAUNCH(T, D)                                              \
  return row_tile == 1 ? launch<T, D, 1>(a, n_slots, rows, smem, st)      \
                       : launch<T, D, 8>(a, n_slots, rows, smem, st)
  if (dtype == 0 && head_dim == 64) APEX_FD_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) APEX_FD_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) APEX_FD_LAUNCH(__nv_bfloat16, 64);
  APEX_FD_LAUNCH(__nv_bfloat16, 128);
#undef APEX_FD_LAUNCH
}
