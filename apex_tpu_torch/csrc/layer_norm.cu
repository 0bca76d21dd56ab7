// LayerNorm / RMSNorm forward and backward for Hopper (sm_90a), plain C
// interface.
//
// Forward.  Replaces: apex_tpu/ops/layer_norm.py:_fwd_kernel (launched by
// _fwd_pallas).  Same contract: over (rows, hidden), with fp32 statistics
// whatever x's dtype, mean = sum(x) / hidden (0 for RMSNorm), the centred
// variance var = sum((x - mean)^2) / hidden, rstd = 1 / sqrt(var + eps),
// y = (x - mean) rstd w + b in x's dtype (w and b each optional, fp32,
// bf16 or fp16), and mean and rstd written per row in fp32.
//
// What bounds it on an H100: bytes at the training steps' rows (x read
// and y written once, ~8 flops an element: (12288, 1024) bf16 is 50 MB,
// 0.0150 ms at 3.35 TB/s), latency at decode's 64 rows (128 KB: a load,
// two row sums and a store in a chain).  The design (the host plan
// `fwd_plan`):
//   * a row belongs to a group of warps whose threads hold it in
//     registers: x is read once, y written once, the two sums (the mean,
//     then the centred squares) are warp shuffles and, between the warps
//     of a group, one shared-memory step each.
//   * rows of 16-byte multiples, up to 8192 columns: two 16-byte vectors
//     of x, w and b a thread as loaded (2 warps a row at hidden 1024 in
//     16-bit), one for few rows (at most 8 an SM: decode, prefill; 4
//     warps at 1024, a shorter chain a row).  Blocks of up to 8 warps,
//     as many an SM as the form's registers let in (four at one vector
//     a thread, two at two), one wave of them; each group walks a run of
//     rows with the next row's loads in flight while it computes one, w
//     and b loaded once.
//     (The backward's ring of bulk copies on 8 one-warp rows a block was
//     measured slower here: what hides a row's chain of two sums is rows
//     in flight an SM, which registers, not the ring, bound.)
//   * rows of 8192-16384 columns: one row of 12 warps a block, about a
//     block an SM over a run of rows streaming through a ring of 1-D bulk
//     copies (cp.async.bulk on an mbarrier) a few rows ahead; w and b
//     turned into fp32 in shared memory once a block.
//   * rows whose bytes or bases are not 16-byte multiples are read and
//     written 4 or 2 bytes at a time, straight from device memory (the
//     plan's load width, chosen before the launch), as are w and b where
//     they are not 16-byte aligned rows of x's dtype.
//   * no atomics and a fixed order of every sum: the same bits every run.
//
// Backward.  Replaces: apex_tpu/ops/layer_norm.py:_bwd_kernel (launched by
// _bwd_pallas).  Same contract: over (rows, hidden) with the forward's
// fp32 mean and rstd per row,
//   dx = rstd * (wg - mean(wg) - xhat * mean(wg * xhat)),  wg = g * w,
// (RMSNorm drops the mean(wg) term) rounded once to x's dtype, and with a
// weight dw = sum over rows of g * xhat, db = sum of g, in fp32.
//
// What bounds it on an H100: bytes.  g and x are read once and dx is
// written once, ~20 flops an element, far under the card's ~20 flops a
// byte in fp32.  At (12288, 1024) bf16 that is 75.5 MB, 0.0226 ms at
// 3.35 TB/s; to reach it each SM must keep ~25 KB of rows in flight.
// The design:
//   * persistent blocks (the host plan `bwd_plan`: about one a SM), each
//     over a fixed run of rows.  A row belongs to one warp for hidden <=
//     1024, else to 2-8 warps (a row group), so that a thread holds at
//     most 32 columns: its dw and db partial sums stay in fp32 registers
//     across all of its rows.  A block has 8 warps (one row of 12 at
//     hidden > 8192, whose threads hold up to 48 columns).
//   * each row group streams its rows through a ring of `stages` slots in
//     shared memory: the group's first thread asks for a row of g and a
//     row of x by two 1-D bulk copies (cp.async.bulk, the TMA without a
//     tensor map) and for the row's mean and rstd by two 4-byte cp.async,
//     all completing on the slot's mbarrier, `stages` rows ahead of the
//     row being computed (4 at hidden 1024 in bf16: 16 KB a warp, 128 KB
//     an SM in flight).
//   * a row is two passes: the two sums (warp shuffles; one
//     shared-memory step between the warps of a wider row), then dx,
//     rounded and stored 16 bytes a thread, and dw += g * xhat, db += g.
//     The thread's 16-byte pieces of g and x stay in registers between
//     the passes (the 12-warp rows read the staged row again).
//   * rows whose bytes or bases are not 16-byte multiples are copied by
//     the group's threads with 4- or 2-byte loads into the same slots,
//     one row at a time (the plan's load width, chosen before the launch).
//   * dw and db without atomics, the same bits on every run: each block
//     sums its row groups' registers in group order into one partial row
//     (~128 of them at (12288, 1024)); a second launch of one block a
//     4-column slice (256 blocks at hidden 1024) sums the partial rows of
//     its columns in a fixed order.  -DAPEX_LNB_FINISH=1 builds the
//     other way: a cooperative launch whose blocks meet at a grid barrier
//     and then sum the slices themselves.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

#ifndef APEX_LNB_FINISH
// 0: a second launch; 1: a grid barrier; 2: no finishing pass (dw and db
// are not summed: timed only)
#define APEX_LNB_FINISH 0
#endif

#ifndef APEX_LNB_MATH
#define APEX_LNB_MATH 1  // 0: the rows stream through, nothing computed
#endif

#ifndef APEX_LNF_MATH
// 0: the forward copies x to y (its bytes, no sums), mean 0, rstd 1
#define APEX_LNF_MATH 1
#endif

#define APEX_LNB_COOP (APEX_LNB_FINISH == 1)
#if APEX_LNB_COOP
#include <cooperative_groups.h>
#endif

namespace {

constexpr int kMaxCols = 32;  // columns a thread holds, up to 8 warps a row
constexpr int kWideWarps = 12;  // a row's warps past 8192 columns
constexpr int kMaxHidden = 16384;
constexpr int kMaxSmem = 232448;
constexpr int kMaxStages = 4;
constexpr int kFinishThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* g;
  const void* x;
  const float* mean;
  const float* rstd;
  const void* w;  // null: no weight (no dw, db)
  int w_dtype;    // 0 fp32, 1 bf16, 2 fp16
  void* dx;
  float* pdw;  // (blocks, ld) partial rows
  float* pdb;
  float* dw;
  float* db;
  long long g_stride, x_stride, dx_stride;  // elements
  int rows, hidden, rows_per_block, wpr, stages, width, rms, ld;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// 16 bytes (4 fp32 or 8 16-bit values) as floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = to_float(h[i]);
}

// N (a multiple of 4) floats of shared memory
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(p)[i];
    f[4 * i] = a.x; f[4 * i + 1] = a.y; f[4 * i + 2] = a.z; f[4 * i + 3] = a.w;
  }
}

__host__ __device__ __forceinline__ int round16(long long b) {
  return static_cast<int>((b + 15) / 16 * 16);
}

// The dynamic shared memory of a block, laid out in this order: the
// ring (groups x stages x {g, x} rows of row_bytes), w's row in fp32, the
// staged means and rstds (groups x stages x 2), the row sums' exchange
// (groups x 2 parities x wpr warps x 2), the slots' mbarriers.  The
// groups' dw / db rows (groups > 1) and the grid barrier's finishing sums
// reuse it from the start.
struct Layout {
  int row_bytes, ring, w, stats, red, bars, total;
  __host__ __device__ Layout(int hidden, int el, int groups, int stages,
                             int wpr, int threads) {
    row_bytes = round16((long long)hidden * el);
    ring = 0;
    w = groups * stages * 2 * row_bytes;
    stats = w + (hidden + 7) / 8 * 32;  // zeros past hidden
    red = stats + round16(groups * stages * 2 * 4);
    bars = red + round16(groups * 2 * wpr * 2 * 4);
    const int main = bars + groups * stages * 8;
    const int acc = groups > 1 ? groups * 2 * ((hidden + 3) / 4) * 16 : 0;
    const int fin = APEX_LNB_COOP ? 2 * threads * 16 : 0;
    total = main > acc ? main : acc;
    total = total > fin ? total : fin;
  }
};

// the row group's threads: a warp, or bar.sync on the group's barrier
__device__ __forceinline__ void group_sync(int grp, int tpr) {
  if (tpr == 32)
    __syncwarp();
  else
    hopper::named_barrier_sync(1 + grp, tpr);
}

// `bytes` from device memory at `src` to shared memory at `dst` by the
// group's threads, `width` bytes a load (4, or 2 for 16-bit rows), the
// rest of the padded row zeroed
__device__ __forceinline__ void copy_narrow(unsigned char* dst,
                                            const unsigned char* src,
                                            int bytes, int padded, int width,
                                            int t, int tpr) {
  if (width == 4) {
    for (int i = t * 4; i < bytes; i += tpr * 4)
      *reinterpret_cast<uint32_t*>(dst + i) =
          __ldg(reinterpret_cast<const unsigned int*>(src + i));
  } else {
    for (int i = t * 2; i < bytes; i += tpr * 2)
      *reinterpret_cast<uint16_t*>(dst + i) =
          __ldg(reinterpret_cast<const unsigned short*>(src + i));
  }
  for (int i = bytes + t; i < padded; i += tpr) dst[i] = 0;
}

// columns [4 s, 4 s + 4) of dw and db for the slices s = b0, b0 + nb, ...:
// the block's threads take the partial rows in turn, then a fixed tree
// over the threads (the same bits on every run).  `red`: 2 x blockDim
// float4 of shared memory
__device__ void finish_slices(const float* __restrict__ pdw,
                              const float* __restrict__ pdb, float* dw,
                              float* db, int parts, int hidden, int ld,
                              int b0, int nb, float4* red) {
  // the largest power of two of the block's threads take part
  int nt = 1;
  while (2 * nt <= static_cast<int>(blockDim.x)) nt *= 2;
  const int tid = threadIdx.x < nt ? threadIdx.x : -1;
  const int slices = (hidden + 3) / 4;
  for (int sl = b0; sl < slices; sl += nb) {
    float4 sw = make_float4(0.f, 0.f, 0.f, 0.f), sb = sw;
    for (int p = tid; tid >= 0 && p < parts; p += nt) {
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(pdw + (long long)p * ld) +
                 sl);
      const float4 b =
          __ldcg(reinterpret_cast<const float4*>(pdb + (long long)p * ld) +
                 sl);
      sw.x += a.x; sw.y += a.y; sw.z += a.z; sw.w += a.w;
      sb.x += b.x; sb.y += b.y; sb.z += b.z; sb.w += b.w;
    }
    if (tid >= 0) {
      red[tid] = sw;
      red[nt + tid] = sb;
    }
    __syncthreads();
    for (int off = nt / 2; off > 0; off >>= 1) {
      if (tid >= 0 && tid < off) {
        const float4 a = red[tid + off], b = red[nt + tid + off];
        float4& x = red[tid];
        float4& y = red[nt + tid];
        x.x += a.x; x.y += a.y; x.z += a.z; x.w += a.w;
        y.x += b.x; y.y += b.y; y.z += b.z; y.w += b.w;
      }
      __syncthreads();
    }
    if (tid >= 0 && tid < 4 && sl * 4 + tid < hidden) {
      const float* x = reinterpret_cast<const float*>(&red[0]);
      const float* y = reinterpret_cast<const float*>(&red[nt]);
      dw[sl * 4 + tid] = x[tid];
      db[sl * 4 + tid] = y[tid];
    }
    __syncthreads();
  }
}

// The kernel's two forms: blocks of 8 warps whose threads hold up to 32
// columns (THREADS 256), the row pieces kept in registers between the
// two passes; and rows of 8192-16384 columns, one row of 12 warps a block
// (THREADS 384), whose threads hold up to 44 (fp32) or 48 columns and
// read the staged row again in pass 2 (CACHE false), within the 168
// registers a thread of 384 may have
template <typename T, int THREADS, bool CACHE = THREADS == 256>
__global__ void __launch_bounds__(THREADS) ln_bwd_kernel(Args a) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte vector
  // vectors a thread holds
  constexpr int NV = THREADS == 256
                         ? kMaxCols / E
                         : (kMaxHidden + THREADS * E - 1) / (THREADS * E);
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.hidden, S = a.stages, wpr = a.wpr;
  const int tpr = 32 * wpr;
  const int groups = blockDim.x / tpr;
  const int grp = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int lane = threadIdx.x % 32, wrow = t / 32;
  const bool has_w = a.w != nullptr;
  const bool bulk = a.width == 16;
  const Layout L(H, sizeof(T), groups, S, wpr, blockDim.x);
  const int row_el = L.row_bytes / sizeof(T);
  T* ring = reinterpret_cast<T*>(smem + L.ring) + grp * S * 2 * row_el;
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  float* stats = reinterpret_cast<float*>(smem + L.stats) + grp * S * 2;
  float* red = reinterpret_cast<float*>(smem + L.red) + grp * 2 * wpr * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars) + grp * S;

  // this group's rows: row0 + k groups + grp, k = 0 .. n - 1
  const int row0 = blockIdx.x * a.rows_per_block;
  const int row_end = min(row0 + a.rows_per_block, a.rows);
  const int n = row_end - row0 > grp ? (row_end - row0 - grp + groups - 1) /
                                           groups
                                     : 0;
  const T* g = static_cast<const T*>(a.g);
  const T* x = static_cast<const T*>(a.x);
  const uint32_t row_copy = static_cast<uint32_t>(H * sizeof(T));
  // the group's first thread: row k's g and x by two bulk copies, its
  // mean and rstd by 4-byte cp.async, all on slot k % S's mbarrier
  auto fetch = [&](int k) {
    const long long r = row0 + (long long)k * groups + grp;
    const int st = k % S;
    uint64_t* bar = &full[st];
    hopper::cp_async4(&stats[2 * st], a.mean + r, true);
    hopper::cp_async4(&stats[2 * st + 1], a.rstd + r, true);
    hopper::cp_async_mbar_arrive(bar);
    hopper::mbar_arrive_expect_tx(bar, 2 * row_copy);
    hopper::bulk_load(ring + st * 2 * row_el, g + r * a.g_stride, row_copy,
                      bar);
    hopper::bulk_load(ring + (st * 2 + 1) * row_el, x + r * a.x_stride,
                      row_copy, bar);
  };
  if (bulk && t == 0) {
    for (int s = 0; s < S; ++s) hopper::mbar_init(&full[s], 2);
    hopper::mbar_fence_init();
    for (int k = 0; k < min(S, n); ++k) fetch(k);
  }
  if (has_w) {
    for (int i = threadIdx.x; i < (H + 7) / 8 * 8; i += blockDim.x)
      w_s[i] = i >= H ? 0.f
               : a.w_dtype == 0
                   ? static_cast<const float*>(a.w)[i]
                   : a.w_dtype == 1
                         ? to_float(static_cast<const __nv_bfloat16*>(a.w)[i])
                         : to_float(static_cast<const __half*>(a.w)[i]);
  }
  __syncthreads();

  float dwa[NV][E], dba[NV][E];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < E; ++e) dwa[v][e] = dba[v][e] = 0.f;
  T* dx = static_cast<T*>(a.dx);
  const float inv_h = 1.f / static_cast<float>(H);

  for (int k = 0; k < n; ++k) {
    const long long r = row0 + (long long)k * groups + grp;
    const int st = bulk ? k % S : 0;
    const T* gs = ring + st * 2 * row_el;
    const T* xs = gs + row_el;
    float mu, rs;
    if (bulk) {
      hopper::mbar_wait(&full[st], (k / S) & 1);
      mu = stats[2 * st];
      rs = stats[2 * st + 1];
    } else {
      copy_narrow(reinterpret_cast<unsigned char*>(ring),
                  reinterpret_cast<const unsigned char*>(g + r * a.g_stride),
                  row_copy, L.row_bytes, a.width, t, tpr);
      copy_narrow(reinterpret_cast<unsigned char*>(ring + row_el),
                  reinterpret_cast<const unsigned char*>(x + r * a.x_stride),
                  row_copy, L.row_bytes, a.width, t, tpr);
      mu = a.mean[r];
      rs = a.rstd[r];
      group_sync(grp, tpr);
    }
    const float nmr = -mu * rs;  // xhat = x rs - mean rs, one FMA

    // pass 1: sum(wg) and sum(wg * xhat).  CACHE keeps the thread's
    // 16-byte pieces of the row in registers for pass 2
    uint4 gp[NV], xp[NV];
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = (v * tpr + t) * E;
      if (APEX_LNB_MATH && col < H) {
        gp[v] = *reinterpret_cast<const uint4*>(gs + col);
        xp[v] = *reinterpret_cast<const uint4*>(xs + col);
        float gv[E], xv[E], wv[E];
        unpack<T>(gp[v], gv);
        unpack<T>(xp[v], xv);
        if (has_w) load_f32(w_s + col, wv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xh = fmaf(xv[e], rs, nmr);
          const float wg = has_w ? gv[e] * wv[e] : gv[e];
          c1 += wg;
          c2 = fmaf(wg, xh, c2);
        }
      }
      if (!CACHE) asm volatile("" ::: "memory");
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      c1 += __shfl_xor_sync(kFull, c1, o);
      c2 += __shfl_xor_sync(kFull, c2, o);
    }
    if (wpr > 1) {  // the row's warps, summed in warp order
      float* slot = red + (k & 1) * wpr * 2;
      if (lane == 0) {
        slot[2 * wrow] = c1;
        slot[2 * wrow + 1] = c2;
      }
      group_sync(grp, tpr);
      c1 = c2 = 0.f;
      for (int i = 0; i < wpr; ++i) {
        c1 += slot[2 * i];
        c2 += slot[2 * i + 1];
      }
    }
    // dx = rstd (wg - mean(wg) - xhat mean(wg xhat)) = rs wg - ra - xhat rb
    const float ra = a.rms ? 0.f : rs * (c1 * inv_h);
    const float rb = rs * (c2 * inv_h);

    // pass 2: dx, and the dw / db sums
    T* dxr = dx + r * a.dx_stride;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = (v * tpr + t) * E;
      if (APEX_LNB_MATH && col < H) {
        if (!CACHE) {
          gp[v] = *reinterpret_cast<const uint4*>(gs + col);
          xp[v] = *reinterpret_cast<const uint4*>(xs + col);
        }
        float gv[E], xv[E];
        unpack<T>(gp[v], gv);
        unpack<T>(xp[v], xv);
        uint4 out;  // dx rounded to T as it is computed
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xh = fmaf(xv[e], rs, nmr);
          const float wg = has_w ? gv[e] * w_s[col + e] : gv[e];
          o[e] = from_float<T>(fmaf(-xh, rb, fmaf(rs, wg, -ra)));
          dwa[v][e] = fmaf(gv[e], xh, dwa[v][e]);
          dba[v][e] += gv[e];
        }
        if (bulk) {
          *reinterpret_cast<uint4*>(dxr + col) = out;
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (col + e < H) dxr[col + e] = o[e];
        }
      }
      if (!CACHE) asm volatile("" ::: "memory");
    }
    group_sync(grp, tpr);  // the slot is read: it may be refilled
    if (bulk && t == 0 && k + S < n) fetch(k + S);
  }
  if (!has_w) return;

  // the block's partial row: its groups' sums in group order, through
  // shared memory when the block has more than one group
  const int b = blockIdx.x;
  float* pdw = a.pdw + (long long)b * a.ld;
  float* pdb = a.pdb + (long long)b * a.ld;
  float* acc = reinterpret_cast<float*>(smem);  // [groups][2][ld]
  float* dw_to = groups == 1 ? pdw : acc + (grp * 2) * a.ld;
  float* db_to = groups == 1 ? pdb : acc + (grp * 2 + 1) * a.ld;
  __syncthreads();  // every group is done with the ring
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int col = (v * tpr + t) * E;
#pragma unroll
    for (int e = 0; e < E; e += 4)
      if (col + e < H) {  // ld pads hidden to 4 with zeros
        *reinterpret_cast<float4*>(dw_to + col + e) = make_float4(
            dwa[v][e], dwa[v][e + 1], dwa[v][e + 2], dwa[v][e + 3]);
        *reinterpret_cast<float4*>(db_to + col + e) = make_float4(
            dba[v][e], dba[v][e + 1], dba[v][e + 2], dba[v][e + 3]);
      }
  }
  __syncthreads();
  for (int c = threadIdx.x; groups > 1 && c < H; c += blockDim.x) {
    float sw = 0.f, sb = 0.f;
    for (int q = 0; q < groups; ++q) {
      sw += acc[(q * 2) * a.ld + c];
      sb += acc[(q * 2 + 1) * a.ld + c];
    }
    pdw[c] = sw;
    pdb[c] = sb;
  }
#if APEX_LNB_COOP
  __threadfence();
  cooperative_groups::this_grid().sync();
  finish_slices(a.pdw, a.pdb, a.dw, a.db, gridDim.x, H, a.ld, blockIdx.x,
                gridDim.x, reinterpret_cast<float4*>(smem));
#endif
}

__global__ void __launch_bounds__(kFinishThreads) ln_bwd_finish_kernel(
    const float* __restrict__ pdw, const float* __restrict__ pdb, float* dw,
    float* db, int parts, int hidden, int ld) {
  __shared__ float4 red[2 * kFinishThreads];
  finish_slices(pdw, pdb, dw, db, parts, hidden, ld, blockIdx.x, gridDim.x,
                red);
}

template <typename T, int THREADS>
int launch(const Args& a, int blocks, int finish_blocks, int smem,
           cudaStream_t stream) {
  const auto kernel = ln_bwd_kernel<T, THREADS>;
  static int opted = 0;  // the largest dynamic shared memory opted into
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
#if APEX_LNB_COOP
  if (a.w != nullptr) {
    // every block must be resident at once for the grid barrier
    int per_sm = 0, sms = hopper::sm_count();
    const cudaError_t q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, smem);
    if (q != cudaSuccess) return static_cast<int>(q);
    if (blocks > per_sm * sms) return static_cast<int>(cudaErrorInvalidValue);
    Args copy = a;
    void* params[] = {&copy};
    const cudaError_t l = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(THREADS),
        params, smem, stream);
    if (l != cudaSuccess) return static_cast<int>(l);
    return static_cast<int>(cudaGetLastError());
  }
#endif
  kernel<<<blocks, THREADS, smem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.w == nullptr || APEX_LNB_FINISH == 2)
    return static_cast<int>(e);
  ln_bwd_finish_kernel<<<finish_blocks, kFinishThreads, 0, stream>>>(
      a.pdw, a.pdb, a.dw, a.db, blocks, a.hidden, a.ld);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// The dynamic shared memory (bytes) a block of the plan takes, or -1 for
// a plan no block can hold.  Layout is this source's alone: the host plan
// (ops.layer_norm.bwd_plan) sizes the ring and w's row within BWD_SMEM,
// which leaves room under kMaxSmem for the rest of it.
int block_smem(int el, int hidden, int warps, int wpr, int stages) {
  const Layout L(hidden, el, warps / wpr, stages, wpr, 32 * warps);
  return L.total <= kMaxSmem ? L.total : -1;
}

// ------------------------------------------------------------- forward --

constexpr int kFwdMaxStages = 8;

struct FwdArgs {
  const void* x;
  const void* w;  // null: no weight
  const void* b;  // null: no bias
  void* y;
  float* mean;
  float* rstd;
  long long x_stride, y_stride;  // elements
  float eps;
  int w_dtype, b_dtype;  // 0 fp32, 1 bf16, 2 fp16
  int w_vec, b_vec;      // 1: absent, or x's dtype and 16-byte aligned
  int rows, hidden, rows_per_block, wpr, stages, width, rms;
};

// The forward's dynamic shared memory, in this order: the ring (groups x
// stages rows of x) and w's and b's rows in fp32 (both with a ring only),
// the row sums' exchange (groups x 2 sums x wpr warps), the mbarriers.
struct FwdLayout {
  int row_bytes, ring, wb, red, bars, total;
  __host__ __device__ FwdLayout(int hidden, int el, int groups, int stages,
                                int wpr) {
    row_bytes = round16((long long)hidden * el);
    ring = 0;
    wb = groups * stages * row_bytes;
    red = wb + (stages > 0 ? 2 * ((hidden + 7) / 8 * 32) : 0);
    bars = red + round16(groups * 2 * wpr * 4);
    total = bars + groups * stages * 8;
  }
};

// element i of a parameter row of dtype `dt`
__device__ __forceinline__ float param_at(const void* p, int dt, int i) {
  return dt == 0   ? static_cast<const float*>(p)[i]
         : dt == 1 ? to_float(static_cast<const __nv_bfloat16*>(p)[i])
                   : to_float(static_cast<const __half*>(p)[i]);
}

// columns [col, col + E) of a row of x in device memory, zero past H, for
// rows read 4 bytes (pairs of 16-bit values) or one element at a time
template <typename T, int E>
__device__ __forceinline__ void load_x_narrow(const T* row, int col, int H,
                                              int width, float (&f)[E]) {
  if constexpr (sizeof(T) == 2) {
    if (width == 4) {
#pragma unroll
      for (int i = 0; i < E; i += 2) {
        if (col + i < H) {
          const unsigned int u =
              __ldg(reinterpret_cast<const unsigned int*>(row + col + i));
          const T* h = reinterpret_cast<const T*>(&u);
          f[i] = to_float(h[0]);
          f[i + 1] = to_float(h[1]);
        } else {
          f[i] = f[i + 1] = 0.f;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < E; ++i) f[i] = col + i < H ? to_float(row[col + i]) : 0.f;
}

// columns [col, col + E) of a row of y, rounded to T: one 16-byte store
// (width 16), else an element at a time up to H
template <typename T, int E>
__device__ __forceinline__ void store_y(T* row, int col, int H, int width,
                                        const float (&v)[E]) {
  if (width == 16) {
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int i = 0; i < E; ++i) o[i] = from_float<T>(v[i]);
    *reinterpret_cast<uint4*>(row + col) = out;
    return;
  }
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (col + i < H) row[col + i] = from_float<T>(v[i]);
}

// p[0] + ... + p[E - 1] as a fixed tree (E 4 or 8)
template <int E>
__device__ __forceinline__ float tree_sum(const float (&p)[E]) {
  float s = (p[0] + p[1]) + (p[2] + p[3]);
  if constexpr (E == 8) s += (p[4] + p[5]) + (p[6] + p[7]);
  return s;
}

// the row group's sum of v: warp shuffles, then (wpr > 1) the warps' sums
// through shared memory in warp order.  `which` (0, 1) picks the
// exchange's slot: a row takes two sums, and a warp can only write a
// slot again after the group's next barrier, which every warp reaches
// after reading it
__device__ __forceinline__ float group_sum(float v, float* red, int which,
                                           int wpr, int lane, int wrow,
                                           int grp, int tpr) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (wpr == 1) return v;
  float* slot = red + which * wpr;
  if (lane == 0) slot[wrow] = v;
  group_sync(grp, tpr);
  float p[kWideWarps];
#pragma unroll
  for (int i = 0; i < kWideWarps; ++i) p[i] = i < wpr ? slot[i] : 0.f;
  v = 0.f;
#pragma unroll
  for (int i = 0; i < kWideWarps; ++i) v += p[i];
  return v;
}

// A thread's 16-byte vectors of a row as loaded (x, and w and b where
// they are 16-byte aligned rows of x's dtype), unpacked to fp32 in each
// pass: 12 registers a vector
template <int NV>
struct Pieces {
  uint4 x[NV], w[NV], b[NV];
};

// The forms, by THREADS and FAST.  THREADS 256 (hidden <= 8192): blocks
// of up to 8 warps, one row a row group of 1-8 warps whose threads hold up
// to 32 columns; FAST (16-byte rows): VECS (1-8) 16-byte vectors of x,
// w and b as loaded (w and b once a block), each row group walking a run
// of rows with the next row's loads in flight while it computes one,
// compiled for four blocks an SM at one vector a thread, two at two
// (`FwdMinBlocks`).  THREADS 384 (8192 < hidden <= 16384): one row of
// 12 warps a block whose threads hold up to 48 columns in fp32 registers;
// FAST:
// about a block an SM walking a run of rows through the ring of bulk
// copies, w and b staged in fp32 in shared memory once a block.  Not FAST
// (rows read 4 or 2 bytes at a time): x in fp32 registers, straight from
// device memory, w and b an element at a time
// The blocks an SM a form is compiled for (its register cap: 64
// registers a thread at 4, 128 at 2).  The host plan
// (ops.layer_norm.FWD_BLOCKS_PER_SM) sizes its runs of rows by the same.
template <int THREADS, bool FAST, int VECS>
struct FwdMinBlocks {
  static constexpr int value = !(THREADS == 256 && FAST) ? 1
                               : VECS == 1               ? 4
                               : VECS == 2               ? 2
                                                         : 1;
};

template <typename T, int THREADS, bool FAST, int VECS = 0>
__global__ void __launch_bounds__(THREADS,
                                  FwdMinBlocks<THREADS, FAST, VECS>::value)
    ln_fwd_kernel(FwdArgs a) {
  constexpr int E = 16 / sizeof(T);
  constexpr bool RING = FAST && THREADS == 384;
  constexpr bool PACKED = FAST && THREADS == 256;
  // vectors a thread holds: VECS for the packed rows, else enough for
  // the form's widest row
  constexpr int NV = PACKED ? VECS
                     : THREADS == 384
                         ? (kMaxHidden + THREADS * E - 1) / (THREADS * E)
                         : kMaxCols / E;
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.hidden, S = a.stages, wpr = a.wpr;
  const int tpr = 32 * wpr;
  const int groups = blockDim.x / tpr;
  const int grp = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int lane = threadIdx.x % 32, wrow = t / 32;
  const FwdLayout L(H, sizeof(T), groups, S, wpr);
  const int row_el = L.row_bytes / sizeof(T);
  T* slots = reinterpret_cast<T*>(smem + L.ring) + grp * S * row_el;
  const int h8 = (H + 7) / 8 * 8;
  float* w_s = reinterpret_cast<float*>(smem + L.wb);
  float* b_s = w_s + h8;
  float* red = reinterpret_cast<float*>(smem + L.red) + grp * 2 * wpr;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars) + grp * S;

  // this group's rows: row0 + k groups + grp, k = 0 .. n - 1
  const int row0 = blockIdx.x * a.rows_per_block;
  const int row_end = min(row0 + a.rows_per_block, a.rows);
  const int n = row_end - row0 > grp ? (row_end - row0 - grp + groups - 1) /
                                           groups
                                     : 0;
  const T* x = static_cast<const T*>(a.x);
  const uint32_t row_copy = static_cast<uint32_t>(H * sizeof(T));
  // the group's first thread: row k of x by one bulk copy into slot k % S
  auto fetch = [&](int k) {
    const long long r = row0 + (long long)k * groups + grp;
    const int st = k % S;
    hopper::mbar_arrive_expect_tx(&full[st], row_copy);
    hopper::bulk_load(slots + st * row_el, x + r * a.x_stride, row_copy,
                      &full[st]);
  };
  const bool has_w = a.w != nullptr, has_b = a.b != nullptr;
  if constexpr (RING) {
    if (t == 0) {
      for (int s = 0; s < S; ++s) hopper::mbar_init(&full[s], 1);
      hopper::mbar_fence_init();
      for (int k = 0; k < min(S, n); ++k) fetch(k);
    }
    // w and b in fp32 (1 and 0 where absent), once a block
    for (int i = threadIdx.x; i < h8; i += blockDim.x) {
      w_s[i] = has_w && i < H ? param_at(a.w, a.w_dtype, i) : 1.f;
      b_s[i] = has_b && i < H ? param_at(a.b, a.b_dtype, i) : 0.f;
    }
    __syncthreads();  // the mbarriers are initialised, w_s and b_s written
  }

  T* y = static_cast<T*>(a.y);
  const float inv_h = 1.f / static_cast<float>(H);
  // PACKED: the group's w and b once, its first row, and in the loop the
  // next row's x in flight while the current one is computed
  Pieces<PACKED ? NV : 1> pc;
  uint4 nx[PACKED ? NV : 1];
  auto load_row = [&](int k, uint4 (&to)[PACKED ? NV : 1]) {
    const T* xr = x + (row0 + (long long)k * groups + grp) * a.x_stride;
#pragma unroll
    for (int v = 0; v < (PACKED ? NV : 1); ++v) {
      const int col = (v * tpr + t) * E;
      if (col < H) to[v] = __ldg(reinterpret_cast<const uint4*>(xr + col));
    }
  };
  if constexpr (PACKED) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = (v * tpr + t) * E;
      if (col < H) {
        if (has_w)
          pc.w[v] = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const T*>(a.w) + col));
        if (has_b)
          pc.b[v] = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const T*>(a.b) + col));
      }
    }
    if (n > 0) load_row(0, pc.x);
  }
  for (int k = 0; k < n; ++k) {
    const long long r = row0 + (long long)k * groups + grp;
    // PACKED: the row's 16-byte pieces as loaded; else in fp32
    float xv[PACKED ? 1 : NV][E];
    if constexpr (!PACKED) {
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < E; ++e) xv[v][e] = 0.f;
    }
    if constexpr (RING) {
      const int st = k % S;
      hopper::mbar_wait(&full[st], (k / S) & 1);
      const T* xs = slots + st * row_el;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int col = (v * tpr + t) * E;
        if (col < H)
          unpack<T>(*reinterpret_cast<const uint4*>(xs + col), xv[v]);
      }
    } else if constexpr (PACKED) {
      if (k + 1 < n) load_row(k + 1, nx);
    } else {
      const T* xr = x + r * a.x_stride;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int col = (v * tpr + t) * E;
        if (col < H) load_x_narrow<T>(xr, col, H, a.width, xv[v]);
      }
    }
    // the thread's columns [v] of the row in fp32, zero past H
    auto piece = [&](int v, float (&f)[E]) {
      if constexpr (PACKED) {
        if ((v * tpr + t) * E < H) {
          unpack<T>(pc.x[v], f);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) f[e] = 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] = xv[v][e];
      }
    };
    float mu = 0.f, rs = 1.f;
#if APEX_LNF_MATH
    float part[E];
#pragma unroll
    for (int e = 0; e < E; ++e) part[e] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float f[E];
      piece(v, f);
#pragma unroll
      for (int e = 0; e < E; ++e) part[e] += f[e];
    }
    const float s =
        group_sum(tree_sum(part), red, 0, wpr, lane, wrow, grp, tpr);
#endif
    // every thread holds its pieces of the row: the slot may be refilled
    if constexpr (RING) {
      group_sync(grp, tpr);
      if (t == 0 && k + S < n) fetch(k + S);
    }
#if APEX_LNF_MATH
    mu = a.rms ? 0.f : s * inv_h;
#pragma unroll
    for (int e = 0; e < E; ++e) part[e] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float f[E];
      piece(v, f);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if ((v * tpr + t) * E + e < H) {
          const float d = f[e] - mu;
          part[e] = fmaf(d, d, part[e]);
        }
    }
    const float q =
        group_sum(tree_sum(part), red, 1, wpr, lane, wrow, grp, tpr);
    rs = rsqrtf(fmaf(q, inv_h, a.eps));
#endif
    T* yr = y + r * a.y_stride;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = (v * tpr + t) * E;
      if (col < H) {
        float o[E];
        piece(v, o);
#if APEX_LNF_MATH
        float wv[E], bv[E];
        if constexpr (RING) {
          load_f32(w_s + col, wv);
          load_f32(b_s + col, bv);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            wv[e] = 1.f;
            bv[e] = 0.f;
          }
          if constexpr (PACKED) {
            if (has_w) unpack<T>(pc.w[v], wv);
            if (has_b) unpack<T>(pc.b[v], bv);
          } else {
            if (has_w) {
#pragma unroll
              for (int e = 0; e < E; ++e)
                if (col + e < H) wv[e] = param_at(a.w, a.w_dtype, col + e);
            }
            if (has_b) {
#pragma unroll
              for (int e = 0; e < E; ++e)
                if (col + e < H) bv[e] = param_at(a.b, a.b_dtype, col + e);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = fmaf((o[e] - mu) * rs, wv[e], bv[e]);
#endif
        store_y<T>(yr, col, H, PACKED || RING ? 16 : a.width, o);
      }
    }
    if (t == 0) {
      a.mean[r] = mu;
      a.rstd[r] = rs;
    }
    if constexpr (PACKED) {
#pragma unroll
      for (int v = 0; v < NV; ++v) pc.x[v] = nx[v];
    }
  }
}

// the packed form holding `vecs` 16-byte vectors a thread (1, 2, 4; 8 in
// fp32), or the other forms
template <typename T, int THREADS>
void (*fwd_kernel(bool fast, int vecs))(FwdArgs) {
  if (!fast) return ln_fwd_kernel<T, THREADS, false>;
  if constexpr (THREADS == 384) {
    return ln_fwd_kernel<T, THREADS, true>;
  } else {
    if (vecs <= 1) return ln_fwd_kernel<T, THREADS, true, 1>;
    if (vecs <= 2) return ln_fwd_kernel<T, THREADS, true, 2>;
    if constexpr (sizeof(T) == 4) {
      if (vecs > 4) return ln_fwd_kernel<T, THREADS, true, 8>;
    }
    return ln_fwd_kernel<T, THREADS, true, 4>;
  }
}

template <typename T, int THREADS>
int launch_fwd(const FwdArgs& a, int blocks, int warps, int smem,
               cudaStream_t stream) {
  // the packed form reads w and b as 16-byte vectors of x's dtype, the
  // ring stages them in fp32: any other w or b takes the narrow form
  const bool fast = a.width == 16 && (THREADS == 384 || (a.w_vec && a.b_vec));
  constexpr int E = 16 / sizeof(T);
  const int vecs = (a.hidden + 32 * a.wpr * E - 1) / (32 * a.wpr * E);
  const auto kernel = fwd_kernel<T, THREADS>(fast, vecs);
  // the most dynamic shared memory opted into (no packed form takes more
  // than 48 KB)
  static int opted[2] = {0, 0};
  int& o = opted[fast];
  if (smem > 48 * 1024 && smem > o) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    o = smem;
  }
  kernel<<<blocks, 32 * warps, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the forward's dynamic shared memory (bytes) for a block of the plan, or
// -1 for a plan no block can hold
int fwd_block_smem(int el, int hidden, int warps, int wpr, int stages) {
  const FwdLayout L(hidden, el, warps / wpr, stages, wpr);
  return L.total <= kMaxSmem ? L.total : -1;
}

}  // namespace

// g, x and dx (rows, hidden) of one dtype (0 fp32, 1 bf16, 2 fp16), the
// hidden dim contiguous, row strides in elements; mean and rstd fp32
// (rows,); w (hidden,) contiguous of dtype `w_dtype` (the same codes), or
// null for no weight (then dw, db, pdw, pdb are unused).  With a weight,
// pdw and pdb are fp32 scratch of (blocks, ld), ld = hidden rounded up to
// 4, and dw, db fp32 (hidden,).  The plan (ops.layer_norm.bwd_plan):
// `blocks` blocks of `warps` warps and `rows_per_block` rows covering the
// rows exactly (the last one short); `wpr` warps a row: a power of two up
// to 8 with hidden <= wpr * 1024 on blocks of 8 warps, or 12 on blocks of
// one such row for hidden in (8192, 16384]; `stages` ring slots (1-4);
// `width` the load width in bytes: 16 (bulk copies: hidden * element size
// a multiple of 16 and g, x, dx and their row strides 16-byte aligned;
// also the 16-byte stores of dx), 4 (4-byte multiples and alignment) or
// 2 (16-bit rows); widths 4 and 2 take one slot.  `finish_blocks` blocks
// sum the partial rows (the second launch).  A plan or input that breaks
// these is cudaErrorInvalidValue with nothing launched.  rms: 1 for
// RMSNorm.  Launches on `stream`; returns 0 when launched, else the CUDA
// error.
extern "C" int apex_layer_norm_bwd(int dtype, const void* g,
                                   long long g_stride, const void* x,
                                   long long x_stride, const void* mean,
                                   const void* rstd, const void* w,
                                   int w_dtype, void* dx,
                                   long long dx_stride, void* pdw, void* pdb,
                                   void* dw, void* db, int rms, int rows,
                                   int hidden, int blocks, int rows_per_block,
                                   int warps, int wpr, int stages, int width,
                                   int finish_blocks, void* stream) {
  const int el = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || rows <= 0 || hidden <= 0 ||
      hidden > kMaxHidden)
    return static_cast<int>(cudaErrorInvalidValue);
  // rows of up to 8 x 1024 columns on 1-8 warps (a power of two) of
  // blocks of 8; wider ones on blocks of one row of 12 warps
  const bool narrow_rows = warps == 8 && (wpr & (wpr - 1)) == 0 &&
                           wpr >= 1 && wpr <= 8 &&
                           hidden <= wpr * 32 * kMaxCols;
  const bool wide_rows = warps == kWideWarps && wpr == kWideWarps &&
                         hidden > 8 * 32 * kMaxCols;
  bool ok = (narrow_rows || wide_rows) && blocks >= 1 &&
            rows_per_block >= 1 &&
            (long long)blocks * rows_per_block >= rows &&
            (long long)(blocks - 1) * rows_per_block < rows && stages >= 1 &&
            stages <= kMaxStages;
  if (width == 16)
    ok = ok && (long long)hidden * el % 16 == 0 && aligned(g, 16) &&
         aligned(x, 16) && aligned(dx, 16) && g_stride * el % 16 == 0 &&
         x_stride * el % 16 == 0 && dx_stride * el % 16 == 0;
  else if (width == 4)
    ok = ok && stages == 1 && (long long)hidden * el % 4 == 0 &&
         aligned(g, 4) && aligned(x, 4) && g_stride * el % 4 == 0 &&
         x_stride * el % 4 == 0;
  else
    ok = ok && width == 2 && el == 2 && stages == 1;
  if (w != nullptr)
    ok = ok && w_dtype >= 0 && w_dtype <= 2 && pdw && pdb && dw && db &&
         aligned(pdw, 16) && aligned(pdb, 16) && finish_blocks >= 1;
  const int smem = block_smem(el, hidden, warps, wpr, stages);
  if (!ok || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.g = g;
  a.x = x;
  a.mean = static_cast<const float*>(mean);
  a.rstd = static_cast<const float*>(rstd);
  a.w = w;
  a.w_dtype = w_dtype;
  a.dx = dx;
  a.pdw = static_cast<float*>(pdw);
  a.pdb = static_cast<float*>(pdb);
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  a.g_stride = g_stride;
  a.x_stride = x_stride;
  a.dx_stride = dx_stride;
  a.rows = rows;
  a.hidden = hidden;
  a.rows_per_block = rows_per_block;
  a.wpr = wpr;
  a.stages = stages;
  a.width = width;
  a.rms = rms;
  a.ld = (hidden + 3) / 4 * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return wide_rows ? launch<float, 384>(a, blocks, finish_blocks, smem, s)
                     : launch<float, 256>(a, blocks, finish_blocks, smem, s);
  if (dtype == 1)
    return wide_rows
               ? launch<__nv_bfloat16, 384>(a, blocks, finish_blocks, smem, s)
               : launch<__nv_bfloat16, 256>(a, blocks, finish_blocks, smem, s);
  return wide_rows ? launch<__half, 384>(a, blocks, finish_blocks, smem, s)
                   : launch<__half, 256>(a, blocks, finish_blocks, smem, s);
}

// x and y (rows, hidden) of one dtype (0 fp32, 1 bf16, 2 fp16), the hidden
// dim contiguous, row strides in elements; w and b (hidden,) contiguous of
// dtypes `w_dtype`, `b_dtype` (the same codes), each null for none; mean
// and rstd fp32 (rows,).  The plan (ops.layer_norm.fwd_plan): `blocks`
// blocks of `warps` warps and `rows_per_block` rows covering the rows
// exactly (the last one short); `wpr` warps a row: a power of two up to
// 8 with hidden <= wpr * 1024 and warps a multiple of wpr up to 8, or 12
// on blocks of one such row for hidden in (8192, 16384]; `stages` ring
// slots (1-8; 0: no ring, the rows read straight from device memory);
// `width` the load and store width in bytes: 16 (hidden * element size a
// multiple of 16 and x, y and their row strides 16-byte aligned; the only
// width a ring takes), 4 (4-byte multiples and alignment) or 2 (16-bit
// rows).  A plan or input that breaks these is cudaErrorInvalidValue with
// nothing launched.  rms: 1 for RMSNorm.  Launches on `stream`; returns 0
// when launched, else the CUDA error.
extern "C" int apex_layer_norm_fwd(int dtype, const void* x,
                                   long long x_stride, const void* w,
                                   int w_dtype, const void* b, int b_dtype,
                                   void* y, long long y_stride, void* mean,
                                   void* rstd, float eps, int rms, int rows,
                                   int hidden, int blocks, int rows_per_block,
                                   int warps, int wpr, int stages, int width,
                                   void* stream) {
  const int el = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || rows <= 0 || hidden <= 0 ||
      hidden > kMaxHidden)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool narrow_rows = (wpr & (wpr - 1)) == 0 && wpr >= 1 && wpr <= 8 &&
                           hidden <= wpr * 32 * kMaxCols && warps >= wpr &&
                           warps <= 8 && warps % wpr == 0;
  const bool wide_rows = warps == kWideWarps && wpr == kWideWarps &&
                         hidden > 8 * 32 * kMaxCols;
  // a ring (1-8 slots) for the 12-warp rows of 16 bytes, none otherwise
  const bool ring = wide_rows && width == 16;
  bool ok = (narrow_rows || wide_rows) && blocks >= 1 &&
            rows_per_block >= 1 &&
            (long long)blocks * rows_per_block >= rows &&
            (long long)(blocks - 1) * rows_per_block < rows &&
            (ring ? stages >= 1 && stages <= kFwdMaxStages : stages == 0) &&
            mean != nullptr && rstd != nullptr;
  if (width == 16)
    ok = ok && (long long)hidden * el % 16 == 0 && aligned(x, 16) &&
         aligned(y, 16) && x_stride * el % 16 == 0 &&
         y_stride * el % 16 == 0;
  else if (width == 4)
    ok = ok && (long long)hidden * el % 4 == 0 && aligned(x, 4) &&
         aligned(y, 4) && x_stride * el % 4 == 0 && y_stride * el % 4 == 0;
  else
    ok = ok && width == 2 && el == 2;
  if (w != nullptr) ok = ok && w_dtype >= 0 && w_dtype <= 2;
  if (b != nullptr) ok = ok && b_dtype >= 0 && b_dtype <= 2;
  const int smem = fwd_block_smem(el, hidden, warps, wpr, stages);
  if (!ok || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a;
  a.x = x;
  a.w = w;
  a.b = b;
  a.y = y;
  a.mean = static_cast<float*>(mean);
  a.rstd = static_cast<float*>(rstd);
  a.x_stride = x_stride;
  a.y_stride = y_stride;
  a.eps = eps;
  a.w_dtype = w_dtype;
  a.b_dtype = b_dtype;
  // w and b absent or rows of x's dtype that 16-byte loads can read
  a.w_vec = w == nullptr || (w_dtype == dtype && aligned(w, 16));
  a.b_vec = b == nullptr || (b_dtype == dtype && aligned(b, 16));
  a.rows = rows;
  a.hidden = hidden;
  a.rows_per_block = rows_per_block;
  a.wpr = wpr;
  a.stages = stages;
  a.width = width;
  a.rms = rms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return wide_rows ? launch_fwd<float, 384>(a, blocks, warps, smem, s)
                     : launch_fwd<float, 256>(a, blocks, warps, smem, s);
  if (dtype == 1)
    return wide_rows
               ? launch_fwd<__nv_bfloat16, 384>(a, blocks, warps, smem, s)
               : launch_fwd<__nv_bfloat16, 256>(a, blocks, warps, smem, s);
  return wide_rows ? launch_fwd<__half, 384>(a, blocks, warps, smem, s)
                   : launch_fwd<__half, 256>(a, blocks, warps, smem, s);
}
