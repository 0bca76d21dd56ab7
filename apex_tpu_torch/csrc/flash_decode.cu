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
// What bounds it on an H100: bytes, and before them memory latency.
// Each visible K/V row is read once and used for G*q_len query rows
// (usually 1), about 1 flop per byte read, far under the ~295 flop/byte
// at which the tensor cores become the limit; so the design spends
// nothing on tensor cores.  A decode launch moves only tens of MB
// through ~1000 small blocks, so what a block waits on is the chain of
// dependent reads (length, table, K/V), not the bandwidth.  The design
// keeps that chain short and every read wide:
//   * one thread block per (slot, kv head, tile of <= 8 query rows);
//     the loop over the slot's keys takes the place of the TPU grid's
//     sequential table axis.  The block reads lengths[s] and
//     block_table[s, t] itself (Pallas had them by scalar prefetch).
//   * the 4 warps take disjoint 32-key chunks.  A warp copies its
//     chunk's K and V rows into shared memory with 16-byte cp.async
//     copies, all issued at once and coalesced along each page (one
//     wait per chunk, not one per row), and reads the next chunk's
//     table entries while they fly.  Only keys < min(length, max_pages
//     * page) are copied, so a slot of length 0 never reads the table.
//   * in shared memory K rows are swizzled by 16-byte piece, so each
//     lane scores its own key (one key per lane, all query rows of the
//     tile sharing the read) without bank conflicts; for P.V each lane
//     owns d/32 output columns and reads V rows whole across the warp.
//   * each warp keeps its own online softmax (m, l, acc in fp32) and
//     the four are merged once at the end through shared memory.
//   * masked keys (position >= the row's visibility) are skipped, not
//     multiplied by 0: a recycled page may hold anything.  The final
//     divide uses max(l, 1e-30) as the TPU kernel does.
// Rounding follows the TPU kernel: scores are fp32 dots scaled in fp32,
// and p is rounded to the cache dtype before the P.V product
// (flash_decode.py:245).  That rounding is why, in bf16, this kernel
// sits further from the fp32 plain version than the fp32 kernel does.
// heads_per_step, the TPU kernel's head-packing knob, is a tiling
// choice that this kernel does not make.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowTile = 8;   // query rows per block; grid.z tiles the rest
constexpr int kChunk = 32;    // keys per warp iteration, one per lane
constexpr unsigned kFull = 0xffffffffu;

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
  const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

// 16-byte global -> shared copy that bypasses the registers (and L1)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// dynamic shared memory: each warp's K and V staging during the key
// loop, then (reused) the warps' softmax states for the merge
template <typename T, int D>
constexpr size_t smem_bytes() {
  constexpr size_t staging = size_t(kWarps) * 2 * kChunk * D * sizeof(T);
  constexpr size_t merge = size_t(kWarps) * kRowTile * (D + 2) * sizeof(float);
  return staging > merge ? staging : merge;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, long long q_s_slot, long long q_s_pos,
    long long q_s_head, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ lengths, T* __restrict__ out, int q_len, int hq,
    int hkv, int n_pages, int page, int max_pages, float scale) {
  constexpr int kCols = D / 32;          // output columns per lane
  constexpr int kE = 16 / sizeof(T);     // elements per 16-byte piece
  constexpr int kPieces = D / kE;        // pieces per K/V row (>= 8)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float q_s[kRowTile][D];

  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = hq / hkv;
  const int rows = G * q_len;           // row r = g * q_len + i
  const int r0 = blockIdx.z * kRowTile;
  const int nr = min(kRowTile, rows - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // out is (n_slots, q_len, hq, D) contiguous
  auto out_at = [&](int r, int col) -> T* {
    const int g = r / q_len, i = r % q_len;
    return out + (((long long)s * q_len + i) * hq + (long long)kvh * G + g) *
                     D + col;
  };

  const int length = lengths[s];
  if (length <= 0) {  // inactive slot: exact zeros, the table is not read
    for (int e = tid; e < nr * D; e += kThreads)
      *out_at(r0 + e / D, e % D) = from_float<T>(0.f);
    return;
  }

  // keys past the table's capacity are never visited (the TPU grid ends
  // at max_pages); every visible position is below `length`
  const int kv_end = min(length, max_pages * page);
  const long long page_elems = (long long)page * D;
  const T* k_head = k_pages + (long long)kvh * n_pages * page_elems;
  const T* v_head = v_pages + (long long)kvh * n_pages * page_elems;

  // element offset, within its head, of this lane's key in the chunk
  // starting at `base`; keys at or past kv_end read nothing
  auto key_offset = [&](int base) -> long long {
    const int kvpos = base + lane;
    if (kvpos >= kv_end) return 0;
    const int t = kvpos / page;
    const int pg = block_table[(long long)s * max_pages + t];
    return (long long)pg * page_elems + (long long)(kvpos - t * page) * D;
  };
  long long off = key_offset(warp * kChunk);  // in flight with q's loads

  for (int e = tid; e < nr * D; e += kThreads) {
    const int r = r0 + e / D, g = r / q_len, i = r % q_len;
    q_s[e / D][e % D] = to_float(
        q[s * q_s_slot + i * q_s_pos + ((long long)kvh * G + g) * q_s_head +
          e % D]);
  }
  __syncthreads();

  float m[kRowTile], l[kRowTile], acc[kRowTile][kCols];
  int vis[kRowTile];
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    vis[r] = r < nr ? length - q_len + 1 + (r0 + r) % q_len : 0;
  }

  // this warp's staging: K rows (16-byte pieces swizzled by row) then V
  T* k_s = reinterpret_cast<T*>(smem) + warp * 2 * kChunk * D;
  T* v_s = k_s + kChunk * D;

  for (int base = warp * kChunk; base < kv_end; base += kWarps * kChunk) {
    const int n_keys = min(kChunk, kv_end - base);  // warp-uniform
    // 32 consecutive pieces per step: rows adjacent in a page copy
    // coalesced.  Piece c of row j lands at piece c ^ (j % 8).
#pragma unroll
    for (int it = 0; it < kPieces; ++it) {
      const int p = it * 32 + lane;
      const int row = p / kPieces, c = p % kPieces;
      const long long src = __shfl_sync(kFull, off, row) + c * kE;
      if (row < n_keys) {
        cp_async16(k_s + row * D + (c ^ (row % 8)) * kE, k_head + src);
        cp_async16(v_s + row * D + c * kE, v_head + src);
      }
    }
    off = key_offset(base + kWarps * kChunk);  // the next chunk's table
    cp_async_wait_all();
    __syncwarp();

    // scores of this lane's key against every row of the tile
    const int kvpos = base + lane;
    const bool key_ok = lane < n_keys;
    float sc[kRowTile];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) sc[r] = 0.f;
    if (key_ok) {
      const T* krow = k_s + lane * D;
#pragma unroll
      for (int u = 0; u < kPieces; ++u) {
        float kf[kE];
        load16(krow + (u ^ (lane % 8)) * kE, kf);
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          if (r < nr) {
#pragma unroll
            for (int j = 0; j < kE; ++j)
              sc[r] = fmaf(q_s[r][u * kE + j], kf[j], sc[r]);
          }
        }
      }
    }

    // online softmax, per row.  nr, vis[r] and cmax are the same in
    // every lane, so each branch below is warp-uniform and rows the
    // tile does not hold cost no shuffle.
    float pc[kRowTile];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      pc[r] = 0.f;
      if (r < nr) {
        const bool ok = key_ok && kvpos < vis[r];
        const float sr = sc[r] * scale;
        const float cmax = warp_max(ok ? sr : -INFINITY);
        if (cmax != -INFINITY) {
          const float m_new = fmaxf(m[r], cmax);
          const float alpha = expf(m[r] - m_new);
          const float p = ok ? expf(sr - m_new) : 0.f;
          l[r] = l[r] * alpha + warp_sum(p);
          m[r] = m_new;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
          pc[r] = to_float(from_float<T>(p));  // P.V in the cache dtype
        }
      }
    }

    // P.V: key j's V row, p broadcast from lane j; rows past n_keys
    // were never copied and keys a row cannot see are skipped
#pragma unroll 4
    for (int j = 0; j < n_keys; ++j) {
      float vf[kCols];
      load_cols(v_s + j * D + lane * kCols, vf);
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        if (r < nr) {
          const float pj = __shfl_sync(kFull, pc[r], j);
          if (base + j < vis[r]) {
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              acc[r][c] = fmaf(pj, vf[c], acc[r][c]);
          }
        }
      }
    }
    __syncwarp();  // the staging is free for the next chunk's copies
  }

  // merge the four warps' softmax states (reusing the staging memory)
  float* m_s = reinterpret_cast<float*>(smem);  // [kWarps][kRowTile]
  float* l_s = m_s + kWarps * kRowTile;         // [kWarps][kRowTile]
  float* acc_s = l_s + kWarps * kRowTile;       // [kWarps][kRowTile][D]
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) {
    if (r < nr) {
      if (lane == 0) {
        m_s[warp * kRowTile + r] = m[r];
        l_s[warp * kRowTile + r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc_s[(warp * kRowTile + r) * D + lane * kCols + c] = acc[r][c];
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * D; e += kThreads) {
    const int r = e / D, col = e % D;
    const int vis_r = length - q_len + 1 + (r0 + r) % q_len;
    float o = 0.f;  // rows with no visible position stay exact zeros
    if (vis_r > 0) {
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * kRowTile + r]);
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = m_s[w * kRowTile + r];
        if (mw != -INFINITY) {
          const float f = expf(mw - mx);
          lsum += l_s[w * kRowTile + r] * f;
          a += acc_s[(w * kRowTile + r) * D + col] * f;
        }
      }
      o = a / fmaxf(lsum, 1e-30f);
    }
    *out_at(r0 + r, col) = from_float<T>(o);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, long long q_s_slot, long long q_s_pos,
                   long long q_s_head, const void* k_pages,
                   const void* v_pages, const void* block_table,
                   const void* lengths, void* out, int n_slots, int q_len,
                   int hq, int hkv, int n_pages, int page, int max_pages,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  if (smem > 48 * 1024) {  // above the default limit: opt in, once
    static bool opted_in = false;
    if (!opted_in) {
      const cudaError_t e = cudaFuncSetAttribute(
          decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      opted_in = true;
    }
  }
  const int rows = (hq / hkv) * q_len;
  const dim3 grid(n_slots, hkv, (rows + kRowTile - 1) / kRowTile);
  decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), q_s_slot, q_s_pos, q_s_head,
      static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(block_table), static_cast<const int*>(lengths),
      static_cast<T*>(out), q_len, hq, hkv, n_pages, page, max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim 64 or 128.  q strides are
// in elements (its last dim must be contiguous); the pages (16-byte
// aligned), table, lengths and out are contiguous.  Launches on
// `stream` and returns the CUDA error of the launch (0 = launched).
extern "C" int apex_flash_decode(int dtype, int head_dim, const void* q,
                                 long long q_s_slot, long long q_s_pos,
                                 long long q_s_head, const void* k_pages,
                                 const void* v_pages, const void* block_table,
                                 const void* lengths, void* out, int n_slots,
                                 int q_len, int hq, int hkv, int n_pages,
                                 int page, int max_pages, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define APEX_FD_LAUNCH(T, D)                                                  \
  return static_cast<int>(launch<T, D>(                                       \
      q, q_s_slot, q_s_pos, q_s_head, k_pages, v_pages, block_table, lengths, \
      out, n_slots, q_len, hq, hkv, n_pages, page, max_pages, scale, st))
  if (dtype == 0 && head_dim == 64) APEX_FD_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) APEX_FD_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) APEX_FD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) APEX_FD_LAUNCH(__nv_bfloat16, 128);
#undef APEX_FD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
