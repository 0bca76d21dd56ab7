// Per-channel sums (the batch norm's statistics) for Hopper (sm_90a), plain
// C interface.
//
// Replaces: apex_tpu/ops/welford.py:_stats_kernel (launched by
// channel_sums).  Same contract: over a contiguous (rows, C) tensor of
// fp32, bf16, fp16 or fp64, the fp32 sums sum_r x[r, c] and sum_r
// x[r, c]^2, each (C,).
//
// What bounds it on an H100: bytes.  x is read once (2 bytes an element
// in bf16) for 3 flops; the stem's (3211264, 64) bf16 is 411 MB, 0.1227 ms
// at 3.35 TB/s, the last stage's (12544, 2048) 51 MB, 0.0153 ms.  The TPU
// kernel carries one (1, C) accumulator across its sequential grid; blocks
// on the card run in any order.  The design (the host plan `sums_plan`):
//   * one launch a call.  A block of 256 threads owns every channel of a
//     column chunk (all C channels up to 256 16-byte vectors a row: 2048
//     channels in 16-bit) over a run of rows, which is one contiguous
//     range of bytes.  Each thread owns one 16-byte vector of channels
//     (8 in 16-bit, 4 in fp32, 2 in fp64) of every R-th row of the run,
//     R = 256 / (vectors a row), and keeps their fp32 sums in registers;
//     it issues the loads of its next 8 rows before it adds the current
//     ones.  About a block an SM: two or four, more bytes in flight,
//     measured slower (scripts/port_hopper_ablation.py --sums).
//   * a block's threads meet in shared memory, the R row slots summed in
//     slot order; the blocks of a thread-block cluster (the most, up to
//     8, that divide the blocks: 6 of 132) then meet in rank order
//     through distributed shared memory, each block summing a slice of
//     the channels over the cluster and writing the cluster's partial
//     sums.  With one cluster those are the outputs.
//   * with more, the last cluster to finish, which it learns from an
//     integer ticket (atomicInc, which wraps back to 0 for the next
//     call), sums the clusters' partials in cluster order, a slice of
//     the channels a block.  A second launch that sums them instead
//     measured no faster on an H100 (PERF.md).
//   * a C whose bytes are not a multiple of 16, or an unaligned base,
//     takes one element a load (the plan's load width).
//   * no float atomics and a fixed order of every sum: the same bits on
//     every run, whichever cluster finishes last.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef APEX_SUMS_MATH
// 0: the rows stream through, their bits folded by OR (timed only)
#define APEX_SUMS_MATH 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kMaxVec = 8;  // channels of a 16-byte vector (16-bit)
constexpr int kUnroll = 8;  // 16-byte loads a thread issues before it adds

struct Args {
  const void* x;
  float* s;  // (c,) outputs
  float* q;
  float* part;            // (clusters, 2, c) partials, clusters > 1
  unsigned int* ticket;   // 0 between calls, clusters > 1
  long long rows;
  int c, rows_per_block, cluster, clusters, vec, chunk;  // chunk: vectors
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(double v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// every thread of every block of the cluster: the writes to shared memory
// before it are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the float at this block's shared-memory address `a` in the cluster's
// block `rank`
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

// `v` to this block's shared-memory address `a` in the cluster's block
// `rank`
__device__ __forceinline__ void st_cluster(uint32_t a, uint32_t rank,
                                           uint32_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(remote), "r"(v)
               : "memory");
}

// channel ch's partial sums over the clusters, in cluster order, eight
// clusters' loads issued before the first of them is added
__device__ __forceinline__ void sum_parts(const float* part, int clusters,
                                          int c, int ch, float& ps,
                                          float& pq) {
  ps = pq = 0.f;
  for (int k0 = 0; k0 < clusters; k0 += 8) {
    float ls[8], lq[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (k0 + j < clusters) {
        ls[j] = __ldcg(part + (2LL * (k0 + j)) * c + ch);
        lq[j] = __ldcg(part + (2LL * (k0 + j) + 1) * c + ch);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (k0 + j < clusters) {
        ps += ls[j];
        pq += lq[j];
      }
  }
}

// a 16-byte vector of T as floats, or one element (VEC false)
template <typename T, bool VEC>
struct Piece {
  static constexpr int E = VEC ? 16 / sizeof(T) : 1;
  using Raw = typename std::conditional<VEC, uint4, T>::type;
  static __device__ __forceinline__ Raw load(const T* p) {
    if constexpr (VEC)
      return __ldcs(reinterpret_cast<const uint4*>(p));
    else
      return *p;
  }
  static __device__ __forceinline__ void add(const Raw& u, float (&s)[E],
                                             float (&q)[E]) {
#if APEX_SUMS_MATH
    const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float v = to_float(h[i]);
      s[i] += v;
      q[i] = fmaf(v, v, q[i]);
    }
#else
    uint32_t bits;
    if constexpr (VEC)
      bits = u.x | u.y | u.z | u.w;
    else
      bits = __float_as_uint(to_float(u));
    s[0] = __uint_as_float(__float_as_uint(s[0]) | bits);
#endif
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) channel_sums_kernel(Args a) {
  using P = Piece<T, VEC>;
  constexpr int E = P::E;
  // the threads' sums by row slot, then the block's sums (sums, squares)
  __shared__ float red[2 * kThreads * kMaxVec];
  __shared__ float bsum[2 * kThreads * kMaxVec];
  __shared__ uint32_t last;
  const int tid = threadIdx.x;
  const int C = a.c, V = a.vec;  // vectors a row
  const int W = a.chunk * E;     // channels of this block's column chunk
  const int R = kThreads / a.chunk;
  const int lc = tid % a.chunk, rs = tid / a.chunk;
  const int vcol = blockIdx.y * a.chunk + lc;
  const bool mine = rs < R && vcol < V;
  const int rank = blockIdx.x % a.cluster, cid = blockIdx.x / a.cluster;

  float s[E], q[E];
#pragma unroll
  for (int i = 0; i < E; ++i) s[i] = q[i] = 0.f;
  if (mine) {
    const long long row0 = (long long)blockIdx.x * a.rows_per_block;
    const long long row_end =
        min(row0 + a.rows_per_block, static_cast<long long>(a.rows));
    const T* x = static_cast<const T*>(a.x) + (long long)vcol * E;
    // batches of kUnroll rows (every R-th), the next batch's loads
    // issued before the current one is added; rows added in order
    const long long span = (long long)(kUnroll - 1) * R;
    long long r = row0 + rs;
    typename P::Raw u[kUnroll], nu[kUnroll];
    bool more = r + span < row_end;
    if (more) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) u[j] = P::load(x + (r + j * R) * C);
    }
    while (more) {
      const long long rn = r + (long long)kUnroll * R;
      const bool next = rn + span < row_end;
      if (next) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
          nu[j] = P::load(x + (rn + j * R) * C);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) P::add(u[j], s, q);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) u[j] = nu[j];
      r = rn;
      more = next;
    }
    for (; r < row_end; r += R) P::add(P::load(x + r * C), s, q);
  }
  if (rs < R) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      red[rs * W + lc * E + i] = s[i];
      red[(R + rs) * W + lc * E + i] = q[i];
    }
  }
  __syncthreads();
  // the block's sums: the row slots in slot order
  for (int cc = tid; cc < W; cc += kThreads) {
    float bs = 0.f, bq = 0.f;
#pragma unroll 8
    for (int k = 0; k < R; ++k) {
      bs += red[k * W + cc];
      bq += red[(R + k) * W + cc];
    }
    bsum[cc] = bs;
    bsum[W + cc] = bq;
  }
  // the cluster's sums: each block a slice of the chunk's channels, the
  // blocks in rank order
  const int cs = a.cluster;
  if (cs > 1)
    cluster_sync();
  else
    __syncthreads();
  const int c0 = blockIdx.y * W;  // the chunk's first channel
  const int slice = (W + cs - 1) / cs;
  const bool direct = a.clusters == 1;
  for (int cc = rank * slice + tid; cc < min(W, (rank + 1) * slice);
       cc += kThreads) {
    float ps = 0.f, pq = 0.f;
    if (cs == 1) {
      ps = bsum[cc];
      pq = bsum[W + cc];
    } else {
      // every rank's value loaded before the first is added
      float vs[kMaxCluster], vq[kMaxCluster];
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)
        if (k < cs) {
          vs[k] = ld_cluster(smem_u32(&bsum[cc]), k);
          vq[k] = ld_cluster(smem_u32(&bsum[W + cc]), k);
        }
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)
        if (k < cs) {
          ps += vs[k];
          pq += vq[k];
        }
    }
    const int ch = c0 + cc;
    if (ch < C) {
      if (direct) {
        a.s[ch] = ps;
        a.q[ch] = pq;
      } else {
        a.part[(2LL * cid) * C + ch] = ps;
        a.part[(2LL * cid + 1) * C + ch] = pq;
      }
    }
  }
  if (direct) {
    if (cs > 1) cluster_sync();  // no block leaves while another reads it
    return;
  }
  // the last cluster to finish sums the clusters' partials
  __threadfence();  // this block's partials, before the ticket
  if (cs > 1)
    cluster_sync();
  else
    __syncthreads();
  if (rank == 0 && tid == 0) {
    const unsigned int total = a.clusters * gridDim.y;
    const uint32_t is_last = atomicInc(a.ticket, total - 1) == total - 1;
    if (is_last) __threadfence();  // the others' partials, after the ticket
    if (cs == 1)
      last = is_last;
    else
      for (int k = 0; k < cs; ++k) st_cluster(smem_u32(&last), k, is_last);
  }
  if (cs > 1)
    cluster_sync();
  else
    __syncthreads();
  if (!last) return;
  const int fslice = (C + cs - 1) / cs;
  for (int ch = rank * fslice + tid; ch < min(C, (rank + 1) * fslice);
       ch += kThreads) {
    float ps, pq;
    sum_parts(a.part, a.clusters, C, ch, ps, pq);
    a.s[ch] = ps;
    a.q[ch] = pq;
  }
}

template <typename T, bool VEC>
int launch(const Args& a, int row_blocks, int col_blocks,
           cudaStream_t stream) {
  const auto kernel = channel_sums_kernel<T, VEC>;
  const dim3 grid(row_blocks, col_blocks);
  if (a.cluster == 1) {
    kernel<<<grid, kThreads, 0, stream>>>(a);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = a.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t l = cudaLaunchKernelEx(&cfg, kernel, a);
    if (l != cudaSuccess) return static_cast<int>(l);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// x contiguous (rows, c) of dtype 0 fp32, 1 bf16, 2 fp16, 3 fp64; s and q
// fp32 (c,).  The plan (ops.welford.sums_plan): `row_blocks` blocks (a
// multiple of `cluster`, 1-8) of `rows_per_block` rows covering the rows
// (a trailing block may have none), times `col_blocks` column chunks of
// `chunk` vectors (at most 256; the chunks cover the row's vectors);
// `width` the load width in bytes: 16 (c * element size a multiple of 16
// and x 16-byte aligned) or the element size.  With more than one
// cluster (row_blocks / cluster > 1), `part` is fp32 scratch of
// (row_blocks / cluster, 2, c) and `ticket` an unsigned int that is 0
// (each call leaves it 0; calls that may run at once need their own).  A
// plan or input that breaks these is cudaErrorInvalidValue with nothing
// launched.  Launches on `stream`; returns 0 when launched, else the CUDA
// error.
extern "C" int apex_channel_sums(int dtype, const void* x, long long rows,
                                 int c, void* s, void* q, void* part,
                                 void* ticket, int row_blocks,
                                 int rows_per_block, int cluster,
                                 int col_blocks, int chunk, int width,
                                 void* stream) {
  const int el = dtype == 0 ? 4 : dtype == 3 ? 8 : 2;
  const bool vec = width == 16;
  const long long vecs = vec ? (long long)c * el / 16 : c;
  bool ok = dtype >= 0 && dtype <= 3 && rows > 0 && c > 0 && s && q &&
            cluster >= 1 && cluster <= kMaxCluster && row_blocks >= cluster &&
            row_blocks % cluster == 0 && rows_per_block >= 1 &&
            (long long)row_blocks * rows_per_block >= rows &&
            chunk >= 1 && chunk <= kThreads && col_blocks >= 1 &&
            col_blocks <= 65535 && (long long)col_blocks * chunk >= vecs &&
            (long long)(col_blocks - 1) * chunk < vecs;
  if (vec)
    ok = ok && (long long)c * el % 16 == 0 && aligned(x, 16);
  else
    ok = ok && width == el;
  const int clusters = row_blocks / cluster;
  if (clusters > 1)
    ok = ok && part != nullptr && ticket != nullptr;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.s = static_cast<float*>(s);
  a.q = static_cast<float*>(q);
  a.part = static_cast<float*>(part);
  a.ticket = static_cast<unsigned int*>(ticket);
  a.rows = rows;
  a.c = c;
  a.rows_per_block = rows_per_block;
  a.cluster = cluster;
  a.clusters = clusters;
  a.vec = static_cast<int>(vecs);
  a.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch<float, true>(a, row_blocks, col_blocks, st)
               : launch<float, false>(a, row_blocks, col_blocks, st);
  if (dtype == 1)
    return vec ? launch<__nv_bfloat16, true>(a, row_blocks, col_blocks, st)
               : launch<__nv_bfloat16, false>(a, row_blocks, col_blocks, st);
  if (dtype == 2)
    return vec ? launch<__half, true>(a, row_blocks, col_blocks, st)
               : launch<__half, false>(a, row_blocks, col_blocks, st);
  return vec ? launch<double, true>(a, row_blocks, col_blocks, st)
             : launch<double, false>(a, row_blocks, col_blocks, st);
}
