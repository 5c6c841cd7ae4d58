// One location-sensitive attention step for Hopper (sm_90a).
//
// lsa_step_kernel replaces transtacos_retunegan_tpu/ops/lsa_kernel.py ::
// _kernel (launched by lsa_step_fused).  Per batch row:
//
//   loc  = window(cum) @ loc_mat        (location conv and dense folded into
//                                        one [kwin, A] matrix)
//   e    = tanh(keys + q + loc + b) . v
//   a    = softmax(e) over the text positions with mask > 0: masked
//          energies are -1e30, the weights are multiplied by the mask and
//          the divisor gets +1e-30, so an all-masked row gives zeros
//   cum' = cum + a
//   ctx  = a @ values
//
// The TPU kernel builds the kwin-tap windows with a constant [N*kwin, N]
// shift-matrix matmul, because gathers are slow there and the MXU is idle.
// Here the window is a direct stencil over the cumulative alignment held in
// shared memory with its zero halo of kwin/2 on each side.
//
// What bounds it on an H100: each input is read once and each output
// written once, about 0.8 MB at B=8, N=64, A=128, D=256, i.e. 0.24 us at
// 3.35 TB/s, and about 4.7 MFLOP of float32 work.  Both are far under one
// kernel launch, so the time is latency: the launch, and the longest chain
// of dependent round trips to memory and barriers inside it.  So the kernel
// makes one round trip to load and reads nothing from a peer CTA: the
// exchange across the cluster is stores and one cluster barrier.
//
// Design: one thread-block cluster of C CTAs per batch row (grid (C, B),
// cluster dims (C, 1, 1)); CTA r owns the contiguous tile of P text
// positions [r*P, min((r+1)*P, N)), with P = max(8, ceil(N/8)) and
// C = ceil(N/P) <= 8, the portable cluster size (lsa_plan; mirrored by
// ops/lsa_kernel.py::lsa_plan).
// - Loads: every operand a CTA reads (its window of cum, mask, keys and
//   values, q, b, v, loc_mat) is copied to shared memory with cp.async at
//   the start, all copies in flight at once; the values are waited for only
//   before the context.  A tile must fit: about 1.5 KB per text position
//   at A=128, D=256, so N up to about 1,000 (ERR_SMEM beyond).
// - Stencil: a thread owns one column c of A and CHUNK positions of its
//   tile at a time, with one accumulator per position, so the kwin taps
//   form CHUNK independent chains.  The window of cum is read as
//   broadcasts, loc_mat and keys with c on neighbouring banks.
// - Energies: per position a warp butterfly over its 32 columns, then the
//   warps' partials added in a fixed order by warp 0.
// - Softmax and context over the cluster, through distributed shared
//   memory: each CTA keeps its max m_r, its weights w_n = exp(e_n - m_r)
//   (0 where masked) and their sum s_r, and computes its unnormalised
//   partial context ctx_r[d] = sum_n w_n values[n, d].  It stores (m_r, s_r)
//   into every CTA of the cluster and each column of ctx_r into the CTA
//   that owns the column (CTA j owns a slice of ceil(D/C) columns), then
//   one cluster.sync().  A store into a peer is fire-and-forget, where a
//   load from it is a round trip of most of a microsecond; after the
//   barrier every read is local and no CTA touches a peer again, so no
//   second barrier is needed.  Every CTA then takes, in rank order,
//   M = max m_j and S = sum s_j exp(m_j - M); it writes
//   align_n = w_n exp(m_r - M) / (S + 1e-30) and cum' for its own positions,
//   and the context of its slice, summed over the C partials in rank order.
// No atomics, and every sum is taken in an order fixed by N alone, so a row
// gives the same bits at any B and on every launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_KWIN = 63;
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr int MIN_TILE = 8;       // text positions per CTA, at least
constexpr int CHUNK = 8;          // positions a thread carries at once
constexpr int SMEM_LIMIT = 227 * 1024;
// returned when no cluster of the plan fits on the device, and when a
// CTA's tile needs more shared memory than a block has
constexpr int ERR_CLUSTER_FIT = 1 << 20;
constexpr int ERR_SMEM = (1 << 20) + 1;

struct Plan {
  int c, p;   // CTAs per row (the cluster), text positions per CTA
};

Plan plan(int n) {
  int p = (n + MAX_CLUSTER - 1) / MAX_CLUSTER;
  if (p < MIN_TILE) p = MIN_TILE;
  return {(n + p - 1) / p, p};
}

__host__ __device__ inline int round_chunk(int p) {
  return (p + CHUNK - 1) / CHUNK * CHUNK;
}

// columns of ctx each CTA of a C-CTA cluster sums: CTA j owns
// [j * sw, min((j + 1) * sw, D))
__host__ __device__ inline int slice_width(int D, int C) {
  return (D + C - 1) / C;
}

// shared floats of one CTA: values [P, D], keys [P, A], loc_mat [kwin, A],
// the (m_j, s_j) and the partial contexts of this CTA's slice that its
// peers store into it, the padded window of cum, the mask and the weights
// [P], the warps' energy partials, q, b, v [A]
__host__ __device__ inline long long smem_floats(int P, int A, int D,
                                                 int kwin, int C) {
  const long long pc = round_chunk(P), nwc = (A + 31) / 32;
  return (long long)P * D + (long long)(P + kwin) * A + 2 * MAX_CLUSTER +
         (long long)C * slice_width(D, C) + (pc + kwin - 1) + 2LL * P +
         pc * nwc + 3LL * A;
}

// asynchronous copies from global to shared memory (cp.async), 4 or 16
// bytes: all of a CTA's operands are in flight at once, one round trip
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// A cluster barrier in two halves, arrive without ordering memory and wait:
// arriving at entry and waiting just before the first store into a peer's
// shared memory makes sure that every CTA of the cluster is running by
// then, at no cost on the way.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(THREADS, 1)
lsa_step_kernel(int N, int A, int D, int kwin, int P,
                const float* __restrict__ q, const float* __restrict__ cum,
                const float* __restrict__ keys,
                const float* __restrict__ values,
                const float* __restrict__ mask,
                const float* __restrict__ loc_mat,
                const float* __restrict__ v, const float* __restrict__ b,
                float* __restrict__ align, float* __restrict__ cum_out,
                float* __restrict__ ctx) {
  extern __shared__ __align__(16) float s[];
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int row = blockIdx.y, t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  const int half = kwin / 2, n0 = r * P;
  const int cnt = min(P, N - n0);             // >= 1: (C - 1) * P < N
  const int nch = (cnt + CHUNK - 1) / CHUNK;  // chunks of this tile
  const int nwc = (A + 31) / 32, apad = nwc * 32, pc = round_chunk(P);
  const int sw = slice_width(D, C);
  float* vals = s;                            // [P, D]
  float* ks = vals + P * D;                   // [P, A]
  float* locm = ks + P * A;                   // [kwin, A]
  float* gstat = locm + kwin * A;             // [MAX_CLUSTER][2], from peers
  float* gctx = gstat + 2 * MAX_CLUSTER;      // [C][sw], from peers
  float* cpad = gctx + C * sw;                // [pc + kwin - 1]
  float* msk = cpad + pc + kwin - 1;          // [P]
  float* w = msk + P;                         // [P]
  float* red = w + P;                         // [chunk][warp of A][CHUNK]
  float* qs = red + pc * nwc;                 // [A]
  float* bs = qs + A;                         // [A]
  float* vs = bs + A;                         // [A]
  // 16-byte copies of loc_mat, keys and values where they are aligned
  const bool vec =
      A % 4 == 0 && D % 4 == 0 &&
      (((size_t)keys | (size_t)values | (size_t)loc_mat) & 15) == 0;

  // every operand of the tile, copied to shared memory at once: the window
  // of cum over the tile's chunks (zero outside [0, N)), the mask, q, b, v,
  // loc_mat and keys; then the values, waited for only before the context
  const float* cr = cum + (size_t)row * N;
  for (int i = t; i < nch * CHUNK + kwin - 1; i += nt) {
    const int j = n0 + i - half;
    if (j >= 0 && j < N)
      copy_async(cpad + i, cr + j);
    else
      cpad[i] = 0.f;
  }
  for (int i = t; i < cnt; i += nt)
    copy_async(msk + i, mask + (size_t)row * N + n0 + i);
  for (int i = t; i < A; i += nt) {
    copy_async(qs + i, q + (size_t)row * A + i);
    copy_async(bs + i, b + i);
    copy_async(vs + i, v + i);
  }
  const float* kr = keys + ((size_t)row * N + n0) * A;
  const float* vr = values + ((size_t)row * N + n0) * D;
  if (vec) {
    for (int i = 4 * t; i < kwin * A; i += 4 * nt)
      copy_async16(locm + i, loc_mat + i);
    for (int i = 4 * t; i < cnt * A; i += 4 * nt) copy_async16(ks + i, kr + i);
    copy_commit();
    for (int i = 4 * t; i < cnt * D; i += 4 * nt)
      copy_async16(vals + i, vr + i);
  } else {
    for (int i = t; i < kwin * A; i += nt) copy_async(locm + i, loc_mat + i);
    for (int i = t; i < cnt * A; i += nt) copy_async(ks + i, kr + i);
    copy_commit();
    for (int i = t; i < cnt * D; i += nt) copy_async(vals + i, vr + i);
  }
  copy_commit();
  copy_wait<1>();
  __syncthreads();

  // energies: (chunk, column) items, whole warps on one chunk
  for (int i = t; i < nch * apad; i += nt) {
    const int ch = i / apad, c = i - ch * apad, p0 = ch * CHUNK;
    float part[CHUNK];
    if (c < A) {
      float kv[CHUNK], acc[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        kv[j] = p0 + j < cnt ? ks[(p0 + j) * A + c] : 0.f;
        acc[j] = 0.f;
      }
      const float* cw = cpad + p0;
#pragma unroll 8
      for (int k = 0; k < kwin; ++k) {
        const float l = locm[k * A + c];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) acc[j] = fmaf(cw[j + k], l, acc[j]);
      }
      const float qc = qs[c], bc = bs[c], vc = vs[c];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        part[j] = tanhf(kv[j] + qc + acc[j] + bc) * vc;
    } else {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) part[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) part[j] = warp_sum(part[j]);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        red[(ch * nwc + (c >> 5)) * CHUNK + j] = part[j];
    }
  }
  __syncthreads();

  // the tile's masked energies, max m_r, weights and their sum s_r
  float m = -INFINITY, sum = 0.f;
  if (warp == 0) {
    for (int p = lane; p < cnt; p += 32) {
      const float* pr = red + (p / CHUNK) * nwc * CHUNK + p % CHUNK;
      float e = 0.f;
#pragma unroll 4
      for (int k = 0; k < nwc; ++k) e += pr[k * CHUNK];
      e = msk[p] > 0.f ? e : -1e30f;
      w[p] = e;
      m = fmaxf(m, e);
    }
    m = warp_max(m);
    for (int p = lane; p < cnt; p += 32) {
      const float x = msk[p] > 0.f ? expf(w[p] - m) : 0.f;
      w[p] = x;
      sum += x;
    }
    sum = warp_sum(sum);
  }
  copy_wait<0>();
  __syncthreads();

  // the tile's unnormalised partial context, stored with (m_r, s_r) into
  // the shared memory of the CTAs that own its columns
  cluster_wait();
  for (int d = t; d < D; d += nt) {
    float acc = 0.f;
#pragma unroll 8
    for (int p = 0; p < cnt; ++p) acc = fmaf(w[p], vals[p * D + d], acc);
    const int j = d / sw;
    cluster.map_shared_rank(gctx, j)[r * sw + d - j * sw] = acc;
  }
  if (warp == 0 && lane < C) {
    float* st = cluster.map_shared_rank(gstat, lane) + 2 * r;
    st[0] = m;
    st[1] = sum;
  }
  cluster.sync();

  // merge, in rank order, from this CTA's own shared memory
  float M = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAX_CLUSTER; ++j)
    if (j < C) M = fmaxf(M, gstat[2 * j]);
  float f[MAX_CLUSTER], S = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_CLUSTER; ++j) {
    if (j < C) {
      f[j] = expf(gstat[2 * j] - M);
      S += gstat[2 * j + 1] * f[j];
    }
  }
  const float den = S + 1e-30f, inv = 1.f / den;
  const float own = expf(gstat[2 * r] - M);
#pragma unroll
  for (int j = 0; j < MAX_CLUSTER; ++j)
    if (j < C) f[j] *= inv;
  // the context of the slice on the lower threads, the tile's alignment on
  // the upper ones
  const int d0 = r * sw, d1 = min(D, d0 + sw);
  for (int d = d0 + t; d < d1; d += nt) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j)
      if (j < C) acc = fmaf(gctx[j * sw + d - d0], f[j], acc);
    ctx[(size_t)row * D + d] = acc;
  }
  for (int p = (t + nt / 2) % nt; p < cnt; p += nt) {
    const float a = w[p] * own / den;
    const size_t o = (size_t)row * N + n0 + p;
    align[o] = a;
    cum_out[o] = cpad[half + p] + a;
  }
}

// The launch floor: no work, the same grid, cluster and shared memory.
__global__ void __launch_bounds__(THREADS, 1) lsa_floor_kernel() {}

// Grid (C, B) of THREADS-thread CTAs in clusters of (C, 1, 1), or a
// non-zero code: bad arguments, too much shared memory (ERR_SMEM), or no
// cluster of this shape fits on the device (ERR_CLUSTER_FIT).
int configure(const void* kernel, int B, int N, int A, int D, int kwin,
              void* stream, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr) {
  if (B < 1 || B > 65535 || N < 1 || A < 1 || D < 1 || kwin < 1 ||
      kwin % 2 == 0 || kwin > MAX_KWIN)
    return (int)cudaErrorInvalidValue;
  const Plan pl = plan(N);
  const long long bytes = smem_floats(pl.p, A, D, kwin, pl.c) *
                          (long long)sizeof(float);
  if (bytes > SMEM_LIMIT) return ERR_SMEM;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(pl.c, B, 1);
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = (size_t)bytes;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;

  // whether one cluster fits, asked once per device, kernel, C and bytes
  static std::mutex lock;
  static std::map<std::tuple<int, const void*, int, long long>, int> fits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const auto key = std::make_tuple(dev, kernel, pl.c, bytes);
  std::lock_guard<std::mutex> hold(lock);
  auto it = fits.find(key);
  if (it == fits.end()) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
    if (err != cudaSuccess) return (int)err;
    it = fits.emplace(key, clusters).first;
  }
  return it->second > 0 ? 0 : ERR_CLUSTER_FIT;
}

}  // namespace

extern "C" {

// The kernel's choice for N text positions: C CTAs per row, P positions
// each (ops/lsa_kernel.py::lsa_plan mirrors it).
void lsa_plan(int n, int* c, int* p) {
  const Plan pl = plan(n);
  *c = pl.c;
  *p = pl.p;
}

// q [B,A], cum [B,N], keys [B,N,A], values [B,N,D], mask [B,N],
// loc_mat [kwin,A], v [A], b [A] -> align [B,N], cum_out [B,N], ctx [B,D];
// all float32, contiguous.  Returns a cudaError_t code, ERR_SMEM or
// ERR_CLUSTER_FIT.
int lsa_step(int B, int N, int A, int D, int kwin, const float* q,
             const float* cum, const float* keys, const float* values,
             const float* mask, const float* loc_mat, const float* v,
             const float* b, float* align, float* cum_out, float* ctx,
             void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc = configure((const void*)lsa_step_kernel, B, N, A, D, kwin,
                           stream, &cfg, &attr);
  if (rc != 0) return rc;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, lsa_step_kernel, N, A, D, kwin, plan(N).p, q,
                         cum, keys, values, mask, loc_mat, v, b, align,
                         cum_out, ctx);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// lsa_floor_kernel launched as lsa_step would launch lsa_step_kernel.
int lsa_floor(int B, int N, int A, int D, int kwin, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc = configure((const void*)lsa_floor_kernel, B, N, A, D, kwin,
                           stream, &cfg, &attr);
  if (rc != 0) return rc;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, lsa_floor_kernel);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

const char* lsa_error_string(int code) {
  if (code == ERR_CLUSTER_FIT)
    return "no thread-block cluster of this shape fits on the device";
  if (code == ERR_SMEM)
    return "text too long: a CTA's tile does not fit in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
