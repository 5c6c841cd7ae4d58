// One location-sensitive attention step for Hopper (sm_90a).
//
// lsa_step_kernel replaces transtacos_retunegan_tpu/ops/lsa_kernel.py ::
// _kernel (launched by lsa_step_fused).  Per batch row:
//
//   loc  = window31(cum) @ loc_mat      (location conv and dense folded into
//                                        one [kwin, A] matrix)
//   e    = tanh(keys + q + loc + b) . v
//   a    = softmax(e) over the text positions with mask > 0: masked
//          energies are -1e30, the weights are multiplied by the mask and
//          the divisor gets +1e-30, so an all-masked row gives zeros
//   cum' = cum + a
//   ctx  = a @ values
//
// The TPU kernel builds the 31-tap windows with a constant [N*kwin, N]
// shift-matrix matmul, because gathers are slow there and the MXU is idle.
// Here the window is a direct stencil over the cumulative alignment held in
// shared memory with its zero halo of kwin/2 on each side.
//
// Design: one block per batch row, as the TPU grid.  Shared memory holds the
// padded cum, q, b, v, the [kwin, A] location matrix (15.9 KB at A=128,
// kwin=31) and the N energies.  One warp per text position reduces
// tanh(...) * v over A with its lanes on neighbouring a, so the keys reads
// coalesce and the location matrix is read without bank conflicts; the
// block takes the softmax's max and sum; threads over D compute the context
// with coalesced reads of values.
//
// What bounds it on an H100: each input is read once and each output written
// once, about 0.8 MB at B=8, N=64, A=128, D=256, i.e. 0.24 us at 3.35 TB/s;
// the location stencil (2*kwin*A operations per position) is 1-2 us of
// float32 work spread over B SMs.  Both are far under one kernel launch, so
// the launch sets the time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_KWIN = 63;
constexpr int SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide reductions; every thread gets the result
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  __syncthreads();
  return s;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) m = fmaxf(m, red[i]);
  __syncthreads();
  return m;
}

// shared floats of one block: padded cum, q, b, v, location matrix,
// energies, reduction scratch
__host__ __device__ inline int smem_floats(int N, int A, int kwin) {
  return (N + kwin - 1) + 3 * A + kwin * A + N + 32;
}

__global__ void __launch_bounds__(THREADS)
lsa_step_kernel(int N, int A, int D, int kwin, const float* __restrict__ q,
                const float* __restrict__ cum, const float* __restrict__ keys,
                const float* __restrict__ values,
                const float* __restrict__ mask,
                const float* __restrict__ loc_mat,
                const float* __restrict__ v, const float* __restrict__ b,
                float* __restrict__ align, float* __restrict__ cum_out,
                float* __restrict__ ctx) {
  extern __shared__ __align__(16) float s[];
  const int row = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int half = kwin / 2, npad = N + kwin - 1;
  float* cpad = s;
  float* qs = cpad + npad;
  float* bs = qs + A;
  float* vs = bs + A;
  float* locm = vs + A;
  float* e = locm + kwin * A;
  float* red = e + N;
  const float* cr = cum + (size_t)row * N;
  const float* mr = mask + (size_t)row * N;

  for (int i = t; i < npad; i += nt) {
    const int j = i - half;
    cpad[i] = (j >= 0 && j < N) ? cr[j] : 0.f;
  }
  for (int c = t; c < A; c += nt) {
    qs[c] = q[(size_t)row * A + c];
    bs[c] = b[c];
    vs[c] = v[c];
  }
  for (int i = t; i < kwin * A; i += nt) locm[i] = loc_mat[i];
  __syncthreads();

  // energies: one warp per text position
  const float* kr = keys + (size_t)row * N * A;
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  for (int n = warp; n < N; n += nw) {
    const float* kn = kr + (size_t)n * A;
    float part = 0.f;
    for (int c = lane; c < A; c += 32) {
      float loc = 0.f;
      for (int k = 0; k < kwin; ++k) loc = fmaf(cpad[n + k], locm[k * A + c], loc);
      part = fmaf(tanhf(kn[c] + qs[c] + loc + bs[c]), vs[c], part);
    }
    part = warp_sum(part);
    if (lane == 0) e[n] = mr[n] > 0.f ? part : -1e30f;
  }
  __syncthreads();

  // masked softmax
  float m = -INFINITY;
  for (int n = t; n < N; n += nt) m = fmaxf(m, e[n]);
  m = block_max(m, red);
  float den = 0.f;
  for (int n = t; n < N; n += nt) {
    const float w = mr[n] > 0.f ? expf(e[n] - m) : 0.f;
    e[n] = w;
    den += w;
  }
  den = block_sum(den, red) + 1e-30f;
  for (int n = t; n < N; n += nt) {
    const float a = e[n] / den;
    e[n] = a;
    align[(size_t)row * N + n] = a;
    cum_out[(size_t)row * N + n] = cr[n] + a;
  }
  __syncthreads();

  // context
  const float* vr = values + (size_t)row * N * D;
  for (int d = t; d < D; d += nt) {
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc = fmaf(e[n], vr[(size_t)n * D + d], acc);
    ctx[(size_t)row * D + d] = acc;
  }
}

}  // namespace

extern "C" {

// q [B,A], cum [B,N], keys [B,N,A], values [B,N,D], mask [B,N],
// loc_mat [kwin,A], v [A], b [A] -> align [B,N], cum_out [B,N], ctx [B,D];
// all float32, contiguous.  Returns a cudaError_t code.
int lsa_step(int B, int N, int A, int D, int kwin, const float* q,
             const float* cum, const float* keys, const float* values,
             const float* mask, const float* loc_mat, const float* v,
             const float* b, float* align, float* cum_out, float* ctx,
             void* stream) {
  if (B < 1 || N < 1 || A < 1 || D < 1 || kwin < 1 || kwin % 2 == 0 ||
      kwin > MAX_KWIN)
    return (int)cudaErrorInvalidValue;
  const long long bytes =
      (long long)smem_floats(N, A, kwin) * (long long)sizeof(float);
  if (bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lsa_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  lsa_step_kernel<<<B, THREADS, (size_t)bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      N, A, D, kwin, q, cum, keys, values, mask, loc_mat, v, b, align,
      cum_out, ctx);
  return (int)cudaGetLastError();
}

const char* lsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
