// Fused autoregressive decode of the TransTacoS decoder for Hopper (sm_90a).
//
// Two kernels, one step function:
//
//   decode_step_kernel  replaces transtacos_retunegan_tpu/ops/fused_decoder.py
//                       :: _make_step_kernel (launched by _call_step inside
//                       fused_decode's lax.scan).  One decode step per
//                       launch; the carry goes in and out through global
//                       memory and a torch loop drives the steps.
//   decode_full_kernel  replaces fused_decoder.py :: _make_full_kernel
//                       (fused_decode_full).  The TPU kernel runs the decode
//                       as a sequential grid with the carry in VMEM scratch;
//                       GPU blocks run in parallel with nothing carried
//                       between them, so here each block owns one batch row
//                       and loops over all steps with its carry held in
//                       shared memory.  With early_exit a block stops
//                       computing once ITS row has finished and emits zero
//                       frame/stop/align with fin = 1 for the rest.
//
// step() computes _step_math (fused_decoder.py:189-270) for one batch row in
// one block: ReLU prenet -> input-feed projection of [prenet, ctx] ->
// residual GRU tower (gates r|z|n, input bias bi, hidden bias only bhn
// inside r*(.)) -> location-sensitive attention (query projection, 31-tap
// location feature of the cumulative alignment through the folded [31, A]
// matrix, tanh(keys + q + loc + b) . v, softmax masked with -1e30 and a
// +1e-30 denominator, context) -> frame [r*M] and stop [r] heads -> per-row
// stop (any of r sigmoids >= 0.5) -> impute-finished selection of the carry.
// Matmul operands are bf16 (or f32) weights with f32 accumulation; the
// activation feeding each matmul is rounded to the weight type first, as
// the Pallas kernel's x.astype(bf16) does.  Biases, the location matrix, v
// and the carry are f32.
//
// What bounds it on an H100: every step reads all decoder weights (about
// 3.8 M elements, 7.6 MB in bf16) once for one or a few rows, so a step is a
// chain of memory-bound GEMVs with a sequential dependency between steps.
// The bound is the weight bytes over 3.35 TB/s per step (the weights also
// fit the 50 MB L2).  This simple design gives each batch row ONE block
// (one SM): a GEMV reads weight rows [in, out] coalesced across threads, one
// output column per thread (split along the input when there are fewer
// columns than threads), activations broadcast from shared memory.  One SM
// cannot pull more than a small fraction of the card's bandwidth, so the
// kernel sits far above its bound; splitting the weights across SMs with a
// grid-wide barrier per step (or a cluster, TMA and wgmma) is the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_PRENET = 4;
constexpr int MAX_GRU = 4;
constexpr int N_META = 53;
constexpr int MAX_THREADS = 512;

struct Args {
  int B, N, M, D, H, A, R, RM, KWIN, n_prenet, n_gru, steps, early_exit, nt;
  long long smem_bytes;
  int prenet[MAX_PRENET];
  // element offsets into the weight buffer ([in, out] row-major matrices)
  long long o_pre[MAX_PRENET], o_wx, o_wi[MAX_GRU], o_wh[MAX_GRU], o_wq, o_wf,
      o_ws;
  // element offsets into the f32 buffer
  long long o_bpre[MAX_PRENET], o_bx, o_bi[MAX_GRU], o_bhn[MAX_GRU], o_loc,
      o_v, o_ba, o_bf, o_bs;
};

// meta layout: see ops/fused_decoder.py::_meta
int unpack(const long long* m, int n, Args* a) {
  if (n != N_META) return 1;
  int i = 0;
  a->B = (int)m[i++]; a->N = (int)m[i++]; a->M = (int)m[i++];
  a->D = (int)m[i++]; a->H = (int)m[i++]; a->A = (int)m[i++];
  a->R = (int)m[i++]; a->RM = (int)m[i++]; a->KWIN = (int)m[i++];
  a->n_prenet = (int)m[i++]; a->n_gru = (int)m[i++]; a->steps = (int)m[i++];
  a->early_exit = (int)m[i++]; a->nt = (int)m[i++]; a->smem_bytes = m[i++];
  for (int k = 0; k < MAX_PRENET; ++k) a->prenet[k] = (int)m[i++];
  for (int k = 0; k < MAX_PRENET; ++k) a->o_pre[k] = m[i++];
  a->o_wx = m[i++];
  for (int k = 0; k < MAX_GRU; ++k) a->o_wi[k] = m[i++];
  for (int k = 0; k < MAX_GRU; ++k) a->o_wh[k] = m[i++];
  a->o_wq = m[i++]; a->o_wf = m[i++]; a->o_ws = m[i++];
  for (int k = 0; k < MAX_PRENET; ++k) a->o_bpre[k] = m[i++];
  a->o_bx = m[i++];
  for (int k = 0; k < MAX_GRU; ++k) a->o_bi[k] = m[i++];
  for (int k = 0; k < MAX_GRU; ++k) a->o_bhn[k] = m[i++];
  a->o_loc = m[i++]; a->o_v = m[i++]; a->o_ba = m[i++];
  a->o_bf = m[i++]; a->o_bs = m[i++];
  if (i != N_META) return 1;
  if (a->n_prenet < 1 || a->n_prenet > MAX_PRENET || a->n_gru < 1 ||
      a->n_gru > MAX_GRU || a->nt < 32 || a->nt > MAX_THREADS ||
      a->nt % 32 != 0 || a->B < 1 || a->N < 1)
    return 1;
  return 0;
}

__host__ __device__ inline int imax(int x, int y) { return x > y ? x : y; }
__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }

// Shared-memory carve-up in floats; ops/fused_decoder.py::smem_bytes
// computes the same total and the launcher checks that the two agree.
struct Layout {
  int h, ctx, cum, prev, fin, act, vin, x, gi, gh, q, locm, cpad, e, ctxn,
      out, red, total;
};

__host__ __device__ inline Layout layout(const Args& a) {
  int pmax = 0;
  for (int i = 0; i < a.n_prenet; ++i) pmax = imax(pmax, a.prenet[i]);
  const int plast = a.prenet[a.n_prenet - 1];
  const int vmax = imax(imax(a.M, pmax), imax(plast + a.D, a.H + a.D));
  Layout L;
  int o = 0;
  L.h = o;    o += up4(a.n_gru * a.H);   // carry: GRU states
  L.ctx = o;  o += up4(a.D);             // carry: context
  L.cum = o;  o += up4(a.N);             // carry: cumulative alignment
  L.prev = o; o += up4(a.M);             // carry: previous frame
  L.fin = o;  o += 4;                    // carry: finished flag
  L.act = o;  o += up4(pmax);            // prenet activations
  L.vin = o;  o += up4(vmax);            // rounded GEMV input
  L.x = o;    o += up4(a.H);             // GRU tower activation / rnn out
  L.gi = o;   o += up4(3 * a.H);
  L.gh = o;   o += up4(3 * a.H);
  L.q = o;    o += up4(a.A);
  L.locm = o; o += up4(a.KWIN * a.A);    // folded location matrix
  L.cpad = o; o += up4(a.N + a.KWIN - 1);
  L.e = o;    o += up4(a.N);             // energies, then alignment
  L.ctxn = o; o += up4(a.D);
  L.out = o;  o += up4(a.RM + a.R);      // frame + stop head outputs
  L.red = o;  o += up4(a.nt);            // reduction scratch
  L.total = o;
  return L;
}

template <typename W> __device__ __forceinline__ float ldw(const W* p);
template <> __device__ __forceinline__ float ldw<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float ldw<__nv_bfloat16>(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

// the activation as the matmul sees it: rounded to the weight type
template <typename W> __device__ __forceinline__ float rnd(float x) {
  return x;
}
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// y[c] = sum_i x[i] * w[i * out + c] (+ bias[c]); x, y in shared memory.
// Ends with a barrier.  Callers barrier after writing x.
template <typename W>
__device__ void gemv(const W* __restrict__ w, int in, int out,
                     const float* x, float* y,
                     const float* __restrict__ bias, float* red) {
  const int nt = blockDim.x, t = threadIdx.x;
  if (out >= nt) {
    for (int c = t; c < out; c += nt) {
      const W* col = w + c;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int i = 0;
      for (; i + 4 <= in; i += 4) {
        a0 = fmaf(x[i], ldw(col + (size_t)i * out), a0);
        a1 = fmaf(x[i + 1], ldw(col + (size_t)(i + 1) * out), a1);
        a2 = fmaf(x[i + 2], ldw(col + (size_t)(i + 2) * out), a2);
        a3 = fmaf(x[i + 3], ldw(col + (size_t)(i + 3) * out), a3);
      }
      for (; i < in; ++i) a0 = fmaf(x[i], ldw(col + (size_t)i * out), a0);
      y[c] = ((a0 + a1) + (a2 + a3)) + (bias ? bias[c] : 0.f);
    }
  } else {
    // fewer columns than threads: split the input among ks thread groups
    const int ks = nt / out;
    const int c = t % out, k0 = t / out;
    float acc = 0.f;
    if (k0 < ks)
      for (int i = k0; i < in; i += ks)
        acc = fmaf(x[i], ldw(w + (size_t)i * out + c), acc);
    red[t] = acc;
    __syncthreads();
    if (t < out) {
      float s = 0.f;
      for (int k = 0; k < ks; ++k) s += red[k * out + t];
      y[t] = s + (bias ? bias[t] : 0.f);
    }
  }
  __syncthreads();
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

// One decode step of this block's row.  The carry is in shared memory and
// is updated in place; the row's emissions go to frames_o [RM], stop_o [R],
// align_o [N] and *fin_o.  keys/values/mask point at the row.
template <typename W>
__device__ void step(const Args& a, const Layout& L, float* s,
                     const W* __restrict__ wb, const float* __restrict__ fb,
                     const float* __restrict__ keys,
                     const float* __restrict__ values,
                     const float* __restrict__ mask, float* frames_o,
                     float* stop_o, float* align_o, float* fin_o) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int H = a.H, D = a.D, N = a.N, A = a.A;
  float* h = s + L.h;
  float* ctx = s + L.ctx;
  float* cum = s + L.cum;
  float* prev = s + L.prev;
  float* act = s + L.act;
  float* vin = s + L.vin;
  float* x = s + L.x;
  float* gi = s + L.gi;
  float* gh = s + L.gh;
  float* q = s + L.q;
  const float* locm = s + L.locm;
  float* cpad = s + L.cpad;
  float* e = s + L.e;
  float* ctxn = s + L.ctxn;
  float* out = s + L.out;
  float* red = s + L.red;
  const float was_fin = s[L.fin];
  const bool held = was_fin > 0.f;

  // ---- prenet
  const float* src = prev;
  int in = a.M;
  for (int l = 0; l < a.n_prenet; ++l) {
    for (int i = t; i < in; i += nt) vin[i] = rnd<W>(src[i]);
    __syncthreads();
    gemv<W>(wb + a.o_pre[l], in, a.prenet[l], vin, act, fb + a.o_bpre[l], red);
    for (int i = t; i < a.prenet[l]; i += nt) act[i] = fmaxf(act[i], 0.f);
    __syncthreads();
    src = act;
    in = a.prenet[l];
  }

  // ---- input feeding: x = [prenet, ctx] @ wx + bx
  for (int i = t; i < in; i += nt) vin[i] = rnd<W>(act[i]);
  for (int i = t; i < D; i += nt) vin[in + i] = rnd<W>(ctx[i]);
  __syncthreads();
  gemv<W>(wb + a.o_wx, in + D, H, vin, x, fb + a.o_bx, red);

  // ---- residual GRU tower
  for (int j = 0; j < a.n_gru; ++j) {
    float* hj = h + j * H;
    for (int i = t; i < H; i += nt) vin[i] = rnd<W>(x[i]);
    __syncthreads();
    gemv<W>(wb + a.o_wi[j], H, 3 * H, vin, gi, fb + a.o_bi[j], red);
    for (int i = t; i < H; i += nt) vin[i] = rnd<W>(hj[i]);
    __syncthreads();
    gemv<W>(wb + a.o_wh[j], H, 3 * H, vin, gh, nullptr, red);
    const float* bhn = fb + a.o_bhn[j];
    for (int c = t; c < H; c += nt) {
      const float r = sigm(gi[c] + gh[c]);
      const float z = sigm(gi[H + c] + gh[H + c]);
      const float n = tanhf(gi[2 * H + c] + r * (gh[2 * H + c] + bhn[c]));
      const float hn = (1.f - z) * n + z * hj[c];
      x[c] = hn + x[c];
      if (!held) hj[c] = hn;
    }
    __syncthreads();
  }

  // ---- location-sensitive attention
  const int half = a.KWIN / 2, npad = N + a.KWIN - 1;
  for (int i = t; i < H; i += nt) vin[i] = rnd<W>(x[i]);
  for (int i = t; i < npad; i += nt) {
    const int j = i - half;
    cpad[i] = (j >= 0 && j < N) ? cum[j] : 0.f;
  }
  __syncthreads();
  gemv<W>(wb + a.o_wq, H, A, vin, q, nullptr, red);
  const float* v = fb + a.o_v;
  const float* ba = fb + a.o_ba;
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  for (int n = warp; n < N; n += nw) {
    const float* kr = keys + (size_t)n * A;
    float part = 0.f;
    for (int c = lane; c < A; c += 32) {
      float loc = 0.f;
      for (int k = 0; k < a.KWIN; ++k) loc = fmaf(cpad[n + k], locm[k * A + c], loc);
      part = fmaf(tanhf(kr[c] + q[c] + loc + ba[c]), v[c], part);
    }
    part = warp_sum(part);
    if (lane == 0) e[n] = mask[n] > 0.f ? part : -1e30f;
  }
  __syncthreads();
  float m = __int_as_float(0xff800000);   // -inf
  for (int n = t; n < N; n += nt) m = fmaxf(m, e[n]);
  m = block_max(m, red);
  float den = 0.f;
  for (int n = t; n < N; n += nt) {
    const float w = mask[n] > 0.f ? expf(e[n] - m) : 0.f;
    e[n] = w;
    den += w;
  }
  den = block_sum(den, red) + 1e-30f;
  for (int n = t; n < N; n += nt) e[n] = e[n] / den;
  __syncthreads();
  for (int d = t; d < D; d += nt) {
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc = fmaf(e[n], values[(size_t)n * D + d], acc);
    ctxn[d] = acc;
  }
  for (int i = t; i < H; i += nt) vin[i] = rnd<W>(x[i]);
  __syncthreads();

  // ---- frame and stop heads on [rnn, ctx_new]
  for (int i = t; i < D; i += nt) vin[H + i] = rnd<W>(ctxn[i]);
  __syncthreads();
  gemv<W>(wb + a.o_wf, H + D, a.RM, vin, out, fb + a.o_bf, red);
  gemv<W>(wb + a.o_ws, H + D, a.R, vin, out + a.RM, fb + a.o_bs, red);
  if (t < a.R) out[a.RM + t] = sigm(out[a.RM + t]);
  __syncthreads();

  // ---- stop rule, emissions, impute-finished carry update
  bool newly = false;
  for (int i = 0; i < a.R; ++i) newly = newly || out[a.RM + i] >= 0.5f;
  const float fin = fmaxf(was_fin, newly ? 1.f : 0.f);
  const float alive = 1.f - was_fin;
  for (int i = t; i < a.RM; i += nt) frames_o[i] = out[i] * alive;
  for (int i = t; i < a.R; i += nt) stop_o[i] = out[a.RM + i];
  for (int n = t; n < N; n += nt) align_o[n] = e[n];
  if (t == 0) *fin_o = fin;
  if (!held) {
    for (int i = t; i < D; i += nt) ctx[i] = ctxn[i];
    for (int n = t; n < N; n += nt) cum[n] = cum[n] + e[n];
    for (int i = t; i < a.M; i += nt) prev[i] = out[a.RM - a.M + i] * alive;
  }
  __syncthreads();
  if (t == 0) s[L.fin] = fin;
  __syncthreads();
}

__device__ void load_locm(const Args& a, const Layout& L, float* s,
                          const float* __restrict__ fb) {
  for (int i = threadIdx.x; i < a.KWIN * a.A; i += blockDim.x)
    s[L.locm + i] = fb[a.o_loc + i];
}

template <typename W>
__global__ void __launch_bounds__(MAX_THREADS)
decode_step_kernel(Args a, const W* __restrict__ wb,
                   const float* __restrict__ fb, const float* prev,
                   const float* ctx, const float* hs, const float* cum,
                   const float* __restrict__ keys,
                   const float* __restrict__ values,
                   const float* __restrict__ mask, const float* finished,
                   float* frames, float* stop, float* align, float* ctx_o,
                   float* cum_o, float* prev_o, float* fin_o, float* hs_o) {
  extern __shared__ __align__(16) float s[];
  const Layout L = layout(a);
  const int row = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int H = a.H, D = a.D, N = a.N, M = a.M;
  for (int j = 0; j < a.n_gru; ++j)
    for (int i = t; i < H; i += nt)
      s[L.h + j * H + i] = hs[((size_t)j * a.B + row) * H + i];
  for (int i = t; i < D; i += nt) s[L.ctx + i] = ctx[(size_t)row * D + i];
  for (int i = t; i < N; i += nt) s[L.cum + i] = cum[(size_t)row * N + i];
  for (int i = t; i < M; i += nt) s[L.prev + i] = prev[(size_t)row * M + i];
  if (t == 0) s[L.fin] = finished[row];
  load_locm(a, L, s, fb);
  __syncthreads();
  step<W>(a, L, s, wb, fb, keys + (size_t)row * N * a.A,
          values + (size_t)row * N * D, mask + (size_t)row * N,
          frames + (size_t)row * a.RM, stop + (size_t)row * a.R,
          align + (size_t)row * N, fin_o + row);
  for (int j = 0; j < a.n_gru; ++j)
    for (int i = t; i < H; i += nt)
      hs_o[((size_t)j * a.B + row) * H + i] = s[L.h + j * H + i];
  for (int i = t; i < D; i += nt) ctx_o[(size_t)row * D + i] = s[L.ctx + i];
  for (int i = t; i < N; i += nt) cum_o[(size_t)row * N + i] = s[L.cum + i];
  for (int i = t; i < M; i += nt) prev_o[(size_t)row * M + i] = s[L.prev + i];
}

template <typename W>
__global__ void __launch_bounds__(MAX_THREADS)
decode_full_kernel(Args a, const W* __restrict__ wb,
                   const float* __restrict__ fb,
                   const float* __restrict__ keys,
                   const float* __restrict__ values,
                   const float* __restrict__ mask, float* frames, float* stop,
                   float* align, float* fin) {
  extern __shared__ __align__(16) float s[];
  const Layout L = layout(a);
  const int row = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  for (int i = t; i < L.total; i += nt) s[i] = 0.f;   // zero carry
  __syncthreads();
  load_locm(a, L, s, fb);
  __syncthreads();
  const float* kr = keys + (size_t)row * a.N * a.A;
  const float* vr = values + (size_t)row * a.N * a.D;
  const float* mr = mask + (size_t)row * a.N;
  for (int st = 0; st < a.steps; ++st) {
    const size_t o = (size_t)st * a.B + row;
    float* fo = frames + o * a.RM;
    float* so = stop + o * a.R;
    float* ao = align + o * a.N;
    if (a.early_exit && s[L.fin] > 0.f) {
      // this row has finished: skip the step math
      for (int i = t; i < a.RM; i += nt) fo[i] = 0.f;
      for (int i = t; i < a.R; i += nt) so[i] = 0.f;
      for (int i = t; i < a.N; i += nt) ao[i] = 0.f;
      if (t == 0) fin[o] = 1.f;
      continue;
    }
    step<W>(a, L, s, wb, fb, kr, vr, mr, fo, so, ao, fin + o);
  }
}

template <typename K>
int prepare(K kern, const Args& a) {
  const Layout L = layout(a);
  const long long bytes = (long long)L.total * (long long)sizeof(float);
  if (bytes != a.smem_bytes) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename W>
int launch_full(const Args& a, const void* wb, const float* fb,
                const float* keys, const float* values, const float* mask,
                float* frames, float* stop, float* align, float* fin,
                cudaStream_t st) {
  int err = prepare(decode_full_kernel<W>, a);
  if (err) return err;
  decode_full_kernel<W><<<a.B, a.nt, (size_t)a.smem_bytes, st>>>(
      a, static_cast<const W*>(wb), fb, keys, values, mask, frames, stop,
      align, fin);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_step(const Args& a, const void* wb, const float* fb,
                const float* prev, const float* ctx, const float* hs,
                const float* cum, const float* keys, const float* values,
                const float* mask, const float* finished, float* frames,
                float* stop, float* align, float* ctx_o, float* cum_o,
                float* prev_o, float* fin_o, float* hs_o, cudaStream_t st) {
  int err = prepare(decode_step_kernel<W>, a);
  if (err) return err;
  decode_step_kernel<W><<<a.B, a.nt, (size_t)a.smem_bytes, st>>>(
      a, static_cast<const W*>(wb), fb, prev, ctx, hs, cum, keys, values,
      mask, finished, frames, stop, align, ctx_o, cum_o, prev_o, fin_o, hs_o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Whole decode: outputs frames [steps, B, RM], stop [steps, B, R],
// align [steps, B, N], fin [steps, B, 1].  Returns a cudaError_t code.
int decode_full(int bf16, const long long* meta, int n_meta, const void* wbuf,
                const float* fbuf, const float* keys, const float* values,
                const float* mask, float* frames, float* stop, float* align,
                float* fin, void* stream) {
  Args a;
  if (unpack(meta, n_meta, &a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_full<__nv_bfloat16>(a, wbuf, fbuf, keys, values, mask,
                                           frames, stop, align, fin, st)
              : launch_full<float>(a, wbuf, fbuf, keys, values, mask, frames,
                                   stop, align, fin, st);
}

// One step: carry in (prev [B,M], ctx [B,D], hs [n_gru,B,H], cum [B,N],
// finished [B,1]) -> emissions (frames [B,RM], stop [B,R], align [B,N]) and
// carry out (ctx_o, cum_o, prev_o, fin_o, hs_o).  Returns a cudaError_t code.
int decode_step(int bf16, const long long* meta, int n_meta, const void* wbuf,
                const float* fbuf, const float* prev, const float* ctx,
                const float* hs, const float* cum, const float* keys,
                const float* values, const float* mask, const float* finished,
                float* frames, float* stop, float* align, float* ctx_o,
                float* cum_o, float* prev_o, float* fin_o, float* hs_o,
                void* stream) {
  Args a;
  if (unpack(meta, n_meta, &a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_step<__nv_bfloat16>(
                    a, wbuf, fbuf, prev, ctx, hs, cum, keys, values, mask,
                    finished, frames, stop, align, ctx_o, cum_o, prev_o, fin_o,
                    hs_o, st)
              : launch_step<float>(a, wbuf, fbuf, prev, ctx, hs, cum, keys,
                                   values, mask, finished, frames, stop, align,
                                   ctx_o, cum_o, prev_o, fin_o, hs_o, st);
}

const char* decoder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
