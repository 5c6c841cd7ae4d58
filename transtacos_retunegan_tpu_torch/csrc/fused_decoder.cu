// Fused autoregressive decode of the TransTacoS decoder for Hopper (sm_90a).
//
// Two kernels, one step function:
//
//   decode_full_kernel  replaces transtacos_retunegan_tpu/ops/fused_decoder.py
//                       :: _make_full_kernel (fused_decode_full): the whole
//                       decode in one launch.  With early_exit a row that
//                       has finished skips its work and emits zero
//                       frame/stop/align with fin = 1; once every row has
//                       finished the grid leaves the step loop together.
//   decode_step_kernel  replaces fused_decoder.py :: _make_step_kernel (one
//                       decode step per launch; the carry comes in and goes
//                       out through global memory and a torch loop drives
//                       the steps).  The path for shapes past the
//                       shared-memory fit check.
//
// step() computes _step_math (fused_decoder.py:189-270): ReLU prenet ->
// input-feed projection of [prenet, ctx] -> residual GRU tower (gates r|z|n,
// input bias bi, hidden bias only bhn inside r*(.)) -> location-sensitive
// attention (query projection, 31-tap location feature of the cumulative
// alignment through the folded [31, A] matrix, tanh(keys + q + loc + b) . v,
// softmax masked with -1e30 and a +1e-30 denominator, context) -> frame
// [r*M] and stop [r] heads -> per-row stop (any of r sigmoids >= 0.5) ->
// impute-finished selection of the carry.  Matmul operands are bf16 (or
// f32) weights with f32 accumulation; the activation feeding each matmul is
// rounded to the weight type first, as the Pallas kernel's x.astype(bf16)
// does.  Biases, the location matrix, v and the carry are f32.
//
// Design.  A step is a chain of GEMVs over 3.8 M weights (7.6 MB in bf16)
// with a sequential dependency between steps.  Both kernels run a
// persistent cooperative grid of G blocks, one per SM, and split every
// weight matrix [in, out] by output columns over the blocks; the GRU
// matrices by hidden unit, so that the block owning units c0..c1 holds
// columns c, H+c and 2H+c of wi_j and wh_j and updates its own units
// without an exchange.  ops/fused_decoder.py::fold_params pre-tiles wbuf so
// that each block's slice is one contiguous piece, column-major inside
// (slice() below gives its layout; the host passes each block's offset).
// decode_full_kernel copies its slice into shared memory once (at most
// 68 KB in bf16, 137 KB in f32 at G = 132, ws being whole in every block)
// and reuses it for every step; decode_step_kernel reads it from global
// memory (L2).  Each column's dot product is taken by one warp, its lanes
// striding over the input, for up to RB rows at once, so every weight is
// read once per step per RB rows.  Vectors cross blocks through a small
// global scratch read with ld.global.cg after a grid barrier (a monotonic
// arrival counter, release/acquire, with a bounded spin that sets an error
// word instead of hanging).  Barriers separate only dependent phases,
// n_prenet + n_gru + 5 per step:
//   1. prenet layer 0 on prev, and gh_j = h_j . wh_j for the block's units
//      (they depend only on the carry); further prenet layers one phase each
//   2. input-feed dense wx on [prenet, ctx]
//   3. per GRU j: gi_j and the update of the block's own units
//   4. the query wq
//   5. energies: (row, text position) pairs spread over the blocks
//   6. softmax, recomputed by every block for every row; the block's
//      context columns, alignment emission and cum update
//   7. the frame head by columns; the r stop logits computed redundantly by
//      every block, so that every block knows every row's fin
// No sum uses atomics and each output's sum is taken by the same lanes in
// the same order whatever B or G is, so a row decoded in a batch is
// bit-identical to the row decoded alone.
//
// What bounds it: latency, not bytes.  After the first step a step moves no
// weight bytes; it costs its grid barriers (each an L2 round trip for every
// block) plus, per phase, the L2 round trip that stages the phase's inputs
// into shared memory, a GEMV from shared memory, and the instructions around
// them.  tools/decode_phases.py times each phase on the card.  A later PR
// would add mma.sync or wgmma over B rows padded to 8 or 16, a TMA bulk copy
// of the slices, and fewer barriers per step (replicating the small wq in
// every block to fold phase 4 into phase 3, or exchanging through
// distributed shared memory within clusters).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_PRENET = 4;
constexpr int MAX_GRU = 4;
constexpr int N_META = 43;
constexpr int THREADS = 512;
constexpr int RB = 4;                       // rows per GEMV work item
constexpr int SYNC_FLOATS = 4;              // barrier counter, error word
constexpr unsigned long long SPIN_NS = 2000000000ull;   // 2 s per barrier
constexpr int ERR_BARRIER = 1;

struct Args {
  int B, N, M, D, H, A, R, RM, KWIN, n_prenet, n_gru, steps, early_exit, nt,
      G, wsize;
  long long smem_bytes, wtotal, scratch_floats;
  long long wmax;   // largest block's slice, elements
  int numax;        // most GRU units of a block
  int prenet[MAX_PRENET];
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
  a->early_exit = (int)m[i++]; a->nt = (int)m[i++]; a->G = (int)m[i++];
  a->wsize = (int)m[i++];
  a->smem_bytes = m[i++]; a->wtotal = m[i++]; a->scratch_floats = m[i++];
  a->wmax = m[i++]; a->numax = (int)m[i++];
  for (int k = 0; k < MAX_PRENET; ++k) a->prenet[k] = (int)m[i++];
  for (int k = 0; k < MAX_PRENET; ++k) a->o_bpre[k] = m[i++];
  a->o_bx = m[i++];
  for (int k = 0; k < MAX_GRU; ++k) a->o_bi[k] = m[i++];
  for (int k = 0; k < MAX_GRU; ++k) a->o_bhn[k] = m[i++];
  a->o_loc = m[i++]; a->o_v = m[i++]; a->o_ba = m[i++];
  a->o_bf = m[i++]; a->o_bs = m[i++];
  if (i != N_META) return 1;
  if (a->n_prenet < 1 || a->n_prenet > MAX_PRENET || a->n_gru < 1 ||
      a->n_gru > MAX_GRU || a->nt < 32 || a->nt > THREADS ||
      a->nt % 32 != 0 || a->B < 1 || a->N < 1 || a->G < 1 ||
      a->KWIN < 1 || a->KWIN > 32 || a->KWIN % 2 != 1 ||
      (a->wsize != 2 && a->wsize != 4))
    return 1;
  // span_lo's products stay within 32 bits
  long long widest = (long long)a->B * a->N;
  const long long dims[] = {a->H, a->A, a->RM, a->D, 3LL * a->H};
  for (long long d : dims) widest = d > widest ? d : widest;
  for (int k = 0; k < a->n_prenet; ++k) widest = a->prenet[k] > widest ? a->prenet[k] : widest;
  if ((long long)a->G * widest >= (1LL << 31)) return 1;
  return 0;
}

__host__ __device__ inline int imax(int x, int y) { return x > y ? x : y; }
__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline long long up8(long long n) { return (n + 7) & ~7LL; }

// first of the n items that block g of G owns: [lo(g), lo(g + 1))
__host__ __device__ inline int span_lo(int g, int G, int n) {
  return (int)((unsigned)g * (unsigned)n / (unsigned)G);
}

// Block g's slice of the weights: its columns of each matrix, stored
// column-major ([column][input]) one matrix after the other, each piece
// padded to 8 elements.  The GRU pieces hold the block's units unit-major:
// [unit][gate r|z|n][input].  Every block holds all r columns of ws.
// ops/fused_decoder.py::_slice computes the same.
struct Slice {
  int p0[MAX_PRENET], cp[MAX_PRENET];   // first column, columns per layer
  int x0, cx, u0, nu, q0, cq, f0, cf;
  long long o_pre[MAX_PRENET], o_wx, o_wi[MAX_GRU], o_wh[MAX_GRU], o_wq,
      o_wf, o_ws, size;
};

__host__ __device__ inline Slice slice(const Args& a, int g) {
  Slice s;
  long long o = 0;
  int in = a.M;
  for (int l = 0; l < a.n_prenet; ++l) {
    const int out = a.prenet[l];
    s.p0[l] = span_lo(g, a.G, out);
    s.cp[l] = span_lo(g + 1, a.G, out) - s.p0[l];
    s.o_pre[l] = o;
    o += up8((long long)s.cp[l] * in);
    in = out;
  }
  s.x0 = span_lo(g, a.G, a.H);
  s.cx = span_lo(g + 1, a.G, a.H) - s.x0;
  s.o_wx = o;
  o += up8((long long)s.cx * (in + a.D));
  s.u0 = s.x0;                          // GRU units: the same split of H
  s.nu = s.cx;
  for (int j = 0; j < a.n_gru; ++j) {
    s.o_wi[j] = o;
    o += up8(3LL * s.nu * a.H);
    s.o_wh[j] = o;
    o += up8(3LL * s.nu * a.H);
  }
  s.q0 = span_lo(g, a.G, a.A);
  s.cq = span_lo(g + 1, a.G, a.A) - s.q0;
  s.o_wq = o;
  o += up8((long long)s.cq * a.H);
  s.f0 = span_lo(g, a.G, a.RM);
  s.cf = span_lo(g + 1, a.G, a.RM) - s.f0;
  s.o_wf = o;
  o += up8((long long)s.cf * (a.H + a.D));
  s.o_ws = o;
  o += up8((long long)a.R * (a.H + a.D));
  s.size = o;
  return s;
}

// Shared memory of one block: the weight slice (staged kernels only),
// then f32 activations for B rows.  ops/fused_decoder.py::smem_bytes
// computes the same total and prepare() checks that the two agree (and
// that a.wmax and a.numax are the maxima over the blocks' slices).
struct Layout {
  long long wbytes, bytes;
  int bp, ldx, ldn, ld3, ldr;
  int locm, xin, gi, gh, e, sl, fin, rows, slot, misc, win, floats;
};

__host__ __device__ inline Layout layout(const Args& a, bool staged) {
  const long long wmax = a.wmax;
  const int numax = a.numax;
  int pmax = 0;
  for (int i = 0; i < a.n_prenet; ++i) pmax = imax(pmax, a.prenet[i]);
  const int plast = a.prenet[a.n_prenet - 1];
  const int vmax = imax(imax(a.M + a.n_gru * a.H, pmax),
                        imax(plast + a.D, a.H + a.D));
  Layout L;
  L.wbytes = staged ? (wmax * a.wsize + 15) / 16 * 16 : 0;
  L.bp = (a.B + RB - 1) / RB * RB;
  L.ldx = up4(vmax);
  L.ldn = up4(a.N);
  L.ld3 = up4(3 * numax);
  L.ldr = up4(a.R);
  int o = 0;
  L.locm = o; o += up4(a.KWIN * a.A);     // folded location matrix
  L.xin = o;  o += L.bp * L.ldx;          // rounded GEMV inputs per row
  L.gi = o;   o += L.bp * L.ld3;          // the block's GRU input gates
  L.gh = o;   o += a.n_gru * L.bp * L.ld3;  // its hidden gates, every GRU
  L.e = o;    o += L.bp * L.ldn;          // alignment per row
  L.sl = o;   o += L.bp * L.ldr;          // stop probabilities per row
  L.fin = o;  o += up4(a.B);              // carry: finished flags
  L.rows = o; o += up4(a.B);              // rows computed this step (int)
  L.slot = o; o += up4(a.B);              // row -> index in rows, or -1
  L.misc = o; o += 4;                     // row count, barrier verdict
  L.win = o;  o += a.nt;                  // a location window per warp
  L.floats = o;
  L.bytes = L.wbytes + 4LL * o;
  return L;
}

// Global scratch, f32, after SYNC_FLOATS words of barrier state.
// ops/fused_decoder.py::scratch_floats computes the same total.
struct Scratch {
  float *act, *x, *q, *e, *ctxn, *h, *ctx, *cum, *prev;
  long long floats;
};

__host__ __device__ inline Scratch scratch_of(const Args& a, float* base) {
  int pmax = 0;
  for (int i = 0; i < a.n_prenet; ++i) pmax = imax(pmax, a.prenet[i]);
  const long long B = a.B;
  Scratch s;
  long long o = SYNC_FLOATS;
  s.act = base + o;  o += a.n_prenet * B * pmax;
  s.x = base + o;    o += 2 * B * a.H;       // GRU tower, ping-pong
  s.q = base + o;    o += B * a.A;
  s.e = base + o;    o += B * a.N;           // energies
  s.ctxn = base + o; o += B * a.D;           // new context
  s.h = base + o;    o += a.n_gru * B * a.H;   // carry of decode_full
  s.ctx = base + o;  o += B * a.D;
  s.cum = base + o;  o += B * a.N;
  s.prev = base + o; o += B * a.M;
  s.floats = o;
  return s;
}

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

// a weight from shared or global memory (generic load)
template <typename W> __device__ __forceinline__ float ldw(const W* p);
template <> __device__ __forceinline__ float ldw<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float ldw<__nv_bfloat16>(const __nv_bfloat16* p) {
  const unsigned short u = *reinterpret_cast<const unsigned short*>(p);
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

// the activation as the matmul sees it: rounded to the weight type
template <typename W> __device__ __forceinline__ float rnd(float x) {
  return x;
}
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// data another block wrote: through L2, never a stale L1 line
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Grid-wide barrier over a monotonic arrival counter: barrier k of a launch
// waits until the counter reaches k * G.  The spin is bounded; past the
// bound (or once any block has failed) it sets the error word and every
// thread gets false, and the kernel returns.  Ends with __syncthreads.
struct GridBar {
  unsigned* count;
  int* err;
  unsigned target;
  int G;
};

__device__ bool grid_sync(GridBar& gb, int* verdict) {
  __syncthreads();
  if (threadIdx.x == 0) {
    gb.target += gb.G;
    __threadfence();
    red_release(gb.count, 1u);
    int ok = 1;
    const unsigned long long t0 = now_ns();
    unsigned spins = 0;
    while (ld_acquire(gb.count) < gb.target) {
      if ((++spins & 63u) == 0) {
        if (*(volatile int*)gb.err) { ok = 0; break; }
        if (now_ns() - t0 > SPIN_NS) {
          atomicExch(gb.err, ERR_BARRIER);
          ok = 0;
          break;
        }
      }
    }
    *verdict = ok;
  }
  __syncthreads();
  return *verdict != 0;
}

// For c < C and i < nact: f(c, i, sum_k xin[i][k] * w[c * K + k]).  One
// warp per (column, RB rows); lane l sums k = l, l + 32, ... in order, then
// a butterfly: the sum of one (column, row) never depends on B or G.  Warp
// w0 takes the first item, so that GEMVs of one phase called one after
// another run side by side; returns the warp after the last item.
template <typename W, typename F>
__device__ int gemv(const W* w, int C, int K, const float* xin, int ldx,
                    int nact, F f, int w0 = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int chunks = (nact + RB - 1) / RB;
  w0 %= nw;
  for (int it = (warp - w0 + nw) % nw; it < C * chunks; it += nw) {
    const int c = it % C, i0 = (it / C) * RB;
    const W* col = w + (size_t)c * K;
    const float* x = xin + (size_t)i0 * ldx;
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = lane; k < K; k += 32) {
      const float wv = ldw(col + k);
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = fmaf(x[r * ldx + k], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = warp_sum(acc[r]);
    if (lane == 0)
      for (int r = 0; r < RB && i0 + r < nact; ++r) f(c, i0 + r, acc[r]);
  }
  return w0 + C * chunks;
}

// A vector of every row that a phase stages: src[rows[i] * stride + k],
// k < K, goes to xin[i][off + k].
struct Piece {
  const float* src;
  long long stride;
  int K, off;
};

// xin[i][p.off + k] = rnd(p.src[rows[i] * p.stride + k]) for i < nact,
// k < p.K.  Few elements per thread (one row): one load each.  Many (a
// cohort): 16-byte loads, four in flight per thread before any store.
template <typename W>
__device__ void stage(float* xin, int ldx, const int* rows, int nact,
                      const Piece& p) {
  const int nt = blockDim.x, total = nact * p.K;
  const bool vec = (p.K & 3) == 0 && (p.stride & 3) == 0 && (p.off & 3) == 0 &&
                   (reinterpret_cast<size_t>(p.src) & 15) == 0;
  if (total <= 2 * nt || !vec) {
    for (int idx = threadIdx.x; idx < total; idx += nt) {
      const int i = idx / p.K, k = idx - i * p.K;
      xin[(size_t)i * ldx + p.off + k] = rnd<W>(ldcg(p.src + rows[i] * p.stride + k));
    }
    return;
  }
  const int K4 = p.K >> 2, total4 = total >> 2;
  for (int base = threadIdx.x; base < total4; base += 4 * nt) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * nt;
      if (idx < total4) {
        const int i = idx / K4, k = 4 * (idx - i * K4);
        v[u] = __ldcg(reinterpret_cast<const float4*>(p.src + rows[i] * p.stride + k));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * nt;
      if (idx < total4) {
        const int i = idx / K4, k = 4 * (idx - i * K4);
        float* d = xin + (size_t)i * ldx + p.off + k;
        d[0] = rnd<W>(v[u].x); d[1] = rnd<W>(v[u].y);
        d[2] = rnd<W>(v[u].z); d[3] = rnd<W>(v[u].w);
      }
    }
  }
}

// Carry of one step: in and out may alias (decode_full) since every carry
// vector is read only in a phase before the one that writes it.
struct Carry {
  const float *prev, *ctx, *h, *cum;
  float *prev_o, *ctx_o, *h_o, *cum_o;
};

// Emissions of one step: frames [B, RM], stop [B, R], align [B, N], fin [B]
struct Emit {
  float *frames, *stop, *align, *fin;
};

// One decode step of every row over the whole grid.  Returns false if a
// grid barrier failed.  fin_s (shared) holds each row's finished flag and
// is updated at the end; with early_exit, finished rows are skipped.
template <typename W>
__device__ bool step(const Args& a, const Layout& L, const Slice& sl,
                     unsigned char* smem, const W* __restrict__ wsl,
                     const float* __restrict__ fb, const float* keys,
                     const float* values, const float* mask,
                     const Scratch& sc, const Carry& cy, const Emit& em,
                     GridBar& gb) {
  float* s = reinterpret_cast<float*>(smem + L.wbytes);
  const int t = threadIdx.x, nt = blockDim.x, g = blockIdx.x;
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  const int B = a.B, H = a.H, D = a.D, N = a.N, A = a.A, M = a.M;
  float* xin = s + L.xin;
  float* gi = s + L.gi;
  float* gh = s + L.gh;
  float* al = s + L.e;
  float* slp = s + L.sl;
  float* fin_s = s + L.fin;
  int* rows = reinterpret_cast<int*>(s + L.rows);
  int* slot = reinterpret_cast<int*>(s + L.slot);
  int* misc = reinterpret_cast<int*>(s + L.misc);
  const int ldx = L.ldx, ld3 = L.ld3;

  if (t == 0) {
    int n = 0;
    for (int b = 0; b < B; ++b) {
      const bool skip = a.early_exit && fin_s[b] > 0.f;
      slot[b] = skip ? -1 : n;
      if (!skip) rows[n++] = b;
    }
    misc[0] = n;
  }
  __syncthreads();
  const int nact = misc[0];

  // ---- phase 1: prenet layer 0 on prev; gh_j of the block's units
  int pmax = 0;
  for (int i = 0; i < a.n_prenet; ++i) pmax = imax(pmax, a.prenet[i]);
  // xin rows: [prev | h_0 | h_1 | ...]
  stage<W>(xin, ldx, rows, nact, Piece{cy.prev, M, M, 0});
  for (int j = 0; j < a.n_gru; ++j)
    stage<W>(xin, ldx, rows, nact, Piece{cy.h + (size_t)j * B * H, H, H, M + j * H});
  __syncthreads();
  {
    const float* bias = fb + a.o_bpre[0];
    const int p0 = sl.p0[0];
    float* act = sc.act;
    int w0 = gemv(wsl + sl.o_pre[0], sl.cp[0], M, xin, ldx, nact,
                  [&](int c, int i, float v) {
                    act[(size_t)rows[i] * pmax + p0 + c] = fmaxf(v + bias[p0 + c], 0.f);
                  });
    for (int j = 0; j < a.n_gru; ++j) {
      float* ghj = gh + (size_t)j * L.bp * ld3;
      w0 = gemv(wsl + sl.o_wh[j], 3 * sl.nu, H, xin + M + j * H, ldx, nact,
                [&](int c, int i, float v) { ghj[i * ld3 + c] = v; }, w0);
    }
  }
  if (!grid_sync(gb, misc + 1)) return false;

  // ---- further prenet layers
  int in = a.prenet[0];
  for (int l = 1; l < a.n_prenet; ++l) {
    const float* src = sc.act + (size_t)(l - 1) * B * pmax;
    float* dst = sc.act + (size_t)l * B * pmax;
    stage<W>(xin, ldx, rows, nact, Piece{src, pmax, in, 0});
    __syncthreads();
    const float* bias = fb + a.o_bpre[l];
    const int p0 = sl.p0[l];
    gemv(wsl + sl.o_pre[l], sl.cp[l], in, xin, ldx, nact,
         [&](int c, int i, float v) {
           dst[(size_t)rows[i] * pmax + p0 + c] = fmaxf(v + bias[p0 + c], 0.f);
         });
    in = a.prenet[l];
    if (!grid_sync(gb, misc + 1)) return false;
  }

  // ---- phase 2: x = [prenet, ctx] @ wx + bx
  {
    const float* act = sc.act + (size_t)(a.n_prenet - 1) * B * pmax;
    stage<W>(xin, ldx, rows, nact, Piece{act, pmax, in, 0});
    stage<W>(xin, ldx, rows, nact, Piece{cy.ctx, D, D, in});
    __syncthreads();
    const float* bias = fb + a.o_bx;
    const int x0 = sl.x0;
    float* x = sc.x;
    gemv(wsl + sl.o_wx, sl.cx, in + D, xin, ldx, nact,
         [&](int c, int i, float v) {
           x[(size_t)rows[i] * H + x0 + c] = v + bias[x0 + c];
         });
  }
  if (!grid_sync(gb, misc + 1)) return false;

  // ---- phase 3: residual GRU tower, the block's units
  for (int j = 0; j < a.n_gru; ++j) {
    const float* src = sc.x + (size_t)(j & 1) * B * H;
    float* dst = sc.x + (size_t)((j + 1) & 1) * B * H;
    stage<W>(xin, ldx, rows, nact, Piece{src, H, H, 0});
    __syncthreads();
    const float* bi = fb + a.o_bi[j];
    const int u0 = sl.u0;
    gemv(wsl + sl.o_wi[j], 3 * sl.nu, H, xin, ldx, nact,
         [&](int c, int i, float v) {
           const int u = c / 3, gate = c - 3 * u;
           gi[i * ld3 + c] = v + bi[gate * H + u0 + u];
         });
    __syncthreads();
    const float* ghj = gh + (size_t)j * L.bp * ld3;
    const float* bhn = fb + a.o_bhn[j];
    const float* hin = cy.h + (size_t)j * B * H;
    float* hout = cy.h_o + (size_t)j * B * H;
    for (int idx = t; idx < nact * sl.nu; idx += nt) {
      const int i = idx / sl.nu, u = idx - i * sl.nu;
      const int b = rows[i], c = u0 + u;
      const float* gii = gi + i * ld3 + 3 * u;
      const float* ghi = ghj + i * ld3 + 3 * u;
      const float r = sigm(gii[0] + ghi[0]);
      const float z = sigm(gii[1] + ghi[1]);
      const float n = tanhf(gii[2] + r * (ghi[2] + bhn[c]));
      const float hold = ldcg(hin + (size_t)b * H + c);
      const float hn = (1.f - z) * n + z * hold;
      dst[(size_t)b * H + c] = hn + ldcg(src + (size_t)b * H + c);
      hout[(size_t)b * H + c] = fin_s[b] > 0.f ? hold : hn;
    }
    if (!grid_sync(gb, misc + 1)) return false;
  }
  const float* xr = sc.x + (size_t)(a.n_gru & 1) * B * H;   // rnn output

  // ---- phase 4: query
  stage<W>(xin, ldx, rows, nact, Piece{xr, H, H, 0});
  __syncthreads();
  {
    const int q0 = sl.q0;
    float* q = sc.q;
    gemv(wsl + sl.o_wq, sl.cq, H, xin, ldx, nact,
         [&](int c, int i, float v) { q[(size_t)rows[i] * A + q0 + c] = v; });
  }
  if (!grid_sync(gb, misc + 1)) return false;

  // ---- phase 5: energies of the block's (row, position) pairs
  const int plo = span_lo(g, a.G, B * N), phi = span_lo(g + 1, a.G, B * N);
  {
    const float* locm = s + L.locm;
    const float* v = fb + a.o_v;
    const float* ba = fb + a.o_ba;
    const int half = a.KWIN / 2;
    float* win = s + L.win + warp * 32;          // cum[n - half .. n + half]
    for (int p = plo + warp; p < phi; p += nw) {
      const int b = p / N, n = p - b * N;
      if (slot[b] < 0) continue;
      const int jw = n + lane - half;
      win[lane] = (lane < a.KWIN && jw >= 0 && jw < N)
                      ? ldcg(cy.cum + (size_t)b * N + jw) : 0.f;
      __syncwarp();
      const float* kr = keys + ((size_t)b * N + n) * A;
      const float* qr = sc.q + (size_t)b * A;
      float part = 0.f;
      for (int c0 = lane; c0 < A; c0 += 128) {   // four columns' chains at once
        float loc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < a.KWIN; ++k) {
          const float wk = win[k];
          const float* lk = locm + k * A + c0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c0 + 32 * j < A) loc[j] = fmaf(wk, lk[32 * j], loc[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + 32 * j;
          if (c < A) part = fmaf(tanhf(kr[c] + ldcg(qr + c) + loc[j] + ba[c]), v[c], part);
        }
      }
      part = warp_sum(part);
      if (lane == 0) sc.e[p] = mask[p] > 0.f ? part : -1e30f;
      __syncwarp();
    }
  }
  if (!grid_sync(gb, misc + 1)) return false;

  // ---- phase 6: softmax of every row (in every block), the block's
  // context columns, alignment emission and cum update
  for (int i = warp; i < nact; i += nw) {
    const int b = rows[i];
    float* ai = al + (size_t)i * L.ldn;
    const float* mr = mask + (size_t)b * N;
    float m = __int_as_float(0xff800000);       // -inf
    for (int n0 = lane; n0 < N; n0 += 128) {    // four loads in flight
      float ev[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (n0 + 32 * u < N) ev[u] = ldcg(sc.e + (size_t)b * N + n0 + 32 * u);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (n0 + 32 * u < N) {
          ai[n0 + 32 * u] = ev[u];
          m = fmaxf(m, ev[u]);
        }
    }
    m = warp_max(m);
    float den = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float w = mr[n] > 0.f ? expf(ai[n] - m) : 0.f;
      ai[n] = w;
      den += w;
    }
    den = warp_sum(den) + 1e-30f;
    for (int n = lane; n < N; n += 32) ai[n] = ai[n] / den;
  }
  __syncthreads();
  for (int p = plo + t; p < phi; p += nt) {
    const int b = p / N, n = p - b * N;
    const int i = slot[b];
    const float cold = ldcg(cy.cum + p);
    if (i < 0) {
      em.align[p] = 0.f;
      cy.cum_o[p] = cold;
    } else {
      const float w = al[(size_t)i * L.ldn + n];
      em.align[p] = w;
      cy.cum_o[p] = fin_s[b] > 0.f ? cold : cold + w;
    }
  }
  {
    const int d0 = span_lo(g, a.G, D), cd = span_lo(g + 1, a.G, D) - d0;
    for (int it = warp; it < cd * nact; it += nw) {
      const int i = it / cd, d = d0 + it - i * cd, b = rows[i];
      const float* ai = al + (size_t)i * L.ldn;
      const float* vr = values + (size_t)b * N * D + d;
      float acc = 0.f;
      for (int n0 = lane; n0 < N; n0 += 128) {  // n in order, loads ahead
        float vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n0 + 32 * u < N) vv[u] = __ldg(vr + (size_t)(n0 + 32 * u) * D);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n0 + 32 * u < N) acc = fmaf(ai[n0 + 32 * u], vv[u], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) sc.ctxn[(size_t)b * D + d] = acc;
    }
  }
  if (!grid_sync(gb, misc + 1)) return false;

  // ---- phase 7: frame head (the block's columns) and stop head (all r)
  stage<W>(xin, ldx, rows, nact, Piece{xr, H, H, 0});
  stage<W>(xin, ldx, rows, nact, Piece{sc.ctxn, D, D, H});
  __syncthreads();
  {
    const float* bf = fb + a.o_bf;
    const int f0 = sl.f0, RM = a.RM, pm = a.RM - M;
    const int w0 = gemv(wsl + sl.o_wf, sl.cf, H + D, xin, ldx, nact,
         [&](int c, int i, float v) {
           const int b = rows[i], col = f0 + c;
           const float fr = (v + bf[col]) * (1.f - fin_s[b]);
           em.frames[(size_t)b * RM + col] = fr;
           if (col >= pm) {
             const size_t k = (size_t)b * M + col - pm;
             cy.prev_o[k] = fin_s[b] > 0.f ? ldcg(cy.prev + k) : fr;
           }
         });
    const float* bs = fb + a.o_bs;
    gemv(wsl + sl.o_ws, a.R, H + D, xin, ldx, nact,
         [&](int c, int i, float v) { slp[i * L.ldr + c] = sigm(v + bs[c]); }, w0);
    for (int idx = t; idx < B * sl.cf; idx += nt) {   // skipped rows emit 0
      const int b = idx / sl.cf;
      if (slot[b] < 0) em.frames[(size_t)b * RM + f0 + idx - b * sl.cf] = 0.f;
    }
    const int d0 = span_lo(g, a.G, D), cd = span_lo(g + 1, a.G, D) - d0;
    for (int idx = t; idx < nact * cd; idx += nt) {
      const int i = idx / cd, b = rows[i];
      const size_t k = (size_t)b * D + d0 + idx - i * cd;
      cy.ctx_o[k] = fin_s[b] > 0.f ? ldcg(cy.ctx + k) : ldcg(sc.ctxn + k);
    }
  }
  __syncthreads();
  if (t < B) {
    const int b = t, i = slot[b];
    float fin = 1.f;
    if (i >= 0) {
      bool newly = false;
      for (int r = 0; r < a.R; ++r) newly = newly || slp[i * L.ldr + r] >= 0.5f;
      fin = fmaxf(fin_s[b], newly ? 1.f : 0.f);
    }
    if (g == 0) {
      for (int r = 0; r < a.R; ++r)
        em.stop[(size_t)b * a.R + r] = i >= 0 ? slp[i * L.ldr + r] : 0.f;
      em.fin[b] = fin;
    }
    fin_s[b] = fin;
  }
  return grid_sync(gb, misc + 1);
}

__device__ void load_locm(const Args& a, float* locm, const float* fb) {
  for (int i = threadIdx.x; i < a.KWIN * a.A; i += blockDim.x)
    locm[i] = fb[a.o_loc + i];
}

__device__ GridBar grid_bar(const Args& a, float* scratch) {
  GridBar gb;
  gb.count = reinterpret_cast<unsigned*>(scratch);
  gb.err = reinterpret_cast<int*>(scratch) + 1;
  gb.target = 0;
  gb.G = a.G;
  return gb;
}

template <typename W>
__global__ void __launch_bounds__(THREADS, 1)
decode_full_kernel(Args a, const W* wb, const long long* bases,
                   const float* fb, const float* keys,
                   const float* values, const float* mask, float* scratch,
                   float* frames, float* stop, float* align, float* fin) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a, true);
  const Slice sl = slice(a, blockIdx.x);
  const int t = threadIdx.x, nt = blockDim.x;
  float* s = reinterpret_cast<float*>(smem + L.wbytes);
  for (int i = t; i < L.floats; i += nt) s[i] = 0.f;    // zero carry flags
  __syncthreads();
  {  // the block's weight slice, once, in 16-byte pieces
    const uint4* src = reinterpret_cast<const uint4*>(wb + bases[blockIdx.x]);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    const long long n16 = sl.size * a.wsize / 16;
    for (long long i = t; i < n16; i += nt) dst[i] = src[i];
  }
  load_locm(a, s + L.locm, fb);
  __syncthreads();
  const W* wsl = reinterpret_cast<const W*>(smem);
  const Scratch sc = scratch_of(a, scratch);      // carry zeroed by the wrapper
  const Carry cy{sc.prev, sc.ctx, sc.h, sc.cum, sc.prev, sc.ctx, sc.h, sc.cum};
  GridBar gb = grid_bar(a, scratch);
  const float* fin_s = s + L.fin;
  int st = 0;
  for (; st < a.steps; ++st) {
    if (a.early_exit) {
      bool all = true;
      for (int b = 0; b < a.B; ++b) all = all && fin_s[b] > 0.f;
      if (all) break;           // every block sees the same flags
    }
    const size_t o = (size_t)st * a.B;
    const Emit em{frames + o * a.RM, stop + o * a.R, align + o * a.N, fin + o};
    if (!step<W>(a, L, sl, smem, wsl, fb, keys, values, mask, sc, cy, em, gb))
      return;
  }
  // every row has finished: the remaining steps emit zeros with fin = 1
  const long long gt = (long long)blockIdx.x * nt + t, gs = (long long)a.G * nt;
  const long long o = (long long)st * a.B, rest = (long long)(a.steps - st) * a.B;
  for (long long i = gt; i < rest * a.RM; i += gs) frames[o * a.RM + i] = 0.f;
  for (long long i = gt; i < rest * a.R; i += gs) stop[o * a.R + i] = 0.f;
  for (long long i = gt; i < rest * a.N; i += gs) align[o * a.N + i] = 0.f;
  for (long long i = gt; i < rest; i += gs) fin[o + i] = 1.f;
}

template <typename W>
__global__ void __launch_bounds__(THREADS, 1)
decode_step_kernel(Args a, const W* wb, const long long* bases,
                   const float* fb, const float* prev,
                   const float* ctx, const float* hs, const float* cum,
                   const float* keys, const float* values, const float* mask,
                   const float* finished, float* scratch, float* frames,
                   float* stop, float* align, float* ctx_o, float* cum_o,
                   float* prev_o, float* fin_o, float* hs_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a, false);
  const Slice sl = slice(a, blockIdx.x);
  const int t = threadIdx.x, nt = blockDim.x;
  float* s = reinterpret_cast<float*>(smem + L.wbytes);
  for (int i = t; i < L.floats; i += nt) s[i] = 0.f;
  __syncthreads();
  for (int b = t; b < a.B; b += nt) s[L.fin + b] = finished[b];
  load_locm(a, s + L.locm, fb);
  __syncthreads();
  const Scratch sc = scratch_of(a, scratch);
  const Carry cy{prev, ctx, hs, cum, prev_o, ctx_o, hs_o, cum_o};
  const Emit em{frames, stop, align, fin_o};
  GridBar gb = grid_bar(a, scratch);
  step<W>(a, L, sl, smem, wb + bases[blockIdx.x], fb, keys, values,
          mask, sc, cy, em, gb);
}

// The same grid and the same barriers as one decode with no math: the
// floor of the design's time per step.
__global__ void __launch_bounds__(THREADS, 1)
barrier_kernel(Args a, float* scratch, int rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* verdict = reinterpret_cast<int*>(smem);
  GridBar gb = grid_bar(a, scratch);
  for (int k = 0; k < rounds; ++k)
    if (!grid_sync(gb, verdict)) return;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Shared-memory size check, the attribute, and the grid: G blocks must all
// be resident at once (cooperative launch), at most one per SM.
template <typename K>
int prepare(K kern, const Args& a, bool staged, int* grid) {
  const Layout L = layout(a, staged);
  if (L.bytes != a.smem_bytes) return (int)cudaErrorInvalidValue;
  long long total = 0, wmax = 0;
  int numax = 0;
  for (int g = 0; g < a.G; ++g) {
    const Slice s = slice(a, g);
    total += s.size;
    wmax = s.size > wmax ? s.size : wmax;
    numax = imax(numax, s.nu);
  }
  if (total != a.wtotal || wmax != a.wmax || numax != a.numax)
    return (int)cudaErrorInvalidValue;
  if (scratch_of(a, nullptr).floats != a.scratch_floats)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  if ((err = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)))
    return err;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, a.nt, (size_t)L.bytes)))
    return err;
  const int gmax = per_sm * sms < sms ? per_sm * sms : sms;
  if (a.G > gmax) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = a.G;
  return 0;
}

template <typename T> struct ident { using type = T; };

template <typename... P>
int launch_coop(void (*kern)(P...), int grid, int nt, size_t smem,
                cudaStream_t st, typename ident<P>::type... args) {
  void* ptrs[] = {(void*)&args...};
  int err = (int)cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                             dim3(nt), ptrs, smem, st);
  return err ? err : (int)cudaGetLastError();
}

template <typename W>
int launch_full(const Args& a, const void* wb, const long long* bases,
                const float* fb,
                const float* keys, const float* values, const float* mask,
                float* scratch, float* frames, float* stop, float* align,
                float* fin, int* grid, cudaStream_t st) {
  int err = prepare(decode_full_kernel<W>, a, true, grid);
  if (err) return err;
  return launch_coop(decode_full_kernel<W>, a.G, a.nt, (size_t)a.smem_bytes, st,
                     a, static_cast<const W*>(wb), bases, fb, keys, values,
                     mask, scratch, frames, stop, align, fin);
}

template <typename W>
int launch_step(const Args& a, const void* wb, const long long* bases,
                const float* fb,
                const float* prev, const float* ctx, const float* hs,
                const float* cum, const float* keys, const float* values,
                const float* mask, const float* finished, float* scratch,
                float* frames, float* stop, float* align, float* ctx_o,
                float* cum_o, float* prev_o, float* fin_o, float* hs_o,
                int* grid, cudaStream_t st) {
  int err = prepare(decode_step_kernel<W>, a, false, grid);
  if (err) return err;
  return launch_coop(decode_step_kernel<W>, a.G, a.nt, (size_t)a.smem_bytes, st,
                     a, static_cast<const W*>(wb), bases, fb, prev, ctx, hs, cum,
                     keys, values, mask, finished, scratch, frames, stop,
                     align, ctx_o, cum_o, prev_o, fin_o, hs_o);
}

}  // namespace

extern "C" {

// Whole decode: outputs frames [steps, B, RM], stop [steps, B, R],
// align [steps, B, N], fin [steps, B, 1].  wbuf: the tiled weights, block
// g's slice at element bases[g] (on the device).  scratch: scratch_floats zeroed
// f32 (barrier words first).  *grid gets the number of blocks.  Returns a
// cudaError_t code; a barrier timeout shows in the scratch's error word.
int decode_full(int bf16, const long long* meta, int n_meta, const void* wbuf,
                const long long* bases, const float* fbuf, const float* keys, const float* values,
                const float* mask, float* scratch, float* frames, float* stop,
                float* align, float* fin, int* grid, void* stream) {
  Args a;
  if (unpack(meta, n_meta, &a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_full<__nv_bfloat16>(a, wbuf, bases, fbuf, keys, values,
                                           mask, scratch, frames, stop, align,
                                           fin, grid, st)
              : launch_full<float>(a, wbuf, bases, fbuf, keys, values, mask,
                                   scratch, frames, stop, align, fin, grid, st);
}

// One step: carry in (prev [B,M], ctx [B,D], hs [n_gru,B,H], cum [B,N],
// finished [B,1]) -> emissions (frames [B,RM], stop [B,R], align [B,N]) and
// carry out (ctx_o, cum_o, prev_o, fin_o, hs_o).  Returns a cudaError_t code.
int decode_step(int bf16, const long long* meta, int n_meta, const void* wbuf,
                const long long* bases, const float* fbuf, const float* prev, const float* ctx,
                const float* hs, const float* cum, const float* keys,
                const float* values, const float* mask, const float* finished,
                float* scratch, float* frames, float* stop, float* align,
                float* ctx_o, float* cum_o, float* prev_o, float* fin_o,
                float* hs_o, int* grid, void* stream) {
  Args a;
  if (unpack(meta, n_meta, &a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_step<__nv_bfloat16>(
                    a, wbuf, bases, fbuf, prev, ctx, hs, cum, keys, values, mask,
                    finished, scratch, frames, stop, align, ctx_o, cum_o,
                    prev_o, fin_o, hs_o, grid, st)
              : launch_step<float>(a, wbuf, bases, fbuf, prev, ctx, hs, cum, keys,
                                   values, mask, finished, scratch, frames,
                                   stop, align, ctx_o, cum_o, prev_o, fin_o,
                                   hs_o, grid, st);
}

// `rounds` grid barriers on decode_full's grid (same G, threads and shared
// memory), nothing else.
int grid_barriers(const long long* meta, int n_meta, float* scratch,
                  int rounds, int* grid, void* stream) {
  Args a;
  if (unpack(meta, n_meta, &a)) return (int)cudaErrorInvalidValue;
  int err = prepare(barrier_kernel, a, true, grid);
  if (err) return err;
  return launch_coop(barrier_kernel, a.G, a.nt, (size_t)a.smem_bytes,
                     static_cast<cudaStream_t>(stream), a, scratch, rounds);
}

const char* decoder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
