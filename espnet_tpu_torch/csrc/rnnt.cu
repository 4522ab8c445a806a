// RNN-T lattice sweeps in fp32 for Hopper (sm_90a): alpha and beta.
//
// Replaces: espnet_tpu/ops/pallas/rnnt_kernel.py, `_alpha_kernel` (:53) and
// `_beta_kernel` (:75), which `_sweep` (:106) launches through its one
// `pallas_call` (:118) for the forward and the VJP of `rnnt_loss_fused`.
// Over the blank and emit log-prob lattices (B, T, U+1) of the joint's
// log-softmax, with each sample's lengths T_b and U_b:
//     alpha(0, 0) = 0
//     alpha(t, u) = logadd(alpha(t-1, u) + blank(t-1, u),
//                          alpha(t, u-1) + emit(t, u-1))
//     nll_b = -(alpha(T_b-1, U_b) + blank(T_b-1, U_b))
//     beta(T_b-1, U_b) = blank(T_b-1, U_b)          (the exit)
//     beta(t, u) = logadd(blank(t, u) + beta(t+1, u),
//                         emit(t, u) + beta(t, u+1))
// with logadd(a, b) = max(a, b) + log1p(exp(-|a - b|)), the plain version's
// (torch.logaddexp) arithmetic: each cell takes the same two terms in the
// same order, so alpha, beta and nll are the plain sweeps' bits. Cells
// outside t < T_b, u <= U_b are -1e30 in alpha and beta, and a sweep visits
// only the cells inside: its work is the data's, not the padded lattice's.
//
// What bounds it: the function reads the blank and emit entries inside the
// lengths and writes the lattice, 1.06 MB at the transducer's train shape
// (B=25, T=145, U+1=65; 14.7 k cells inside), 0.32 us at 3.35 TB/s; its ~10
// operations a cell are nothing beside that. The real limit is the chain:
// T_b + U_b anti-diagonals, each waiting on the one before, so the longest
// sample's diagonals times the latency of one diagonal's dependent step (a
// shuffle, two adds and a log-add, ~200 SM cycles) is a floor below which
// no design goes. tools/rnnt_chain.py measures that step on the card and
// chip_smoke.py reports the floor beside the byte bound (PERF.md section 6).
//
// Design: one block per utterance: warp 0 sweeps it, warp 1 writes the
// padded part of the lattice (rows t >= T_b, columns u > U_b) -1e30 once,
// coalesced, so that nothing is written twice and the fill is off the
// sweep's warp. Lane l holds the G cells u = G l .. G l + G - 1 of the
// current diagonal in registers, G = ceil((U_b + 1) / 32) chosen per
// utterance (at most C = ceil((U+1) / 32)): cells past U_b are never
// inside, so an utterance with U_b < 32 costs one cell a lane whatever the
// padded U+1. At diagonal d, cell u is (d - u, u). Its two predecessors are
// the same register and the one before it, of the previous diagonal; only
// the lane's first cell needs the previous lane's last, which comes by
// __shfl_up_sync (alpha; beta's last cell takes the next lane's first by
// __shfl_down_sync), issued as soon as the cells are. So there is no
// barrier and no shared memory on the chain, and a diagonal costs one
// shuffle and G independent log-adds, computed without a branch and then
// masked. The lattice entries a diagonal reads sit at addresses that do not
// depend on the chain: the warp copies them P - 1 diagonals ahead into a
// ring of P slots in shared memory by cp.async (one group of copies a
// diagonal; cp.async.wait_group P - 1 then finds the current one landed),
// unconditionally, from addresses clamped into the lattice (only the cells
// inside use what they read), so their latency from L2 or device memory is
// off the chain. Stores of the cells are not waited on. Each utterance has
// an SM's load/store unit to itself: the skewed accesses touch a row each
// lane, ~32 transactions an instruction, and four utterances to an SM made
// that unit the limit (PERF.md section 6).
//
// U+1 > 32 MAXC: one block per utterance of NW <= 32 warps, each holding
// 32 C cells (C = 8, 16 or 32, the least that fits); the cell that lies
// across a warp boundary goes through shared memory, double-buffered, with
// one __syncthreads per diagonal, and the entries are loaded at the
// diagonal that uses them. No atomics: each cell is written by one thread
// once, and two launches give the same bits.

#include <math.h>

#include "attn_common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAXC = 8;        // cells a lane holds on the one-warp path
constexpr int MAX_NW = 32;     // warps of one utterance on the block path

__device__ __forceinline__ float logadd(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ bool inside(int t, int u, int Tb, int Ub) {
  return (unsigned)t < (unsigned)Tb && u <= Ub;
}

// i clamped into [0, n): the loads read the lattice unconditionally, so
// that no select waits on them, and only cells inside use what they read
__device__ __forceinline__ int clamp(int i, int n) {
  return min(max(i, 0), n - 1);
}

// One cell (t, u) of alpha from the diagonal before: alpha(t-1, u) (up)
// and alpha(t, u-1) (left), with blank(t-1, u) and emit(t, u-1).
__device__ __forceinline__ float alpha_cell(float up, float left, float xb,
                                            float xe, int t, int u, int Tb,
                                            int Ub) {
  const float from_blank = t >= 1 ? up + xb : NEG;
  const float from_emit = u >= 1 ? left + xe : NEG;
  const float val = logadd(from_blank, from_emit);  // no branch around it
  return inside(t, u, Tb, Ub) ? val : NEG;
}

// One cell (t, u) of beta from the diagonal after: beta(t+1, u) (down) and
// beta(t, u+1) (right), with blank(t, u) and emit(t, u). Past the last
// frame only the exit continues, with probability 1.
__device__ __forceinline__ float beta_cell(float down, float right, float xb,
                                           float xe, int t, int u, int Tb,
                                           int Ub) {
  const float after_blank = t == Tb - 1 ? (u == Ub ? 0.f : NEG) : down;
  const float after_emit = u < Ub ? right : NEG;
  const float val = logadd(xb + after_blank, xe + after_emit);
  return inside(t, u, Tb, Ub) ? val : NEG;
}

// -1e30 in every cell of the sample's (T, U1) lattice outside t < Tb,
// u <= Ub, which the sweep does not write: the rows past Tb, then the
// columns past Ub of the rows before it
__device__ __forceinline__ void fill_outside(float* lat, int T, int U1, int Tb,
                                             int Ub, int tid, int nthr) {
  for (int i = Tb * U1 + tid; i < T * U1; i += nthr) lat[i] = NEG;
  for (int t = 0; t < Tb; ++t)
    for (int u = Ub + 1 + tid; u < U1; u += nthr) lat[t * U1 + u] = NEG;
}

// The steps of the one-warp path whose lattice entries are in flight: the
// ring holds P of them, 2 C floats a lane each.
constexpr int MAX_STAGES = 8;
template <int C>
__host__ __device__ constexpr int stages() {
  return C <= 4 ? MAX_STAGES : 4;
}

// The sweep of one utterance by the calling warp(s), G cells a lane: step
// r is diagonal 1 + r of alpha (diagonal 0 is the start cell alone) or
// D - 1 - r of beta; lane l of warp w holds u = G (32 w + l) + c.
template <int G, bool BLOCK, bool ALPHA>
__device__ __forceinline__ void sweep(const float* __restrict__ bl,
                                      const float* __restrict__ em,
                                      float* __restrict__ out,
                                      float* __restrict__ nll, float* ring,
                                      float (*edge)[MAX_NW], int T, int U1,
                                      int Tb, int Ub) {
  constexpr int P = stages<G>();
  constexpr int SLOT = 2 * G * 32;  // one step's entries
  const int lane = threadIdx.x & 31;
  const int wu = BLOCK ? threadIdx.x >> 5 : 0;
  const int nw = BLOCK ? blockDim.x >> 5 : 1;
  const int D = Tb > 0 ? Tb + Ub : 0;  // diagonals inside the lattice
  const int u0 = G * (32 * wu + lane);
  const int steps = ALPHA ? max(D - 1, 0) : D;
  const int last = T * U1 - 1;
  // the lattice index of blank(t-1, u) (alpha) or of (t, u) (beta) for
  // the lane's first cell at step 0; a step moves it by dstep, and cell
  // c's is c (U1 - 1) below the first's; alpha's emit(t, u-1) is U1 - 1 and
  // its cell (t, u) U1 above its blank entry
  const int dstep = ALPHA ? U1 : -U1;
  const int base = ALPHA ? -u0 * (U1 - 1) : (D - 1 - u0) * U1 + u0;
  const int emit_at = ALPHA ? U1 - 1 : 0, cell_at = ALPHA ? U1 : 0;

  // one-warp path: a step's entries into a slot of the ring, one group of
  // copies a step, clamped into the lattice (a cell outside reads some
  // entry harmlessly); a lane reads back only its own
  float* my = ring + lane;
  auto stage = [&](int i0, int slot) {
    float* s = my + slot * SLOT;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const int i = i0 - c * (U1 - 1);
      cp_async4(s + 32 * c, bl + clamp(i, last + 1), true);
      cp_async4(s + 32 * (G + c), em + clamp(i + emit_at, last + 1), true);
    }
    cp_async_commit();
  };
  if (!BLOCK)
    for (int k = 0; k < P - 1; ++k) stage(base + k * dstep, k);

  // the lane's cells of the diagonal before (alpha) or after (beta) the
  // step's: alpha starts from diagonal 0, whose one cell inside is 0
  float x[G];
#pragma unroll
  for (int c = 0; c < G; ++c) x[c] = NEG;
  if (ALPHA && D > 0 && wu == 0 && lane == 0) {
    x[0] = 0.f;
    out[0] = 0.f;
  }
  // the cell across the lane's end (alpha: u0 - 1 from lane l - 1, beta:
  // u0 + G from lane l + 1), shuffled as soon as the cells are, so that
  // the shuffle overlaps the stores and the next staging; across the
  // warp's end it comes from the neighbouring warp through shared memory
  // on the block path, else is -1e30
  auto across = [&]() {
    return ALPHA ? __shfl_up_sync(FULL, x[G - 1], 1)
                 : __shfl_down_sync(FULL, x[0], 1);
  };
  auto edges = [&](float nb, int parity) {
    if (BLOCK) {
      if (lane == (ALPHA ? 31 : 0)) edge[parity][wu] = x[ALPHA ? G - 1 : 0];
      __syncthreads();
    }
    if (ALPHA && lane == 0)
      return BLOCK && wu > 0 ? edge[parity][wu - 1] : NEG;
    if (!ALPHA && lane == 31)
      return BLOCK && wu < nw - 1 ? edge[parity][wu + 1] : NEG;
    return nb;
  };
  float nb = edges(across(), 1);
  for (int r = 0; r < steps; ++r) {
    const int d = ALPHA ? 1 + r : D - 1 - r, ib = base + r * dstep;
    float xb[G], xe[G];
    if (BLOCK) {
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const int i = ib - c * (U1 - 1);
        xb[c] = __ldg(bl + clamp(i, last + 1));
        xe[c] = __ldg(em + clamp(i + emit_at, last + 1));
      }
    } else {
      stage(ib + (P - 1) * dstep, (r + P - 1) % P);
      cp_async_wait<P - 1>();  // step r's group has landed
      const float* s = my + (r % P) * SLOT;
#pragma unroll
      for (int c = 0; c < G; ++c) {
        xb[c] = s[32 * c];
        xe[c] = s[32 * (G + c)];
      }
    }
    // in place: alpha's cell c reads the old cells c and c - 1, so c runs
    // down; beta's reads the old c and c + 1, so c runs up
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int c = ALPHA ? G - 1 - k : k, u = u0 + c, t = d - u;
      if (ALPHA)
        x[c] = alpha_cell(x[c], c > 0 ? x[c - 1] : nb, xb[c], xe[c], t, u,
                          Tb, Ub);
      else
        x[c] = beta_cell(x[c], c < G - 1 ? x[c + 1] : nb, xb[c], xe[c], t,
                         u, Tb, Ub);
    }
    nb = across();
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (inside(d - u0 - c, u0 + c, Tb, Ub))
        out[ib - c * (U1 - 1) + cell_at] = x[c];
    nb = edges(nb, r & 1);
  }
  if (!BLOCK) cp_async_wait<0>();  // the ring's copies past the last step
  if (ALPHA) {
    // the exit cell (Tb-1, Ub) lies on the last diagonal, now in x
    if (D == 0) {
      if (wu == 0 && lane == 0) *nll = -NEG;
      return;
    }
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (u0 + c == Ub) *nll = -(x[c] + bl[(Tb - 1) * U1 + Ub]);
  }
}

// The one-warp path's sweep with the fewest cells a lane that hold the
// utterance's U_b + 1, at most C: the cells past U_b are never inside
template <int G, int C, bool ALPHA>
__device__ __forceinline__ void sweep_fitted(
    const float* __restrict__ bl, const float* __restrict__ em,
    float* __restrict__ out, float* __restrict__ nll, float* ring, int T,
    int U1, int Tb, int Ub) {
  if constexpr (G < C) {
    if (Ub >= 32 * G)
      return sweep_fitted<G + 1, C, ALPHA>(bl, em, out, nll, ring, T, U1, Tb,
                                           Ub);
  }
  sweep<G, false, ALPHA>(bl, em, out, nll, ring, nullptr, T, U1, Tb, Ub);
}

// One sweep (alpha, or beta) of utterance blockIdx.x. One-warp path: warp
// 0 sweeps with as few cells a lane as the utterance needs, and warp 1
// writes the padding; block path: NW warps of C cells a lane share the
// sweep.
template <int C, bool BLOCK, bool ALPHA>
__global__ void __launch_bounds__(BLOCK ? 32 * MAX_NW : 64)
rnnt_sweep_kernel(const float* __restrict__ blank,
                  const float* __restrict__ emit, const int* __restrict__ tlen,
                  const int* __restrict__ ulen, float* __restrict__ lat,
                  float* __restrict__ nll, int T, int U1) {
  extern __shared__ float ring[];   // one-warp path: [P][2 C][32]
  __shared__ float edge[2][MAX_NW];  // block path: each warp's end cell
  const int b = blockIdx.x;
  const long long off = (long long)b * T * U1;
  float* out = lat + off;
  const int Tb = min(max(tlen[b], 0), T);
  const int Ub = min(max(ulen[b], 0), U1 - 1);
  if (BLOCK) {
    fill_outside(out, T, U1, Tb, Ub, threadIdx.x, blockDim.x);
    sweep<C, true, ALPHA>(blank + off, emit + off, out,
                          ALPHA ? nll + b : nullptr, ring, edge, T, U1, Tb,
                          Ub);
  } else if (threadIdx.x >= 32) {
    fill_outside(out, T, U1, Tb, Ub, threadIdx.x - 32, 32);
  } else {
    sweep_fitted<1, C, ALPHA>(blank + off, emit + off, out,
                              ALPHA ? nll + b : nullptr, ring, T, U1, Tb,
                              Ub);
  }
}

template <int C, bool BLOCK>
int launch_c(bool is_alpha, const float* blank, const float* emit,
             const int* tlen, const int* ulen, float* out, float* nll, int B,
             int T, int U1, cudaStream_t s) {
  const int nw = BLOCK ? (U1 + 32 * C - 1) / (32 * C) : 2;
  // a ring that holds any sweep the one-warp path may take
  const size_t smem = BLOCK ? 0 : sizeof(float) * MAX_STAGES * 2 * C * 32;
  auto kernel = is_alpha ? rnnt_sweep_kernel<C, BLOCK, true>
                         : rnnt_sweep_kernel<C, BLOCK, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, 32 * nw, smem, s>>>(blank, emit, tlen, ulen, out, nll, T, U1);
  return (int)cudaGetLastError();
}

template <int C>
int one_warp(bool is_alpha, const float* blank, const float* emit,
             const int* tlen, const int* ulen, float* out, float* nll, int B,
             int T, int U1, cudaStream_t s, int c) {
  if constexpr (C < MAXC) {
    if (c > C)
      return one_warp<C + 1>(is_alpha, blank, emit, tlen, ulen, out, nll, B,
                             T, U1, s, c);
  }
  return launch_c<C, false>(is_alpha, blank, emit, tlen, ulen, out, nll, B,
                            T, U1, s);
}

int sweep(bool is_alpha, const float* blank, const float* emit,
          const int* tlen, const int* ulen, float* out, float* nll, int B,
          int T, int U1, void* stream) {
  // the lattice indices a sweep forms stay below (T + 2 (U+1)) (U+1)
  if (B < 1 || T < 1 || U1 < 1 || U1 > 32 * 32 * MAX_NW ||
      (long long)(T + 2 * U1) * U1 > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int c = (U1 + 31) / 32;  // cells a lane holds with one warp
  if (c <= MAXC)
    return one_warp<1>(is_alpha, blank, emit, tlen, ulen, out, nll, B, T, U1,
                       s, c);
  if (U1 <= 8 * 32 * MAX_NW)
    return launch_c<8, true>(is_alpha, blank, emit, tlen, ulen, out, nll, B,
                             T, U1, s);
  if (U1 <= 16 * 32 * MAX_NW)
    return launch_c<16, true>(is_alpha, blank, emit, tlen, ulen, out, nll, B,
                              T, U1, s);
  return launch_c<32, true>(is_alpha, blank, emit, tlen, ulen, out, nll, B, T,
                            U1, s);
}

}  // namespace

extern "C" int rnnt_alpha(const float* blank, const float* emit,
                          const int* tlen, const int* ulen, float* alpha,
                          float* nll, int B, int T, int U1, void* stream) {
  return sweep(true, blank, emit, tlen, ulen, alpha, nll, B, T, U1, stream);
}

extern "C" int rnnt_beta(const float* blank, const float* emit,
                         const int* tlen, const int* ulen, float* beta, int B,
                         int T, int U1, void* stream) {
  return sweep(false, blank, emit, tlen, ulen, beta, nullptr, B, T, U1,
               stream);
}
