// The attention backward shared by K1b (flash_attn_bwd.cu: every key, an
// additive bias, optionally causal) and K4b (banded_attn_bwd.cu: keys
// within +-W of the query, valid keys only). The two files hold the notes
// on what each replaces and what bounds it; this one holds the design.
//
// Given q, k, v, the forward's output o and row statistics (max m and
// log l of the row sum), and the output gradient do:
//
//   P  = exp(score - m - log l) on the allowed keys
//   D  = rowsum(do * o)
//   dS = P * (do v^T - D)
//   dq = s * dS k,  dk = s * dS^T q,  dv = P^T do
//
// Two kernels, no atomics and a fixed order of every sum, so every launch
// gives the same bits.
//
// attn_bwd_dkv_kernel: one block of up to 2 (K1b) or 4 (K4b) warps per
// (b, h, key tile); each warp owns 16 keys, so a tile is 16 * warps keys
// and the host picks the warps so that the tiles split Tk evenly (T = 145:
// 10 slabs of 16 in 5 tiles of 2 warps). The block keeps its K and V rows in
// shared memory
// and walks the query slabs of 16 rows that its keys reach (every slab for
// K1b; the slabs within ceil(W / 16) slabs of a warp's own for K4b, each
// warp skipping the slabs its band misses), double-buffered: while a slab
// is used, cp.async brings the next slab's q, do and o rows (16-byte copies
// where d % 4 == 0), its row statistics and, for K1b, its bias tile. Per
// slab and warp, the 16 keys x 16 queries unit:
//   - D of the slab's rows from do and o in shared memory (two lanes a row,
//     then a shuffle to the lanes that need it);
//   - the scores S^T on the CUDA cores, each a chain of fmaf over d in
//     order, in the layout of the mma accumulators (each lane keys g, g + 8
//     and queries 2t, 2t + 1 of each 8-query group), then rounded exactly
//     as the forward rounds them (the caller's score function): the
//     product with sm_scale and the sum with the bias as separate
//     __fmul_rn / __fadd_rn, which nvcc never contracts into an FFMA, so P
//     is the P whose row statistics the forward saved;
//   - dP^T = v do^T on the tensor cores as 3xTF32 (mma.sync m16n8k8: each
//     fp32 operand split into hi = tf32(x) and lo = tf32(x - hi), three
//     products lo*hi + hi*lo + hi*hi with fp32 accumulation), into four
//     accumulators so that no chain of dependent mma is longer than d / 8;
//   - P and dS in registers; dS stored (K1b: the bias gradient, (B, H, Tq,
//     Tk); K4b: the band's units into a scratch the dq kernel reads);
//   - dv += P^T do and dk += dS^T q, 3xTF32, with P^T and dS^T taken
//     straight from the registers that hold them (k slot t <- query 2t,
//     slot t + 4 <- query 2t + 1, and do and q rows read in that order),
//     into accumulators of 16 keys x d per warp, each 8-query step from
//     zero and added rounded to nearest (attn_common.cuh:mma_3xtf32; so
//     is dq's each 8-key step).
//
// attn_bwd_dq_kernel: one block of up to 2 (K1b) or 4 (K4b) warps per
// (b, h, query tile); each warp owns 16 query rows and walks the key chunks
// they reach two 16-key chunks a stage, double-buffered (K rows and each
// warp's 16 x 32 tile of dS by cp.async), and forms dq = s * dS k on the
// tensor cores as 3xTF32. dq needs no
// recompute: dS is stored whole anyway for K1b (8.4 MB at the flagship's
// train shape), and for K4b the band's units are 20 MB at the long-form
// shape, read back from L2 more cheaply than the scores (fp32 on the CUDA
// cores) and do v^T could be formed again.
//
// The head dimension is zero-padded to DP = 16, 32, 64 or 128 in shared
// memory (exact: fmaf and products with 0 leave a sum as it is). Keys past
// Tk and rows past Tq get P = dS = 0. q, k and v are read through their
// batch, head and time strides; o, do, the statistics, dq, dk and dv are
// contiguous (B, H, T, d).

#pragma once

#include <math.h>

#include <type_traits>

#include "attn_common.cuh"

namespace {

constexpr int BWD_MAXW = 4;  // warps per block at most
// the warps per block (at most) and the 16-key chunks per stage of the dq
// kernel, chosen on the card at the paths' shapes (PERF.md section 6): for
// K1b, 2-warp blocks keep all 500 resident at T = 145; for K4b at T = 2189,
// 4-warp blocks share each query slab among more keys
constexpr int DKV_MAXW_DENSE = 2, DKV_MAXW_BAND = 4;
constexpr int DQ_MAXW_DENSE = 2, DQ_MAXW_BAND = 4, DQ_CHUNKS = 2;
constexpr int BWD_DMAX = 128;

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* stats;  // (B, H, Tq, 2): m, log l
  float* dq;
  float* dk;
  float* dv;
  float* ds;           // K1b: (B, H, Tq, Tk); K4b: the band's units
  const float* bias;   // K1b, or null: broadcast to (B, H, Tq, Tk)
  long long bsb, bsh, bsq, bsk;
  const unsigned char* valid;  // K4b: (B, T), nonzero = a valid key; or null
  Strides qs, ks, vs;
  int H, Tq, Tk, d;
  int causal;          // K1b: key n allowed for query r iff n <= r + Tk - Tq
  int W, nw16;         // K4b: the window and ceil(W / 16)
  float sm_scale;
};

// K4b's scratch: for each (b, h) and 16-row query slab s, 16 rows of
// 16 * (2 nw16 + 1) floats, the unit of key chunk c at column
// 16 (c - s + nw16)
__device__ __forceinline__ long long band_unit(const BwdArgs& a, int bh,
                                               int s, int c, int row) {
  const int nslab = (a.Tq + 15) >> 4;
  const int ncw = 16 * (2 * a.nw16 + 1);
  return (((long long)bh * nslab + s) * 16 + row) * ncw +
         16 * (c - s + a.nw16);
}

template <int DP, bool BAND>
__global__ void __launch_bounds__(BWD_MAXW * 32, DP <= 64 ? 3 : 1)
attn_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int SK = DP + 4;   // padded row of the K, V, q, do and o tiles
  constexpr int KT = DP / 8;   // n tiles of dk and dv
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nthr >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row, column
  const int BN = 16 * nw, SB = BN + 4;
  float* sK = reinterpret_cast<float*>(smem4);   // [BN][SK]
  float* sV = sK + BN * SK;                      // [BN][SK]
  float* sQ = sV + BN * SK;                      // [2][16][SK]
  float* sG = sQ + 2 * 16 * SK;                  // [2][16][SK], do
  float* sO = sG + 2 * 16 * SK;                  // [2][16][SK]
  float* sSt = sO + 2 * 16 * SK;                 // [2][16][2], m and log l
  float* sB = sSt + 2 * 32;                      // [2][16][SB], the bias

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int Tq = a.Tq, Tk = a.Tk, d = a.d;
  const int n0 = blockIdx.x * BN;        // the block's first key
  const int nw0 = n0 + 16 * warp;        // this warp's first key
  const int cw = nw0 >> 4;               // and its 16-key chunk
  const float* qb = a.q + b * a.qs.b + h * a.qs.h;
  const float* kb = a.k + b * a.ks.b + h * a.ks.h;
  const float* vb = a.v + b * a.vs.b + h * a.vs.h;
  const long long rows = (long long)bh * Tq;  // rows of o, do and stats
  const float* ob = a.o + rows * d;
  const float* gb = a.dout + rows * d;
  const float* stb = a.stats + rows * 2;
  const float* biasb =
      (!BAND && a.bias != nullptr) ? a.bias + b * a.bsb + h * a.bsh : nullptr;
  // the query slabs [s_lo, s_hi) the block's keys reach
  int s_lo = 0, s_hi = (Tq + 15) >> 4;
  if (BAND) {
    s_lo = max(0, (n0 >> 4) - a.nw16);
    s_hi = min(s_hi, (n0 >> 4) + nw + a.nw16);
  }
  const bool keys_in = nw0 < Tk;
  bool kvalid[2];  // K4b: keys nw0 + g and nw0 + g + 8 exist and are valid
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = nw0 + g + 8 * i;
    kvalid[i] = n < Tk && (a.valid == nullptr || a.valid[b * Tk + n] != 0);
  }

  // the padding columns d..DP-1 of every tile: cp.async never writes them
  const int dpad = DP - d;
  for (int i = tid; i < (2 * BN + 96) * dpad; i += nthr) {
    const int r = i / dpad;
    sK[r * SK + d + (i - r * dpad)] = 0.f;  // sK, sV, sQ, sG, sO in a row
  }

  auto load_slab = [&](int s, int st) {
    const int r0 = 16 * s, nv = Tq - r0;
    load_rows<SK>(sQ + st * 16 * SK, qb + r0 * a.qs.t, a.qs.t, 16, nv, d,
                  tid, nthr);
    load_rows<SK>(sG + st * 16 * SK, gb + (long long)r0 * d, d, 16, nv, d,
                  tid, nthr);
    load_rows<SK>(sO + st * 16 * SK, ob + (long long)r0 * d, d, 16, nv, d,
                  tid, nthr);
    if (tid < 32) {
      const bool ok = tid < 2 * nv;
      cp_async4(sSt + st * 32 + tid, ok ? stb + 2 * r0 + tid : stb, ok);
    }
    if (biasb != nullptr) {
      // a warp reads consecutive keys of a bias row
      float* dB = sB + st * 16 * SB;
      for (int i = tid; i < 16 * BN; i += nthr) {
        const int r = i / BN, c = i - r * BN;
        const bool ok = r < nv && n0 + c < Tk;
        cp_async4(dB + r * SB + c,
                  ok ? biasb + (r0 + r) * a.bsq + (n0 + c) * a.bsk : biasb,
                  ok);
      }
    }
  };

  // the block's K and V rows, with the first slab
  load_rows<SK>(sK, kb + n0 * a.ks.t, a.ks.t, BN, Tk - n0, d, tid, nthr);
  load_rows<SK>(sV, vb + n0 * a.vs.t, a.vs.t, BN, Tk - n0, d, tid, nthr);
  load_slab(s_lo, 0);
  cp_async_commit();

  float accK[KT][4], accV[KT][4];
#pragma unroll
  for (int nt = 0; nt < KT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) accK[nt][e] = accV[nt][e] = 0.f;

  const float* ka = sK + (16 * warp + g) * SK;  // key rows g, g + 8
  const float* va = sV + (16 * warp + g) * SK;
  const int nst = s_hi - s_lo;
  for (int j = 0; j < nst; ++j) {
    const int st = j & 1, s = s_lo + j, r0 = 16 * s;
    if (j + 1 < nst) load_slab(s + 1, st ^ 1);
    cp_async_commit();  // possibly empty: slab j is then the older group
    cp_async_wait_1();
    __syncthreads();
    const float* cQ = sQ + st * 16 * SK;
    const float* cG = sG + st * 16 * SK;
    const float* cSt = sSt + st * 32;
    const float* cB = sB + st * 16 * SB;

    // D of the slab's rows: lanes l and l + 16 sum the halves of row l % 16
    float Dl;
    {
      const int c0 = (lane >> 4) * (DP / 2);
      const float* x = cG + (lane & 15) * SK + c0;
      const float* y = sO + st * 16 * SK + (lane & 15) * SK + c0;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < DP / 2; c += 4) {
        const float4 u = *reinterpret_cast<const float4*>(x + c);
        const float4 w = *reinterpret_cast<const float4*>(y + c);
        acc = fmaf(u.x, w.x, acc);
        acc = fmaf(u.y, w.y, acc);
        acc = fmaf(u.z, w.z, acc);
        acc = fmaf(u.w, w.w, acc);
      }
      Dl = acc + __shfl_xor_sync(0xffffffffu, acc, 16);
    }
    float Dr[2][2];  // D of rows 8 nt + 2t + c
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        Dr[nt][c] = __shfl_sync(0xffffffffu, Dl, 8 * nt + 2 * t + c);

    bool active = keys_in;
    if (BAND) active = active && abs(s - cw) <= a.nw16;
    if (active) {
      // S^T: sc[nt][e] is key nw0 + g + 8 (e >> 1), query r0 + 8 nt + 2t +
      // (e & 1); each a chain of fmaf over d in order (the forward's)
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < DP; kc += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(ka + kc);
        const float4 k8 = *reinterpret_cast<const float4*>(ka + 8 * SK + kc);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float4 qv = *reinterpret_cast<const float4*>(
                cQ + (8 * nt + 2 * t + c) * SK + kc);
            float& s0 = sc[nt][c];
            float& s8 = sc[nt][2 + c];
            s0 = fmaf(qv.x, k0.x, s0);
            s0 = fmaf(qv.y, k0.y, s0);
            s0 = fmaf(qv.z, k0.z, s0);
            s0 = fmaf(qv.w, k0.w, s0);
            s8 = fmaf(qv.x, k8.x, s8);
            s8 = fmaf(qv.y, k8.y, s8);
            s8 = fmaf(qv.z, k8.z, s8);
            s8 = fmaf(qv.w, k8.w, s8);
          }
      }

      // dP^T = v do^T: A = v rows g, g + 8, B = do rows 8 nt + g; the
      // hi * hi products and the cross terms of even and odd k steps in
      // four accumulators, so that no chain of dependent mma is longer
      // than KT
      float dpp[2][2][2][4];  // [parity][hi*hi, cross][nt][e]
#pragma unroll
      for (int i = 0; i < 32; ++i) (&dpp[0][0][0][0])[i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t ah[4], al[4];
        split_tf32(va[8 * ks + t], ah[0], al[0]);
        split_tf32(va[8 * SK + 8 * ks + t], ah[1], al[1]);
        split_tf32(va[8 * ks + t + 4], ah[2], al[2]);
        split_tf32(va[8 * SK + 8 * ks + t + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* gr = cG + (8 * nt + g) * SK + 8 * ks;
          uint32_t bh2[2], bl2[2];
          split_tf32(gr[t], bh2[0], bl2[0]);
          split_tf32(gr[t + 4], bh2[1], bl2[1]);
          mma_tf32(dpp[ks & 1][1][nt], al, bh2);
          mma_tf32(dpp[ks & 1][1][nt], ah, bl2);
          mma_tf32(dpp[ks & 1][0][nt], ah, bh2);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[nt][e] = (dpp[0][1][nt][e] + dpp[1][1][nt][e]) +
                      (dpp[0][0][nt][e] + dpp[1][0][nt][e]);

      // P and dS, in place of the scores and dP^T
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = 8 * nt + 2 * t + (e & 1), r = r0 + rl;
          const int kl = 16 * warp + g + 8 * (e >> 1), n = n0 + kl;
          const float m = cSt[2 * rl], logl = cSt[2 * rl + 1];
          const float D = Dr[nt][e & 1];
          float p = 0.f, dsv = 0.f;
          if (BAND) {
            if (r < Tq && kvalid[e >> 1] && abs(r - n) <= a.W) {
              // rounded as the forward: the product alone
              p = expf(__fmul_rn(sc[nt][e], a.sm_scale) - m - logl);
              dsv = p * (dp[nt][e] - D);
            }
            a.ds[band_unit(a, bh, s, cw, rl) + g + 8 * (e >> 1)] = dsv;
          } else if (r < Tq && n < Tk) {
            // rounded as the forward: the product, then the sum
            float val = __fmul_rn(sc[nt][e], a.sm_scale);
            if (biasb != nullptr) val = __fadd_rn(val, cB[rl * SB + kl]);
            const bool masked = a.causal && n > r + (Tk - Tq);
            if (masked) val = -1e9f;  // as the forward scores it
            p = expf(val - m - logl);
            dsv = masked ? 0.f : p * (dp[nt][e] - D);
            a.ds[(rows + r) * Tk + n] = dsv;
          }
          sc[nt][e] = p;
          dp[nt][e] = dsv;
        }

      // dv += P^T do, dk += dS^T q: k slot t <- query 2t, slot t + 4 <-
      // query 2t + 1
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        split_tf32(sc[ks][0], ph[0], pl[0]);
        split_tf32(sc[ks][2], ph[1], pl[1]);
        split_tf32(sc[ks][1], ph[2], pl[2]);
        split_tf32(sc[ks][3], ph[3], pl[3]);
        split_tf32(dp[ks][0], sh[0], sl[0]);
        split_tf32(dp[ks][2], sh[1], sl[1]);
        split_tf32(dp[ks][1], sh[2], sl[2]);
        split_tf32(dp[ks][3], sh[3], sl[3]);
        const float* g0 = cG + (8 * ks + 2 * t) * SK + g;
        const float* q0 = cQ + (8 * ks + 2 * t) * SK + g;
#pragma unroll
        for (int nt = 0; nt < KT; ++nt) {
          uint32_t bh2[2], bl2[2];
          split_tf32(g0[8 * nt], bh2[0], bl2[0]);
          split_tf32(g0[SK + 8 * nt], bh2[1], bl2[1]);
          mma_3xtf32(accV[nt], ph, pl, bh2, bl2);
          split_tf32(q0[8 * nt], bh2[0], bl2[0]);
          split_tf32(q0[SK + 8 * nt], bh2[1], bl2[1]);
          mma_3xtf32(accK[nt], sh, sl, bh2, bl2);
        }
      }
    }
    __syncthreads();  // stage st is refilled at the next iteration
  }

  if (!keys_in) return;
  const long long kbase = (long long)bh * Tk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = nw0 + g + 8 * i;
    if (n >= Tk) continue;
    float* dkr = a.dk + (kbase + n) * d;
    float* dvr = a.dv + (kbase + n) * d;
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      const int c = 8 * nt + 2 * t;
      if (c < d) {
        dkr[c] = accK[nt][2 * i] * a.sm_scale;
        dvr[c] = accV[nt][2 * i];
      }
      if (c + 1 < d) {
        dkr[c + 1] = accK[nt][2 * i + 1] * a.sm_scale;
        dvr[c + 1] = accV[nt][2 * i + 1];
      }
    }
  }
}

template <int DP, bool BAND, int KS>
__global__ void __launch_bounds__(BWD_MAXW * 32)
attn_bwd_dq_kernel(const BwdArgs a) {
  constexpr int KC = 16 * KS;  // keys per stage: KS chunks of 16
  constexpr int SKQ = DP + 8;  // rows of K: B fragments free of conflicts
  constexpr int SS = KC + 4;   // rows of a warp's 16 x KC dS tile
  constexpr int KT = DP / 8;   // n tiles of dq
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nthr >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* sK = reinterpret_cast<float*>(smem4);  // [2][KC][SKQ]
  float* sS = sK + 2 * KC * SKQ;                // [2][nw][16][SS]

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int Tq = a.Tq, Tk = a.Tk, d = a.d;
  const int s0 = blockIdx.x * nw;         // the block's first query slab
  const int s = s0 + warp, r0 = 16 * s;   // this warp's
  const int nslab = (Tq + 15) >> 4;
  const float* kb = a.k + b * a.ks.b + h * a.ks.h;
  // the key chunks [c_lo, c_hi) the block's rows reach
  int c_lo = 0, c_hi = (Tk + 15) >> 4;
  if (BAND) {
    c_lo = max(0, s0 - a.nw16);
    c_hi = min(c_hi, s0 + nw + a.nw16);
  }
  // whether this warp's rows take chunk c
  auto takes = [&](int c) {
    return r0 < Tq && c < c_hi && (!BAND || abs(c - s) <= a.nw16);
  };

  const int dpad = DP - d;
  for (int i = tid; i < 2 * KC * dpad; i += nthr) {
    const int r = i / dpad;
    sK[r * SKQ + d + (i - r * dpad)] = 0.f;
  }

  // chunks c .. c + KS - 1 into stage st
  auto load_stage = [&](int c, int st) {
    const int n0 = 16 * c;
    load_rows<SKQ>(sK + st * KC * SKQ, kb + n0 * a.ks.t, a.ks.t, KC,
                   min(Tk, 16 * c_hi) - n0, d, tid, nthr);
    float* dS = sS + st * nw * 16 * SS;
    if (BAND) {
      // each warp's unit of the scratch, where its band reaches the chunk
      for (int i = tid; i < nw * 64 * KS; i += nthr) {
        const int w = i / (64 * KS), rest = i - w * 64 * KS;
        const int r = rest / (4 * KS), col = 4 * (rest - r * 4 * KS);
        const int cc = c + (col >> 4), sw = s0 + w;
        if (sw < nslab && cc < c_hi && abs(cc - sw) <= a.nw16)
          cp_async16(dS + (w * 16 + r) * SS + col,
                     a.ds + band_unit(a, bh, sw, cc, r) + (col & 15), true);
      }
    } else {
      for (int i = tid; i < nw * 16 * KC; i += nthr) {
        const int row = i / KC, col = i - row * KC;
        const int r = 16 * s0 + row, n = n0 + col;
        const bool ok = r < Tq && n < Tk;
        cp_async4(dS + row * SS + col,
                  ok ? a.ds + ((long long)bh * Tq + r) * Tk + n : a.ds, ok);
      }
    }
  };

  load_stage(c_lo, 0);
  cp_async_commit();
  float acc[KT][4];
#pragma unroll
  for (int nt = 0; nt < KT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int c = c_lo, j = 0; c < c_hi; c += KS, ++j) {
    const int st = j & 1;
    if (c + KS < c_hi) load_stage(c + KS, st ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const float* cS = sS + (st * nw + warp) * 16 * SS;
    const float* cK = sK + st * KC * SKQ;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      if (!takes(c + i)) continue;
#pragma unroll
      for (int ks = 2 * i; ks < 2 * i + 2; ++ks) {
        uint32_t ah[4], al[4];
        split_tf32(cS[g * SS + 8 * ks + t], ah[0], al[0]);
        split_tf32(cS[(g + 8) * SS + 8 * ks + t], ah[1], al[1]);
        split_tf32(cS[g * SS + 8 * ks + t + 4], ah[2], al[2]);
        split_tf32(cS[(g + 8) * SS + 8 * ks + t + 4], ah[3], al[3]);
        const float* kr = cK + (8 * ks + t) * SKQ + g;
#pragma unroll
        for (int nt = 0; nt < KT; ++nt) {
          uint32_t bh2[2], bl2[2];
          split_tf32(kr[8 * nt], bh2[0], bl2[0]);
          split_tf32(kr[4 * SKQ + 8 * nt], bh2[1], bl2[1]);
          mma_3xtf32(acc[nt], ah, al, bh2, bl2);
        }
      }
    }
    __syncthreads();
  }

  if (r0 >= Tq) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= Tq) continue;
    float* dqr = a.dq + ((long long)bh * Tq + r) * d;
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      const int c = 8 * nt + 2 * t;
      if (c < d) dqr[c] = acc[nt][2 * i] * a.sm_scale;
      if (c + 1 < d) dqr[c + 1] = acc[nt][2 * i + 1] * a.sm_scale;
    }
  }
}

// 16-row slabs of T split evenly over the fewest tiles of at most
// BWD_MAXW warps -> the warps per block and the tiles
inline void bwd_tiles(int T, int maxw, int& nw, int& nblk) {
  const int n16 = (T + 15) / 16;
  nblk = (n16 + maxw - 1) / maxw;
  nw = (n16 + nblk - 1) / nblk;
}

template <int DP, bool BAND>
int bwd_launch_dp(const BwdArgs& a, int B, bool dq, cudaStream_t stream) {
  int nw, nblk;
  if (dq) {
    constexpr int KS = DQ_CHUNKS;
    bwd_tiles(a.Tq, BAND ? DQ_MAXW_BAND : DQ_MAXW_DENSE, nw, nblk);
    const size_t smem = sizeof(float) * (size_t)(2 * 16 * KS * (DP + 8) +
                                                 2 * nw * 16 * (16 * KS + 4));
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dq_kernel<DP, BAND, KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_dq_kernel<DP, BAND, KS>
        <<<dim3(nblk, B * a.H), 32 * nw, smem, stream>>>(a);
  } else {
    bwd_tiles(a.Tk, BAND ? DKV_MAXW_BAND : DKV_MAXW_DENSE, nw, nblk);
    const int BN = 16 * nw;
    const size_t smem =
        sizeof(float) * (size_t)((2 * BN + 96) * (DP + 4) + 64 +
                                 (a.bias != nullptr ? 32 * (BN + 4) : 0));
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dkv_kernel<DP, BAND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_dkv_kernel<DP, BAND>
        <<<dim3(nblk, B * a.H), 32 * nw, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// the dk, dv and dS kernel (dq false) or the dq kernel (dq true)
template <bool BAND>
int bwd_launch(const BwdArgs& a, int B, bool dq, void* stream) {
  if (a.d < 1 || a.d > BWD_DMAX || a.Tq < 1 || a.Tk < 1 || B * a.H < 1 ||
      B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto dp) {
    return bwd_launch_dp<decltype(dp)::value, BAND>(a, B, dq, s);
  };
  if (a.d <= 16) return run(std::integral_constant<int, 16>{});
  if (a.d <= 32) return run(std::integral_constant<int, 32>{});
  if (a.d <= 64) return run(std::integral_constant<int, 64>{});
  return run(std::integral_constant<int, 128>{});
}

}  // namespace
