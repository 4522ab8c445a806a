// Forward flash attention in fp32 with an additive bias, for Hopper (sm_90a):
// the scores in fp32 on the CUDA cores, P v on the tensor cores at fp32
// accuracy (3xTF32).
//
// Replaces: espnet_tpu/ops/attention_kernels.py:fused_attention, which on the
// TPU calls JAX's Pallas flash_attention (jax.experimental.pallas.ops.tpu).
// It computes out = softmax(q k^T * sm_scale + bias) v, optionally causal
// (key n allowed for query r iff n <= r + Tk - Tq; a masked score is -1e9),
// for q (B, H, Tq, d), k and v (B, H, Tk, d), d <= 128, and an f32 bias that
// broadcasts to (B, H, Tq, Tk) through its strides. Every conformer
// self-attention of the ASR encoder runs it.
//
// What bounds it: at the flagship's decode shape (B=64, H=4, T=145, d=64) the
// function reads q, k, v and the f32 rel-pos + padding bias once and writes
// the output once, 59.5 MB (17.8 us at 3.35 TB/s); its two products are
// 4*B*H*Tq*Tk*d = 1.38 GFLOP (8.4 us at 165 TFLOP/s, the tensor cores' rate
// for fp32-accurate 3xTF32 products). So it is bound by bytes, and the bias
// (21.5 MB) is the largest input: it is read once, coalesced.
//
// The scores are the plain version's bits. Each is a chain of fmaf over d in
// order, then a rounded product with sm_scale and a rounded sum with the
// bias, as the plain version (fp32 matmul, then * sm_scale, then + bias) and
// the backward's recompute (flash_attn_bwd.cu) form them. That is needed:
// the flagship's first block has scores of ~1800 (chip_smoke.py's
// score_precision), where an fp32 ulp is 1.2e-4 and a row whose top scores
// nearly tie turns one ulp into ~1e-3 of output; the plain version is itself
// ~1e-3 from a float64 reference there. Scores formed by 3xTF32 products
// (~2^-21 relative) land ~2.6e-3 from the plain version, past the 1e-4
// tolerance, and their row statistics no longer match the backward's
// recompute, whose gradients then move by ~5e-4 relative against 2e-5
// (PERF.md section 6). So q k^T stays on the CUDA cores.
//
// P v is 3xTF32 on the tensor cores: each fp32 operand x is split into
// hi = tf32_rn(x) and lo = tf32_rn(x - hi), and each product formed as
// lo*hi + hi*lo + hi*hi with fp32 accumulation (CUTLASS's
// OpMultiplyAddFastF32), each 8-key step from zero and added to the output
// rounded to nearest on the CUDA cores (attn_common.cuh:mma_3xtf32: the
// tensor cores' own accumulator truncates, which over 501 keys biased the
// output by 2.6e-5). The dropped terms are ~2^-21 of a product, and with
// P in [0, 1] the output keeps fp32-level accuracy (~1e-5 at |v| = 30). The
// kernel's arithmetic is fixed here: it does not read torch's allow_tf32
// flags (tasks/asr.py turns those off for the library products around it).
//
// Design: one block of 1..4 warps per (b, h, query tile); each warp owns 16
// query rows, so a tile is 16 * warps rows and the host picks the warps so
// that the tiles split Tq evenly (T = 145: 10 slabs of 16 in tiles of 4, 4
// and 2 warps; 10% of the rows are padding, not the 24% of 64-row tiles).
// q, k and v are read through their batch, head and time strides (the
// conformer's are views of its (B, T, H * d) projections), so nothing is
// copied before the kernel. The block's q rows go to shared memory once; then it walks the keys in
// 32-key tiles, double-buffered: while a tile is used, cp.async brings the
// next tile's K and V rows (16 bytes a thread where d % 4 == 0) and its bias
// tile (4 bytes a thread, each lane on one key column, so a warp reads 32
// consecutive keys of a row) into shared memory. Per tile and warp: the
// 16 x 32 scores, each lane holding rows g, g + 8 and keys 2t, 2t + 1 of
// each 8-key group (the mma accumulator layout), from float4 loads of q and
// K rows padded to DP + 4 floats (free of bank conflicts; lanes that share a
// row or a key read it as one broadcast); scale and bias; the online softmax
// (row max over the 4 lanes that share a row); then O += P v with mma.sync
// m16n8k8 TF32, P taken straight from the score registers: they hold keys
// 2t, 2t+1 where the A fragment wants t, t+4, so the k slots are renamed
// (slot t <- key 2t, slot t+4 <- key 2t+1) and V's rows read in the same
// order. The head dimension is zero-padded to DP = 16, 32, 64 or 128 in
// shared memory (exact: fmaf with 0 leaves a sum as it is). Keys past Tk get
// a score of -inf, rows past Tq are not stored. No atomics and a fixed order
// of every sum: two launches give the same bits.
//
// Why mma.sync and not wgmma for P v: wgmma takes 64-row tiles a warpgroup,
// so T = 145 would pad to 192 rows (24% idle), and its TF32 operands must
// both sit K-major in swizzled shared memory, so P would go through shared
// memory in hi and lo copies, with V transposed; the kernel is bound by
// bytes and by its CUDA-core work, not by the tensor cores.
//
// How far from the bound, and what holds it there: PERF.md section 6
// (chip_smoke.py's kernel line). The scores are 0.69 GFLOP of fp32 FMA at
// the decode shape (10 us at 67 TFLOP/s, more than the byte bound), with
// one float4 load from shared memory to 6.4 FMA.
//
// For training, the kernel also writes each query row's softmax statistics,
// the row max m and log l of the row sum, as stats (B, H, Tq, 2). The backward
// (flash_attn_bwd.cu) recomputes P = exp(s - m - log l) from them. Two numbers
// and not one log-sum-exp m + log l: in a row whose every score is masked to
// -1e9 the sum of the two rounds to -1e9 in fp32, and P would come back as 1
// instead of the forward's uniform 1/Tk.

#include <math.h>

#include <type_traits>

#include "attn_common.cuh"

namespace {

constexpr int BN = 32;         // keys per tile: one per lane in the bias load
constexpr int MAXW = 4;        // warps per block at most
constexpr int BM_MAX = 16 * MAXW;
constexpr int SBS = BN + 8;    // padded row of the bias tile
constexpr int DMAX = 128;      // largest head size taken

template <int DP>
__global__ void __launch_bounds__(MAXW * 32)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ stats, int H, int Tq, int Tk, int d,
                      Strides qs, Strides ks, Strides vs, long long bsb,
                      long long bsh, long long bsq, long long bsk, int causal,
                      float sm_scale) {
  constexpr int SK = DP + 4;   // padded row of the Q, K and V tiles
  constexpr int KT = DP / 8;   // n tiles of P v
  constexpr int NT = BN / 8;   // n tiles of the scores, k steps of P v
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // [2][BN][SK]
  float* sV = sK + 2 * BN * SK;                  // [2][BN][SK]
  float* sB = sV + 2 * BN * SK;                  // [2][BM][SBS]
  float* sQ = sB + 2 * BM_MAX * SBS;             // [BM][SK]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row, column
  const int BM = (nthr >> 5) * 16;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = blockIdx.x * BM;
  const int r0 = q0 + warp * 16;          // this warp's first query row
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* biasb = bias ? bias + b * bsb + h * bsh : nullptr;
  const int shift = Tk - Tq;
  const int ntiles = (Tk + BN - 1) / BN;
  // rows of 16-byte chunks: d % 4 == 0, aligned bases and row strides
  const bool vec = (d % 4 == 0) && (ks.t % 4 == 0) && (vs.t % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(kb) |
                     reinterpret_cast<uintptr_t>(vb)) & 15) == 0;

  // the padding columns d..DP-1 of K and V (both stages) and of Q:
  // cp.async never writes them
  const int dpad = DP - d;
  for (int i = tid; i < (4 * BN + BM) * dpad; i += nthr) {
    const int r = i / dpad, c = d + (i - r * dpad);
    if (r < 4 * BN)
      sK[r * SK + c] = 0.f;  // sV follows sK: rows 2BN..4BN-1
    else
      sQ[(r - 4 * BN) * SK + c] = 0.f;
  }

  // the bias rows this thread loads: q0 + warp + nw k for k < brows
  const int nw = nthr >> 5;
  const int brows = max(0, (Tq - q0 - warp + nw - 1) / nw);
  const float* brow = biasb ? biasb + (q0 + warp) * bsq + lane * bsk : nullptr;

  auto load_tile = [&](int j, int st) {
    const int n0 = j * BN;
    float* dK = sK + st * BN * SK;
    float* dV = sV + st * BN * SK;
    if (vec) {
      const int c4 = d >> 2;
      for (int i = tid; i < BN * c4; i += nthr) {
        const int r = i / c4, c = (i - r * c4) * 4;
        const bool ok = n0 + r < Tk;
        const long long row = ok ? n0 + r : 0;
        cp_async16(dK + r * SK + c, kb + row * ks.t + c, ok);
        cp_async16(dV + r * SK + c, vb + row * vs.t + c, ok);
      }
    } else {
      for (int i = tid; i < BN * d; i += nthr) {
        const int r = i / d, c = i - r * d;
        const bool ok = n0 + r < Tk;
        const long long row = ok ? n0 + r : 0;
        cp_async4(dK + r * SK + c, kb + row * ks.t + c, ok);
        cp_async4(dV + r * SK + c, vb + row * vs.t + c, ok);
      }
    }
    if (biasb != nullptr) {
      // thread: key column lane of the tile, rows warp + nw k
      float* dB = sB + st * BM * SBS + warp * SBS + lane;
      const float* src = brow + n0 * bsk;
      const bool okc = n0 + lane < Tk;
#pragma unroll 4
      for (int k = 0; k < 16; ++k) {
        const bool ok = okc && k < brows;
        cp_async4(dB + k * nw * SBS, ok ? src : biasb, ok);
        src += nw * bsq;
      }
    }
  };

  // the block's query rows, with the first tile
  if (d % 4 == 0 && qs.t % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(qb) & 15) == 0) {
    const int c4 = d >> 2;
    for (int i = tid; i < BM * c4; i += nthr) {
      const int r = i / c4, c = (i - r * c4) * 4;
      const bool ok = q0 + r < Tq;
      cp_async16(sQ + r * SK + c, ok ? qb + (q0 + r) * qs.t + c : qb, ok);
    }
  } else {
    for (int i = tid; i < BM * d; i += nthr) {
      const int r = i / d, c = i - r * d;
      const bool ok = q0 + r < Tq;
      cp_async4(sQ + r * SK + c, ok ? qb + (q0 + r) * qs.t + c : qb, ok);
    }
  }
  load_tile(0, 0);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[KT][4];
#pragma unroll
  for (int nt = 0; nt < KT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const bool active = r0 < Tq;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) load_tile(j + 1, st ^ 1);
    cp_async_commit();  // possibly empty: tile j is then the older group
    cp_async_wait_1();
    __syncthreads();
    if (active) {
      const float* cK = sK + st * BN * SK;
      const float* cV = sV + st * BN * SK;
      const float* cB = sB + st * BM * SBS + (warp * 16 + g) * SBS + 2 * t;
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      // fp32 on the CUDA cores, each score a chain of fmaf over d in order
      // (the plain version's and the backward's rounding): rows g, g + 8
      // of this warp's slab against keys 8 nt + 2t + c, in the layout of
      // the mma accumulators that P v reads
      const float* qa = sQ + (warp * 16 + g) * SK;
#pragma unroll
      for (int kc = 0; kc < DP; kc += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qa + kc);
        const float4 a8 = *reinterpret_cast<const float4*>(qa + 8 * SK + kc);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float4 kv = *reinterpret_cast<const float4*>(
                cK + (nt * 8 + 2 * t + c) * SK + kc);
            float& s0 = s[nt][c];
            float& s8 = s[nt][2 + c];
            s0 = fmaf(a.x, kv.x, s0);
            s0 = fmaf(a.y, kv.y, s0);
            s0 = fmaf(a.z, kv.z, s0);
            s0 = fmaf(a.w, kv.w, s0);
            s8 = fmaf(a8.x, kv.x, s8);
            s8 = fmaf(a8.y, kv.y, s8);
            s8 = fmaf(a8.z, kv.z, s8);
            s8 = fmaf(a8.w, kv.w, s8);
          }
      }

      // scores; s[nt][e] is row r0 + g + 8 (e >> 1), key n0 + 8 nt + 2t +
      // (e & 1)
      const int n0 = j * BN;
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + g + 8 * i;
          // keys 2t, 2t + 1 of the bias row: one 8-byte load, rows padded
          // to BN + 8 so that each half warp hits 32 distinct banks
          const float2 bb =
              biasb != nullptr
                  ? *reinterpret_cast<const float2*>(cB + i * 8 * SBS + nt * 8)
                  : make_float2(0.f, 0.f);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * i + c;
            const int n = n0 + nt * 8 + 2 * t + c;
            float val;
            if (n >= Tk) {
              val = -INFINITY;  // not a key: left out of the softmax
            } else {
              // rounded as the plain version: the product, then the sum
              val = __fmul_rn(s[nt][e], sm_scale);
              if (biasb != nullptr) val = __fadd_rn(val, c ? bb.y : bb.x);
              if (causal && n > r + shift) val = -1e9f;
            }
            s[nt][e] = val;
            tmax[i] = fmaxf(tmax[i], val);
          }
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
        // key n0 < Tk is in every tile, so the new max is finite
        const float mnew = fmaxf(m[i], tmax[i]);
        alpha[i] = expf(m[i] - mnew);
        m[i] = mnew;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - m[e >> 1]);
          s[nt][e] = p;
          l[e >> 1] += p;  // this lane's share; the 4 lanes sum at the end
        }
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        acc[nt][0] *= alpha[0];
        acc[nt][1] *= alpha[0];
        acc[nt][2] *= alpha[1];
        acc[nt][3] *= alpha[1];
      }

      // O += P v: k slot t <- key 2t, slot t + 4 <- key 2t + 1
#pragma unroll
      for (int ks = 0; ks < NT; ++ks) {
        uint32_t ah[4], al[4];
        split_tf32(s[ks][0], ah[0], al[0]);
        split_tf32(s[ks][2], ah[1], al[1]);
        split_tf32(s[ks][1], ah[2], al[2]);
        split_tf32(s[ks][3], ah[3], al[3]);
        const float* v0 = cV + (ks * 8 + 2 * t) * SK + g;
#pragma unroll
        for (int nt = 0; nt < KT; ++nt) {
          uint32_t bh2[2], bl2[2];
          split_tf32(v0[nt * 8], bh2[0], bl2[0]);
          split_tf32(v0[SK + nt * 8], bh2[1], bl2[1]);
          mma_3xtf32(acc[nt], ah, al, bh2, bl2);
        }
      }
    }
    __syncthreads();  // stage st is refilled at the next iteration
  }

  if (!active) return;
  float* ob = out + (long long)bh * Tq * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + g + 8 * i;
    if (r >= Tq) continue;
    const float inv = 1.f / l[i];
    if (stats != nullptr && t == 0) {
      float* st = stats + ((long long)bh * Tq + r) * 2;
      st[0] = m[i];
      st[1] = logf(l[i]);
    }
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < d) ob[(long long)r * d + c] = acc[nt][2 * i] * inv;
      if (c + 1 < d) ob[(long long)r * d + c + 1] = acc[nt][2 * i + 1] * inv;
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* out, float* stats, int B, int H, int Tq, int Tk, int d,
           Strides qs, Strides ks, Strides vs, long long bsb, long long bsh,
           long long bsq, long long bsk, int causal, float sm_scale,
           cudaStream_t stream) {
  // 16-row slabs split evenly over the fewest tiles of at most MAXW warps
  const int n16 = (Tq + 15) / 16;
  const int nblk = (n16 + MAXW - 1) / MAXW;
  const int nw = (n16 + nblk - 1) / nblk;
  const int BM = 16 * nw;
  const size_t smem =
      sizeof(float) * (size_t)(4 * BN * (DP + 4) + 2 * BM_MAX * SBS +
                               BM * (DP + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BM - 1) / BM, B * H);
  flash_attn_fwd_kernel<DP><<<grid, 32 * nw, smem, stream>>>(
      q, k, v, bias, out, stats, H, Tq, Tk, d, qs, ks, vs, bsb, bsh, bsq, bsk,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Tq, d), k and v (B, H, Tk, d) with the given batch, head and time
// strides and d contiguous; out (B, H, Tq, d) and stats (B, H, Tq, 2)
// contiguous; the bias broadcast to (B, H, Tq, Tk) through its strides
extern "C" int flash_attn_fwd(const float* q, const float* k, const float* v,
                              const float* bias, float* out, float* stats,
                              int B, int H, int Tq, int Tk, int d,
                              long long qsb, long long qsh, long long qst,
                              long long ksb, long long ksh, long long kst,
                              long long vsb, long long vsh, long long vst,
                              long long bsb, long long bsh, long long bsq,
                              long long bsk, int causal, float sm_scale,
                              void* stream) {
  if (d < 1 || d > DMAX || Tq < 1 || Tk < 1 || B * H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst};
  auto run = [&](auto dp) {
    return launch<decltype(dp)::value>(q, k, v, bias, out, stats, B, H, Tq,
                                       Tk, d, qs, ks, vs, bsb, bsh, bsq, bsk,
                                       causal, sm_scale, s);
  };
  if (d <= 16) return run(std::integral_constant<int, 16>{});
  if (d <= 32) return run(std::integral_constant<int, 32>{});
  if (d <= 64) return run(std::integral_constant<int, 64>{});
  return run(std::integral_constant<int, 128>{});
}
