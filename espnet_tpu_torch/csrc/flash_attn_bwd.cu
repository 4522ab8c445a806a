// Backward flash attention in fp32 with an additive bias, for Hopper (sm_90a).
//
// Replaces: the VJP of JAX's Pallas TPU flash_attention, which
// espnet_tpu/ops/attention_kernels.py:fused_attention reaches on the TPU:
// _flash_attention_bwd (jax/experimental/pallas/ops/tpu/flash_attention.py)
// and its two kernels _flash_attention_bwd_dkv and _flash_attention_bwd_dq.
// Given q (B, H, Tq, d), k and v (B, H, Tk, d), the bias of the forward
// (broadcast to (B, H, Tq, Tk) through its strides), the forward's output o,
// its row statistics (max m and log l of the row sum, flash_attn.cu) and the
// output gradient do, it computes
//
//   P  = exp(q k^T * s + bias - m - log l)   (the forward's softmax)
//   D  = rowsum(do * o)
//   dS = P * (do v^T - D),   0 where the causal rule masked the score
//   dbias = dS,  dq = s * dS k,  dk = s * dS^T q,  dv = P^T do
//
// with the forward's causal rule (key j allowed for query i iff
// j <= i + Tk - Tq). Every conformer self-attention of the ASR encoder runs
// it once per train step.
//
// What bounds it: at the flagship's train shape (B=25, H=4, T=145, d=64) the
// function reads q, k, v, o, do and the f32 bias and writes dq, dk, dv and
// dbias, about 46 MB (14 us at 3.35 TB/s), and does five products of
// B*H*Tq*Tk*d multiply-adds (q k^T, do v^T, P^T do, dS^T q, dS k): 1.35 GFLOP,
// 20 us at the 67 TFLOP/s fp32 rate outside the tensor cores. So it is bound
// by operations, and the bias gradient, which the rel-pos term needs, is as
// large as the bias itself.
//
// Design: two kernels, no atomics, so the sums come out the same in every
// run. flash_attn_bwd_dkv_kernel: one block of 256 threads per (b, h, 64-key
// tile) keeps its K and V tiles in shared memory and walks the queries in
// 64-row tiles: recomputes the 64x64 scores and do v^T (each thread 4 query
// rows x 4 keys), forms P and dS, writes dS to dbias, and accumulates
// dv += P^T do and dk += dS^T q in registers (each thread 4 keys x d/16
// columns). D of a query tile is summed by four threads per row. Since dbias
// holds dS whole, flash_attn_bwd_dq_kernel then needs no recompute: one block
// per (b, h, 64-query tile) forms dq = s * dS k from it. When the caller needs
// no bias gradient, dbias is scratch of the same shape. Keys past Tk and rows
// past Tq get P = dS = 0, so T needs no padding. Plain fp32 FMA on the CUDA
// cores: tensor cores, TMA and keeping dS out of device memory when no bias
// gradient is wanted are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;         // query rows per tile
constexpr int BN = 64;         // keys per tile
constexpr int THREADS = 256;
constexpr int DMAX = 128;      // largest head size taken
constexpr int CG = DMAX / 16;  // output column groups per thread
constexpr int TP = BN + 1;     // padded row of the P and dS tiles

__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ stats, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ ds, int H, int Tq, int Tk,
    int d, long long bsb, long long bsh, long long bsq, long long bsk,
    int causal, float sm_scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* sK = smem;            // BN x dp
  float* sV = sK + BN * dp;    // BN x dp
  float* sQ = sV + BN * dp;    // BM x dp
  float* sG = sQ + BM * dp;    // BM x dp, the output gradient
  float* sP = sG + BM * dp;    // BM x TP
  float* sS = sP + BM * TP;    // BM x TP, dS
  float* sM = sS + BM * TP;    // BM row max
  float* sL = sM + BM;         // BM log row sum
  float* sD = sL + BM;         // BM rowsum(do * o)

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // keys tx + 16 j, output columns tx + 16 c
  const int ty = tid >> 4;     // query rows (scores) or keys (dk, dv) ty*4+i
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int n0 = blockIdx.x * BN;
  const long long qoff = (long long)bh * Tq * d;
  const long long koff = (long long)bh * Tk * d;
  const float* biasb = bias ? bias + b * bsb + h * bsh : nullptr;
  float* dsb = ds + (long long)bh * Tq * Tk;
  const float* stb = stats + (long long)bh * Tq * 2;
  const int shift = Tk - Tq;

  for (int i = tid; i < BN * d; i += THREADS) {
    const int r = i / d, c = i - (i / d) * d;
    const bool ok = n0 + r < Tk;
    sK[r * dp + c] = ok ? k[koff + (long long)(n0 + r) * d + c] : 0.f;
    sV[r * dp + c] = ok ? v[koff + (long long)(n0 + r) * d + c] : 0.f;
  }

  float accK[4][CG], accV[4][CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CG; ++c) accK[i][c] = accV[i][c] = 0.f;

  for (int m0 = 0; m0 < Tq; m0 += BM) {
    __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
    for (int i = tid; i < BM * d; i += THREADS) {
      const int r = i / d, c = i - (i / d) * d;
      const bool ok = m0 + r < Tq;
      sQ[r * dp + c] = ok ? q[qoff + (long long)(m0 + r) * d + c] : 0.f;
      sG[r * dp + c] = ok ? dout[qoff + (long long)(m0 + r) * d + c] : 0.f;
    }
    {
      // D = rowsum(do * o), four threads per row
      const int r = tid >> 2, part = tid & 3;
      float acc = 0.f;
      if (m0 + r < Tq) {
        const long long row = qoff + (long long)(m0 + r) * d;
        for (int c = part; c < d; c += 4)
          acc = fmaf(dout[row + c], o[row + c], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) {
        const bool ok = m0 + r < Tq;
        sD[r] = acc;
        sM[r] = ok ? stb[(m0 + r) * 2] : 0.f;
        sL[r] = ok ? stb[(m0 + r) * 2 + 1] : 0.f;
      }
    }
    __syncthreads();

    float s[4][4], g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = g[i][j] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * dp + kk];
        gv[i] = sG[(ty * 4 + i) * dp + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * dp + kk];
        vv[j] = sV[(tx + 16 * j) * dp + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          g[i][j] = fmaf(gv[i], vv[j], g[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i, r = m0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nl = tx + 16 * j, n = n0 + nl;
        float p = 0.f, dsv = 0.f;
        if (r < Tq && n < Tk) {
          float val = s[i][j] * sm_scale;
          if (biasb != nullptr) val += biasb[r * bsq + n * bsk];
          const bool masked = causal && n > r + shift;
          if (masked) val = -1e9f;  // as the forward scores it
          p = expf(val - sM[rl] - sL[rl]);
          dsv = masked ? 0.f : p * (g[i][j] - sD[rl]);
          dsb[(long long)r * Tk + n] = dsv;
        }
        sP[rl * TP + nl] = p;
        sS[rl * TP + nl] = dsv;
      }
    }
    __syncthreads();

    for (int rl = 0; rl < BM; ++rl) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[rl * TP + ty * 4 + i];
        sv[i] = sS[rl * TP + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float gg = sG[rl * dp + col], qq = sQ[rl * dp + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            accV[i][c] = fmaf(pv[i], gg, accV[i][c]);
            accK[i][c] = fmaf(sv[i], qq, accK[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= Tk) continue;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dk[koff + (long long)n * d + col] = accK[i][c] * sm_scale;
        dv[koff + (long long)n * d + col] = accV[i][c];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dq_kernel(const float* __restrict__ ds,
                         const float* __restrict__ k, float* __restrict__ dq,
                         int Tq, int Tk, int d, float sm_scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* sK = smem;            // BN x dp
  float* sS = sK + BN * dp;    // BM x TP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const float* dsb = ds + (long long)bh * Tq * Tk;
  const float* kb = k + (long long)bh * Tk * d;
  float* dqb = dq + (long long)bh * Tq * d;

  float acc[4][CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[i][c] = 0.f;

  for (int n0 = 0; n0 < Tk; n0 += BN) {
    __syncthreads();  // the previous tile's K and dS are no longer read
    for (int i = tid; i < BN * d; i += THREADS) {
      const int r = i / d, c = i - (i / d) * d;
      sK[r * dp + c] = n0 + r < Tk ? kb[(long long)(n0 + r) * d + c] : 0.f;
    }
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i - (i / BN) * BN;
      sS[r * TP + c] = (m0 + r < Tq && n0 + c < Tk)
                           ? dsb[(long long)(m0 + r) * Tk + n0 + c]
                           : 0.f;
    }
    __syncthreads();
    for (int n = 0; n < BN; ++n) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(ty * 4 + i) * TP + n];
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float kk = sK[n * dp + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(sv[i], kk, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= Tq) continue;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = tx + 16 * c;
      if (col < d) dqb[(long long)r * d + col] = acc[i][c] * sm_scale;
    }
  }
}

}  // namespace

// dk, dv and dS (into ds, (B, H, Tq, Tk) contiguous); launch before
// flash_attn_bwd_dq on the same stream.
extern "C" int flash_attn_bwd_dkv(const float* q, const float* k,
                                  const float* v, const float* bias,
                                  const float* o, const float* dout,
                                  const float* stats, float* dk, float* dv,
                                  float* ds, int B, int H, int Tq, int Tk,
                                  int d, long long bsb, long long bsh,
                                  long long bsq, long long bsk, int causal,
                                  float sm_scale, void* stream) {
  if (d < 1 || d > DMAX || Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
                      (size_t)((BN + BN + BM + BM) * (d + 1) + 2 * BM * TP +
                               3 * BM);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + BN - 1) / BN, B * H);
  flash_attn_bwd_dkv_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, bias, o, dout, stats, dk, dv, ds, H, Tq, Tk, d, bsb, bsh, bsq,
      bsk, causal, sm_scale);
  return (int)cudaGetLastError();
}

// dq = sm_scale * dS k from the ds that flash_attn_bwd_dkv wrote.
extern "C" int flash_attn_bwd_dq(const float* ds, const float* k, float* dq,
                                 int B, int H, int Tq, int Tk, int d,
                                 float sm_scale, void* stream) {
  if (d < 1 || d > DMAX || Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(BN * (d + 1) + BM * TP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BM - 1) / BM, B * H);
  flash_attn_bwd_dq_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      ds, k, dq, Tq, Tk, d, sm_scale);
  return (int)cudaGetLastError();
}
