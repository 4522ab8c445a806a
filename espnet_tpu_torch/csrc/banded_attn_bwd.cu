// Banded (Longformer) attention backward in fp32, for Hopper (sm_90a).
//
// Replaces: the VJP of the splash attention that
// espnet_tpu/ops/attention_kernels.py:banded_attention reaches on the TPU:
// _splash_attention_bwd (jax/experimental/pallas/ops/tpu/splash_attention/
// splash_attention_kernel.py) and its two kernels _splash_attention_bwd_dq and
// _splash_attention_bwd_dkv. Given q, k, v (B, H, T, d), valid (B, T), the
// forward's output o and row statistics (max m and log l of the row sum,
// banded_attn.cu) and the output gradient do, it computes
//
//   P  = exp(q k^T * s - m - log l) on the allowed keys, 0 elsewhere
//   D  = rowsum(do * o)
//   dS = P * (do v^T - D)
//   dq = s * dS k,  dk = s * dS^T q,  dv = P^T do
//
// with the forward's rule: key j allowed for query i iff |i - j| <= W and
// valid[b, j]. A row with no allowed key has P = 0 and sends nothing. Every
// block of the Longformer encoder runs it once per train step.
//
// What bounds it: at the long-form train shape (B=4, H=4, T~2200, d=64,
// W=64) it reads q, k, v, o, do and writes dq, dk, dv, about 18 MB (5 us at
// 3.35 TB/s), and does about 10*d operations per allowed (i, j) pair (the
// scores and do v^T recomputed in each of its two kernels, then P^T do,
// dS^T q and dS k): ~0.75 GFLOP, 11 us at the 67 TFLOP/s fp32 rate. Bound
// by operations, as long as the work stays O(T * W).
//
// Design: two kernels, both of K1b's (flash_attn_bwd.cu) tiling restricted to
// the band, and no atomics, so the sums come out the same in every run.
// banded_attn_bwd_dkv_kernel: one block of 256 threads per (b, h, 64-key
// tile) keeps its K and V tiles in shared memory and visits only the query
// tiles of its band, [n0 - W, n0 + 63 + W]: recomputes the scores and do v^T
// (each thread 4 query rows x 4 keys), forms P and dS, and accumulates
// dv += P^T do and dk += dS^T q in registers. banded_attn_bwd_dq_kernel: one
// block per (b, h, 64-query tile) keeps its q and do tiles and visits only the
// key tiles of its band, recomputes P and dS the same way and accumulates
// dq += dS k. Nothing of size T x T is written: dS lives in shared memory.
// D of a query tile is summed by four threads per row in each kernel. Plain
// fp32 FMA on the CUDA cores: tensor cores, TMA and one fused pass are later
// work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;         // query rows per tile
constexpr int BN = 64;         // keys per tile
constexpr int THREADS = 256;
constexpr int DMAX = 128;      // largest head size taken
constexpr int CG = DMAX / 16;  // output column groups per thread
constexpr int TP = BN + 1;     // padded row of the P and dS tiles

// The query tile m0's rows (< mhi) of q and do into sQ and sG, and each row's
// D, m and log l into sD, sM and sL.
__device__ void load_query_tile(const float* __restrict__ q,
                                const float* __restrict__ o,
                                const float* __restrict__ dout,
                                const float* __restrict__ stb, long long base,
                                int m0, int mhi, int d, float* sQ, float* sG,
                                float* sD, float* sM, float* sL) {
  const int tid = threadIdx.x, dp = d + 1;
  for (int i = tid; i < BM * d; i += THREADS) {
    const int r = i / d, c = i - (i / d) * d;
    const bool ok = m0 + r < mhi;
    sQ[r * dp + c] = ok ? q[base + (long long)(m0 + r) * d + c] : 0.f;
    sG[r * dp + c] = ok ? dout[base + (long long)(m0 + r) * d + c] : 0.f;
  }
  // D = rowsum(do * o), four threads per row
  const int r = tid >> 2, part = tid & 3;
  const bool ok = m0 + r < mhi;
  float acc = 0.f;
  if (ok) {
    const long long row = base + (long long)(m0 + r) * d;
    for (int c = part; c < d; c += 4) acc = fmaf(dout[row + c], o[row + c], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) {
    sD[r] = acc;
    sM[r] = ok ? stb[(m0 + r) * 2] : 0.f;
    sL[r] = ok ? stb[(m0 + r) * 2 + 1] : 0.f;
  }
}

// The key tile n0's rows (< nhi) of k and v into sK and sV, and 1 in sOK
// where the key is in range and valid.
__device__ void load_key_tile(const float* __restrict__ k,
                              const float* __restrict__ v,
                              const unsigned char* __restrict__ vb,
                              long long base, int n0, int nhi, int d,
                              float* sK, float* sV, float* sOK) {
  const int tid = threadIdx.x, dp = d + 1;
  for (int i = tid; i < BN * d; i += THREADS) {
    const int r = i / d, c = i - (i / d) * d;
    const bool ok = n0 + r < nhi;
    sK[r * dp + c] = ok ? k[base + (long long)(n0 + r) * d + c] : 0.f;
    sV[r * dp + c] = ok ? v[base + (long long)(n0 + r) * d + c] : 0.f;
  }
  if (tid < BN) {
    const int n = n0 + tid;
    sOK[tid] = (n < nhi && (vb == nullptr || vb[n] != 0)) ? 1.f : 0.f;
  }
}

// P and dS of the (query tile m0, key tile n0) pair into sP and sS (BM x TP),
// from the tiles in shared memory; each thread 4 rows x 4 keys.
__device__ void p_and_ds(const float* sQ, const float* sG, const float* sK,
                         const float* sV, const float* sOK, const float* sD,
                         const float* sM, const float* sL, int m0, int mhi,
                         int n0, int d, int W, float sm_scale, float* sP,
                         float* sS) {
  const int tid = threadIdx.x, dp = d + 1;
  const int tx = tid & 15, ty = tid >> 4;
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
      if (r < mhi && sOK[nl] != 0.f && abs(r - n) <= W) {
        p = expf(s[i][j] * sm_scale - sM[rl] - sL[rl]);
        dsv = p * (g[i][j] - sD[rl]);
      }
      sP[rl * TP + nl] = p;
      sS[rl * TP + nl] = dsv;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
banded_attn_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ valid,
    const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ stats, float* __restrict__ dk,
    float* __restrict__ dv, int H, int T, int d, int W, float sm_scale) {
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
  float* sOK = sD + BM;        // BN

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // output columns tx + 16 c
  const int ty = tid >> 4;     // keys ty * 4 + i
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int n0 = blockIdx.x * BN;
  const long long base = (long long)bh * T * d;
  const float* stb = stats + (long long)bh * T * 2;
  const unsigned char* vb = valid ? valid + (long long)b * T : nullptr;
  // the query rows whose band reaches keys n0 .. n0 + BN - 1
  const int mlo = max(0, n0 - W);
  const int mhi = min(T, n0 + BN + W);

  load_key_tile(k, v, vb, base, n0, T, d, sK, sV, sOK);

  float accK[4][CG], accV[4][CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CG; ++c) accK[i][c] = accV[i][c] = 0.f;

  for (int m0 = mlo; m0 < mhi; m0 += BM) {
    __syncthreads();  // the previous tile's Q, dO, P and dS are no longer read
    load_query_tile(q, o, dout, stb, base, m0, mhi, d, sQ, sG, sD, sM, sL);
    __syncthreads();
    p_and_ds(sQ, sG, sK, sV, sOK, sD, sM, sL, m0, mhi, n0, d, W, sm_scale, sP,
             sS);
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
    if (n >= T) continue;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dk[base + (long long)n * d + col] = accK[i][c] * sm_scale;
        dv[base + (long long)n * d + col] = accV[i][c];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
banded_attn_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ valid,
    const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ stats, float* __restrict__ dq, int H, int T,
    int d, int W, float sm_scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* sQ = smem;            // BM x dp
  float* sG = sQ + BM * dp;    // BM x dp, the output gradient
  float* sK = sG + BM * dp;    // BN x dp
  float* sV = sK + BN * dp;    // BN x dp
  float* sP = sV + BN * dp;    // BM x TP
  float* sS = sP + BM * TP;    // BM x TP, dS
  float* sM = sS + BM * TP;    // BM row max
  float* sL = sM + BM;         // BM log row sum
  float* sD = sL + BM;         // BM rowsum(do * o)
  float* sOK = sD + BM;        // BN

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // output columns tx + 16 c
  const int ty = tid >> 4;     // query rows ty * 4 + i
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int m0 = blockIdx.x * BM;
  const long long base = (long long)bh * T * d;
  const float* stb = stats + (long long)bh * T * 2;
  const unsigned char* vb = valid ? valid + (long long)b * T : nullptr;
  // the keys the band of rows m0 .. m0 + BM - 1 reaches
  const int lo = max(0, m0 - W);
  const int hi = min(T, m0 + BM + W);

  load_query_tile(q, o, dout, stb, base, m0, T, d, sQ, sG, sD, sM, sL);

  float acc[4][CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[i][c] = 0.f;

  for (int n0 = lo; n0 < hi; n0 += BN) {
    __syncthreads();  // the previous tile's K, V, P and dS are no longer read
    load_key_tile(k, v, vb, base, n0, hi, d, sK, sV, sOK);
    __syncthreads();
    p_and_ds(sQ, sG, sK, sV, sOK, sD, sM, sL, m0, T, n0, d, W, sm_scale, sP,
             sS);
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
    if (r >= T) continue;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = tx + 16 * c;
      if (col < d) dq[base + (long long)r * d + col] = acc[i][c] * sm_scale;
    }
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) *
         (size_t)((BN + BN + BM + BM) * (d + 1) + 2 * BM * TP + 3 * BM + BN);
}

}  // namespace

// dk and dv; valid: (B, T) bytes, nonzero = a valid key, or null.
extern "C" int banded_attn_bwd_dkv(const float* q, const float* k,
                                   const float* v, const unsigned char* valid,
                                   const float* o, const float* dout,
                                   const float* stats, float* dk, float* dv,
                                   int B, int H, int T, int d, int W,
                                   float sm_scale, void* stream) {
  if (d < 1 || d > DMAX || T < 1 || W < 0) return (int)cudaErrorInvalidValue;
  if (W > T) W = T;  // the band then holds every key
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      banded_attn_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BN - 1) / BN, B * H);
  banded_attn_bwd_dkv_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, valid, o, dout, stats, dk, dv, H, T, d, W, sm_scale);
  return (int)cudaGetLastError();
}

// dq; the same arguments as banded_attn_bwd_dkv.
extern "C" int banded_attn_bwd_dq(const float* q, const float* k,
                                  const float* v, const unsigned char* valid,
                                  const float* o, const float* dout,
                                  const float* stats, float* dq, int B, int H,
                                  int T, int d, int W, float sm_scale,
                                  void* stream) {
  if (d < 1 || d > DMAX || T < 1 || W < 0) return (int)cudaErrorInvalidValue;
  if (W > T) W = T;  // the band then holds every key
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      banded_attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BM - 1) / BM, B * H);
  banded_attn_bwd_dq_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, valid, o, dout, stats, dq, H, T, d, W, sm_scale);
  return (int)cudaGetLastError();
}
