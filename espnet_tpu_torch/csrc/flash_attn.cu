// Forward flash attention in fp32 with an additive bias, for Hopper (sm_90a).
//
// Replaces: espnet_tpu/ops/attention_kernels.py:fused_attention, which on the
// TPU calls JAX's Pallas flash_attention (jax.experimental.pallas.ops.tpu).
// It computes out = softmax(q k^T * sm_scale + bias) v, optionally causal,
// for q (B, H, Tq, d), k and v (B, H, Tk, d) and a bias that broadcasts to
// (B, H, Tq, Tk). Every conformer self-attention of the ASR encoder runs it.
//
// What bounds it: at the flagship's shape (B=64, H=4, T=145, d=64) the
// function reads q, k, v and the f32 bias once and writes the output once,
// about 60 MB (18 us at 3.35 TB/s), and does 4*B*H*Tq*Tk*d = 1.4 GFLOP of
// fp32 multiply-adds (21 us at the 67 TFLOP/s fp32 rate outside the tensor
// cores). The bias is the largest input, so the kernel reads it exactly once,
// straight from device memory into registers.
//
// Design: one block of 256 threads per (b, h, 64-query tile). The block keeps
// its query tile in shared memory and walks the keys in 64-key tiles: scores
// for the 64x64 tile (each thread owns 4 query rows x 4 keys), an online
// softmax with a running max and sum per row (reduced over the 16 threads
// that share a row with warp shuffles), then P v into an f32 accumulator in
// registers (4 rows x d/16 columns per thread). The Tq x Tk score matrix never
// goes to device memory. Keys past Tk are left out of the softmax and query
// rows past Tq are not stored, so T needs no padding. Rows of K, Q and P in
// shared memory are padded by one float so the threads of a warp hit distinct
// banks. Plain fp32 FMA, no tensor cores: wgmma, TMA and pipelining are later
// work.
//
// For training, the kernel also writes each query row's softmax statistics,
// the row max m and log l of the row sum, as stats (B, H, Tq, 2). The backward
// (flash_attn_bwd.cu) recomputes P = exp(s - m - log l) from them. Two numbers
// and not one log-sum-exp m + log l: in a row whose every score is masked to
// -1e9 the sum of the two rounds to -1e9 in fp32, and P would come back as 1
// instead of the forward's uniform 1/Tk.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;         // query rows per block
constexpr int BN = 64;         // keys per tile
constexpr int THREADS = 256;
constexpr int DMAX = 128;      // largest head size taken
constexpr int CG = DMAX / 16;  // output column groups per thread
constexpr int BNP = BN + 1;    // padded row of the P tile

__global__ void __launch_bounds__(THREADS)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ stats, int H, int Tq, int Tk,
                      int d, long long bsb, long long bsh, long long bsq,
                      long long bsk, int causal, float sm_scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* sQ = smem;            // BM x dp
  float* sK = sQ + BM * dp;    // BN x dp
  float* sV = sK + BN * dp;    // BN x d
  float* sP = sV + BN * d;     // BM x BNP

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // keys tx + 16 j, output columns tx + 16 c
  const int ty = tid >> 4;     // query rows ty * 4 + i
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = blockIdx.x * BM;
  const float* qb = q + (long long)bh * Tq * d;
  const float* kb = k + (long long)bh * Tk * d;
  const float* vb = v + (long long)bh * Tk * d;
  float* ob = out + (long long)bh * Tq * d;
  const float* biasb = bias ? bias + b * bsb + h * bsh : nullptr;
  // causal: key n is allowed for query row r iff n <= r + shift
  const int shift = Tk - Tq;

  for (int i = tid; i < BM * d; i += THREADS) {
    const int r = i / d, c = i - (i / d) * d;
    sQ[r * dp + c] = (q0 + r < Tq) ? qb[(long long)(q0 + r) * d + c] : 0.f;
  }

  float m[4], l[4], acc[4][CG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = 0; n0 < Tk; n0 += BN) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BN * d; i += THREADS) {
      const int r = i / d, c = i - (i / d) * d;
      const bool ok = n0 + r < Tk;
      sK[r * dp + c] = ok ? kb[(long long)(n0 + r) * d + c] : 0.f;
      sV[i] = ok ? vb[(long long)(n0 + r) * d + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * dp + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * dp + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        float val;
        if (n >= Tk) {
          val = -INFINITY;  // not a key: left out of the softmax
        } else {
          val = s[i][j] * sm_scale;
          if (biasb != nullptr && r < Tq) val += biasb[r * bsq + n * bsk];
          if (causal && n > r + shift) val = -1e9f;
        }
        s[i][j] = val;
        tmax = fmaxf(tmax, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // key n0 < Tk is in every tile, so mnew is finite
      const float mnew = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - mnew);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mnew);
        sP[(ty * 4 + i) * BNP + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int n = 0; n < BN; ++n) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * BNP + n];
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float vv = sV[n * d + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
    const float inv = 1.f / l[i];
    if (stats != nullptr && tx == 0) {
      float* st = stats + ((long long)bh * Tq + r) * 2;
      st[0] = m[i];
      st[1] = logf(l[i]);
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[(long long)r * d + col] = acc[i][c] * inv;
    }
  }
}

}  // namespace

extern "C" int flash_attn_fwd(const float* q, const float* k, const float* v,
                              const float* bias, float* out, float* stats,
                              int B, int H, int Tq, int Tk, int d,
                              long long bsb, long long bsh, long long bsq,
                              long long bsk, int causal, float sm_scale,
                              void* stream) {
  if (d < 1 || d > DMAX || Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)(BM * (d + 1) + BN * (d + 1) + BN * d + BM * BNP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BM - 1) / BM, B * H);
  flash_attn_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, bias, out, stats, H, Tq, Tk, d, bsb, bsh, bsq, bsk, causal,
      sm_scale);
  return (int)cudaGetLastError();
}
