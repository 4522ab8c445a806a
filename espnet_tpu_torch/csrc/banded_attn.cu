// Banded (Longformer) attention forward in fp32, for Hopper (sm_90a).
//
// Replaces: espnet_tpu/ops/attention_kernels.py:banded_attention, which on the
// TPU builds a splash-attention kernel with a LocalMask (_splash_banded_kernel)
// and calls it: _splash_attention_forward in
// jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py.
// For q, k, v (B, H, T, d) and valid (B, T) it computes
//
//   out[i] = sum_j P[i, j] v[j],  P = softmax over the allowed keys j of
//            (q[i] . k[j]) * sm_scale,
//
// a key j being allowed for query i iff |i - j| <= W and valid[b, j]. A row
// with no allowed key (a padded row further than W from every valid key)
// gives 0. Every block of the Longformer encoder runs it once per forward.
//
// What bounds it: at the long-form shape (B=4, H=4, T~2200, d=64, W=64) the
// function reads q, k, v and writes out, about 9 MB (3 us at 3.35 TB/s), and
// does 4*d operations per allowed (i, j) pair, about 129 allowed keys per row:
// 0.29 GFLOP (4 us at the 67 TFLOP/s fp32 rate outside the tensor cores). So
// it is bound by operations, and only if the work stays O(T * W).
//
// Design: K1's (flash_attn.cu) tiling, restricted to the band. One block of
// 256 threads per (b, h, 64-query tile) keeps its query tile in shared memory
// and visits only the keys [q0 - W, q0 + 63 + W] that the band of its rows
// reaches, in 64-key tiles (3 tiles at W = 64), never the rest of T: scores
// for the 64x64 tile (each thread 4 query rows x 4 keys), then an online
// softmax over the allowed keys with a running max and sum per row (reduced
// over the 16 threads of a row with warp shuffles), then P v into an f32
// accumulator in registers. Keys that are not allowed score -inf; a row's max
// stays -inf until it meets an allowed key, and exp is taken against 0 then,
// so no NaN arises. With stats given, each row's max m and log l of its sum
// are written (0 and -inf for a row with no allowed key), for the backward
// (banded_attn_bwd.cu). Plain fp32 FMA on the CUDA cores: wgmma, TMA and
// pipelining are later work.

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
banded_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const unsigned char* __restrict__ valid,
                       float* __restrict__ out, float* __restrict__ stats,
                       int H, int T, int d, int W, float sm_scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* sQ = smem;            // BM x dp
  float* sK = sQ + BM * dp;    // BN x dp
  float* sV = sK + BN * dp;    // BN x d
  float* sP = sV + BN * d;     // BM x BNP
  float* sOK = sP + BM * BNP;  // BN: 1 where the key is in range and valid

  const int tid = threadIdx.x;
  const int tx = tid & 15;     // keys tx + 16 j, output columns tx + 16 c
  const int ty = tid >> 4;     // query rows ty * 4 + i
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BM;
  const long long base = (long long)bh * T * d;
  const unsigned char* vb = valid ? valid + (long long)b * T : nullptr;
  // the keys the band of rows q0 .. q0 + BM - 1 reaches
  const int lo = max(0, q0 - W);
  const int hi = min(T, q0 + BM + W);

  for (int i = tid; i < BM * d; i += THREADS) {
    const int r = i / d, c = i - (i / d) * d;
    sQ[r * dp + c] = (q0 + r < T) ? q[base + (long long)(q0 + r) * d + c] : 0.f;
  }

  float m[4], l[4], acc[4][CG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = lo; n0 < hi; n0 += BN) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BN * d; i += THREADS) {
      const int r = i / d, c = i - (i / d) * d;
      const bool ok = n0 + r < hi;
      sK[r * dp + c] = ok ? k[base + (long long)(n0 + r) * d + c] : 0.f;
      sV[i] = ok ? v[base + (long long)(n0 + r) * d + c] : 0.f;
    }
    if (tid < BN) {
      const int n = n0 + tid;
      sOK[tid] = (n < hi && (vb == nullptr || vb[n] != 0)) ? 1.f : 0.f;
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
        const int nl = tx + 16 * j, n = n0 + nl;
        const bool allowed = sOK[nl] != 0.f && abs(r - n) <= W;
        s[i][j] = allowed ? s[i][j] * sm_scale : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mnew = fmaxf(m[i], tmax);
      // no allowed key seen yet: every p and the old sum are 0 either way
      const float ref = mnew == -INFINITY ? 0.f : mnew;
      const float alpha = expf(m[i] - ref);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - ref);
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
    if (r >= T) continue;
    const bool any = l[i] > 0.f;
    const float inv = any ? 1.f / l[i] : 0.f;
    if (stats != nullptr && tx == 0) {
      float* st = stats + ((long long)bh * T + r) * 2;
      st[0] = any ? m[i] : 0.f;
      st[1] = logf(l[i]);  // -inf for a row with no allowed key
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = tx + 16 * c;
      if (col < d) out[base + (long long)r * d + col] = acc[i][c] * inv;
    }
  }
}

}  // namespace

// valid: (B, T) bytes, nonzero = a valid key, or null for all valid; stats:
// (B, H, T, 2) or null when no gradient is wanted.
extern "C" int banded_attn_fwd(const float* q, const float* k, const float* v,
                               const unsigned char* valid, float* out,
                               float* stats, int B, int H, int T, int d, int W,
                               float sm_scale, void* stream) {
  if (d < 1 || d > DMAX || T < 1 || W < 0) return (int)cudaErrorInvalidValue;
  if (W > T) W = T;  // the band then holds every key
  const size_t smem = sizeof(float) * (size_t)(BM * (d + 1) + BN * (d + 1) +
                                               BN * d + BM * BNP + BN);
  cudaError_t err = cudaFuncSetAttribute(
      banded_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BM - 1) / BM, B * H);
  banded_attn_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, valid, out, stats, H, T, d, W, sm_scale);
  return (int)cudaGetLastError();
}
