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
// with logadd(a, b) = max(a, b) + log1p(exp(-|a - b|)). Cells outside
// t < T_b, u <= U_b are -1e30 in alpha and beta, and a sweep visits only the
// cells inside: its work is the data's, not the padded lattice's.
//
// What bounds it: the function reads the two lattices and writes one
// lattice, 2.8 MB at the transducer's train shape (B=25, T=145, U+1=65),
// 0.84 us at 3.35 TB/s; its ~10 operations a cell are nothing beside that.
// The real limit is the dependency chain: T_b + U_b anti-diagonals, each
// waiting on the one before (209 at that shape), one barrier apiece.
//
// Design: the TPU kernel pre-skews the lattices in XLA so that a diagonal is
// one contiguous row of its vector registers. On the card that is not
// needed: one block per utterance, one thread per u (a thread takes several
// u when U+1 exceeds the block); at diagonal d thread u computes cell
// (d-u, u). The previous diagonal lives in shared memory, double-buffered,
// so one __syncthreads() per diagonal orders the reads of one step before
// the writes of the next. The lattices are read from device memory, where
// a sample's 75 KB sit in L2 after the first touch; shared memory holds only
// 2 (U+1) floats, so the same kernel takes every shape up to the block's
// shared-memory limit. No atomics: each cell is written by one thread once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_THREADS = 1024;
constexpr size_t MAX_SMEM = 232448;  // what one block may hold on Hopper

__device__ __forceinline__ float logadd(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ void lengths(const int* tlen, const int* ulen,
                                        int b, int T, int U1, int* Tb,
                                        int* Ub) {
  *Tb = min(max(tlen[b], 0), T);
  *Ub = min(max(ulen[b], 0), U1 - 1);
}

// -1e30 in every cell of the sample's lattice outside t < Tb, u <= Ub
__device__ void fill_outside(float* lat, int T, int U1, int Tb, int Ub) {
  for (int i = threadIdx.x; i < T * U1; i += blockDim.x) {
    if (i / U1 >= Tb || i % U1 > Ub) lat[i] = NEG;
  }
}

__global__ void rnnt_alpha_kernel(const float* __restrict__ blank,
                                  const float* __restrict__ emit,
                                  const int* __restrict__ tlen,
                                  const int* __restrict__ ulen,
                                  float* __restrict__ alpha,
                                  float* __restrict__ nll, int T, int U1) {
  extern __shared__ float diag[];  // two diagonals of U1 slots
  const int b = blockIdx.x;
  const long long off = (long long)b * T * U1;
  const float* bl = blank + off;
  const float* em = emit + off;
  float* al = alpha + off;
  int Tb, Ub;
  lengths(tlen, ulen, b, T, U1, &Tb, &Ub);
  fill_outside(al, T, U1, Tb, Ub);
  float* prev = diag;
  float* cur = diag + U1;
  const int D = Tb > 0 ? Tb + Ub : 0;  // diagonals inside the lattice
  for (int d = 0; d < D; ++d) {
    for (int u = threadIdx.x; u < U1; u += blockDim.x) {
      const int t = d - u;
      float a = NEG;
      if (u <= Ub && t >= 0 && t < Tb) {
        if (d == 0) {
          a = 0.f;
        } else {
          const float from_blank =
              t >= 1 ? prev[u] + bl[(t - 1) * U1 + u] : NEG;
          const float from_emit =
              u >= 1 ? prev[u - 1] + em[t * U1 + u - 1] : NEG;
          a = logadd(from_blank, from_emit);
        }
        al[t * U1 + u] = a;
      }
      cur[u] = a;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  if (threadIdx.x == 0) {
    // the exit cell (Tb-1, Ub) lies on the last diagonal, now in prev
    nll[b] = D > 0 ? -(prev[Ub] + bl[(Tb - 1) * U1 + Ub]) : -NEG;
  }
}

__global__ void rnnt_beta_kernel(const float* __restrict__ blank,
                                 const float* __restrict__ emit,
                                 const int* __restrict__ tlen,
                                 const int* __restrict__ ulen,
                                 float* __restrict__ beta, int T, int U1) {
  extern __shared__ float diag[];
  const int b = blockIdx.x;
  const long long off = (long long)b * T * U1;
  const float* bl = blank + off;
  const float* em = emit + off;
  float* be = beta + off;
  int Tb, Ub;
  lengths(tlen, ulen, b, T, U1, &Tb, &Ub);
  fill_outside(be, T, U1, Tb, Ub);
  float* next = diag;
  float* cur = diag + U1;
  const int D = Tb > 0 ? Tb + Ub : 0;
  for (int d = D - 1; d >= 0; --d) {
    for (int u = threadIdx.x; u < U1; u += blockDim.x) {
      const int t = d - u;
      float v = NEG;
      if (u <= Ub && t >= 0 && t < Tb) {
        // beta(t+1, u) is slot u of the next diagonal; past the last frame
        // only the exit continues, with probability 1
        const float after_blank =
            t == Tb - 1 ? (u == Ub ? 0.f : NEG) : next[u];
        const float after_emit = u < Ub ? next[u + 1] : NEG;
        v = logadd(bl[t * U1 + u] + after_blank, em[t * U1 + u] + after_emit);
        be[t * U1 + u] = v;
      }
      cur[u] = v;
    }
    __syncthreads();
    float* tmp = next;
    next = cur;
    cur = tmp;
  }
}

int launch_config(int U1, int* threads, size_t* smem) {
  *threads = min((U1 + 31) / 32 * 32, MAX_THREADS);
  *smem = 2 * sizeof(float) * (size_t)U1;
  return *smem <= MAX_SMEM ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rnnt_alpha(const float* blank, const float* emit,
                          const int* tlen, const int* ulen, float* alpha,
                          float* nll, int B, int T, int U1, void* stream) {
  int threads;
  size_t smem;
  if (B < 1 || T < 1 || U1 < 1 || launch_config(U1, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rnnt_alpha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rnnt_alpha_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      blank, emit, tlen, ulen, alpha, nll, T, U1);
  return (int)cudaGetLastError();
}

extern "C" int rnnt_beta(const float* blank, const float* emit,
                         const int* tlen, const int* ulen, float* beta, int B,
                         int T, int U1, void* stream) {
  int threads;
  size_t smem;
  if (B < 1 || T < 1 || U1 < 1 || launch_config(U1, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rnnt_beta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rnnt_beta_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      blank, emit, tlen, ulen, beta, T, U1);
  return (int)cudaGetLastError();
}
