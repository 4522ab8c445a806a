// Fused log-mel frontend in fp32 for Hopper (sm_90a).
//
// Replaces: espnet_tpu/ops/pallas/logmel_kernel.py:fused_logmel (its Pallas
// body `_kernel`). For a wave (B, S) it computes, for every frame t of the
// centred (reflect-padded) STFT,
//     spec = frame_t @ Wdft      Wdft (n_fft, 2F): Hann x [cos | -sin]
//     power = re^2 + im^2        F = n_fft / 2 + 1 bins
//     out[b, t] = log(max(power @ mel, 1e-10))      mel (F, n_mels)
// and writes (B, T, n_mels) with T = S / hop + 1 (n_fft = k * hop).
//
// What bounds it: the function needs only an FFT per frame and the nonzero
// mel weights, 0.5 GFLOP at the flagship's shape (B=64, S=74656, n_fft=512,
// hop=128, 80 mels), so it is bound by its 31 MB of wave in and log-mel out
// (9 us at 3.35 TB/s). This kernel instead does the windowed DFT as a dense
// (T, n_fft) x (n_fft, 2F) product, 2*B*T*(n_fft*2F + F*n_mels) = 21 GFLOP
// (316 us at the 67 TFLOP/s fp32 rate outside the tensor cores): its own
// design is bound by operations, so it keeps the operands of the DFT in
// shared memory and spends no device-memory traffic on frames or spectra.
// An FFT in shared memory is the way down to the function's bound.
//
// Design: one block of 256 threads per (b, 128-frame tile). The block reads
// its stretch of the wave once, resolving the reflect padding in the load,
// into shared memory as hop-sized chunks (chunk stride hop + 1, so the frames
// a warp reads fall in distinct banks): frame t, sample n is chunk t + n/hop,
// offset n%hop, and the (T, n_fft) frame matrix is never built. Frequencies
// go in chunks of 32 bins: Wdft's rows for the chunk are staged through
// shared memory 64 at a time, each thread accumulates re and im for 4 frames
// x 4 bins in registers, forms the power in registers and stores it to shared
// memory, and the block then adds the chunk's share of power @ mel into mel
// accumulators that stay in registers (8 frames x 5 mels per thread) over all
// chunks. Only the log-mel output is written. Plain fp32 FMA: tensor cores
// (TF32 would not keep fp32 parity), TMA and pipelining are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 128;      // frames per block
constexpr int FC = 32;       // frequency bins per chunk
constexpr int NK = 64;       // DFT rows staged per step
constexpr int THREADS = 256;
constexpr int MELMAX = 128;  // largest n_mels taken
constexpr int MJ = MELMAX / 16;

__global__ void __launch_bounds__(THREADS)
logmel_fwd_kernel(const float* __restrict__ wave, const float* __restrict__ dft,
                  const float* __restrict__ mel, float* __restrict__ out, int S,
                  int n_fft, int hop, int n_mels, int T) {
  extern __shared__ float smem[];
  const int k = n_fft / hop;
  const int nch = TM + k - 1;       // hop chunks the tile's frames span
  const int hs = hop + 1;           // padded chunk stride
  const int F = n_fft / 2 + 1;
  const int pad = n_fft / 2;
  float* sSeg = smem;               // nch x hs
  float* sW = sSeg + nch * hs;      // NK x 2FC  (re | im columns of the chunk)
  float* sPow = sW + NK * 2 * FC;   // TM x (FC + 1)
  float* sMel = sPow + TM * (FC + 1);  // FC x n_mels

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const float* wb = wave + (long long)b * S;

  // the tile's padded samples [t0*hop, (t0+nch)*hop), reflect resolved
  for (int idx = tid; idx < nch * hop; idx += THREADS) {
    const int c = idx / hop, o = idx - (idx / hop) * hop;
    int i = (t0 + c) * hop + o - pad;
    if (i < 0) i = -i;
    if (i >= S) i = 2 * (S - 1) - i;
    sSeg[c * hs + o] = (i >= 0 && i < S) ? wb[i] : 0.f;
  }

  // DFT mapping: frames tf + 32 i, bins tq + 8 j of the chunk
  const int tf = tid >> 3, tq = tid & 7;
  // mel mapping: frames tt + 16 i, mels tm + 16 j
  const int tt = tid >> 4, tm = tid & 15;
  float macc[8][MJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) macc[i][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += FC) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int n0 = 0; n0 < n_fft; n0 += NK) {
      __syncthreads();  // sW (and, at n0 == 0, sMel) no longer read
      for (int idx = tid; idx < NK * 2 * FC; idx += THREADS) {
        const int r = idx / (2 * FC), c = idx - r * (2 * FC);
        const int f = f0 + (c < FC ? c : c - FC);
        const int col = c < FC ? f : F + f;
        sW[idx] = (n0 + r < n_fft && f < F)
                      ? dft[(long long)(n0 + r) * 2 * F + col] : 0.f;
      }
      if (n0 == 0) {
        for (int idx = tid; idx < FC * n_mels; idx += THREADS) {
          const int fl = idx / n_mels, mm = idx - fl * n_mels;
          sMel[idx] = (f0 + fl < F) ? mel[(long long)(f0 + fl) * n_mels + mm]
                                    : 0.f;
        }
      }
      __syncthreads();
      const int kmax = min(NK, n_fft - n0);
      for (int kk = 0; kk < kmax; ++kk) {
        const int n = n0 + kk;
        const int cofs = (n / hop), oofs = n - (n / hop) * hop;
        float x[4], wr[4], wi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = sSeg[(tf + 32 * i + cofs) * hs + oofs];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wr[j] = sW[kk * 2 * FC + tq + 8 * j];
          wi[j] = sW[kk * 2 * FC + FC + tq + 8 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(x[i], wr[j], re[i][j]);
            im[i][j] = fmaf(x[i], wi[j], im[i][j]);
          }
      }
    }
    // power of the chunk's bins (zero weights past F give zero power)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sPow[(tf + 32 * i) * (FC + 1) + tq + 8 * j] =
            re[i][j] * re[i][j] + im[i][j] * im[i][j];
    __syncthreads();
    const int fn = min(FC, F - f0);
    for (int fl = 0; fl < fn; ++fl) {
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = sPow[(tt + 16 * i) * (FC + 1) + fl];
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int mm = tm + 16 * j;
        if (mm < n_mels) {
          const float w = sMel[fl * n_mels + mm];
#pragma unroll
          for (int i = 0; i < 8; ++i) macc[i][j] = fmaf(p[i], w, macc[i][j]);
        }
      }
    }
  }

  float* ob = out + (long long)b * T * n_mels;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + tt + 16 * i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int mm = tm + 16 * j;
      if (mm < n_mels)
        ob[(long long)t * n_mels + mm] = logf(fmaxf(macc[i][j], 1e-10f));
    }
  }
}

}  // namespace

extern "C" int logmel_fwd(const float* wave, const float* dft, const float* mel,
                          float* out, int B, int S, int n_fft, int hop,
                          int n_mels, int T, void* stream) {
  if (hop < 1 || n_fft % hop != 0 || n_mels < 1 || n_mels > MELMAX ||
      S <= n_fft / 2 || T < 1)
    return (int)cudaErrorInvalidValue;
  const int k = n_fft / hop;
  const size_t smem = sizeof(float) * ((size_t)(TM + k - 1) * (hop + 1) +
                                       NK * 2 * FC + TM * (FC + 1) +
                                       FC * n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TM - 1) / TM, B);
  logmel_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      wave, dft, mel, out, S, n_fft, hop, n_mels, T);
  return (int)cudaGetLastError();
}
