// Fused log-mel frontend in fp32 for Hopper (sm_90a): a shared-memory FFT
// per frame and a sparse mel sum.
//
// Replaces: espnet_tpu/ops/pallas/logmel_kernel.py:fused_logmel (its Pallas
// body `_kernel`). For a wave (B, S) it computes, for every frame t of the
// centred (reflect-padded) STFT with the periodic Hann window w,
//     X_t = rfft(w * frame_t)              F = n_fft / 2 + 1 bins
//     out[b, t] = log(max(|X_t|^2 @ mel, 1e-10))      mel (F, n_mels)
// and writes (B, T, n_mels) with T = S / hop + 1. It takes every power-of-two
// n_fft from 64 to 2048 with hop | n_fft and n_mels <= 128 (the frontend's
// eligibility rule, frontends/default.py:_fused_eligible).
//
// What bounds it: the function needs an FFT per frame and the nonzero mel
// weights, about 0.5 GFLOP at the flagship's shape (B=64, S=74656, n_fft=512,
// hop=128, 80 mels; 8 us at the 67 TFLOP/s fp32 rate), so it is bound by its
// 31 MB of wave in and log-mel out: 9.3 us at 3.35 TB/s. Only the log-mel
// goes to device memory; frames and spectra never do.
//
// Design: one block of 8 warps per (b, tile of consecutive frames). The host
// splits T into equal tiles of at most 16 frames (T = 584: 37 tiles of 16,
// the last 8 frames of padding). The block loads the tile's span of samples,
// (frames - 1) * hop + n_fft, into shared memory once, coalesced, 16 bytes a
// thread by cp.async where it is aligned and inside the wave, with the reflect
// padding resolved by plain loads elsewhere; frames overlap 4x at hop 128, so
// the wave is read from device memory about once. The tables come in the same
// cp.async group. Then:
//   - the n_fft-point real FFT of each frame as an M = n_fft/2-point complex
//     FFT of z[n] = w[2n]x[2n] + i w[2n+1]x[2n+1], by M/16 lanes (at most 32;
//     so at n_fft 512 a warp does 2 frames at once, 16 lanes each):
//     Stockham stages of radix 16, 16, ... then 8, 4 or 2, each lane doing
//     its radix-16 butterflies in registers, the exchanges through a frame
//     buffer in shared memory (one pad every 16 complex values: free of bank
//     conflicts), the stage twiddles in per-stage tables laid out so that
//     neighbouring lanes read neighbouring entries. At n_fft 512 that is one
//     exchange. The last stage leaves Z[lf + G m] in lane lf's registers;
//   - the split step in registers: X[k] = E[k] + W^k O[k] and
//     X[M-k] = conj(E[k] - W^k O[k]) from Z[k] and Z[M-k], the latter by a
//     shuffle from the lane that holds it; the powers |X|^2 into the tile's
//     (frames, M + 1) rows in shared memory;
//   - per (frame, mel bin), the sum over the filter's nonzero weights only
//     (the wrapper packs mel_matrix per mel bin into first bin, count and
//     offset, and the weights: 514 of the 257 x 80 entries at n_fft 512),
//     then log(max(., 1e-10)), written coalesced over the tile's
//     (frames, n_mels) block.
// The window and the twiddles exp(-2 pi i k / n_fft) come from the host,
// built in float64 and rounded to fp32. Plain fp32 on the CUDA cores: the
// FFT does 2.5 N log2 N operations a frame, not the dense DFT's 4 N F.
//
// How far from the bound (chip_smoke.py; PERF.md section 6): about 6x at the
// flagship's shape, 6x faster than torch.stft + the mel product. The
// bytes are not what holds it: it is the work per frame on the CUDA cores
// and through shared memory (two radix-16 passes, the split step, and the
// sparse mel sums with an accurate logf per output, whose uneven filter
// lengths leave lanes idle), against a wave that is read in 9 us.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TFMAX = 16;          // frames per block at most
constexpr int MELMAX = 128;        // largest n_mels taken
constexpr size_t SMEM_CAP = 200 * 1024;

__device__ __forceinline__ int padi(int a) { return a + (a >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// -i * a
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// exp(-2 pi i m / 16) for m = 0..9
__device__ __forceinline__ float2 w16(int m) {
  constexpr float c[10] = {1.f, 0.92387953251128674f, 0.70710678118654752f,
                           0.38268343236508977f, 0.f, -0.38268343236508977f,
                           -0.70710678118654752f, -0.92387953251128674f, -1.f,
                           -0.92387953251128674f};
  constexpr float s[10] = {0.f, 0.38268343236508977f, 0.70710678118654752f,
                           0.92387953251128674f, 1.f, 0.92387953251128674f,
                           0.70710678118654752f, 0.38268343236508977f, 0.f,
                           -0.38268343236508977f};
  return make_float2(c[m], -s[m]);
}

// out[k] = sum_r v[r] exp(-2 pi i r k / R), in place, natural order
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[2] = csub(t0, t2);
    v[1] = cadd(t1, t3);
    v[3] = csub(t1, t3);
  } else if constexpr (R == 8) {
    float2 e[4] = {v[0], v[2], v[4], v[6]};
    float2 o[4] = {v[1], v[3], v[5], v[7]};
    dft<4>(e);
    dft<4>(o);
    constexpr float c = 0.70710678118654752f;
    // o[k] *= exp(-2 pi i k / 8)
    o[1] = make_float2(c * (o[1].x + o[1].y), c * (o[1].y - o[1].x));
    o[2] = mul_mi(o[2]);
    o[3] = make_float2(c * (o[3].y - o[3].x), -c * (o[3].x + o[3].y));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = cadd(e[q], o[q]);
      v[q + 4] = csub(e[q], o[q]);
    }
  } else {
    static_assert(R == 16, "radix 2, 4, 8 or 16");
    // r = 4a + b, k = k1 + 4 k2: a 4-point DFT over a for each b, the
    // twiddles exp(-2 pi i b k1 / 16), then a 4-point DFT over b
    float2 y[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float2 t[4] = {v[b], v[4 + b], v[8 + b], v[12 + b]};
      dft<4>(t);
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1)
        y[b][k1] = (b * k1 == 0) ? t[k1] : cmul(t[k1], w16(b * k1));
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      float2 t[4] = {y[0][k1], y[1][k1], y[2][k1], y[3][k1]};
      dft<4>(t);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = t[k2];
    }
  }
}

// The FFT of M complex values by the G lanes of one frame (lane lf of
// them). One Stockham stage: butterfly j reads values j + r M/R, multiplies
// by the twiddles of its place e = j % NS in the sub-transforms of size NS
// (tws[(r - 1) NS + e], consecutive lanes on consecutive entries), and
// writes its R outputs to (j - e) R + e + r NS. Every lane reads all its
// butterflies' inputs before any lane writes, so a stage works in place.
// The first stage reads the windowed frame instead, z[n] = (w[2n] x[2n],
// w[2n+1] x[2n+1]); the last one keeps its outputs in registers: lane lf
// ends holding Z[lf + G m] in z[m].
template <int M, int G, int R, int NS, bool FIRST, bool LAST>
__device__ __forceinline__ void fft_stage(float2* buf, const float2* tws,
                                          const float* x, const float2* win,
                                          bool even, int lf,
                                          float2 (&z)[M / G]) {
  constexpr int NB = M / R;       // butterflies
  constexpr int BPL = NB / G;     // per lane
  float2 v[BPL][R];
#pragma unroll
  for (int bb = 0; bb < BPL; ++bb) {
    const int j = lf + G * bb;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = j + r * NB;
      if constexpr (FIRST) {
        const float2 xv = even ? reinterpret_cast<const float2*>(x)[n]
                               : make_float2(x[2 * n], x[2 * n + 1]);
        const float2 wv = win[n];
        v[bb][r] = make_float2(wv.x * xv.x, wv.y * xv.y);
      } else {
        v[bb][r] = buf[padi(n)];
      }
    }
  }
  if constexpr (!LAST) __syncwarp();
#pragma unroll
  for (int bb = 0; bb < BPL; ++bb) {
    const int j = lf + G * bb;
    const int e = j & (NS - 1);
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[bb][r] = cmul(v[bb][r], tws[(r - 1) * NS + e]);
    }
    dft<R>(v[bb]);
    const int base = (j - e) * R + e;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (LAST)
        z[bb + BPL * r] = v[bb][r];  // = Z[base + r NS], base = j
      else
        buf[padi(base + r * NS)] = v[bb][r];
    }
  }
  if constexpr (!LAST) __syncwarp();
}

// the stages after the first: radix 16 while 4 bits are left, then 8, 4 or
// 2; TOFF is the stage's offset in the twiddle tables
template <int M, int G, int NS, int REM, int TOFF>
__device__ __forceinline__ void fft_rest(float2* buf, const float2* tws,
                                         int lf, float2 (&z)[M / G]) {
  if constexpr (REM > 0) {
    constexpr int LR = REM >= 4 ? 4 : REM;
    constexpr int R = 1 << LR;
    fft_stage<M, G, R, NS, false, REM == LR>(buf, tws + TOFF, nullptr,
                                             nullptr, false, lf, z);
    fft_rest<M, G, NS * R, REM - LR, TOFF + (R - 1) * NS>(buf, tws, lf, z);
  }
}

// the stages' twiddle tables: exp(-2 pi i r e / (NS R)) = tw[2 r e M/(NS R)]
// (tw over n_fft) at (r - 1) NS + e, stage after stage
template <int M, int NS, int REM>
__device__ __forceinline__ void fill_twiddles(float2* tws, const float2* tw,
                                              int tid) {
  if constexpr (REM > 0) {
    constexpr int LR = REM >= 4 ? 4 : REM;
    constexpr int R = 1 << LR;
    for (int i = tid; i < (R - 1) * NS; i += THREADS) {
      const int r = i / NS + 1, e = i % NS;
      tws[i] = tw[2 * r * e * (M / (NS * R))];
    }
    fill_twiddles<M, NS * R, REM - LR>(tws + (R - 1) * NS, tw, tid);
  }
}

template <int NS, int REM>
constexpr int twiddles_size() {
  if constexpr (REM > 0) {
    constexpr int LR = REM >= 4 ? 4 : REM;
    return ((1 << LR) - 1) * NS + twiddles_size<NS * (1 << LR), REM - LR>();
  } else {
    return 0;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// floats of the tile's span of samples, rounded up to 16 bytes
__host__ __device__ __forceinline__ int span_floats(int TF, int hop, int N) {
  return ((TF - 1) * hop + N + 3) / 4 * 4;
}

template <int LOGM>
struct Shape {
  static constexpr int M = 1 << LOGM;               // complex FFT size
  static constexpr int N = 2 * M;                   // n_fft
  static constexpr int G = M / 16 < 32 ? M / 16 : 32;  // lanes per frame
  static constexpr int FPW = 32 / G;                // frames per warp at once
  static constexpr int MP = M + (M >> 4);           // padded frame buffer
  static constexpr int TWS = twiddles_size<16, LOGM - 4>();
  // float2: split twiddles (M), stage twiddles, frame buffers
  static constexpr int F2 = M + ((TWS + 1) & ~1) + WARPS * FPW * MP;
};

// a tile's padded samples [t0 hop - N/2, ...) into seg, reflect resolved:
// 16-byte cp.async where aligned and inside the wave, plain loads elsewhere
__device__ __forceinline__ void load_span(float* seg, const float* wb, int S,
                                          long long gs, int span4, int tid) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(wb) + (uintptr_t)(gs * 4)) & 15) == 0;
  for (int c = tid; c < span4; c += THREADS) {
    const long long i = gs + 4 * c;
    if (aligned && i >= 0 && i + 3 < S) {
      cp_async16(seg + 4 * c, wb + i);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        long long ii = i + e;
        if (ii < 0) ii = -ii;
        if (ii >= S) ii = 2 * (long long)(S - 1) - ii;
        seg[4 * c + e] = (ii >= 0 && ii < S) ? wb[ii] : 0.f;
      }
    }
  }
}

template <int LOGM>
__global__ void __launch_bounds__(THREADS)
logmel_fwd_kernel(const float* __restrict__ wave, const float* __restrict__ win,
                  const float* __restrict__ tw,
                  const int* __restrict__ mel_idx,
                  const float* __restrict__ mel_w, float* __restrict__ out,
                  int S, int hop, int n_mels, int nnz, int T, int TF) {
  using Sh = Shape<LOGM>;
  constexpr int M = Sh::M, N = Sh::N, G = Sh::G, FPW = Sh::FPW, MP = Sh::MP;
  constexpr int VPL = M / G;
  extern __shared__ float4 smem4[];
  float2* sTwS = reinterpret_cast<float2*>(smem4);             // M
  float2* sTws = sTwS + M;                                      // TWS
  float2* sBuf = sTwS + M + ((Sh::TWS + 1) & ~1);               // FPW MP a warp
  float* sSeg = reinterpret_cast<float*>(sTwS + Sh::F2);        // span, 16B
  float* sWin = sSeg + span_floats(TF, hop, N);                 // N
  float* sP = sWin + N;                                         // TF x (M+1)
  float* sMelW = sP + TF * (M + 1);                             // nnz
  int* sMelIdx = reinterpret_cast<int*>(sMelW + nnz);           // n_mels x 3
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * TF;
  const int nfr = min(TF, T - t0);

  // the tile's samples and the tables, all in flight together
  load_span(sSeg, wave + (long long)b * S, S, (long long)t0 * hop - M,
            span_floats(nfr, hop, N) / 4, tid);
  for (int c = tid; c < M / 2; c += THREADS)
    cp_async16(sTwS + 2 * c, tw + 4 * c);
  for (int c = tid; c < N / 4; c += THREADS)
    cp_async16(sWin + 4 * c, win + 4 * c);
  for (int i = tid; i < nnz; i += THREADS) cp_async4(sMelW + i, mel_w + i);
  for (int i = tid; i < 3 * n_mels; i += THREADS)
    cp_async4(sMelIdx + i, mel_idx + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  fill_twiddles<M, 16, LOGM - 4>(sTws, reinterpret_cast<const float2*>(tw),
                                 tid);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // FPW frames at a time per warp, G lanes each: the FFT, then the split
  // step in registers for the pairs k = lf + G m < M/2 and M - k:
  // X[k] = E + W^k O and X[M-k] = conj(E - W^k O), with
  // E = (Z[k] + conj(Z[M-k])) / 2, O = (Z[k] - conj(Z[M-k])) / 2i; Z[M-k]
  // comes from lane G - lf (lane 0 holds its own), and the powers go to the
  // tile's P rows
  const int lf = lane & (G - 1), sub = lane / G;
  const int partner = (lane & ~(G - 1)) | ((G - lf) & (G - 1));
  float2* buf = sBuf + (warp * FPW + sub) * MP;
  const bool even = (hop & 1) == 0;
  for (int fg = warp * FPW; fg < nfr; fg += WARPS * FPW) {
    const int f = fg + sub;
    const bool valid = f < nfr;
    float2 z[VPL];
    fft_stage<M, G, 16, 1, true, false>(
        buf, nullptr, sSeg + (valid ? f : nfr - 1) * hop,
        reinterpret_cast<const float2*>(sWin), even, lf, z);
    fft_rest<M, G, 16, LOGM - 4, 0>(buf, sTws, lf, z);
    float* P = sP + f * (M + 1);
#pragma unroll
    for (int m = 0; m < VPL / 2; ++m) {
      float2 zm = make_float2(
          __shfl_sync(0xffffffffu, z[VPL - 1 - m].x, partner),
          __shfl_sync(0xffffffffu, z[VPL - 1 - m].y, partner));
      if (lf == 0) zm = z[(VPL - m) % VPL];
      const float2 zk = z[m];
      const float ex = 0.5f * (zk.x + zm.x), ey = 0.5f * (zk.y - zm.y);
      const float ox = 0.5f * (zk.y + zm.y), oy = -0.5f * (zk.x - zm.x);
      const int k = lf + G * m;
      const float2 w = sTwS[k];
      const float wox = w.x * ox - w.y * oy, woy = w.x * oy + w.y * ox;
      if (valid) {
        P[k] = (ex + wox) * (ex + wox) + (ey + woy) * (ey + woy);
        P[M - k] = (ex - wox) * (ex - wox) + (ey - woy) * (ey - woy);
      }
    }
    if (valid && lf == 0)  // X[M/2] = conj(Z[M/2]) for a real frame
      P[M / 2] = z[VPL / 2].x * z[VPL / 2].x + z[VPL / 2].y * z[VPL / 2].y;
    __syncwarp();  // buf is rewritten by the next frames' first stage
  }
  __syncthreads();

  // the tile's (frames, n_mels) log-mel, each over its filter's nonzero
  // weights, written coalesced
  float* ob = out + ((long long)b * T + t0) * n_mels;
  const int df = THREADS / n_mels, dm = THREADS - df * n_mels;
  int f = tid / n_mels, mm = tid - f * n_mels;
  for (int o = tid; o < nfr * n_mels; o += THREADS) {
    const int f0 = sMelIdx[3 * mm], cnt = sMelIdx[3 * mm + 1];
    const float* wm = sMelW + sMelIdx[3 * mm + 2];
    const float* P = sP + f * (M + 1) + f0;
    float s = 0.f;
    for (int c = 0; c < cnt; ++c) s = fmaf(wm[c], P[c], s);
    ob[o] = logf(fmaxf(s, 1e-10f));
    f += df;
    mm += dm;
    if (mm >= n_mels) {
      mm -= n_mels;
      ++f;
    }
  }
}

// shared memory of a block of TF frames
template <int LOGM>
size_t smem_bytes(int TF, int hop, int n_mels, int nnz) {
  using Sh = Shape<LOGM>;
  return sizeof(float2) * (size_t)Sh::F2 +
         sizeof(float) * ((size_t)span_floats(TF, hop, Sh::N) + Sh::N +
                          (size_t)TF * (Sh::M + 1) + nnz) +
         sizeof(int) * 3 * (size_t)n_mels;
}

template <int LOGM>
int launch(const float* wave, const float* win, const float* tw,
           const int* mel_idx, const float* mel_w, float* out, int B, int S,
           int hop, int n_mels, int nnz, int T, cudaStream_t stream) {
  // equal tiles of at most TFMAX frames, fewer where shared memory is short
  int tf_max = TFMAX;
  while (tf_max > 1 && smem_bytes<LOGM>(tf_max, hop, n_mels, nnz) > SMEM_CAP)
    --tf_max;
  const int ntiles = (T + tf_max - 1) / tf_max;
  const int TF = (T + ntiles - 1) / ntiles;
  const size_t smem = smem_bytes<LOGM>(TF, hop, n_mels, nnz);
  if (smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      logmel_fwd_kernel<LOGM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ntiles, B);
  logmel_fwd_kernel<LOGM><<<grid, THREADS, smem, stream>>>(
      wave, win, tw, mel_idx, mel_w, out, S, hop, n_mels, nnz, T, TF);
  return (int)cudaGetLastError();
}

}  // namespace

// wave (B, S); win (n_fft); tw (n_fft, 2) = exp(-2 pi i k / n_fft);
// mel_idx (n_mels, 3) = first bin, count, offset into mel_w (nnz)
extern "C" int logmel_fwd(const float* wave, const float* win, const float* tw,
                          const int* mel_idx, const float* mel_w, float* out,
                          int B, int S, int n_fft, int hop, int n_mels,
                          int nnz, int T, void* stream) {
  if (n_fft < 64 || n_fft > 2048 || (n_fft & (n_fft - 1)) != 0 || hop < 1 ||
      n_fft % hop != 0 || n_mels < 1 || n_mels > MELMAX || nnz < 0 ||
      S <= n_fft / 2 || T != S / hop + 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_fft) {
    case 64:
      return launch<5>(wave, win, tw, mel_idx, mel_w, out, B, S, hop, n_mels,
                       nnz, T, s);
    case 128:
      return launch<6>(wave, win, tw, mel_idx, mel_w, out, B, S, hop, n_mels,
                       nnz, T, s);
    case 256:
      return launch<7>(wave, win, tw, mel_idx, mel_w, out, B, S, hop, n_mels,
                       nnz, T, s);
    case 512:
      return launch<8>(wave, win, tw, mel_idx, mel_w, out, B, S, hop, n_mels,
                       nnz, T, s);
    case 1024:
      return launch<9>(wave, win, tw, mel_idx, mel_w, out, B, S, hop, n_mels,
                       nnz, T, s);
    default:
      return launch<10>(wave, win, tw, mel_idx, mel_w, out, B, S, hop, n_mels,
                        nnz, T, s);
  }
}
