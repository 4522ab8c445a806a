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
// What bounds it: at the long-form train shape (B=4, H=4, T=2189, d=64,
// W=64, 2148-2180 valid frames) it reads q, k, v, o, do and the row
// statistics and writes dq, dk and dv: 72.0 MB, 21.5 us at 3.35 TB/s. Its
// five products over the allowed (i, j) pairs are 2.83 GFLOP, 17.2 us at
// 165 TFLOP/s (3xTF32 on the tensor cores; 42.3 us at the CUDA cores' 67
// TFLOP/s). So it is bound by bytes, as long as the work stays O(T * W).
//
// Design (attn_bwd.cuh, shared with K1b): the dk/dv/dS kernel's warps own
// 16 keys each and visit only the 16-row query slabs within ceil(W / 16)
// slabs of their own, and the dq kernel's warps own 16 rows and visit only
// the 16-key chunks within as many chunks: at W = 64 a slab covers its band
// [r - 64, r + 15 + 64] with 9 units of 16 x 16, 144 keys for the 129
// allowed (1.12x the pairs, not the 1.49x of 64 x 64 tiles). The scores are
// recomputed with the forward's bits: a chain of fmaf over d in order, then
// __fmul_rn by sm_scale alone (banded_attn.cu rounds the product before
// taking the row max; the SASS holds an FMUL there, no FFMA with m). The
// other four products are 3xTF32 on the tensor cores (mma.sync m16n8k8).
// dq without atomics and without a second recompute: the dk/dv kernel
// writes each unit's dS into a scratch the wrapper allocates
// (banded_attn_bwd_scratch floats, 20 MB at the long-form shape), and the
// dq kernel reads it back, mostly from L2. Forming the scores again would
// cost ~0.65 GFLOP of fp32 FMA on the CUDA cores (~10 us at their peak)
// and do v^T again on the tensor cores. At T = 2189: 35 dk/dv blocks of 4
// warps per (b, h), 560 in all, three resident per SM (61 KB of shared
// memory, 162 registers), so 1.4 waves; each block walks 12 slabs, each
// warp works on 9 of them. What limits it now is latency (PERF.md
// section 6), as for K1b.

#include "attn_bwd.cuh"

namespace {

BwdArgs band_args(int H, int T, int d, int W, float sm_scale) {
  if (W > T) W = T;  // the band then holds every key
  BwdArgs a{};
  a.H = H;
  a.Tq = a.Tk = T;
  a.d = d;
  a.W = W;
  a.nw16 = (W + 15) / 16;
  a.sm_scale = sm_scale;
  return a;
}

}  // namespace

// dk, dv and the band's dS (into ds, the scratch above); launch before
// banded_attn_bwd_dq on the same stream. valid: (B, T) bytes, nonzero = a
// valid key, or null; q, k and v with the given batch, head and time
// strides and d contiguous; o, dout and stats contiguous.
extern "C" int banded_attn_bwd_dkv(
    const float* q, const float* k, const float* v, const unsigned char* valid,
    const float* o, const float* dout, const float* stats, float* dk,
    float* dv, float* ds, int B, int H, int T, int d, int W, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, float sm_scale,
    void* stream) {
  if (W < 0) return (int)cudaErrorInvalidValue;
  BwdArgs a = band_args(H, T, d, W, sm_scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.valid = valid;
  a.o = o;
  a.dout = dout;
  a.stats = stats;
  a.dk = dk;
  a.dv = dv;
  a.ds = ds;
  a.qs = Strides{qsb, qsh, qst};
  a.ks = Strides{ksb, ksh, kst};
  a.vs = Strides{vsb, vsh, vst};
  return bwd_launch<true>(a, B, false, stream);
}

// Floats of the scratch that banded_attn_bwd_dkv writes the band's dS into:
// for each (b, h) and 16-row query slab, 16 rows of 16 (2 ceil(W / 16) + 1).
extern "C" long long banded_attn_bwd_scratch(int B, int H, int T, int W) {
  const BwdArgs a = band_args(H, T, 1, W < 0 ? 0 : W, 1.f);
  return (long long)B * H * 16 * ((T + 15) / 16) * 16 * (2 * a.nw16 + 1);
}

// dq = sm_scale * dS k from the scratch that banded_attn_bwd_dkv wrote.
extern "C" int banded_attn_bwd_dq(const float* ds, const float* k, float* dq,
                                  int B, int H, int T, int d, int W,
                                  long long ksb, long long ksh, long long kst,
                                  float sm_scale, void* stream) {
  if (W < 0) return (int)cudaErrorInvalidValue;
  BwdArgs a = band_args(H, T, d, W, sm_scale);
  a.k = k;
  a.dq = dq;
  a.ds = const_cast<float*>(ds);
  a.ks = Strides{ksb, ksh, kst};
  return bwd_launch<true>(a, B, true, stream);
}
