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
// What bounds it: at the flagship's train shape (B=25, H=4, T=145, d=64)
// the function reads q, k, v, o, do and the f32 bias and writes dq, dk, dv
// and dbias: 46.5 MB, 13.9 us at 3.35 TB/s. Its five products (q k^T,
// do v^T, P^T do, dS^T q, dS k) are 1.35 GFLOP, 8.2 us at 165 TFLOP/s (the
// tensor cores' fp32-accurate 3xTF32 rate; 20 us at the 67 TFLOP/s of the
// CUDA cores). So it is bound by bytes, and the bias and its gradient (8.4
// MB each) are the largest of them: the bias is read once, by the block
// that owns its keys, and dS is written once.
//
// Design (attn_bwd.cuh, shared with the banded backward): a dk/dv/dS kernel
// of 16-key warp slabs that walks 16-row query slabs, double-buffered by
// cp.async, then a dq kernel of 16-row warp slabs that reads dS back. The
// scores are recomputed on the CUDA cores with the forward's bits: a chain
// of fmaf over d in order, then __fmul_rn by sm_scale and __fadd_rn of the
// bias (the SASS holds an FMUL and an FADD there, no FFMA). Scores formed
// as 3xTF32 products would land ~2.6e-3 from the plain version at the
// flagship's first block (scores ~1800) and no longer match the forward's
// row statistics (PERF.md section 6). The other four products (do v^T,
// P^T do, dS^T q, dS k) run on the tensor cores as 3xTF32 (mma.sync
// m16n8k8), within 2e-5 of the plain version's gradients. dq from the
// stored dS and not from one block per (b, h) that holds all keys: that
// would be 100 blocks for 132 SMs at the train shape, while reading dS
// (8.4 MB, just written, from L2) costs a few microseconds.
//
// At T = 145 the slabs pad the keys and queries to 160 (10%, not the 75%
// of 64 x 64 tiles): 5 dk/dv blocks of 2 warps per (b, h), 500 in all,
// four resident per SM (48 KB of shared memory each, 168 registers a
// thread). What limits it now is latency, not bytes or the tensor cores:
// with few warps per SM, each slab's loads, barriers and chains of
// dependent mma and fmaf stay exposed (PERF.md section 6).

#include "attn_bwd.cuh"

// dk, dv and dS (into ds, (B, H, Tq, Tk) contiguous); launch before
// flash_attn_bwd_dq on the same stream. q, k and v with the given batch,
// head and time strides and d contiguous; o, dout and stats contiguous.
extern "C" int flash_attn_bwd_dkv(
    const float* q, const float* k, const float* v, const float* bias,
    const float* o, const float* dout, const float* stats, float* dk,
    float* dv, float* ds, int B, int H, int Tq, int Tk, int d, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, long long bsb, long long bsh,
    long long bsq, long long bsk, int causal, float sm_scale, void* stream) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.stats = stats;
  a.dk = dk;
  a.dv = dv;
  a.ds = ds;
  a.bias = bias;
  a.bsb = bsb;
  a.bsh = bsh;
  a.bsq = bsq;
  a.bsk = bsk;
  a.qs = Strides{qsb, qsh, qst};
  a.ks = Strides{ksb, ksh, kst};
  a.vs = Strides{vsb, vsh, vst};
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.d = d;
  a.causal = causal;
  a.sm_scale = sm_scale;
  return bwd_launch<false>(a, B, false, stream);
}

// dq = sm_scale * dS k from the ds that flash_attn_bwd_dkv wrote.
extern "C" int flash_attn_bwd_dq(const float* ds, const float* k, float* dq,
                                 int B, int H, int Tq, int Tk, int d,
                                 long long ksb, long long ksh, long long kst,
                                 float sm_scale, void* stream) {
  BwdArgs a{};
  a.k = k;
  a.dq = dq;
  a.ds = const_cast<float*>(ds);
  a.ks = Strides{ksb, ksh, kst};
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.d = d;
  a.sm_scale = sm_scale;
  return bwd_launch<false>(a, B, true, stream);
}
