// Banded (Longformer) attention forward in fp32, for Hopper (sm_90a): the
// scores in fp32 on the CUDA cores, P v on the tensor cores at fp32
// accuracy (3xTF32).
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
// What bounds it: at the long-form decode shape (B=4, H=4, T=3339, d=64,
// W=64, 2168-2228 valid frames) the function reads q, k, v and writes out,
// 54.7 MB (16.3 us at 3.35 TB/s); its two products are 4 d operations per
// allowed (i, j) pair, ~1.16 GFLOP (7.0 us at 165 TFLOP/s, the tensor cores'
// fp32-accurate 3xTF32 rate). So it is bound by bytes, as long as the work
// stays O(T * W) and padding costs nothing.
//
// Design: K1's (flash_attn.cu) on the band. One block of 1..4 warps per
// (b, h, query tile); each warp owns a slab of 16 query rows, the host
// picking the warps so that the tiles split T evenly. The keys are cut into
// 16-key units; a slab's allowed keys lie in the units within
// ceil(W / 16) units of its own (9 units, 144 keys, for the 129 keys of a
// band at W = 64). The block walks the units its slabs reach two at a time
// (32 keys a stage), double-buffered: while a stage is used, cp.async brings
// the next stage's K and V rows into shared memory (16 bytes a thread where
// d % 4 == 0). Each lane reads one valid byte of the stage's 32 keys and a
// ballot gives the stage's valid keys: a stage with no valid key is neither
// loaded nor used, and a warp skips a stage whose units its band misses.
// So the padded tail of a batch costs close to nothing. Per stage and warp:
// the 16 x 32 scores, each lane holding rows g, g + 8 and keys 2t, 2t + 1
// of each 8-key group (the mma accumulator layout), from float4 loads of
// the q and K rows padded to DP + 4 floats; then, one 16-key unit after the
// other, the online softmax over the unit's allowed keys (row max over the
// 4 lanes that share a row) and O += P v with mma.sync m16n8k8 as 3xTF32,
// P taken straight from the score registers (k slot t <- key 2t, slot
// t + 4 <- key 2t + 1, V's rows read in that order). q, k and v are read
// through their batch, head and time strides (the encoder's are views of
// its (B, T, H * d) projections), so nothing is copied before the kernel.
//
// The scores have the backward's bits (banded_attn_bwd.cu recomputes them
// from the row statistics this kernel writes): a chain of fmaf over d in
// order, then the product with sm_scale rounded alone (__fmul_rn, never
// contracted into an FFMA with the row max; tools/sass_check.py finds every
// read of sm_scale an FMUL). A key that is not allowed scores -inf; a row's
// max stays -inf until it meets an allowed key, and exp is taken against 0
// then, so no NaN arises, and a unit with no allowed key leaves the sums as
// they were, bit for bit. The rows' max m and log l of their sum are
// written for the backward (0 and -inf for a row with no allowed key). No
// atomics and a fixed order of every sum: two launches give the same bits.

#include <math.h>

#include <type_traits>

#include "attn_common.cuh"

namespace {

constexpr int KS = 32;         // keys per stage: two 16-key units
constexpr int MAXW = 4;        // warps per block at most
constexpr int DMAX = 128;      // largest head size taken

template <int DP>
__global__ void __launch_bounds__(MAXW * 32)
banded_attn_fwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const unsigned char* __restrict__ valid,
                       float* __restrict__ out, float* __restrict__ stats,
                       int H, int T, int d, int W, int nw16, Strides qs,
                       Strides ks, Strides vs, float sm_scale) {
  constexpr int SK = DP + 4;   // padded row of the Q, K and V tiles
  constexpr int KT = DP / 8;   // n tiles of P v
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);   // [2][KS][SK]
  float* sV = sK + 2 * KS * SK;                  // [2][KS][SK]
  float* sQ = sV + 2 * KS * SK;                  // [BM][SK]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nthr >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row, column
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int s0 = blockIdx.x * nw;         // the block's first query slab
  const int s = s0 + warp, r0 = 16 * s;   // this warp's
  const int nunits = (T + 15) >> 4;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const unsigned char* vrow = valid ? valid + (long long)b * T : nullptr;
  // the units [u_lo, u_hi) the block's slabs reach, two a stage
  const int u_lo = max(0, s0 - nw16);
  const int u_hi = min(nunits, s0 + nw + nw16);
  const int kend = min(T, 16 * u_hi);     // keys past it are never read
  const int nst = (u_hi - u_lo + 1) >> 1;

  // the padding columns d..DP-1 of K and V (both stages) and of Q:
  // cp.async never writes them
  const int dpad = DP - d;
  for (int i = tid; i < (4 * KS + 16 * nw) * dpad; i += nthr) {
    const int r = i / dpad;
    sK[r * SK + d + (i - r * dpad)] = 0.f;  // sK, sV, sQ in a row
  }

  // the stage's valid keys, one bit each (the same in every warp)
  auto valid_bits = [&](int j) {
    const int n = 16 * (u_lo + 2 * j) + lane;
    const bool ok = n < kend && (vrow == nullptr || vrow[n] != 0);
    return __ballot_sync(0xffffffffu, ok);
  };
  auto load_stage = [&](int j, int st) {
    const int n0 = 16 * (u_lo + 2 * j);
    load_rows<SK>(sK + st * KS * SK, kb + n0 * ks.t, ks.t, KS, kend - n0, d,
                  tid, nthr);
    load_rows<SK>(sV + st * KS * SK, vb + n0 * vs.t, vs.t, KS, kend - n0, d,
                  tid, nthr);
  };

  // the block's query rows, with the first stage
  load_rows<SK>(sQ, qb + 16 * s0 * qs.t, qs.t, 16 * nw, T - 16 * s0, d, tid,
                nthr);
  unsigned vcur = valid_bits(0);
  if (vcur != 0u) load_stage(0, 0);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[KT][4];
#pragma unroll
  for (int nt = 0; nt < KT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const bool active = r0 < T;

  for (int j = 0; j < nst; ++j) {
    const int st = j & 1;
    unsigned vnext = 0u;
    if (j + 1 < nst) {
      vnext = valid_bits(j + 1);
      if (vnext != 0u) load_stage(j + 1, st ^ 1);
    }
    cp_async_commit();  // possibly empty: stage j is then the older group
    cp_async_wait_1();
    __syncthreads();
    const int u0 = u_lo + 2 * j;
    // the units of the stage this warp's band reaches and that hold a
    // valid key
    unsigned units = 0u;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (u0 + i < u_hi && abs(u0 + i - s) <= nw16 &&
          ((vcur >> (16 * i)) & 0xffffu) != 0u)
        units |= 1u << i;
    if (active && units != 0u) {
      const float* cK = sK + st * KS * SK;
      const float* cV = sV + st * KS * SK;
      // s[nt][e]: row r0 + g + 8 (e >> 1), key 16 u0 + 8 nt + 2t + (e & 1);
      // each a chain of fmaf over d in order (the backward's rounding)
      float sc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      const float* qa = sQ + (warp * 16 + g) * SK;
#pragma unroll
      for (int kc = 0; kc < DP; kc += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qa + kc);
        const float4 a8 = *reinterpret_cast<const float4*>(qa + 8 * SK + kc);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float4 kv = *reinterpret_cast<const float4*>(
                cK + (nt * 8 + 2 * t + c) * SK + kc);
            float& x0 = sc[nt][c];
            float& x8 = sc[nt][2 + c];
            x0 = fmaf(a.x, kv.x, x0);
            x0 = fmaf(a.y, kv.y, x0);
            x0 = fmaf(a.z, kv.z, x0);
            x0 = fmaf(a.w, kv.w, x0);
            x8 = fmaf(a8.x, kv.x, x8);
            x8 = fmaf(a8.y, kv.y, x8);
            x8 = fmaf(a8.z, kv.z, x8);
            x8 = fmaf(a8.w, kv.w, x8);
          }
      }

      // one unit after the other: its allowed scores, the online softmax,
      // then O += P v
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!(units & (1u << i))) continue;
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 2 * i; nt < 2 * i + 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = nt * 8 + 2 * t + (e & 1);  // key in the stage
            const int r = r0 + g + 8 * (e >> 1);
            const bool ok = ((vcur >> kl) & 1u) && abs(r - 16 * u0 - kl) <= W;
            // rounded as the backward: the product alone
            const float val =
                ok ? __fmul_rn(sc[nt][e], sm_scale) : -INFINITY;
            sc[nt][e] = val;
            tmax[e >> 1] = fmaxf(tmax[e >> 1], val);
          }
        float alpha[2], ref[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
          const float mnew = fmaxf(m[r], tmax[r]);
          // no allowed key seen yet: every p and the old sums are 0 either
          // way
          ref[r] = mnew == -INFINITY ? 0.f : mnew;
          alpha[r] = expf(m[r] - ref[r]);
          m[r] = mnew;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int nt = 2 * i; nt < 2 * i + 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(sc[nt][e] - ref[e >> 1]);
            sc[nt][e] = p;
            l[e >> 1] += p;  // this lane's share; the 4 lanes sum at the end
          }
#pragma unroll
        for (int nt = 0; nt < KT; ++nt) {
          acc[nt][0] *= alpha[0];
          acc[nt][1] *= alpha[0];
          acc[nt][2] *= alpha[1];
          acc[nt][3] *= alpha[1];
        }
#pragma unroll
        for (int kq = 2 * i; kq < 2 * i + 2; ++kq) {
          uint32_t ah[4], al[4];
          split_tf32(sc[kq][0], ah[0], al[0]);
          split_tf32(sc[kq][2], ah[1], al[1]);
          split_tf32(sc[kq][1], ah[2], al[2]);
          split_tf32(sc[kq][3], ah[3], al[3]);
          const float* v0 = cV + (kq * 8 + 2 * t) * SK + g;
#pragma unroll
          for (int nt = 0; nt < KT; ++nt) {
            uint32_t bh2[2], bl2[2];
            split_tf32(v0[nt * 8], bh2[0], bl2[0]);
            split_tf32(v0[SK + nt * 8], bh2[1], bl2[1]);
            mma_3xtf32(acc[nt], ah, al, bh2, bl2);
          }
        }
      }
    }
    vcur = vnext;
    __syncthreads();  // stage st is refilled at the next iteration
  }

  if (!active) return;
  float* ob = out + (long long)bh * T * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + g + 8 * i;
    if (r >= T) continue;
    const bool any = l[i] > 0.f;
    const float inv = any ? 1.f / l[i] : 0.f;
    if (stats != nullptr && t == 0) {
      float* st = stats + ((long long)bh * T + r) * 2;
      st[0] = any ? m[i] : 0.f;
      st[1] = logf(l[i]);  // -inf for a row with no allowed key
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
int launch(const float* q, const float* k, const float* v,
           const unsigned char* valid, float* out, float* stats, int B, int H,
           int T, int d, int W, Strides qs, Strides ks, Strides vs,
           float sm_scale, cudaStream_t stream) {
  // 16-row slabs split evenly over the fewest tiles of at most MAXW warps
  const int n16 = (T + 15) / 16;
  const int nblk = (n16 + MAXW - 1) / MAXW;
  const int nw = (n16 + nblk - 1) / nblk;
  const size_t smem =
      sizeof(float) * (size_t)((4 * KS + 16 * nw) * (DP + 4));
  cudaError_t err = cudaFuncSetAttribute(
      banded_attn_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  banded_attn_fwd_kernel<DP><<<dim3(nblk, B * H), 32 * nw, smem, stream>>>(
      q, k, v, valid, out, stats, H, T, d, W, (W + 15) / 16, qs, ks, vs,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v (B, H, T, d) with the given batch, head and time strides and d
// contiguous; valid: (B, T) bytes, nonzero = a valid key, or null for all
// valid; out (B, H, T, d) and stats (B, H, T, 2) contiguous, stats null when
// no gradient is wanted.
extern "C" int banded_attn_fwd(const float* q, const float* k, const float* v,
                               const unsigned char* valid, float* out,
                               float* stats, int B, int H, int T, int d, int W,
                               long long qsb, long long qsh, long long qst,
                               long long ksb, long long ksh, long long kst,
                               long long vsb, long long vsh, long long vst,
                               float sm_scale, void* stream) {
  if (d < 1 || d > DMAX || T < 1 || W < 0 || B * H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (W > T) W = T;  // the band then holds every key
  const cudaStream_t s = (cudaStream_t)stream;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst};
  auto run = [&](auto dp) {
    return launch<decltype(dp)::value>(q, k, v, valid, out, stats, B, H, T, d,
                                       W, qs, ks, vs, sm_scale, s);
  };
  if (d <= 16) return run(std::integral_constant<int, 16>{});
  if (d <= 32) return run(std::integral_constant<int, 32>{});
  if (d <= 64) return run(std::integral_constant<int, 64>{});
  return run(std::integral_constant<int, 128>{});
}
