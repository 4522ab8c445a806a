"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; that
version is held here against the JAX function (the einsum path of
fused_attention, and fused_logmel in interpret mode). The CUDA kernels
themselves are held against the plain versions by tests/test_torch_gpu.py,
which needs a card; here are the host-side parts of the kernels: the
log-mel kernel's tables (window, twiddles, packed mel filterbank), its
eligibility rule, and the arithmetic of the attention kernels' 3xTF32
products, emulated in plain torch: the forward's at the decode shape, the
two backward kernels' (fp32 scores, the four other products as 3xTF32) at
the flagship's train shape and at a banded case; and the banded op on
the encoder's strided q, k, v views.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.ops.attention_kernels import fused_attention as jax_attention
from espnet_tpu.ops.mel import log_mel as jax_log_mel
from espnet_tpu.ops.mel import mel_filterbank as jax_mel_filterbank
from espnet_tpu.ops.pallas.logmel_kernel import fused_logmel as jax_logmel
from espnet_tpu.ops.stft import _windowed_dft_matrix as jax_dft
from espnet_tpu.ops.stft import stft as jax_stft
from espnet_tpu.ops.stft import stft_power as jax_stft_power
from espnet_tpu.ops.stft import stft_segmented as jax_stft_segmented
from espnet_tpu_torch.ops import attention, banded_attention
from espnet_tpu_torch.ops.attention import fused_attention
from espnet_tpu_torch.frontends.default import DefaultFrontend
from espnet_tpu_torch.ops.logmel import (fft_tables, fused_logmel,
                                         kernel_takes, n_frames, pack_mel)
from espnet_tpu_torch.ops.mel import mel_matrix
from espnet_tpu_torch.ops.mel import log_mel, mel_filterbank
from espnet_tpu_torch.ops.stft import (_windowed_dft_matrix, hann_window,
                                       stft, stft_segmented)

# fp32 throughout; the two frameworks sum in different orders, so outputs
# agree to a few ulps of their magnitude (attention outputs are O(1))
ATOL = 2e-5
# log-mel: the same, in the log domain of O(1..10) energies
LOGMEL_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attention_case(rng, B, H, Tq, Tk, d, bias_kind):
    q, k, v = (rng.randn(B, H, T, d).astype(np.float32)
               for T in (Tq, Tk, Tk))
    if bias_kind is None:
        return q, k, v, None
    bias = rng.randn(B, H, Tq, Tk).astype(np.float32)
    if bias_kind == "padding":
        lens = rng.randint(1, Tk + 1, size=B)
        pad = np.where(np.arange(Tk)[None] < lens[:, None], 0.0, -1e9)
        bias = (bias + pad[:, None, None, :]).astype(np.float32)
    elif bias_kind == "broadcast":
        bias = bias[:, :1, :1]
    return q, k, v, bias


@pytest.mark.parametrize("B,H,Tq,Tk,d,bias_kind,causal", [
    (2, 4, 37, 37, 16, "padding", False),
    (1, 2, 70, 70, 32, "full", False),
    (2, 2, 9, 9, 8, None, True),
    (2, 3, 5, 12, 16, "padding", True),
    (3, 1, 20, 20, 64, "broadcast", False),
])
def test_fused_attention_plain_matches_jax(B, H, Tq, Tk, d, bias_kind,
                                           causal, record_property):
    rng = np.random.RandomState(B * 100 + Tq)
    q, k, v, bias = _attention_case(rng, B, H, Tq, Tk, d, bias_kind)
    scale = 1.0 / np.sqrt(d)
    ref = jax_attention(*map(jnp.asarray, (q, k, v)),
                        None if bias is None else jnp.asarray(bias),
                        causal=causal, sm_scale=scale, force_xla=True)
    out = fused_attention(*map(torch.from_numpy, (q, k, v)),
                          None if bias is None else torch.from_numpy(bias),
                          causal=causal, sm_scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    record_property("max_abs_err", float(np.abs(out.numpy() - ref).max()))


@pytest.mark.parametrize("B,S,fs,n_fft,hop,n_mels", [
    (2, 20000, 16000, 512, 128, 80),
    (1, 3000, 8000, 128, 64, 20),
    (3, 1281, 16000, 512, 128, 80),
])
def test_fused_logmel_plain_matches_jax(B, S, fs, n_fft, hop, n_mels,
                                        record_property):
    x = np.random.RandomState(S).randn(B, S).astype(np.float32)
    out = fused_logmel(torch.from_numpy(x), fs=fs, n_fft=n_fft,
                       hop_length=hop, n_mels=n_mels).numpy()
    T = n_frames(S, n_fft, hop)
    assert out.shape == (B, T, n_mels)
    kernel = jax_logmel(jnp.asarray(x), fs=fs, n_fft=n_fft, hop_length=hop,
                        n_mels=n_mels, interpret=True)
    np.testing.assert_allclose(out, np.asarray(kernel)[:, :T],
                               atol=LOGMEL_ATOL)
    power, _ = jax_stft_power(jnp.asarray(x), None, n_fft=n_fft,
                              hop_length=hop)
    ref = jax_log_mel(power, fs=fs, n_fft=n_fft, n_mels=n_mels)
    np.testing.assert_allclose(out, np.asarray(ref), atol=LOGMEL_ATOL)
    record_property("max_abs_err", float(max(
        np.abs(out - np.asarray(kernel)[:, :T]).max(),
        np.abs(out - np.asarray(ref)).max())))


def test_dft_and_mel_matrices_equal_jax():
    for args in ((512, 512, "hann", False), (512, 400, "hann", True),
                 (128, 128, None, False)):
        np.testing.assert_array_equal(_windowed_dft_matrix(*args),
                                      jax_dft(*args))
    for args in ((16000, 512, 80), (8000, 128, 20, 20.0, 3000.0, True)):
        np.testing.assert_array_equal(mel_filterbank(*args),
                                      jax_mel_filterbank(*args))


def test_stft_and_log_mel_match_jax():
    x = np.random.RandomState(3).randn(2, 4000).astype(np.float32)
    lens = np.array([4000, 2500])
    re, im, olens = stft(torch.from_numpy(x), torch.from_numpy(lens),
                         n_fft=256, win_length=200, hop_length=64)
    jre, jim, jolens = jax_stft(jnp.asarray(x), jnp.asarray(lens), n_fft=256,
                                win_length=200, hop_length=64)
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=1e-4)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=1e-4)
    np.testing.assert_array_equal(olens.numpy(), np.asarray(jolens))
    sre, sim = stft_segmented(torch.from_numpy(x), n_fft=512, hop_length=128)
    jsre, jsim = jax_stft_segmented(jnp.asarray(x), n_fft=512,
                                    hop_length=128)
    np.testing.assert_allclose(sre.numpy(), np.asarray(jsre), atol=1e-4)
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), atol=1e-4)
    power = (sre * sre + sim * sim)
    out = log_mel(power, fmax=7000.0, log_base=10.0).numpy()
    ref = jax_log_mel(jnp.asarray(power.numpy()), fmax=7000.0,
                      log_base=10.0)
    np.testing.assert_allclose(out, np.asarray(ref), atol=LOGMEL_ATOL)


def test_wrappers_raise_on_devices_without_a_kernel():
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_attention(q, q, q)
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_logmel(torch.zeros(1, 4000, device="meta"))


@pytest.mark.parametrize("fs,n_fft,n_mels", [
    (16000, 512, 80), (8000, 128, 20), (16000, 1024, 80), (16000, 2048, 128),
    (16000, 64, 40),
])
def test_packed_mel_table_reproduces_the_filterbank(fs, n_fft, n_mels):
    idx, w = pack_mel(fs, n_fft, n_mels)
    dense = mel_matrix(fs, n_fft, n_mels, 0.0, None, False, "cpu").numpy()
    assert idx.dtype == np.int32 and w.dtype == np.float32
    assert idx[:, 2].tolist() == np.concatenate(
        [[0], np.cumsum(idx[:-1, 1])]).tolist()
    assert len(w) == idx[:, 1].sum() <= 2 * (n_fft // 2 + 1)
    unpacked = np.zeros_like(dense)
    for m, (first, count, offset) in enumerate(idx):
        unpacked[first:first + count, m] = w[offset:offset + count]
    np.testing.assert_array_equal(unpacked, dense)
    # the kernel's sums, over each filter's range only, give the dense
    # product up to fp32 summation order
    power = torch.from_numpy(np.random.RandomState(n_fft).rand(
        3, n_fft // 2 + 1).astype(np.float32))
    sparse = torch.stack([
        (torch.from_numpy(w[o:o + c]) * power[:, f:f + c]).sum(-1)
        for f, c, o in idx], dim=-1)
    torch.testing.assert_close(sparse, power @ torch.from_numpy(dense),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_fft", [64, 512, 2048])
def test_fft_tables_are_the_window_and_rounded_float64_twiddles(n_fft):
    win, tw = fft_tables(n_fft)
    np.testing.assert_array_equal(win, hann_window(n_fft))
    exact = np.exp(-2j * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft)
    assert tw.shape == (n_fft, 2) and tw.dtype == np.float32
    np.testing.assert_array_equal(tw[:, 0], exact.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], exact.imag.astype(np.float32))


def test_frontend_takes_the_kernel_only_where_the_fft_does():
    assert kernel_takes(512, 128, 80) and kernel_takes(64, 64, 128)
    assert kernel_takes(2048, 512, 80) and not kernel_takes(4096, 1024, 80)
    assert not kernel_takes(400, 100, 80) and not kernel_takes(512, 96, 80)
    assert not kernel_takes(512, 128, 129)
    assert DefaultFrontend()._fused_eligible()
    for kw in ({"n_fft": 400, "hop_length": 100}, {"n_fft": 384},
               {"n_fft": 4096}, {"n_mels": 160}):
        assert not DefaultFrontend(**kw)._fused_eligible(), kw


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the attention kernel forms it: a = ah + al, b = bh + bl in
    TF32, and lo*hi + hi*lo + hi*hi, each product exact in fp32 (11 x 11
    bits) and summed in fp32."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def test_3xtf32_products_keep_fp32_accuracy_at_the_decode_shape():
    # the flagship decode's attention: (B, H, T, d) = (64, 4, 145, 64); the
    # card's tolerance (1e-4 on outputs of O(1)) rests on this budget
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(64, 4, 145, 64).astype(np.float32))
               for _ in range(3))
    # the rounding: 11 significant bits, halves away from zero (1 + 2^-11
    # is a tie and goes up, -(1 + 2^-11) down)
    x = np.concatenate([rng.randn(1000) * 10.0 ** rng.randint(-4, 4, 1000),
                        [1 + 2.0 ** -11, -(1 + 2.0 ** -11), 3e-3]]
                       ).astype(np.float32)
    quantum = 2.0 ** (np.floor(np.log2(np.abs(x.astype(np.float64)))) - 10)
    want = np.sign(x) * np.floor(np.abs(x) / quantum + 0.5) * quantum
    np.testing.assert_array_equal(_tf32_rna(torch.from_numpy(x)).numpy(),
                                  want.astype(np.float32))

    def rel(a, ref):
        return float((a.double() - ref).abs().max() / ref.abs().max())

    s64 = q.double() @ k.double().transpose(-1, -2)
    s = _mm_3xtf32(q, k.transpose(-1, -2))
    assert rel(s, s64) < 1e-6
    p = torch.softmax(s64 / 8.0, dim=-1).float()
    o64 = p.double() @ v.double()
    assert rel(_mm_3xtf32(p, v), o64) < 1e-6
    # one TF32 product alone would not do
    assert rel(_tf32_rna(q) @ _tf32_rna(k).transpose(-1, -2), s64) > 1e-5


def _bwd_3xtf32(q, k, v, out, stats, dout, scores, sm_scale, zero=None):
    """The backward kernels' arithmetic (csrc/attn_bwd.cuh): P from the
    plain version's fp32 scores and the forward's row statistics, then
    do v^T, P^T do, dS^T q and dS k as 3xTF32 products; P and dS are 0
    where ``zero`` is True -> (dq, dk, dv, dS)."""
    p = torch.exp(scores - stats[..., :1] - stats[..., 1:])
    D = (dout * out).sum(dim=-1, keepdim=True)
    ds = p * (_mm_3xtf32(dout, v.transpose(-1, -2)) - D)
    if zero is not None:
        p, ds = p.masked_fill(zero, 0.0), ds.masked_fill(zero, 0.0)
    return (_mm_3xtf32(ds, k) * sm_scale,
            _mm_3xtf32(ds.transpose(-1, -2), q) * sm_scale,
            _mm_3xtf32(p.transpose(-1, -2), dout), ds)


def _relative(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_3xtf32_backward_keeps_the_gradients_within_2e_5():
    # the card's check of both backward kernels (2e-5 of each gradient's
    # largest entry against the plain versions) rests on this budget: the
    # flagship's train shape (25, 4, 145, 64) with a full bias plus padding,
    # and a banded case with ragged valid frames
    rng = np.random.RandomState(1)
    B, H, T, d = 25, 4, 145, 64
    q, k, v, dout = (torch.from_numpy(rng.randn(B, H, T, d).astype(
        np.float32)) for _ in range(4))
    lens = rng.randint(1, T + 1, size=B)
    pad = np.where(np.arange(T)[None] < lens[:, None], 0.0, -1e9)
    bias = torch.from_numpy((3.0 * rng.randn(B, H, T, T)
                             + pad[:, None, None, :]).astype(np.float32))
    scale = d ** -0.5
    out = attention.fused_attention_plain(q, k, v, bias, sm_scale=scale)
    stats = attention.softmax_stats_plain(q, k, bias, sm_scale=scale)
    plain = attention.fused_attention_bwd_plain(q, k, v, bias, out, stats,
                                                dout, sm_scale=scale)
    emulated = _bwd_3xtf32(q, k, v, out, stats, dout,
                           attention._scores(q, k, bias, False, scale), scale)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), emulated, plain):
        assert _relative(a, b) < 2e-5, name

    B, H, T, W = 2, 2, 600, 64
    q, k, v, dout = (torch.from_numpy(rng.randn(B, H, T, d).astype(
        np.float32)) for _ in range(4))
    valid = torch.from_numpy(np.arange(T)[None] < np.array([[600], [377]]))
    out = banded_attention.banded_attention_plain(q, k, v, W, valid,
                                                  sm_scale=scale)
    stats = banded_attention.banded_stats_plain(q, k, W, valid,
                                                sm_scale=scale)
    plain = banded_attention.banded_attention_bwd_plain(
        q, k, v, valid, out, stats, dout, window=W, sm_scale=scale)
    scores, allowed = banded_attention._scores(q, k, W, valid, scale)
    emulated = _bwd_3xtf32(q, k, v, out, stats, dout,
                           scores.masked_fill(~allowed, 0.0), scale,
                           zero=~allowed)
    for name, a, b in zip(("dq", "dk", "dv"), emulated, plain):
        assert _relative(a, b) < 2e-5, name


def _banded_fwd_3xtf32(q, k, v, W, valid, scale):
    """The banded forward kernel's arithmetic (csrc/banded_attn.cu) in
    plain torch: 16-row slabs over the 16-key units within ceil(W / 16)
    units of their own, one unit after the other in key order: the fp32
    scores with the product by ``scale`` rounded alone, -inf off the band
    and on invalid keys, the online softmax (against 0 while a row has
    met no allowed key), O += P v as 3xTF32 -> (out, stats (m, log l))."""
    B, H, T, d = q.shape
    n16, nw16 = -(-T // 16), -(-min(W, T) // 16)
    pad = 16 * n16 - T
    qs, ks, vs = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                  .view(B, H, n16, 16, d) for t in (q, k, v))
    key_ok = torch.nn.functional.pad(valid, (0, pad)).view(B, 1, n16, 1, 16)
    rows = torch.arange(16 * n16).view(n16, 16, 1)
    m = torch.full((B, H, n16, 16), float("-inf"))
    l = torch.zeros(B, H, n16, 16)
    acc = torch.zeros(B, H, n16, 16, d)
    for off in range(-nw16, nw16 + 1):
        u = torch.arange(n16) + off
        uc = u.clamp(0, n16 - 1)
        keys = (16 * uc).view(n16, 1, 1) + torch.arange(16)
        allowed = (((u >= 0) & (u < n16)).view(n16, 1, 1)
                   & ((rows - keys).abs() <= W) & key_ok[:, :, uc])
        s = (qs @ ks[:, :, uc].transpose(-1, -2)) * scale
        s = s.masked_fill(~allowed, float("-inf"))
        mnew = torch.maximum(m, s.amax(dim=-1))
        ref = torch.where(mnew == float("-inf"), 0.0, mnew)
        alpha = torch.exp(m - ref)
        p = torch.exp(s - ref[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _mm_3xtf32(p, vs[:, :, uc])
        m = mnew
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    out = (acc * inv[..., None]).view(B, H, 16 * n16, d)[:, :, :T]
    stats = torch.stack([torch.where(l > 0, m, 0.0), torch.log(l)], dim=-1)
    return out, stats.view(B, H, 16 * n16, 2)[:, :, :T]


def test_banded_forward_design_keeps_fp32_accuracy():
    # the card's check of the banded forward (1e-4 on outputs of O(1))
    # rests on this budget: ragged valid frames at T = 600, W = 64, rows
    # with no allowed key among them (0, and statistics (0, -inf))
    rng = np.random.RandomState(2)
    B, H, T, d, W = 2, 2, 600, 64, 64
    q, k, v = (torch.from_numpy(3.0 * rng.randn(B, H, T, d).astype(
        np.float32)) for _ in range(3))
    valid = torch.from_numpy(np.arange(T)[None] < np.array([[600], [377]]))
    scale = d ** -0.5
    out, stats = _banded_fwd_3xtf32(q, k, v, W, valid, scale)
    plain = banded_attention.banded_attention_plain(q, k, v, W, valid,
                                                    sm_scale=scale)
    want = banded_attention.banded_stats_plain(q, k, W, valid,
                                               sm_scale=scale)
    assert float((out - plain).abs().max()) < 2e-5
    empty = ~torch.isfinite(want[..., 1])
    assert int(empty.sum()) == H * (T - 377 - W)
    assert torch.equal(empty, ~torch.isfinite(stats[..., 1]))
    assert torch.equal(out[empty[..., None].expand_as(out)],
                       torch.zeros(int(empty.sum()) * d))
    torch.testing.assert_close(stats[~empty], want[~empty], atol=2e-5,
                               rtol=0)
    # P v as one TF32 product would not do
    pv1 = torch.softmax(banded_attention._scores(q, k, W, valid, scale)[0]
                        .masked_fill(~banded_attention.banded_allowed(
                            T, W, valid), -1e9), dim=-1)[:, :, :377]
    one = _tf32_rna(pv1) @ _tf32_rna(v)
    assert float((one - plain[:, :, :377]).abs().max()) > 1e-4


def test_banded_attention_takes_the_encoders_strided_views():
    # the Longformer encoder hands q, k, v over as (B, H, T, d) views of
    # its (B, T, H * d) projections; the op takes them as they are
    from espnet_tpu_torch.nn.attention import MultiHeadedAttention
    torch.manual_seed(0)
    attn = MultiHeadedAttention(4, 64).eval()
    x = torch.randn(2, 90, 64)
    valid = torch.arange(90)[None] < torch.tensor([[90], [41]])
    with torch.no_grad():
        q, k, v = attn.qkv(x, x, x)
        assert not q.is_contiguous() and q.stride(-1) == 1
        views = banded_attention.banded_attention(q, k, v, 8, valid,
                                                  sm_scale=0.25)
        copies = banded_attention.banded_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), 8, valid,
            sm_scale=0.25)
    torch.testing.assert_close(views, copies, atol=1e-6, rtol=0)
