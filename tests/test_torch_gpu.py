"""The port's CUDA kernels and its card path, on an NVIDIA card.

These tests import no JAX, so that they run where the port runs; there,
skip tests/conftest.py, which sets JAX up:

    python3 -m pytest tests/test_torch_gpu.py -q --noconftest

Each is marked ``gpu`` and skips, with its reason, where there is no card.
The kernels are held against their plain PyTorch versions on the same
inputs (fp32 sums in another order: 1e-4 for attention outputs of O(1),
1e-3 in the log domain for log-mel energies).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from espnet_tpu_torch.ops import _cuda
from espnet_tpu_torch.ops.attention import (fused_attention,
                                            fused_attention_plain)
from espnet_tpu_torch.ops.logmel import fused_logmel, fused_logmel_plain

ASSET = Path(__file__).resolve().parents[1] / "assets" / "synth_asr_flagship"


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Tq,Tk,d,causal", [
    (64, 4, 145, 145, 64, False),
    (2, 3, 7, 70, 40, True),
    (3, 2, 130, 129, 128, False),
    (1, 1, 65, 65, 16, True),
])
def test_flash_attn_kernel_matches_plain(B, H, Tq, Tk, d, causal):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, H, T, d, generator=g, device="cuda")
               for T in (Tq, Tk, Tk))
    lens = torch.randint(1, Tk + 1, (B,), generator=g, device="cuda")
    pad = torch.where(torch.arange(Tk, device="cuda")[None] < lens[:, None],
                      0.0, -1e9)
    bias = torch.randn(B, H, Tq, Tk, generator=g, device="cuda")
    for b in (bias + pad[:, None, None, :], bias[:, :1, :1], None):
        n0 = _cuda.LAUNCHES["flash_attn_fwd"]
        out = fused_attention(q, k, v, b, causal=causal, sm_scale=d ** -0.5)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["flash_attn_fwd"] == n0 + 1
        ref = fused_attention_plain(q, k, v, b, causal=causal,
                                    sm_scale=d ** -0.5)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,fs,n_fft,hop,n_mels", [
    (64, 74656, 16000, 512, 128, 80),
    (3, 1281, 16000, 512, 128, 80),
    (2, 3000, 8000, 128, 64, 20),
])
def test_logmel_kernel_matches_plain(B, S, fs, n_fft, hop, n_mels):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = 0.3 * torch.randn(B, S, generator=g, device="cuda")
    kw = dict(fs=fs, n_fft=n_fft, hop_length=hop, n_mels=n_mels)
    n0 = _cuda.LAUNCHES["logmel_fwd"]
    out = fused_logmel(x, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["logmel_fwd"] == n0 + 1
    torch.testing.assert_close(out, fused_logmel_plain(x, **kw), atol=1e-3,
                               rtol=0)


@pytest.mark.gpu
def test_speech2text_on_the_card_goes_through_both_kernels():
    _cuda_or_skip()
    from espnet_tpu_torch.bin.asr_inference import Speech2Text
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    utts = [SynthSpeechCorpus().utterance("test", i) for i in range(3)]
    speech = np.zeros((3, max(len(w) for w, _, _ in utts)), np.float32)
    for i, (w, _, _) in enumerate(utts):
        speech[i, :len(w)] = w
    lengths = [len(w) for w, _, _ in utts]
    kw = dict(asr_train_config=ASSET / "config.yaml", asr_model_file=ASSET,
              beam_size=10, ctc_weight=0.3)
    _cuda.reset_launch_counts()
    out = Speech2Text(**kw)(speech, lengths)
    assert _cuda.LAUNCHES == {"flash_attn_fwd": 6, "logmel_fwd": 1}
    ref = Speech2Text(device="cpu", **kw)(speech, lengths)
    assert [n[0][2] for n in out] == [n[0][2] for n in ref]
