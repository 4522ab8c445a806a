"""The port's CUDA kernels and its card path, on an NVIDIA card.

These tests import no JAX, so that they run where the port runs; there,
skip tests/conftest.py, which sets JAX up:

    python3 -m pytest tests/test_torch_gpu.py -q --noconftest

Each is marked ``gpu`` and skips, with its reason, where there is no card.
The kernels are held against their plain PyTorch versions on the same
inputs (fp32 sums in another order, the attention forward's products as
3xTF32 on the tensor cores: 1e-4 for attention outputs of O(1) and for
its row statistics, 1e-3 in the log domain for log-mel energies, and
2e-5 of each gradient's own scale for the attention backward, whose sums
run over at most Tq or Tk terms; the banded attention's the same, its
sums running over at most 2W + 1 keys). The attention forwards and
backwards and the log-mel give the same bits when launched twice on the
same input, and the attention kernels the same bits on q, k, v given as
strided views. The RNN-T sweeps take the same fp32
steps as their plain versions: nll, alpha and beta equal theirs to the
bit, and the closed-form gradient is within 1e-5 of its largest entry.
The GAN mel loss through the log-mel kernel is within 1e-4 of the plain
version's, and VITS and vocoder training repeat themselves bit for bit.
The ECAPA speaker embedding on the card is within 1e-4 of the CPU's, the
keyword classifier through the log-mel kernel within 1e-4 of its plain
frontend, and speaker and classification training repeat themselves bit
for bit. The Conformer separator (the attention kernels at head size 32)
and TF-GridNet separate within 1e-4 of the CPU, and one backward of each
on the card is within 1e-3 of the CPU's gradients (the ReLU and PReLU
sides and the attention's inputs pinned, as chip_smoke's grad check
pins them).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from espnet_tpu_torch import convert
from espnet_tpu_torch.ops import _cuda
from espnet_tpu_torch.ops.attention import (fused_attention,
                                            fused_attention_plain)
from espnet_tpu_torch.ops.logmel import fused_logmel, fused_logmel_plain

ASSET = Path(__file__).resolve().parents[1] / "assets" / "synth_asr_flagship"
TRANSDUCER = (Path(__file__).resolve().parents[1] / "assets"
              / "synth_asr_transducer")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


def _relpos_bias(B, H, T, d, g):
    """A conformer block's rel-pos + padding bias: the rel-shifted
    (q + pos_bias_v) p^T * scale of RelPositionMultiHeadedAttention, with
    random weights on a random input, plus -1e9 past each row's length."""
    from espnet_tpu_torch.nn.attention import RelPositionMultiHeadedAttention
    from espnet_tpu_torch.nn.embedding import RelPositionalEncoding
    attn = RelPositionMultiHeadedAttention(H, H * d).cuda()
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g, device="cuda"))
        x = torch.randn(B, T, H * d, generator=g, device="cuda")
        _, pos = RelPositionalEncoding(H * d).cuda().eval()(x)
        lens = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
        mask = torch.arange(T, device="cuda")[None] < lens[:, None]
        return attn.kernel_inputs(x, x, x, pos, mask[:, None])[3]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Tq,Tk,d,causal", [
    (64, 4, 145, 145, 64, False),
    (2, 3, 7, 70, 40, True),
    (3, 2, 130, 129, 128, False),
    (1, 1, 65, 65, 16, True),
    (25, 4, 145, 145, 64, False),
    (5, 4, 17, 145, 64, False),
    (2, 3, 33, 47, 20, False),
    (2, 3, 70, 7, 40, True),
    (10, 4, 501, 501, 32, False),
])
def test_flash_attn_kernel_matches_plain(B, H, Tq, Tk, d, causal):
    _cuda_or_skip()
    from espnet_tpu_torch.ops.attention import _launch_fwd, softmax_stats_plain
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(B, H, T, d, generator=g, device="cuda")
               for T in (Tq, Tk, Tk))
    lens = torch.randint(1, Tk + 1, (B,), generator=g, device="cuda")
    pad = torch.where(torch.arange(Tk, device="cuda")[None] < lens[:, None],
                      0.0, -1e9)
    bias = torch.randn(B, H, Tq, Tk, generator=g, device="cuda")
    # rows whose every key is masked: the kernel gives them 1/Tk each
    masked = bias + pad[:, None, None, :]
    masked[:, :, ::5] = -1e9
    biases = [bias + pad[:, None, None, :], bias[:, :1, :1], None, masked]
    if Tq == Tk and d == 64:
        biases.append(_relpos_bias(B, H, Tq, d, g))
    for b in biases:
        n0 = _cuda.LAUNCHES["flash_attn_fwd"]
        out = fused_attention(q, k, v, b, causal=causal, sm_scale=d ** -0.5)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["flash_attn_fwd"] == n0 + 1
        ref = fused_attention_plain(q, k, v, b, causal=causal,
                                    sm_scale=d ** -0.5)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
        # two launches give the same bits, the row statistics too
        runs = [_launch_fwd(q, k, v, b, causal, d ** -0.5, True)
                for _ in range(2)]
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])
        # q, k, v as views of (B, T, H, d) projections: read through their
        # strides, the same bits
        views = [t.transpose(1, 2).contiguous().transpose(1, 2)
                 for t in (q, k, v)]
        assert torch.equal(
            _launch_fwd(*views, b, causal, d ** -0.5, True)[0], runs[0][0])
        torch.testing.assert_close(
            runs[0][1], softmax_stats_plain(q, k, b, causal=causal,
                                            sm_scale=d ** -0.5),
            atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,fs,n_fft,hop,n_mels", [
    (64, 74656, 16000, 512, 128, 80),
    (3, 1281, 16000, 512, 128, 80),
    (2, 3000, 8000, 128, 64, 20),
    (4, 1_100_000, 16000, 512, 128, 80),
    (2, 20000, 16000, 1024, 256, 80),
    (2, 257, 16000, 512, 128, 80),
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
    assert torch.equal(out, fused_logmel(x, **kw))


@pytest.mark.gpu
def test_logmel_kernel_refuses_a_shape_it_does_not_take():
    _cuda_or_skip()
    x = torch.randn(2, 4000, device="cuda")
    for kw in ({"n_fft": 384, "hop_length": 128}, {"n_fft": 4096,
                                                   "hop_length": 1024},
               {"n_fft": 512, "hop_length": 96}, {"n_mels": 129}):
        n0 = _cuda.LAUNCHES["logmel_fwd"]
        with pytest.raises(ValueError, match="power-of-two n_fft"):
            fused_logmel(x, **kw)
        assert _cuda.LAUNCHES["logmel_fwd"] == n0


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
    assert _cuda.LAUNCHES == {"flash_attn_fwd": 6, "flash_attn_bwd": 0,
                              "logmel_fwd": 1, "rnnt_alpha": 0,
                              "rnnt_beta": 0, "banded_attn_fwd": 0,
                              "banded_attn_bwd": 0}
    ref = Speech2Text(device="cpu", **kw)(speech, lengths)
    assert [n[0][2] for n in out] == [n[0][2] for n in ref]


def _relative_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _strided(*ts):
    """q, k, v as the attention modules hand them over: (B, H, T, d) views
    of (B, T, H, d) projections."""
    return [t.transpose(1, 2).contiguous().transpose(1, 2) for t in ts]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Tq,Tk,d,causal,bias_kind", [
    (25, 4, 145, 145, 64, False, "full"),
    (25, 4, 145, 145, 64, False, "padding"),
    (25, 4, 145, 145, 64, False, "relpos"),
    (2, 3, 7, 70, 40, True, "full"),
    (2, 3, 70, 7, 40, True, "full"),
    (3, 2, 130, 129, 128, False, None),
    (8, 4, 501, 501, 32, False, "relpos"),
])
def test_flash_attn_backward_kernel_matches_plain(B, H, Tq, Tk, d, causal,
                                                  bias_kind):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(B, H, T, d, generator=g, device="cuda")
               for T in (Tq, Tk, Tk))
    lens = torch.randint(1, Tk + 1, (B,), generator=g, device="cuda")
    pad = torch.where(torch.arange(Tk, device="cuda")[None] < lens[:, None],
                      0.0, -1e9)[:, None, None, :]
    bias = {"full": lambda: torch.randn(B, H, Tq, Tk, generator=g,
                                        device="cuda") + pad,
            "padding": lambda: pad.clone(),
            "relpos": lambda: _relpos_bias(B, H, Tq, d, g),
            None: lambda: None}[bias_kind]()
    ins = [t for t in (q, k, v, bias) if t is not None]
    for t in ins:
        t.requires_grad_(True)
    dout = torch.randn(B, H, Tq, d, generator=g, device="cuda")
    n0 = dict(_cuda.LAUNCHES)
    out = fused_attention(q, k, v, bias, causal=causal, sm_scale=d ** -0.5)
    grads = torch.autograd.grad(out, ins, dout)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attn_fwd"] == n0["flash_attn_fwd"] + 1
    assert _cuda.LAUNCHES["flash_attn_bwd"] == n0["flash_attn_bwd"] + 2
    ref = torch.autograd.grad(
        fused_attention_plain(q, k, v, bias, causal=causal,
                              sm_scale=d ** -0.5), ins, dout)
    for a, b in zip(grads, ref):
        assert a.shape == b.shape
        assert _relative_err(a, b) < 2e-5
    # the backward's wrapper launched twice, and on strided q, k, v: the
    # same bits
    from espnet_tpu_torch.ops.attention import _launch_fwd, fused_attention_bwd
    with torch.no_grad():
        out, stats = _launch_fwd(q, k, v, bias, causal, d ** -0.5, True)
        runs = [fused_attention_bwd(*qkv, bias, out, stats, dout,
                                    causal=causal, sm_scale=d ** -0.5)
                for qkv in ((q, k, v), (q, k, v), _strided(q, k, v))]
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


@pytest.mark.gpu
def test_attention_gradient_on_the_card_reaches_every_projection():
    # the forward kernel's output once had no grad_fn: the projections of
    # q, k, v and the position terms got no gradient through attention
    _cuda_or_skip()
    from espnet_tpu_torch.nn.attention import RelPositionMultiHeadedAttention
    from espnet_tpu_torch.nn.embedding import RelPositionalEncoding
    torch.manual_seed(0)
    cpu = RelPositionMultiHeadedAttention(4, 64)
    with torch.no_grad():
        for p in cpu.parameters():
            p.normal_(0.0, 0.2)
    card = RelPositionMultiHeadedAttention(4, 64).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 37, 64)
    _, pos = RelPositionalEncoding(64).eval()(x)
    mask = (torch.arange(37)[None] < torch.tensor([37, 20, 9])[:, None])
    outs = {}
    for name, mod, dev in (("cpu", cpu, "cpu"), ("card", card, "cuda")):
        out = mod(*[x.to(dev)] * 3, pos.to(dev), mask[:, None].to(dev))
        (out * torch.linspace(-1, 1, 64, device=dev)).sum().backward()
        outs[name] = {n: p.grad.cpu() for n, p in mod.named_parameters()}
    for n in ("linear_q.weight", "linear_k.weight", "linear_v.weight",
              "linear_pos.weight", "pos_bias_u", "pos_bias_v"):
        assert float(outs["card"][n].abs().max()) > 0, n
        assert _relative_err(outs["card"][n], outs["cpu"][n]) < 1e-4, n


@pytest.mark.gpu
def test_logmel_kernel_refuses_a_wave_that_needs_a_gradient():
    # the kernel takes such a wave: it launches (one count) and its
    # backward is the plain version's, recomputed from the wave, so the
    # gradient equals the plain version's on the card; under no_grad it
    # records no graph
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(0)
    wave = 0.1 * torch.randn(2, 4000, generator=g, device="cuda")
    weight = torch.randn(2, 32, 80, generator=g, device="cuda")
    grads = {}
    for name, fn in (("kernel", fused_logmel), ("plain", fused_logmel_plain)):
        x = wave.clone().requires_grad_()
        _cuda.reset_launch_counts()
        (fn(x) * weight).sum().backward()
        assert _cuda.LAUNCHES["logmel_fwd"] == (name == "kernel")
        grads[name] = x.grad
    torch.testing.assert_close(grads["kernel"], grads["plain"], rtol=0,
                               atol=0)
    with torch.no_grad():
        assert fused_logmel(wave.requires_grad_()).grad_fn is None


@pytest.mark.gpu
def test_two_train_steps_of_the_entry_point_on_the_card(tmp_path):
    _cuda_or_skip()
    from espnet_tpu_torch.bin import asr_train
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.utils.config import dump_yaml
    SynthSpeechCorpus().materialize(tmp_path / "data", n_train=6, n_valid=3,
                                    n_test=0)
    data = {split: [f"{tmp_path}/data/{split}/wav.scp,speech,sound",
                    f"{tmp_path}/data/{split}/text,text,text"]
            for split in ("train", "valid")}
    cfg = {
        "output_dir": str(tmp_path / "exp"), "max_epoch": 1,
        "num_iters_per_epoch": 2, "batch_type": "sorted", "batch_size": 3,
        "optim": "adam", "optim_conf": {"lr": 0.002},
        "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 600},
        "train_data_path_and_name_and_type": data["train"],
        "valid_data_path_and_name_and_type": data["valid"],
        "token_list": str(ASSET / "tokens.txt"), "normalize": "global_mvn",
        "stats_file": str(ASSET / "feats_stats.npz"), "specaug": "specaug",
        "encoder": "conformer",
        "encoder_conf": {"output_size": 64, "attention_heads": 4,
                         "linear_units": 128, "num_blocks": 2,
                         "cnn_module_kernel": 7},
        "decoder": "transformer",
        "decoder_conf": {"attention_heads": 4, "linear_units": 128,
                         "num_blocks": 1},
        "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1}}
    dump_yaml(cfg, tmp_path / "train.yaml")
    _cuda.reset_launch_counts()
    _, trainer = asr_train.main(["--config", str(tmp_path / "train.yaml")])
    assert next(trainer.model.parameters()).device.type == "cuda"
    assert len(trainer.step_stats) == 2
    for stats in trainer.step_stats:
        assert np.isfinite(stats["loss"]) and stats["skipped"] == 0.0
    # 2 steps x 2 blocks forward + 1 validation batch x 2 blocks
    assert _cuda.LAUNCHES == {"flash_attn_fwd": 6, "flash_attn_bwd": 8,
                              "logmel_fwd": 3, "rnnt_alpha": 0,
                              "rnnt_beta": 0, "banded_attn_fwd": 0,
                              "banded_attn_bwd": 0}
    flat = convert.state_dict_to_flax(trainer.model)
    assert all(np.isfinite(v).all() for v in flat.values())
    assert (tmp_path / "exp" / "checkpoint" / "params.pkl").exists()


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,U1,V,tl,ul", [
    (25, 145, 65, 25, None, None),              # the train shape
    (3, 7, 5, 6, [7, 1, 4], [0, 4, 2]),
    (3, 9, 1, 4, [9, 0, 5], [0, 0, 0]),         # U+1 = 1: a cell a row
    (2, 11, 300, 5, [11, 6], [299, 140]),       # two warps of 8 cells
    (2, 40, 1100, 5, [40, 33], [1099, 700]),
    (1, 3, 9000, 3, [3], [8999]),               # 16 cells a lane
    (1, 2, 17000, 3, [2], [16999]),             # 32 cells a lane
])
def test_rnnt_sweeps_match_plain(B, T, U1, V, tl, ul):
    _cuda_or_skip()
    from espnet_tpu_torch.ops import rnnt
    g = torch.Generator(device="cuda").manual_seed(3)
    logits = torch.randn(B, T, U1, V, generator=g, device="cuda")
    labels = torch.randint(1, V, (B, U1 - 1), generator=g, device="cuda")
    tl = (torch.randint(1, T + 1, (B,), generator=g, device="cuda")
          if tl is None else torch.tensor(tl, device="cuda"))
    ul = (torch.randint(0, U1, (B,), generator=g, device="cuda")
          if ul is None else torch.tensor(ul, device="cuda"))
    lat = rnnt.lattices(logits, labels, tl, ul)
    n0 = dict(_cuda.LAUNCHES)
    alpha, nll = rnnt.rnnt_alpha(*lat, tl, ul)
    beta = rnnt.rnnt_beta(*lat, tl, ul)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["rnnt_alpha"] == n0["rnnt_alpha"] + 1
    assert _cuda.LAUNCHES["rnnt_beta"] == n0["rnnt_beta"] + 1
    alpha0, nll0 = rnnt.rnnt_alpha_plain(*lat, tl, ul)
    beta0 = rnnt.rnnt_beta_plain(*lat, tl, ul)
    # every path of the kernel (one warp an utterance; a block of warps
    # that hand the boundary cell over in shared memory) takes each cell's
    # two terms in the plain sweeps' order: the same bits, padding too,
    # and the same bits on a second launch
    for a, b in ((alpha, alpha0), (nll, nll0), (beta, beta0)):
        assert torch.equal(a, b), float((a - b).abs().max())
    again = (*rnnt.rnnt_alpha(*lat, tl, ul), rnnt.rnnt_beta(*lat, tl, ul))
    assert all(torch.equal(a, b) for a, b in zip(again, (alpha, nll, beta)))
    # the loss's gradient: the kernels' sweeps through the closed form,
    # against the plain sweeps through the same closed form
    x = logits.clone().requires_grad_()
    (grad,) = torch.autograd.grad(
        rnnt.rnnt_loss(x, labels, tl, ul, reduction="sum"), (x,))
    ref = rnnt.rnnt_grad(logits, labels, *lat, alpha0, beta0, nll0, tl, ul)
    assert _relative_err(grad, ref) < 1e-5


def _held_out(n):
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    utts = [SynthSpeechCorpus().utterance("test", i) for i in range(n)]
    speech = np.zeros((n, 74656), np.float32)
    for i, (w, _, _) in enumerate(utts):
        speech[i, :len(w)] = w
    return speech, [len(w) for w, _, _ in utts], [t for _, t, _ in utts]


@pytest.mark.gpu
def test_transducer_decode_on_the_card_goes_through_the_logmel_kernel():
    _cuda_or_skip()
    from espnet_tpu_torch.bin.asr_transducer_inference import \
        Speech2TextTransducer
    speech, lengths, refs = _held_out(3)
    kw = dict(train_config=TRANSDUCER / "config.yaml",
              model_file=TRANSDUCER, beam_size=5)
    _cuda.reset_launch_counts()
    out = Speech2TextTransducer(**kw)(speech, lengths)
    assert _cuda.LAUNCHES == {"flash_attn_fwd": 0, "flash_attn_bwd": 0,
                              "logmel_fwd": 1, "rnnt_alpha": 0,
                              "rnnt_beta": 0, "banded_attn_fwd": 0,
                              "banded_attn_bwd": 0}
    ref = Speech2TextTransducer(device="cpu", **kw)(speech, lengths)
    assert [n[0][2] for n in out] == [n[0][2] for n in ref]
    assert [n[0][0] for n in out] == refs


@pytest.mark.gpu
def test_transducer_train_step_launches_each_sweep_once():
    _cuda_or_skip()
    from espnet_tpu_torch.data.preprocessor import CommonPreprocessor
    from espnet_tpu_torch.tasks.asr_transducer import ASRTransducerTask
    model, _ = ASRTransducerTask.build_model_from_file(
        TRANSDUCER / "config.yaml", TRANSDUCER, "cuda")
    speech, lengths, refs = _held_out(4)
    pre = CommonPreprocessor("char", list(model.token_list))
    ids = [pre("u", {"text": t})["text"] for t in refs]
    text = np.zeros((4, 64), np.int64)
    for i, x in enumerate(ids):
        text[i, :len(x)] = x
    batch = {"speech": torch.from_numpy(speech).cuda(),
             "speech_lengths": torch.tensor(lengths).cuda(),
             "text": torch.from_numpy(text).cuda(),
             "text_lengths": torch.tensor([len(x) for x in ids]).cuda()}
    model.train()
    _cuda.reset_launch_counts()
    loss, stats, _ = model(**batch)
    loss.backward()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == {"flash_attn_fwd": 0, "flash_attn_bwd": 0,
                              "logmel_fwd": 1, "rnnt_alpha": 1,
                              "rnnt_beta": 1, "banded_attn_fwd": 0,
                              "banded_attn_bwd": 0}
    assert all(torch.isfinite(v) for v in stats.values())
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    with torch.no_grad():   # validation: the forward sweep alone
        model.eval()(**batch)
    assert _cuda.LAUNCHES["rnnt_alpha"] == 2
    assert _cuda.LAUNCHES["rnnt_beta"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("task_name", ["asr", "asr_transducer"])
def test_training_on_the_card_repeats_itself_bit_for_bit(tmp_path,
                                                         task_name):
    # two runs from one seed, and one stopped after its first epoch and
    # resumed, end with the same parameters: dropout, SpecAug, the CTC
    # gradient and the cuDNN convolutions' backward all repeat
    _cuda_or_skip()
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.tasks.asr import ASRTask
    from espnet_tpu_torch.tasks.asr_transducer import ASRTransducerTask
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    SynthSpeechCorpus().materialize(tmp_path / "data", n_train=6, n_valid=0,
                                    n_test=0)
    if task_name == "asr":
        task, model_cfg = ASRTask, {
            "encoder": "conformer",
            "encoder_conf": {"output_size": 64, "attention_heads": 4,
                             "linear_units": 128, "num_blocks": 2,
                             "cnn_module_kernel": 7},
            "decoder": "transformer",
            "decoder_conf": {"attention_heads": 4, "linear_units": 128,
                             "num_blocks": 1},
            "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1}}
    else:
        task, model_cfg = ASRTransducerTask, {
            "encoder": "streaming_conformer",
            "encoder_conf": {"output_size": 64, "attention_heads": 4,
                             "linear_units": 128, "num_blocks": 2,
                             "chunk_size": 4, "left_chunks": 2,
                             "cnn_kernel": 5},
            "decoder": "rnn", "decoder_conf": {"hidden_size": 64},
            "joint_conf": {"joint_space_size": 64},
            "model_conf": {"aux_ctc_weight": 0.3}}

    def train(name, max_epoch, resume=False):
        cfg = {
            "output_dir": str(tmp_path / name), "seed": 3,
            "max_epoch": max_epoch, "num_iters_per_epoch": 1,
            "batch_type": "sorted", "batch_size": 3, "resume": resume,
            "optim": "adam", "optim_conf": {"lr": 0.002},
            "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 10},
            "train_data_path_and_name_and_type": [
                f"{tmp_path}/data/train/wav.scp,speech,sound",
                f"{tmp_path}/data/train/text,text,text"],
            "token_list": str(ASSET / "tokens.txt"),
            "normalize": "global_mvn",
            "stats_file": str(ASSET / "feats_stats.npz"),
            "specaug": "specaug",
            "specaug_conf": {"num_freq_mask": 2,
                             "freq_mask_width_range": [0, 10],
                             "num_time_mask": 2,
                             "time_mask_width_range": [0, 20]},
            **model_cfg}
        task.main(cfg)
        return load_checkpoint(tmp_path / name / "checkpoint")[0]

    ref = train("a", 3)
    train("resumed", 2)
    for other in (train("b", 3), train("resumed", 3, resume=True)):
        assert sorted(other) == sorted(ref)
        for name in ref:
            np.testing.assert_array_equal(other[name], ref[name],
                                          err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,d,W,lens", [
    (4, 4, 2200, 64, 64, (2200, 2131, 1900, 1500)),   # the long-form shape
    (2, 3, 70, 40, 3, (70, 20)),     # T % 64 != 0, padded tail 50 > W
    (2, 2, 50, 16, 100, (50, 7)),    # W >= T
    (1, 2, 130, 128, 0, (100,)),     # W = 0
])
def test_banded_attn_kernels_match_plain(B, H, T, d, W, lens):
    _cuda_or_skip()
    from espnet_tpu_torch.ops.banded_attention import (
        banded_attention, banded_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, dout = (torch.randn(B, H, T, d, generator=g, device="cuda")
                     for _ in range(4))
    valid = (torch.arange(T, device="cuda")[None]
             < torch.tensor(lens, device="cuda")[:, None])
    kw = dict(sm_scale=d ** -0.5)
    n0 = dict(_cuda.LAUNCHES)
    with torch.no_grad():
        out = banded_attention(q, k, v, W, valid, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["banded_attn_fwd"] == n0["banded_attn_fwd"] + 1
    # every row, those with no allowed key (0 in both) too
    torch.testing.assert_close(
        out, banded_attention_plain(q, k, v, W, valid, **kw), atol=1e-4,
        rtol=0)
    # the forward launched again, and on strided q, k, v: the same bits,
    # its row statistics too; those are the plain version's within 1e-4
    # where a row has an allowed key, and (0, -inf) where it has none
    from espnet_tpu_torch.ops.banded_attention import (_launch_fwd,
                                                       banded_stats_plain)
    with torch.no_grad():
        fwd_runs = [_launch_fwd(*qkv, valid, W, d ** -0.5, True)
                    for qkv in ((q, k, v), (q, k, v), _strided(q, k, v))]
        assert torch.equal(fwd_runs[0][0], out)
        for run in fwd_runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(run, fwd_runs[0]))
        stats = fwd_runs[0][1]
        want = banded_stats_plain(q, k, W, valid, **kw)
        finite = torch.isfinite(want[..., 1])
        assert torch.equal(finite, torch.isfinite(stats[..., 1]))
        torch.testing.assert_close(stats[finite], want[finite], atol=1e-4,
                                   rtol=0)
        assert torch.equal(stats[..., 0][~finite],
                           torch.zeros_like(stats[..., 0][~finite]))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    kern = torch.autograd.grad(banded_attention(*ins, W, valid, **kw), ins,
                               dout)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["banded_attn_bwd"] == n0["banded_attn_bwd"] + 2
    plain = torch.autograd.grad(banded_attention_plain(*ins, W, valid, **kw),
                                ins, dout)
    # each gradient against its own largest entry; at W = 0 dq and dk are
    # zero in exact arithmetic (a row attends itself alone) and only
    # rounding of do.v - D remains: against the largest gradient then
    top = max(float(b.abs().max()) for b in plain)
    for a, b in zip(kern, plain):
        own = float(b.abs().max())
        scale = own if own >= 1e-3 * top else top
        assert float((a - b).abs().max()) <= 2e-5 * scale
    # the backward's wrapper launched twice, and on strided q, k, v, with
    # the forward's statistics: the same bits
    from espnet_tpu_torch.ops.banded_attention import banded_attention_bwd
    with torch.no_grad():
        runs = [banded_attention_bwd(*qkv, valid, out, stats, dout, window=W,
                                     **kw)
                for qkv in ((q, k, v), (q, k, v), _strided(q, k, v))]
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


def _longform_cfg():
    """The long-form slice's config (chip_smoke.py's longform_config
    without data): the flagship's with the Longformer encoder."""
    from espnet_tpu_torch.utils.config import load_yaml
    cfg = load_yaml(ASSET / "config.yaml")
    cfg.pop("collate_fixed_lengths")
    cfg.update(token_list=str(ASSET / "tokens.txt"),
               stats_file=str(ASSET / "feats_stats.npz"),
               encoder="longformer",
               encoder_conf={"output_size": 256, "attention_heads": 4,
                             "linear_units": 1024, "num_blocks": 6,
                             "attention_window": 64})
    return cfg


@pytest.mark.gpu
def test_longform_speech2text_encodes_through_the_banded_kernel(tmp_path):
    # a seed-initialised long-form model, saved as the trainer saves it,
    # encodes two recordings of 1.1 M and 0.6 M samples joined from
    # held-out utterances: 6 banded launches, the card's CTC
    # log-probabilities within 1e-4 of the CPU's on valid frames
    _cuda_or_skip()
    from espnet_tpu_torch.bin.asr_inference import Speech2Text
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.nn.initialize import init_like_flax
    from espnet_tpu_torch.tasks.asr import build_model
    from espnet_tpu_torch.train.checkpoint import save_checkpoint
    from espnet_tpu_torch.utils.config import dump_yaml
    cfg = _longform_cfg()
    save_checkpoint(tmp_path / "ckpt", init_like_flax(
        build_model(cfg), torch.Generator().manual_seed(0)))
    dump_yaml(cfg, tmp_path / "config.yaml")
    waves, n = [], 0
    while n < 1_100_000:
        waves.append(SynthSpeechCorpus().utterance("test", len(waves))[0])
        n += len(waves[-1])
    speech = np.zeros((2, n), np.float32)
    speech[0] = np.concatenate(waves)
    speech[1, :600_000] = speech[0, :600_000]
    lengths = [n, 600_000]
    kw = dict(asr_train_config=tmp_path / "config.yaml",
              asr_model_file=tmp_path / "ckpt", ctc_weight=1.0)
    logprobs = {}
    for device in ("cuda", "cpu"):
        s2t = Speech2Text(device=device, **kw)
        _cuda.reset_launch_counts()
        with torch.no_grad():
            enc, enc_lens = s2t.model.encode(
                torch.from_numpy(speech).to(device),
                torch.tensor(lengths, device=device))
            logprobs[device] = torch.log_softmax(
                s2t.model.ctc_logits(enc), dim=-1).cpu()
        if device == "cuda":
            torch.cuda.synchronize()
            assert enc.shape[1] >= 2048
            assert _cuda.LAUNCHES == {"flash_attn_fwd": 0,
                                      "flash_attn_bwd": 0, "logmel_fwd": 1,
                                      "rnnt_alpha": 0, "rnnt_beta": 0,
                                      "banded_attn_fwd": 6,
                                      "banded_attn_bwd": 0}
    frames = (torch.arange(logprobs["cpu"].shape[1])[None]
              < enc_lens.cpu()[:, None])
    assert float((logprobs["cuda"] - logprobs["cpu"]).abs()[frames].max()) \
        <= 1e-4


@pytest.mark.gpu
def test_two_longform_train_steps_repeat_bit_for_bit(tmp_path):
    # the long-form config over two recordings of >= 300 k samples: two
    # runs of two steps from one seed (dropout and SpecAug on) end with
    # the same parameters, through the banded kernels' backward
    _cuda_or_skip()
    from espnet_tpu_torch.data.synth_speech import (SynthSpeechCorpus,
                                                    concat_data_dir)
    from espnet_tpu_torch.tasks.asr import ASRTask
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    SynthSpeechCorpus().materialize(tmp_path / "data", n_train=24,
                                    n_valid=0, n_test=0)
    recs = concat_data_dir(tmp_path / "data" / "train",
                           tmp_path / "data" / "long", 300_000)
    assert len(recs) >= 2
    finals = []
    for run in ("a", "b"):
        cfg = dict(_longform_cfg(), output_dir=str(tmp_path / run),
                   max_epoch=2, num_iters_per_epoch=1, batch_size=2,
                   batch_type="sorted", train_data_path_and_name_and_type=[
                       f"{tmp_path}/data/long/wav.scp,speech,sound",
                       f"{tmp_path}/data/long/text,text,text"],
                   valid_data_path_and_name_and_type=[],
                   train_shape_file=[], valid_shape_file=[])
        _cuda.reset_launch_counts()
        _, trainer = ASRTask.main(cfg)
        assert [s["skipped"] for s in trainer.step_stats] == [0.0, 0.0]
        assert _cuda.LAUNCHES["banded_attn_fwd"] == 12
        assert _cuda.LAUNCHES["banded_attn_bwd"] == 24
        finals.append(load_checkpoint(tmp_path / run / "checkpoint")[0])
    for name in finals[0]:
        np.testing.assert_array_equal(finals[1][name], finals[0][name],
                                      err_msg=name)


@pytest.mark.gpu
def test_grad_check_pin_holds_the_decoder_feed_forward_to_float64():
    # the long-form decoder's feed-forward (256 -> 1024 -> 256, ReLU) at
    # the shape of chip_smoke's long-form grad-check batch, (2, 1112, 256):
    # its gradients on the card in fp32 against a float64 backward on the
    # CPU whose ReLU inputs take the card's sides (tools/grad_pin.py),
    # each within 1e-5 of its largest entry. fp32 sums over at most 2224
    # positions round at ~3e-6 of that; a unit left on the other side of
    # its ReLU moves w_1's gradients by a whole unit's term, ~5e-3 here
    # (1.9e-3 at the long-form state where the former pin let one through).
    # Eight units are planted on the card's side of 0 and below it in
    # float64: for the entry of each where the card's fp32 sum lies most
    # ulps above the float64 one, the bias is set one ulp above minus the
    # card's sum, so the card gives one ulp and float64 a negative value,
    # which the former pin (out + (side - out).detach()) rounded to 0
    _cuda_or_skip()
    import copy
    from espnet_tpu_torch.nn.transformer import PositionwiseFeedForward
    from espnet_tpu_torch.tools import grad_pin
    g = torch.Generator().manual_seed(11)
    ff = PositionwiseFeedForward(256, 1024, dropout_rate=0.0).eval()
    x, dy = (torch.randn(2, 1112, 256, generator=g) for _ in range(2))
    with torch.no_grad():
        ff.w_1.bias.zero_()
        h = copy.deepcopy(ff.w_1).cuda()(x.cuda()).cpu().flatten(0, 1)
        h64 = torch.nn.functional.linear(
            x.double(), ff.w_1.weight.double()).flatten(0, 1)
        ulp = torch.nextafter(h.abs(), torch.tensor(float("inf"))) - h.abs()
        gap = ((h.double() - h64) / ulp.double()).max(0)
        units = gap.values.topk(8).indices
        assert bool((gap.values[units] > 2).all()), gap.values[units]
        up = torch.nextafter(-h, torch.tensor(float("inf")))
        ff.w_1.bias[units] = up[gap.indices[units], units]
    signs, grads, moved = {}, {}, {}
    for leg, dev, dtype in (("card", "cuda", torch.float32),
                            ("float64", "cpu", torch.float64)):
        m = copy.deepcopy(ff).to(dev, dtype)
        grad_pin.pin_relus({"w_1": m.w_1}, signs,
                           None if leg == "card" else moved)
        xi = x.to(dev, dtype, copy=True).requires_grad_()
        (m(xi) * dy.to(dev, dtype)).sum().backward()
        grads[leg] = {"x": xi.grad.cpu().double()} | {
            n: p.grad.cpu().double() for n, p in m.named_parameters()}
    assert moved["w_1"][0] >= 8, moved
    assert moved["w_1"][2] <= grad_pin.MOVE_TOL, moved
    for name, ref in grads["float64"].items():
        err = float((grads["card"][name] - ref).abs().max()
                    / ref.abs().max())
        assert err <= 1e-5, (name, err)


ENH = Path(__file__).resolve().parents[1] / "assets" / "synth_enh_tcn"


@pytest.mark.gpu
def test_separation_on_the_card_matches_the_cpu():
    # the TCN asset on two 4 s test mixtures: each separated wave within
    # 1e-4 of its largest sample on the card and on the CPU (fp32 sums in
    # another order through 8 blocks, the STFT and the overlap-add), the
    # same bits twice on the card, and no kernel launched
    _cuda_or_skip()
    from espnet_tpu_torch.bin.enh_inference import SeparateSpeech
    from espnet_tpu_torch.data.synth_speech import SynthMixCorpus
    corpus = SynthMixCorpus()
    mix = np.stack([corpus.mixture("test", i)[0] for i in range(2)])
    card = SeparateSpeech(ENH / "config.yaml", ENH, fs=16000)
    cpu = SeparateSpeech(ENH / "config.yaml", ENH, fs=16000, device="cpu")
    _cuda.reset_launch_counts()
    got, again = card(mix), card(mix)
    assert not any(_cuda.LAUNCHES.values()), _cuda.LAUNCHES
    for a, b, c in zip(got, again, cpu(mix)):
        np.testing.assert_array_equal(a, b)
        assert np.abs(a - c).max() <= 1e-4 * np.abs(c).max()


@pytest.mark.gpu
@pytest.mark.parametrize("encoder", ["stft", "conv"])
def test_enhancement_training_on_the_card_repeats_itself_bit_for_bit(
        tmp_path, encoder):
    # two 3-step runs from one seed end with the same parameters: the
    # cuDNN convolutions' weight gradients (deterministic algorithms) and
    # the iSTFT's overlap-add (F.fold, no atomics) repeat
    _cuda_or_skip()
    from espnet_tpu_torch.data.synth_speech import SynthMixCorpus
    from espnet_tpu_torch.tasks.enh import EnhancementTask
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    SynthMixCorpus(seconds=1.0).materialize(tmp_path / "data", n_train=6,
                                            n_valid=0, n_test=0)
    d = tmp_path / "data" / "train"

    def train(name):
        EnhancementTask.main({
            "output_dir": str(tmp_path / name), "seed": 3, "max_epoch": 3,
            "num_iters_per_epoch": 1, "batch_type": "sorted",
            "batch_size": 3, "optim": "adam", "optim_conf": {"lr": 0.002},
            "encoder": encoder,
            "encoder_conf": {"channels": 64, "kernel_size": 16,
                             "stride": 8},
            "separator": "tcn",
            "separator_conf": {"layers": 4, "stacks": 1,
                               "bottleneck_dim": 32, "hidden_dim": 64},
            "train_data_path_and_name_and_type": [
                f"{d}/wav.scp,speech_mix,sound",
                f"{d}/spk1.scp,speech_ref1,sound",
                f"{d}/spk2.scp,speech_ref2,sound"]})
        return load_checkpoint(tmp_path / name / "checkpoint")[0]

    ref, other = train("a"), train("b")
    assert sorted(other) == sorted(ref)
    for name in ref:
        np.testing.assert_array_equal(other[name], ref[name], err_msg=name)


@pytest.mark.gpu
def test_joint_model_decodes_and_trains_through_the_kernels():
    # a small joint model (TCN enhancement, 2-block conformer ASR): its
    # decode's encode launches the log-mel kernel once and the attention
    # forward per block; a train step differentiates through the frontend:
    # it launches the log-mel kernel once (its backward is the plain
    # version's) and the attention forward and backward
    _cuda_or_skip()
    from espnet_tpu_torch.tasks.enh import EnhS2TTask
    tokens = ["<blank>", "a", "b", "<space>", "<sos/eos>"]
    model = EnhS2TTask.build_model({
        "token_list": tokens,
        "enh_conf": {"num_spk": 2, "separator": "tcn",
                     "separator_conf": {"layers": 2, "stacks": 1,
                                        "bottleneck_dim": 16,
                                        "hidden_dim": 32}},
        "asr_conf": {"frontend_conf": {"n_fft": 512, "hop_length": 128,
                                       "n_mels": 80},
                     "encoder": "conformer",
                     "encoder_conf": {"output_size": 64,
                                      "attention_heads": 4,
                                      "linear_units": 128, "num_blocks": 2,
                                      "cnn_module_kernel": 7},
                     "decoder_conf": {"attention_heads": 4,
                                      "linear_units": 128, "num_blocks": 1},
                     "ctc_weight": 0.3}}).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    speech = 0.1 * torch.randn(2, 16000, generator=g, device="cuda")
    lens = torch.tensor([16000, 12000], device="cuda")
    model.eval()
    _cuda.reset_launch_counts()
    with torch.no_grad():
        model.encode(speech, lens)
    assert _cuda.LAUNCHES["logmel_fwd"] == 1
    assert _cuda.LAUNCHES["flash_attn_fwd"] == 2
    model.train()
    _cuda.reset_launch_counts()
    loss, stats, _ = model(speech, lens, torch.ones(2, 3, dtype=torch.long,
                                                    device="cuda"),
                           torch.tensor([3, 2], device="cuda"),
                           speech_ref1=speech)
    loss.backward()
    assert torch.isfinite(loss) and "enh_loss" in stats
    assert _cuda.LAUNCHES["logmel_fwd"] == 1
    assert _cuda.LAUNCHES["flash_attn_fwd"] == 2
    assert _cuda.LAUNCHES["flash_attn_bwd"] == 4
    assert all(p.grad is not None for p in model.enh.parameters())


LM_ASSET = Path(__file__).resolve().parents[1] / "assets" / "synth_lm"
TTS_ASSET = Path(__file__).resolve().parents[1] / "assets" / "synth_tts_vits"


@pytest.mark.gpu
def test_lm_fused_decode_on_the_card_matches_the_cpu():
    # the flagship with the LM asset fused at 0.3 on three test
    # utterances: the same ids on the card as on the CPU, K1 and K2
    # launched as without the LM (the LM's attention is plain torch)
    _cuda_or_skip()
    from espnet_tpu_torch.bin.asr_inference import Speech2Text
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    utts = [SynthSpeechCorpus().utterance("test", i) for i in range(3)]
    speech = np.zeros((3, max(len(w) for w, _, _ in utts)), np.float32)
    for i, (w, _, _) in enumerate(utts):
        speech[i, :len(w)] = w
    lengths = [len(w) for w, _, _ in utts]
    kw = dict(asr_train_config=ASSET / "config.yaml", asr_model_file=ASSET,
              beam_size=10, ctc_weight=0.3,
              lm_train_config=LM_ASSET / "config.yaml", lm_file=LM_ASSET,
              lm_weight=0.3)
    _cuda.reset_launch_counts()
    out = Speech2Text(**kw)(speech, lengths)
    assert _cuda.LAUNCHES == {"flash_attn_fwd": 6, "flash_attn_bwd": 0,
                              "logmel_fwd": 1, "rnnt_alpha": 0,
                              "rnnt_beta": 0, "banded_attn_fwd": 0,
                              "banded_attn_bwd": 0}
    ref = Speech2Text(device="cpu", **kw)(speech, lengths)
    assert [n[0][2] for n in out] == [n[0][2] for n in ref]


@pytest.mark.gpu
def test_vits_on_the_card_matches_the_cpu():
    # the VITS asset on one text at max_frames 640 and one numpy noise
    # draw: the same durations on the card and the CPU, the wave within
    # 1e-4 of its largest sample (fp32 sums in another order through 4
    # text blocks, 4 couplings and 43 generator convolutions; TF32 off),
    # the same bits twice on the card, and no kernel launched
    _cuda_or_skip()
    from espnet_tpu_torch.tasks.gan_tts import GANTTSTask
    card, cfg = GANTTSTask.build_model_from_file(
        TTS_ASSET / "config.yaml", TTS_ASSET)
    cpu, _ = GANTTSTask.build_model_from_file(TTS_ASSET / "config.yaml",
                                              TTS_ASSET, "cpu")
    ids = GANTTSTask.build_preprocess_fn(cfg, train=False)(
        "x", {"text": "deka munto ra", "speech": np.zeros(512, np.float32)}
    )["text"]
    text = torch.zeros(1, 64, dtype=torch.int64)
    text[0, :len(ids)] = torch.from_numpy(ids)
    lens = torch.tensor([len(ids)])
    noise = torch.from_numpy(np.random.RandomState(0).randn(
        1, 640, 192).astype(np.float32))
    out = {}
    _cuda.reset_launch_counts()
    for name, model, dev in (("card", card, "cuda"), ("again", card, "cuda"),
                             ("cpu", cpu, "cpu")):
        with torch.no_grad():
            dur = model.generator.prior_and_durations(text.to(dev),
                                                      lens.to(dev))[2]
            wav, olens = model.decode(text.to(dev), lens.to(dev),
                                      noise=noise.to(dev), max_frames=640)
        out[name] = (dur.cpu(), wav.cpu(), int(olens[0]))
    assert not any(_cuda.LAUNCHES.values()), _cuda.LAUNCHES
    assert torch.equal(out["card"][0], out["cpu"][0])
    assert out["card"][2] == out["cpu"][2] > 0
    assert torch.equal(out["card"][1], out["again"][1])
    n = out["cpu"][2] * cfg["hop_length"]
    assert _relative_err(out["card"][1][0, :n], out["cpu"][1][0, :n]) <= 1e-4


@pytest.mark.gpu
def test_k2_in_the_gan_mel_loss_matches_its_plain_version():
    # the GAN mel loss at its shape, (16, 8192) at n_fft 512, hop 128, 80
    # mels: through the kernel (2 launches, the same bits twice) within
    # 1e-4 of the plain version's loss, the backward the plain version's
    _cuda_or_skip()
    from espnet_tpu_torch.models.tts.hifigan import mel_spectrogram_loss
    g = torch.Generator(device="cuda").manual_seed(0)
    real = 0.3 * torch.randn(16, 8192, generator=g, device="cuda")
    fake = (real + 0.05 * torch.randn(16, 8192, generator=g,
                                      device="cuda")).requires_grad_()
    kw = dict(fs=16000, n_fft=512, hop_length=128, n_mels=80)
    _cuda.reset_launch_counts()
    loss = mel_spectrogram_loss(fake, real, **kw)
    assert _cuda.LAUNCHES["logmel_fwd"] == 2
    assert torch.equal(loss, mel_spectrogram_loss(fake, real, **kw))
    plain = (fused_logmel_plain(fake, **kw)
             - fused_logmel_plain(real, **kw)).abs().mean()
    assert abs(float(loss) / float(plain) - 1) <= 1e-4
    grad, = torch.autograd.grad(loss, fake)
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0


def _gan_cfg(tmp_path, task):
    """A tiny VITS (gan_tts) or HiFi-GAN vocoder (gan_vocoder) config over
    4 speaker-0 utterances; the mel loss at n_fft 64, hop 32, 12 mels goes
    through the log-mel kernel."""
    data = tmp_path / "data"
    gen = {"channels": 16, "upsample_scales": [4, 8],
           "upsample_kernel_sizes": [8, 16], "resblock_kernel_sizes": [3],
           "resblock_dilations": [[1, 3]]}
    base = {"fs": 16000, "n_fft": 64, "hop_length": 32, "n_mels": 12,
            "discriminator_conf": {"periods": [2, 3], "scales": 1},
            "grad_clip": -1, "batch_type": "sorted", "batch_size": 2,
            "max_epoch": 2, "num_iters_per_epoch": 1, "log_interval": 1,
            "valid_data_path_and_name_and_type": []}
    if task == "gan_vocoder":
        return dict(base, generator_conf=gen, segment_size=256,
                    train_data_path_and_name_and_type=[
                        f"{data}/train/wav.scp,speech,sound"])
    toks = ["<blank>"] + list("abcdefghijklmnopqrstuvwxyz") + [
        "<space>", "<sos/eos>"]
    (tmp_path / "tokens.txt").write_text("\n".join(toks) + "\n")
    return dict(base, token_list=str(tmp_path / "tokens.txt"),
                max_wav_length=4096,
                collate_fixed_lengths={"text": 40, "speech": 4096,
                                       "spec": 127},
                tts_conf={"z_channels": 8, "hidden": 16, "segment_frames": 8,
                          "text_encoder_conf": {
                              "output_size": 16, "attention_heads": 2,
                              "linear_units": 24, "num_blocks": 1},
                          "generator_conf": gen},
                train_data_path_and_name_and_type=[
                    f"{data}/train/text,text,text",
                    f"{data}/train/wav.scp,speech,sound"])


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["gan_tts", "gan_vocoder"])
def test_gan_training_on_the_card_repeats_itself_bit_for_bit(tmp_path,
                                                             task):
    # two 2-step runs of each entry point from one seed (dropout on) end
    # with the same parameters; every step runs K2 in the mel loss (and
    # in the vocoder's featurize) and skips no turn
    _cuda_or_skip()
    from espnet_tpu_torch.bin import gan_tts_train, gan_vocoder_train
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    from espnet_tpu_torch.utils.config import dump_yaml
    SynthSpeechCorpus().materialize(tmp_path / "data", n_train=4,
                                    n_valid=0, n_test=0, speaker_ids=[0])
    main = {"gan_tts": gan_tts_train, "gan_vocoder": gan_vocoder_train}[
        task].main
    finals = []
    for run in ("a", "b"):
        dump_yaml(dict(_gan_cfg(tmp_path, task),
                       output_dir=str(tmp_path / run)),
                  tmp_path / f"{run}.yaml")
        _cuda.reset_launch_counts()
        _, trainer = main(["--config", str(tmp_path / f"{run}.yaml")])
        assert [(s["skipped"], s["skipped_d"])
                for s in trainer.step_stats] == [(0.0, 0.0)] * 2
        assert _cuda.LAUNCHES["logmel_fwd"] == 2 * (
            2 if task == "gan_tts" else 4)
        finals.append(load_checkpoint(tmp_path / run / "checkpoint")[0])
    assert sorted(finals[1]) == sorted(finals[0])
    for name in finals[0]:
        np.testing.assert_array_equal(finals[1][name], finals[0][name],
                                      err_msg=name)


ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n_fft,hop,n_mels", [
    ((2, 128000), 512, 128, 40),     # diarization's frontend
    ((2, 74560), 256, 64, 40)])      # the codec's mel loss
def test_k2_at_the_diarization_and_codec_shapes(shape, n_fft, hop, n_mels):
    # within 1e-3 of the plain version (log domain, above 1e-8), the same
    # bits twice; the codec's mel loss through it within 1e-4 of the plain
    # one's, its gradient finite
    _cuda_or_skip()
    from espnet_tpu_torch.models.tts.hifigan import melspec
    g = torch.Generator(device="cuda").manual_seed(1)
    wave = 0.3 * torch.randn(*shape, generator=g, device="cuda")
    kw = dict(fs=16000, n_fft=n_fft, hop_length=hop, n_mels=n_mels)
    _cuda.reset_launch_counts()
    out = fused_logmel(wave, **kw)
    assert _cuda.LAUNCHES["logmel_fwd"] == 1
    ref = fused_logmel_plain(wave, **kw)
    sel = ref > float(np.log(1e-8))
    assert float((out - ref)[sel].abs().max()) <= 1e-3
    assert torch.equal(out, fused_logmel(wave, **kw))
    fake = (wave + 0.05 * torch.randn(*shape, generator=g, device="cuda")
            ).requires_grad_()
    loss = (melspec(fake, **kw) - melspec(wave, **kw)).abs().mean()
    plain = (fused_logmel_plain(fake, **kw) - ref).abs().mean()
    assert abs(float(loss.detach()) / float(plain.detach()) - 1) <= 1e-4
    grad, = torch.autograd.grad(loss, fake)
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0


@pytest.mark.gpu
def test_diarization_codec_and_speechlm_on_the_card_match_the_cpu():
    # the three assets: diarization logits within 1e-4 of their largest
    # (K2 launched once), the same codec codes and decoded waves within
    # 1e-4, and the same greedy SpeechLM continuation
    _cuda_or_skip()
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus, dialogs
    from espnet_tpu_torch.tasks.speechlm import (SpeechLMTask,
                                                 recipe_token_list)
    from espnet_tpu_torch.tasks.spk import DiarizationTask
    from espnet_tpu_torch.tasks.ssl import CodecTask
    diar, codec, slm = (ROOT / "assets" / a for a in (
        "synth_diar", "synth_codec", "synth_speechlm"))
    waves, _ = dialogs("test", 2, 16)
    w = torch.from_numpy(np.stack(waves))
    lens = torch.full((2,), w.shape[1])
    out = {}
    for dev in ("cuda", "cpu"):
        m, _ = DiarizationTask.build_model_from_file(diar / "config.yaml",
                                                     diar, dev)
        _cuda.reset_launch_counts()
        with torch.no_grad():
            out[dev] = m.predict(w.to(dev), lens.to(dev))[0].cpu()
        if dev == "cuda":
            assert _cuda.LAUNCHES["logmel_fwd"] == 1
    assert _relative_err(out["cuda"], out["cpu"]) <= 1e-4
    u = SynthSpeechCorpus().utterance("test", 0)[0][:74560]
    x = torch.zeros(1, 74560)
    x[0, :len(u)] = torch.from_numpy(u)
    codes, waves_out = {}, {}
    for dev in ("cuda", "cpu"):
        m, _ = CodecTask.build_model_from_file(codec / "config.yaml", codec,
                                               dev)
        with torch.no_grad():
            codes[dev] = m.encode(x.to(dev)).cpu()
            waves_out[dev] = m.decode(codes["cpu" if "cpu" in codes
                                            else dev].to(dev)).cpu()
    assert torch.equal(codes["cuda"], codes["cpu"])
    assert _relative_err(waves_out["cuda"], waves_out["cpu"]) <= 1e-4
    gen = {}
    for dev in ("cuda", "cpu"):
        m, _ = SpeechLMTask.build_model_from_file(
            slm / "config.yaml", slm, dev,
            {"text_token_list": recipe_token_list()})
        prompt = torch.cat([torch.full((1, 2, 4), 1), 33 + codes["cpu"][
            :, :20]], dim=1).to(dev)
        gen[dev] = m.generate_scan(prompt, torch.tensor([22], device=dev),
                                   30, temperature=0.0, eos_id=2)[0].cpu()
    assert torch.equal(gen["cuda"], gen["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["diar", "codec", "speechlm"])
def test_a5_training_on_the_card_repeats_itself_bit_for_bit(tmp_path, task):
    # two 2-step runs of each entry point from one seed (dropout on) end
    # with the same parameters: the codec's codebook gather and the
    # SpeechLM's embeddings are one-hot products, whose gradients repeat
    _cuda_or_skip()
    from espnet_tpu_torch.bin import (diar_train, gan_codec_train,
                                      speechlm_train)
    from espnet_tpu_torch.data.fileio import NpyScpWriter
    from espnet_tpu_torch.data.speechlm import write_dataset_json
    from espnet_tpu_torch.data.synth_speech import (SynthSpeechCorpus,
                                                    materialize_dialogs)
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    from espnet_tpu_torch.utils.config import dump_yaml
    data = tmp_path / "data"
    base = {"max_epoch": 2, "num_iters_per_epoch": 1, "batch_size": 2,
            "batch_type": "unsorted", "log_interval": 1,
            "valid_data_path_and_name_and_type": []}
    if task == "diar":
        materialize_dialogs(data, "train", 2, 0)
        cfg = dict(base, frontend_conf={"n_fft": 512, "hop_length": 128,
                                        "n_mels": 40},
                   encoder_conf={"output_size": 32, "attention_heads": 2,
                                 "linear_units": 48, "num_blocks": 2,
                                 "input_layer": "conv2d"},
                   collate_fixed_lengths={"speech": 128000,
                                          "spk_labels": 250},
                   train_data_path_and_name_and_type=[
                       f"{data}/train/wav.scp,speech,sound",
                       f"{data}/train/labels.scp,spk_labels,npy"])
        main, kernel_launches = diar_train.main, 2
    elif task == "codec":
        SynthSpeechCorpus().materialize(data, n_train=2, n_valid=0,
                                        n_test=0)
        cfg = dict(base, codec_conf={"channels": 8, "strides": [2, 4, 5, 8],
                                     "code_dim": 16, "num_quantizers": 2,
                                     "codebook_size": 16},
                   collate_fixed_lengths={"speech": 74656},
                   train_data_path_and_name_and_type=[
                       f"{data}/train/wav.scp,speech,sound"])
        main, kernel_launches = gan_codec_train.main, 4
    else:
        rng = np.random.RandomState(0)
        with NpyScpWriter(data / "codes", data / "codes.scp") as wr:
            for i in range(2):
                wr[f"u{i}"] = rng.randint(0, 16, (40, 2)).astype(np.int32)
        write_dataset_json(data / "train.json", "audio_continuation",
                           [{"name": "audio1", "type": "npy",
                             "path": str(data / "codes.scp")}], ["u0", "u1"])
        (tmp_path / "tokens.txt").write_text("a\nb\n")
        cfg = dict(base, d_model=32, heads=2, units=48, layers=2,
                   multi_task_dataset=[str(data / "train.json")],
                   text_token_list=str(tmp_path / "tokens.txt"),
                   codebook_size=16, n_streams=2)
        main, kernel_launches = speechlm_train.main, 0
    finals = []
    for run in ("a", "b"):
        dump_yaml(dict(cfg, output_dir=str(tmp_path / run)),
                  tmp_path / f"{run}.yaml")
        _cuda.reset_launch_counts()
        _, trainer = main(["--config", str(tmp_path / f"{run}.yaml")])
        assert [s["skipped"] for s in trainer.step_stats] == [0.0] * 2
        assert _cuda.LAUNCHES["logmel_fwd"] == kernel_launches
        finals.append(load_checkpoint(tmp_path / run / "checkpoint")[0])
    for name in finals[0]:
        np.testing.assert_array_equal(finals[1][name], finals[0][name],
                                      err_msg=name)


@pytest.mark.gpu
def test_speaker_embedding_on_the_card_matches_the_cpu():
    # the ECAPA asset on 4 held-out utterances as the recipe's stage 3
    # pads them: embeddings within 1e-4 of their largest, no kernel
    # launched (hop 160 does not divide n_fft 512: the plain STFT)
    _cuda_or_skip()
    from espnet_tpu_torch.bin.spk_inference import SpeakerEmbedding
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    spk = ROOT / "assets" / "synth_spk_ecapa"
    corpus = SynthSpeechCorpus()
    speech = np.zeros((4, 74656), np.float32)
    lens = np.zeros((4,), np.int64)
    for j in range(4):
        w = corpus.utterance("test", j)[0][:74656]
        speech[j, :len(w)], lens[j] = w, len(w)
    out = {}
    for dev in ("cuda", "cpu"):
        se = SpeakerEmbedding(spk / "config.yaml", spk, device=dev)
        _cuda.reset_launch_counts()
        out[dev] = torch.from_numpy(se.embed(speech, lens))
        assert not any(_cuda.LAUNCHES.values())
    assert _relative_err(out["cuda"], out["cpu"]) <= 1e-4


@pytest.mark.gpu
def test_classification_model_through_k2_matches_its_plain_frontend():
    # the cls1 recipe's model (4-block Transformer, d=144) on 8 keywords:
    # its logits through K2 (launched once) within 1e-4 of the same
    # model's through the plain STFT and mel ops
    _cuda_or_skip()
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.nn.initialize import init_like_flax
    from espnet_tpu_torch.tasks.spk import ClassificationTask
    cfg = {"n_classes": 30,
           "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
           "encoder_conf": {"output_size": 144, "attention_heads": 4,
                            "linear_units": 576, "num_blocks": 4,
                            "input_layer": "conv2d"}}
    corpus = SynthSpeechCorpus(n_words=30, min_words=1, max_words=1)
    waves = [corpus.utterance("cls-test", i)[0] for i in range(8)]
    speech = torch.zeros(8, 15216)
    lens = torch.tensor([len(w) for w in waves])
    for j, w in enumerate(waves):
        speech[j, :len(w)] = torch.from_numpy(w)
    logits = {}
    for fused in ("auto", "never"):
        c = dict(cfg, frontend_conf=dict(cfg["frontend_conf"],
                                         use_fused_kernel=fused))
        m = init_like_flax(ClassificationTask.build_model(c),
                           torch.Generator().manual_seed(0)).cuda().eval()
        _cuda.reset_launch_counts()
        with torch.no_grad():
            logits[fused] = m.predict(speech.cuda(), lens.cuda()).cpu()
        assert _cuda.LAUNCHES["logmel_fwd"] == int(fused == "auto")
    assert _relative_err(logits["auto"], logits["never"]) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["spk", "cls"])
def test_spk_and_cls_training_on_the_card_repeats_itself_bit_for_bit(
        tmp_path, task):
    # two 2-step runs of each entry point from one seed end with the same
    # parameters: the speaker model with the margin warm-up, the
    # classifier (dropout on) through K2
    _cuda_or_skip()
    from espnet_tpu_torch.bin import cls_train, spk_train
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    from espnet_tpu_torch.utils.config import dump_yaml
    data = tmp_path / "data"
    SynthSpeechCorpus().materialize(data, n_train=4, n_valid=0, n_test=0)
    labels = data / "train" / "labels"
    labels.write_text("".join(
        f"{u} {int(s[3:]) % 4}\n" for u, s in (
            line.split() for line in open(data / "train" / "utt2spk"))))
    base = {"max_epoch": 2, "num_iters_per_epoch": 1, "batch_size": 2,
            "batch_type": "unsorted", "log_interval": 1,
            "valid_data_path_and_name_and_type": []}
    if task == "spk":
        cfg = dict(base, n_spk=4, encoder_conf={"channels": 64,
                                                "num_blocks": 3},
                   embed_dim=32, margin_warmup_epochs=2,
                   model_conf={"aam_margin": 0.3, "aam_scale": 30.0},
                   collate_fixed_lengths={"speech": 74656},
                   train_data_path_and_name_and_type=[
                       f"{data}/train/wav.scp,speech,sound",
                       f"{labels},spk_labels,text_int"])
        main, kernel_launches = spk_train.main, 0
    else:
        cfg = dict(base, n_classes=4,
                   encoder_conf={"output_size": 64, "attention_heads": 2,
                                 "linear_units": 128, "num_blocks": 2,
                                 "input_layer": "conv2d"},
                   train_data_path_and_name_and_type=[
                       f"{data}/train/wav.scp,speech,sound",
                       f"{labels},label,text_int"])
        main, kernel_launches = cls_train.main, 2
    finals = []
    for run in ("a", "b"):
        dump_yaml(dict(cfg, output_dir=str(tmp_path / run)),
                  tmp_path / f"{run}.yaml")
        _cuda.reset_launch_counts()
        _, trainer = main(["--config", str(tmp_path / f"{run}.yaml")])
        assert [s["skipped"] for s in trainer.step_stats] == [0.0] * 2
        assert _cuda.LAUNCHES["logmel_fwd"] == kernel_launches
        finals.append(load_checkpoint(tmp_path / run / "checkpoint")[0])
    for name in finals[0]:
        np.testing.assert_array_equal(finals[1][name], finals[0][name],
                                      err_msg=name)


def _seeded_flat(model, seed=0):
    """The weights of ``model``'s parameter tree from RandomState(seed) at
    init scale (chip_smoke.seed_flat's rule)."""
    rng = np.random.RandomState(seed)
    flat = {}
    for key, value in sorted(convert.state_dict_to_flax(model).items()):
        x = rng.randn(*value.shape)
        name = key.rsplit("/", 1)[-1]
        x = (x / np.sqrt(np.prod(value.shape[:-1])) if name == "kernel"
             else 1.0 + 0.05 * x if name == "scale" else 0.05 * x)
        flat[key] = np.asarray(x, np.float32)
    return flat


def _seeded_separator(sep, seed=0, conf=None):
    """The TCN asset's config with ``sep`` at its default width (``conf``
    over it), and ``_seeded_flat``'s weights of its parameter tree."""
    from espnet_tpu_torch.tasks.enh import EnhancementTask
    from espnet_tpu_torch.utils.config import load_yaml
    cfg = dict(load_yaml(ENH / "config.yaml"), separator=sep,
               separator_conf=dict(conf or {}))
    return cfg, _seeded_flat(EnhancementTask.build_model(cfg), seed)


@pytest.mark.gpu
@pytest.mark.parametrize("sep,n_mix,seconds", [("conformer", 2, 4.0),
                                               ("tfgridnet", 1, 1.0),
                                               ("tfgridnetv2", 1, 1.0)])
def test_separator_on_the_card_matches_the_cpu(sep, n_mix, seconds):
    # the separator at its default width on test mixtures: the estimates
    # within 1e-4 of their largest sample on the card and on the CPU, the
    # same bits twice on the card (the Conformer through the attention
    # forward at head size 32, 2 launches); one backward of the PIT loss
    # on each, the CPU's ReLU / PReLU inputs and attention inputs moved
    # onto the card's (tools/grad_pin.py), every gradient within 1e-3 of
    # its scale (the larger of its own largest entry and 1e-4 of the
    # model's largest)
    _cuda_or_skip()
    from espnet_tpu_torch.data.synth_speech import SynthMixCorpus
    from espnet_tpu_torch.tasks.enh import EnhancementTask
    from espnet_tpu_torch.tools import grad_pin
    cfg, flat = _seeded_separator(sep)
    corpus = SynthMixCorpus(seconds=seconds)
    mixtures = [corpus.mixture("test", i) for i in range(n_mix)]
    batch = {k: torch.from_numpy(np.stack([m[j] for m in mixtures]))
             for j, k in enumerate(("speech_mix", "speech_ref1",
                                    "speech_ref2"))}
    batch["speech_mix_lengths"] = torch.full((n_mix,),
                                             batch["speech_mix"].shape[1])
    signs, store, grads, ests = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        model = convert.load_flax_params(EnhancementTask.build_model(cfg),
                                         flat).to(dev).eval()
        on = {k: v.to(dev) for k, v in batch.items()}
        _cuda.reset_launch_counts()
        with torch.no_grad():
            ests[dev] = [e.cpu() for e in model.forward_enhance(
                on["speech_mix"], on["speech_mix_lengths"])[0]]
            if dev == "cuda":
                again = model.forward_enhance(on["speech_mix"],
                                              on["speech_mix_lengths"])[0]
                assert all(torch.equal(a.cpu(), b)
                           for a, b in zip(again, ests[dev]))
                want = 4 if sep == "conformer" else 0
                assert _cuda.LAUNCHES["flash_attn_fwd"] == want
        noted = None if dev == "cuda" else {}
        hooks = (grad_pin.pin_relus(grad_pin.relu_inputs(model), signs,
                                    noted)
                 + grad_pin.pin_attention(model, store, noted))
        loss, _, _ = model(**on)
        loss.backward()
        for h in hooks:
            h.remove()
        grads[dev] = convert.state_dict_to_flax(model, grad=True)
        assert all(r[2] <= grad_pin.MOVE_TOL for r in (noted or {}).values())
    for a, b in zip(ests["cuda"], ests["cpu"]):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    top = max(float(np.abs(g).max()) for g in grads["cpu"].values())
    for name, g in grads["cpu"].items():
        scale = max(float(np.abs(g).max()), 1e-4 * top)
        assert np.abs(grads["cuda"][name] - g).max() <= 1e-3 * scale, name


# one case per family of the time-domain and multichannel separators, at
# the default width (the mic count where a separator sizes by it): name,
# separator, conf, channels
MULTICHANNEL = [("svoice", "svoice", {}, 1), ("fasnet", "fasnet", {}, 4),
                ("uses", "uses", {}, 1), ("uses2", "uses2", {}, 4),
                ("tfgridnetv2", "tfgridnetv2", {"n_imics": 4}, 4),
                ("tfgridnetv3", "tfgridnetv3", {}, 1),
                ("ineube", "ineube", {"mic_channels": 4}, 4),
                ("neural_beamformer", "neural_beamformer", {}, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,sep,conf,channels", MULTICHANNEL,
                         ids=[c[0] for c in MULTICHANNEL])
def test_multichannel_separator_on_the_card_matches_the_cpu(name, sep, conf,
                                                           channels):
    # two 1 s mixtures (four channels: chip_smoke's reverberant version,
    # a seeded room response per source and mic): the estimates within
    # 1e-4 of their largest sample on the card and on the CPU, the same
    # bits twice on the card, no kernel launched
    _cuda_or_skip()
    from chip_smoke import reverb_mixture
    from espnet_tpu_torch.data.synth_speech import SynthMixCorpus
    from espnet_tpu_torch.tasks.enh import EnhancementTask
    cfg, flat = _seeded_separator(sep, conf=conf)
    corpus = SynthMixCorpus(seconds=1.0)
    triples = [corpus.mixture("test", i) for i in range(2)]
    mix = np.stack([reverb_mixture(*tr, i)[0] if channels > 1 else tr[0]
                    for i, tr in enumerate(triples)])
    ests = {}
    for dev in ("cuda", "cpu"):
        model = convert.load_flax_params(EnhancementTask.build_model(cfg),
                                         flat).to(dev).eval()
        x = torch.from_numpy(mix).to(dev)
        n = torch.full((2,), mix.shape[1], device=dev)
        _cuda.reset_launch_counts()
        with torch.no_grad():
            ests[dev] = [e.cpu() for e in model.forward_enhance(x, n)[0]]
            if dev == "cuda":
                again = model.forward_enhance(x, n)[0]
                assert all(torch.equal(a.cpu(), b)
                           for a, b in zip(again, ests[dev]))
                assert not any(_cuda.LAUNCHES.values())
    for a, b in zip(ests["cuda"], ests["cpu"]):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.gpu
def test_tse_training_on_the_card_repeats_itself_bit_for_bit(tmp_path):
    # two 3-step enh_tse_train runs of a TSE model at its default width
    # from one seed end with the same parameters
    _cuda_or_skip()
    from espnet_tpu_torch.bin import enh_tse_train
    from espnet_tpu_torch.data.fileio import write_wav
    from espnet_tpu_torch.data.synth_speech import SynthMixCorpus
    from espnet_tpu_torch.tasks.enh import EnhTSETask
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    from espnet_tpu_torch.utils.config import dump_yaml
    SynthMixCorpus(seconds=1.0).materialize(tmp_path / "data", n_train=6,
                                            n_valid=0, n_test=0)
    d = tmp_path / "data" / "train"
    base = SynthMixCorpus().base
    with open(d / "enroll.scp", "w") as f:
        for i in range(6):
            w = base.utterance("enroll-test", i)[0][:12000]
            write_wav(d / f"enroll{i}.wav", 16000, w)
            f.write(f"train_{i:05d} {d / f'enroll{i}.wav'}\n")
    cfg = {"tse_conf": {"n_fft": 512, "hop_length": 128}, "seed": 3,
           "max_epoch": 3, "num_iters_per_epoch": 1,
           "batch_type": "sorted", "batch_size": 3, "optim": "adam",
           "optim_conf": {"lr": 0.002},
           "init_param": str(tmp_path / "seed.npz"),
           "train_data_path_and_name_and_type": [
               f"{d}/wav.scp,speech_mix,sound",
               f"{d}/enroll.scp,enroll_ref1,sound",
               f"{d}/spk1.scp,speech_ref1,sound"]}
    np.savez(tmp_path / "seed.npz",
             **_seeded_flat(EnhTSETask.build_model(cfg)))
    dump_yaml(cfg, tmp_path / "tse.yaml")

    def train(name):
        enh_tse_train.main(["--config", str(tmp_path / "tse.yaml"),
                            "--output_dir", str(tmp_path / name)])
        return load_checkpoint(tmp_path / name / "checkpoint")[0]

    ref, other = train("a"), train("b")
    assert sorted(other) == sorted(ref)
    for name in ref:
        np.testing.assert_array_equal(other[name], ref[name], err_msg=name)
