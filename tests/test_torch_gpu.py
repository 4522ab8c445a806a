"""The port's CUDA kernels and its card path, on an NVIDIA card.

These tests import no JAX, so that they run where the port runs; there,
skip tests/conftest.py, which sets JAX up:

    python3 -m pytest tests/test_torch_gpu.py -q --noconftest

Each is marked ``gpu`` and skips, with its reason, where there is no card.
The kernels are held against their plain PyTorch versions on the same
inputs (fp32 sums in another order: 1e-4 for attention outputs of O(1),
1e-3 in the log domain for log-mel energies, and 2e-5 of each
gradient's own scale for the attention backward, whose sums run over at
most Tq or Tk terms; the banded attention's the same, its sums running
over at most 2W + 1 keys). The RNN-T sweeps take the same fp32 steps as
their plain versions: nll, alpha, beta and the closed-form gradient
within 1e-5 of their largest entry.
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
    assert _cuda.LAUNCHES == {"flash_attn_fwd": 6, "flash_attn_bwd": 0,
                              "logmel_fwd": 1, "rnnt_alpha": 0,
                              "rnnt_beta": 0, "banded_attn_fwd": 0,
                              "banded_attn_bwd": 0}
    ref = Speech2Text(device="cpu", **kw)(speech, lengths)
    assert [n[0][2] for n in out] == [n[0][2] for n in ref]


def _relative_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Tq,Tk,d,causal,bias_kind", [
    (25, 4, 145, 145, 64, False, "full"),
    (25, 4, 145, 145, 64, False, "padding"),
    (2, 3, 7, 70, 40, True, "full"),
    (2, 3, 70, 7, 40, True, "full"),
    (3, 2, 130, 129, 128, False, None),
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
            "padding": lambda: pad.clone(), None: lambda: None}[bias_kind]()
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
    _cuda_or_skip()
    wave = torch.randn(2, 4000, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_logmel(wave)
    with torch.no_grad():
        assert fused_logmel(wave).grad_fn is None


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
    (25, 145, 65, 25, None, None),
    (3, 7, 5, 6, [7, 1, 4], [0, 4, 2]),
    (2, 40, 1100, 5, [40, 33], [1099, 700]),
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
    inside = alpha0 > rnnt.NEG_INF / 2
    assert torch.equal(alpha > rnnt.NEG_INF / 2, inside)
    assert torch.equal(beta > rnnt.NEG_INF / 2, inside)
    for a, b in ((nll, nll0), (alpha[inside], alpha0[inside]),
                 (beta[inside], beta0[inside])):
        assert _relative_err(a, b) < 1e-5
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
    from espnet_tpu_torch.tasks.asr import build_model_from_file
    from espnet_tpu_torch.tasks.asr_transducer import build_model
    model, _ = build_model_from_file(TRANSDUCER / "config.yaml", TRANSDUCER,
                                     "cuda", build=build_model)
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
