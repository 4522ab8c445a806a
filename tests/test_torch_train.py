"""The port's training path against the JAX package, on the CPU: the
attention backward, the losses, SpecAug, dropout, initialisation, the
teacher-forced decoder, every parameter's gradient of a small ASR model
(d=64, 2 conformer blocks, 1 decoder layer), two optimizer steps, the
non-finite skip, and the flagship's loss at full width.

Inputs are made with numpy from a seed and fed to both packages. Both
compute in fp32, with sums in another order; each tolerance says why it
is what it is.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from espnet_tpu.bin.asr_inference import Speech2Text as JaxSpeech2Text
from espnet_tpu.nn.decoder import TransformerDecoder as JaxDecoder
from espnet_tpu.ops.attention_kernels import \
    fused_attention as jax_fused_attention
from espnet_tpu.ops import losses as jax_losses
from espnet_tpu.tasks.asr import ASRTask as JaxASRTask
from espnet_tpu.train.optim import build_optimizer as jax_build_optimizer
from espnet_tpu.train.trainer import make_train_step as jax_make_train_step
from espnet_tpu_torch import convert
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.nn import attention as nn_attention
from espnet_tpu_torch.nn.initialize import TRUNC_STD, init_like_flax
from espnet_tpu_torch.ops import losses
from espnet_tpu_torch.ops.attention import (fused_attention_bwd_plain,
                                            fused_attention_plain,
                                            softmax_stats_plain)
from espnet_tpu_torch.ops.specaug import mask_along_axis, specaug, time_warp
from espnet_tpu_torch.tasks.asr import ASRTask, build_model, read_token_list
from espnet_tpu_torch.text.tokenizer import CharTokenizer, TokenIDConverter
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.train.trainer import make_train_step
from tests.torch_streaming_models import flax_params

FLAGSHIP = (Path(__file__).resolve().parents[1] / "assets"
            / "synth_asr_flagship")
D = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers side by side: one torch thread
    each, or torch's pool in every worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def small_cfg(**encoder_extra):
    return {
        "token_list": read_token_list(FLAGSHIP / "tokens.txt"),
        "frontend": "default",
        "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
        "normalize": "global_mvn",
        "stats_file": str(FLAGSHIP / "feats_stats.npz"),
        "encoder": "conformer",
        "encoder_conf": {"output_size": D, "attention_heads": 4,
                         "linear_units": 128, "num_blocks": 2,
                         "cnn_module_kernel": 7, **encoder_extra},
        "decoder": "transformer",
        "decoder_conf": {"attention_heads": 4, "linear_units": 128,
                         "num_blocks": 1},
        "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1},
    }


@pytest.fixture(scope="module")
def small():
    """A JAX model and its parameter tree filled at init scale from a
    numpy seed (nothing compiled; no bias zero and no scale one, so that
    each takes part), and the flat flax dict."""
    cfg = small_cfg()
    jmodel = JaxASRTask.build_model(cfg)
    flat, params = flax_params(jmodel, **JaxASRTask.example_batch(cfg))
    return cfg, jmodel, params, flat


def _batch(seed=1, lens=(9000, 6100, 7600), text_lens=(12, 7, 10)):
    rng = np.random.RandomState(seed)
    speech = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        speech[i, :n] = 0.3 * rng.randn(n)
    text = rng.randint(1, 24, size=(len(lens), max(text_lens)))
    for i, n in enumerate(text_lens):
        text[i, n:] = 0
    return {"speech": speech, "speech_lengths": np.asarray(lens, np.int32),
            "text": text.astype(np.int32),
            "text_lengths": np.asarray(text_lens, np.int32)}


def _torch_batch(batch):
    return {k: _t(v).float() if v.dtype.kind == "f" else _t(v).long()
            for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---- K1's backward ---------------------------------------------------

def _attention_case(kind, rng):
    B, H, d = 2, 3, 16
    Tq, Tk = (7, 11) if kind == "tq_ne_tk" else (9, 9)
    q, k, v = (rng.randn(B, H, T, d).astype(np.float32)
               for T in (Tq, Tk, Tk))
    lens = np.array([Tk, Tk - 4])
    pad = np.where(np.arange(Tk)[None] < lens[:, None], 0.0, -1e9
                   ).astype(np.float32)
    if kind == "padding":
        bias = pad[:, None, None, :]                    # (B, 1, 1, Tk)
    else:
        bias = (rng.randn(B, H, Tq, Tk).astype(np.float32)
                + pad[:, None, None, :])
    return q, k, v, bias, kind in ("causal", "tq_ne_tk")


@pytest.mark.parametrize("kind", ["padding", "relpos", "causal",
                                  "tq_ne_tk"])
def test_attention_backward_matches_jax_vjp(kind, record_property):
    rng = np.random.RandomState(0)
    q, k, v, bias, causal = _attention_case(kind, rng)
    scale = 0.25
    out, vjp = jax.vjp(
        lambda *a: jax_fused_attention(*a, causal=causal, sm_scale=scale,
                                       force_xla=True),
        *map(jnp.asarray, (q, k, v, bias)))
    dout = rng.randn(*out.shape).astype(np.float32)
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    tq, tk, tv, tb = (_t(a).requires_grad_() for a in (q, k, v, bias))
    tout = fused_attention_plain(tq, tk, tv, tb, causal=causal,
                                 sm_scale=scale)
    grads = torch.autograd.grad(tout, (tq, tk, tv, tb), _t(dout))
    # the kernels' arithmetic: P from the row statistics, then dS
    stats = softmax_stats_plain(tq, tk, tb, causal=causal, sm_scale=scale)
    dq, dk, dv, ds = fused_attention_bwd_plain(
        tq, tk, tv, tb, tout, stats, _t(dout), causal=causal,
        sm_scale=scale)
    recompute = (dq, dk, dv, ds.sum_to_size(tb.shape))
    for name, g, r, j in zip(("dq", "dk", "dv", "dbias"), grads, recompute,
                             ref):
        assert g.shape == j.shape == r.shape
        # fp32 sums in another order over <= 11 keys; gradients O(1)
        np.testing.assert_allclose(g.numpy(), j, atol=2e-5, rtol=0)
        np.testing.assert_allclose(r.detach().numpy(), j, atol=2e-5,
                                   rtol=0)
        record_property(f"max_abs_err:{kind}:{name}",
                        float(np.abs(g.numpy() - j).max()))


def test_attention_backward_recompute_in_fully_masked_rows():
    # a row whose every key is masked to -1e9 softmaxes to uniform; the
    # row statistics keep the max and the log-sum apart so that the
    # recompute gives the same uniform P (m + log l would round to -1e9)
    rng = np.random.RandomState(1)
    q, k, v = (_t(rng.randn(1, 2, 5, 8).astype(np.float32))
               for _ in range(3))
    bias = torch.zeros(1, 2, 5, 5)
    bias[:, :, 2] = -1e9
    stats = softmax_stats_plain(q, k, bias, sm_scale=0.3)
    q.requires_grad_()
    out = fused_attention_plain(q, k, v, bias, sm_scale=0.3)
    dout = _t(rng.randn(1, 2, 5, 8).astype(np.float32))
    (ref,) = torch.autograd.grad(out, (q,), dout)
    _, _, dv, _ = fused_attention_bwd_plain(q, k, v, bias, out, stats, dout,
                                            sm_scale=0.3)
    p = torch.softmax(q @ k.transpose(-1, -2) * 0.3 + bias, dim=-1)
    torch.testing.assert_close(dv, p.transpose(-1, -2) @ dout, atol=1e-6,
                               rtol=0)
    dq, _, _, _ = fused_attention_bwd_plain(q, k, v, bias, out, stats, dout,
                                            sm_scale=0.3)
    torch.testing.assert_close(dq, ref, atol=1e-6, rtol=0)


# ---- losses ---------------------------------------------------------

def _ctc_case(name):
    rng = np.random.default_rng({"rand": 0, "repeats": 1, "impossible": 2,
                                 "single": 3}[name])
    if name == "impossible":
        logits = rng.standard_normal((2, 6, 8)).astype(np.float32)
        return (logits, np.array([2, 6]), np.array([[1, 2, 3, 4, 5],
                                                    [1, 2, 0, 0, 0]]),
                np.array([5, 2]))
    if name == "single":
        logits = rng.standard_normal((1, 9, 6)).astype(np.float32)
        return logits, np.array([5]), np.array([[4]]), np.array([1])
    B, T, U, V = 5, 24, 7, 11
    logits = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    ys = rng.integers(1, V, size=(B, U))
    if name == "repeats":
        ys[:, 1], ys[:, 3] = ys[:, 0], ys[:, 2]
    hlens = rng.integers(T // 2, T + 1, size=(B,))
    ylens = rng.integers(1, U + 1, size=(B,))
    return logits, hlens, ys, ylens


@pytest.mark.parametrize("name", ["rand", "repeats", "impossible",
                                  "single"])
def test_ctc_loss_value_and_grad_match_jax(name):
    logits, hlens, ys, ylens = _ctc_case(name)
    args = [jnp.asarray(a.astype(np.int32)) for a in (hlens, ys, ylens)]
    ref, ref_g = jax.jit(jax.value_and_grad(
        lambda x: jax_losses.ctc_loss(x, *args)))(jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    loss = losses.ctc_loss(x, _t(hlens), _t(ys), _t(ylens))
    (g,) = torch.autograd.grad(loss, (x,))
    # the JAX package's alpha/beta scans against torch's CTC: fp32 sums
    # over <= 24 frames of log-probs; a loss of O(10), gradients O(0.1)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=1e-5,
                               rtol=0)
    if name == "impossible":   # zero-infinity: no loss, no gradient
        assert float(g[0].abs().max()) == 0.0


@pytest.mark.parametrize("normalize_length", [False, True])
def test_label_smoothing_accuracy_and_sos_eos(normalize_length):
    rng = np.random.RandomState(2)
    B, U, V = 4, 6, 9
    ys = rng.randint(1, V - 1, size=(B, U)).astype(np.int32)
    lens = np.array([6, 3, 1, 0], np.int32)
    for i, n in enumerate(lens):
        ys[i, n:] = 0
    ys_in, ys_out = losses.add_sos_eos(_t(ys).long(), _t(lens).long(),
                                       V - 1, V - 1)
    ref_in, ref_out = jax_losses.add_sos_eos(jnp.asarray(ys),
                                             jnp.asarray(lens), V - 1, V - 1)
    np.testing.assert_array_equal(ys_in.numpy(), np.asarray(ref_in))
    np.testing.assert_array_equal(ys_out.numpy(), np.asarray(ref_out))
    logits = rng.randn(B, U + 1, V).astype(np.float32) * 3
    logits[0, 2, ys_out[0, 2]] += 10   # some right answers
    loss = losses.label_smoothing_loss(_t(logits), ys_out, 0.1, -1,
                                       normalize_length)
    ref = jax_losses.label_smoothing_loss(jnp.asarray(logits), ref_out, 0.1,
                                          -1, normalize_length)
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)
    acc = losses.accuracy(_t(logits), ys_out)
    np.testing.assert_allclose(
        float(acc), float(jax_losses.accuracy(jnp.asarray(logits),
                                              ref_out)), rtol=1e-7)


# ---- SpecAug ------------------------------------------------------

def test_specaug_semantics():
    g = torch.Generator().manual_seed(0)
    B, T, Fd = 64, 60, 80
    x = torch.randn(B, T, Fd).abs() + 1.0         # no zeros of its own
    lengths = torch.randint(20, T + 1, (B,), generator=g)
    lengths[0] = 11                               # too short to warp
    lengths[1] = T
    valid = torch.arange(T)[None] < lengths[:, None]
    x = x.masked_fill(~valid[..., None], 0.0)
    # frequency masks: whole bands of the feature axis, per utterance at
    # most num_mask bands of width < hi
    y = mask_along_axis(x, lengths, axis=2, generator=g,
                        mask_width_range=(0, 10), num_mask=2)
    masked = (y == 0) & valid[..., None]
    cols = masked[:, 0]
    assert torch.equal(masked, cols[:, None, :] & valid[..., None])
    assert int(cols.sum(dim=1).max()) <= 2 * 9
    assert int(cols.sum(dim=1).max()) > 0
    # time masks: whole frames, inside each utterance's length
    y = mask_along_axis(x, lengths, axis=1, generator=g,
                        mask_width_range=(0, 20), num_mask=2)
    rows = (y == 0).all(dim=2) & valid
    assert torch.equal((y == 0).any(dim=2) & valid, rows)
    assert int(rows.sum(dim=1).max()) <= 2 * 19
    assert int(rows.sum(dim=1).max()) > 0
    # time warp: padding untouched, frames only moved, short utterances
    # as they were
    y = time_warp(x, lengths, generator=g, window=5)
    assert torch.equal(y[~valid], x[~valid])
    assert torch.equal(y[0], x[0])
    for b in range(B):
        rows_b = {tuple(r) for r in x[b, :lengths[b]].tolist()}
        assert all(tuple(r) in rows_b for r in y[b, :lengths[b]].tolist())
    assert not torch.equal(y[1], x[1]) or not torch.equal(y[2], x[2])
    # the whole pipeline with the flagship's settings: padding untouched
    conf = dict(num_freq_mask=2, freq_mask_width_range=[0, 10],
                num_time_mask=2, time_mask_width_range=[0, 20])
    y = specaug(x, lengths, generator=g, **conf)
    assert torch.equal(y[~valid], x[~valid])


def test_specaug_only_in_training():
    cfg = dict(small_cfg(), specaug="specaug",
               specaug_conf={"num_freq_mask": 2,
                             "freq_mask_width_range": [0, 10]})
    model = build_model(cfg)
    batch = _torch_batch(_batch())
    seen = []
    real = model.normalize

    def spy(feats, lens):
        seen.append(feats.clone())
        return real(feats, lens)

    model.normalize = spy
    with torch.no_grad():
        model.eval().encode(batch["speech"], batch["speech_lengths"])
        model.train().encode(batch["speech"], batch["speech_lengths"],
                             torch.Generator().manual_seed(0))
    plain, augmented = seen
    assert not torch.equal(plain, augmented)
    feat_lens = batch["speech_lengths"] // 128 + 1   # centred STFT frames
    pad = torch.arange(plain.shape[1])[None] >= feat_lens[:, None]
    assert float(augmented[pad].abs().max()) == 0.0


# ---- dropout -------------------------------------------------------

def test_dropout_rates_and_modes():
    cfg = small_cfg(dropout_rate=0.2, positional_dropout_rate=0.15)
    cfg["decoder_conf"]["src_attention_dropout_rate"] = 0.05
    model = build_model(cfg)
    rates = {n: m.p for n, m in model.named_modules()
             if isinstance(m, torch.nn.Dropout)}
    enc = "encoder_mod"
    assert rates[f"{enc}.pos_enc.dropout"] == 0.15
    assert rates[f"{enc}.layers.1.dropout"] == 0.2
    assert rates[f"{enc}.layers.1.feed_forward.dropout"] == 0.2
    assert rates[f"{enc}.layers.0.feed_forward_macaron.dropout"] == 0.2
    # the JAX defaults where the config is silent
    assert rates["decoder_mod.pos_enc.dropout"] == 0.1
    assert rates["decoder_mod.layers.0.dropout"] == 0.1
    assert rates["decoder_mod.layers.0.feed_forward.dropout"] == 0.1
    assert rates["decoder_mod.layers.0.self_attn.dropout"] == 0.0
    assert rates["decoder_mod.layers.0.src_attn.dropout"] == 0.05
    assert model.encoder_mod.layers[0].self_attn.dropout_rate == 0.0
    batch = _torch_batch(_batch())
    with torch.no_grad():
        a = model.eval()(**batch)[0]
        b = model(**batch)[0]
        torch.manual_seed(0)
        c = model.train()(**batch, generator=torch.Generator())[0]
        torch.manual_seed(1)
        d = model(**batch, generator=torch.Generator())[0]
    assert float(a) == float(b)
    assert float(c) != float(d) and float(c) != float(a)


def test_attention_dropout_takes_the_explicit_path(monkeypatch):
    calls = []
    real = nn_attention.fused_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(nn_attention, "fused_attention", spy)
    model = build_model(small_cfg(attention_dropout_rate=0.1))
    batch = _torch_batch(_batch())
    with torch.no_grad():
        model.train()(**batch)
        assert calls == []
        model.eval()(**batch)
        assert len(calls) == 2   # one per conformer block


# ---- initialisation --------------------------------------------------

def test_init_statistics_match_flax():
    cfg = small_cfg()
    params = jax.jit(JaxASRTask.build_model(cfg).init)(
        jax.random.PRNGKey(3), **JaxASRTask.example_batch(cfg))
    ref = {k: np.asarray(v) for k, v in flatten_dict(params,
                                                     sep="/").items()}
    model = init_like_flax(build_model(cfg), torch.Generator().manual_seed(3))
    ours = convert.state_dict_to_flax(model)
    assert sorted(ours) == sorted(ref)
    for name, r in ref.items():
        o = ours[name]
        if r.std() == 0:       # zeros and ones
            np.testing.assert_array_equal(o, r)
            continue
        # sampling error of a std estimated from n draws: ~1/sqrt(2n)
        n = r.size
        assert abs(o.std() / r.std() - 1) < 6 / np.sqrt(2 * n) + 0.02, name
        assert abs(o.mean() - r.mean()) < 6 * r.std() / np.sqrt(n), name
        if name.endswith("kernel"):
            # lecun_normal: truncated at two of its standard deviations,
            # fan_in = every axis but the last of the flax kernel
            bound = 2 * np.sqrt(1 / np.prod(r.shape[:-1])) / TRUNC_STD
            assert np.abs(r).max() <= bound * (1 + 1e-6), name
            assert np.abs(o).max() <= bound * (1 + 1e-6), name


# ---- decoder and the whole model -----------------------------------

def test_teacher_forced_decoder_logits(small, record_property):
    cfg, jmodel, params, flat = small
    model = convert.load_flax_params(build_model(cfg), flat).eval()
    rng = np.random.RandomState(4)
    mem = rng.randn(3, 13, D).astype(np.float32)
    mlens = np.array([13, 9, 4])
    ys = rng.randint(0, 25, size=(3, 8))
    ylens = np.array([8, 5, 1])
    dec = {"params": params["params"]["decoder_mod"]}
    ref = JaxDecoder(25, D, 4, 128, 1).apply(
        dec, jnp.asarray(mem), jnp.asarray(mlens), jnp.asarray(ys),
        jnp.asarray(ylens))
    with torch.no_grad():
        out = model.decoder_mod(_t(mem), _t(mlens), _t(ys), _t(ylens))
    # O(1) logits through one fp32 layer
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    record_property("max_abs_err:decoder_logits",
                    float(np.abs(out.numpy() - np.asarray(ref)).max()))


def test_small_model_loss_and_every_gradient(small, record_property):
    cfg, jmodel, params, flat = small
    batch = _batch()

    def loss_fn(p):
        loss, stats, _ = jmodel.apply(p, **_jax_batch(batch),
                                      deterministic=True)
        return loss, stats

    (ref_loss, ref_stats), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    model = convert.load_flax_params(build_model(cfg), flat).eval()
    loss, stats, weight = model(**_torch_batch(batch))
    loss.backward()
    assert weight == 3
    assert set(stats) == set(ref_stats) == {"loss", "loss_ctc", "loss_att",
                                            "acc"}
    for key in stats:
        # losses of O(10) through two blocks and the decoder in fp32
        np.testing.assert_allclose(stats[key].item(),
                                   float(ref_stats[key]), rtol=2e-6,
                                   atol=1e-6)
    grads = convert.state_dict_to_flax(model, grad=True)
    ref_grads = {k: np.asarray(v)
                 for k, v in flatten_dict(ref_grads, sep="/").items()}
    assert sorted(grads) == sorted(ref_grads)
    for name in ("encoder_mod/layer0/self_attn/pos_bias_u",
                 "encoder_mod/layer1/self_attn/pos_bias_v",
                 "encoder_mod/layer0/self_attn/linear_pos/kernel",
                 "encoder_mod/layer1/self_attn/linear_q/kernel"):
        assert np.abs(grads[f"params/{name}"]).max() > 1e-4, name
    worst = 0.0
    for name, ref in ref_grads.items():
        # 1e-4 of each parameter's own gradient scale (observed ~1e-5),
        # and 1e-7 absolute for the key biases, whose gradient is zero by
        # the softmax's shift invariance and so is fp32 noise in both
        scale = np.abs(ref).max()
        np.testing.assert_allclose(grads[name], ref, rtol=0,
                                   atol=1e-4 * scale + 1e-7, err_msg=name)
        worst = max(worst, float(np.abs(grads[name] - ref).max()
                                 / max(scale, 1e-30)) if scale > 1e-6
                    else 0.0)
    record_property("max_rel_err:gradients", worst)


# ---- training steps ---------------------------------------------------

def _no_dropout_cfg():
    cfg = small_cfg(dropout_rate=0.0, positional_dropout_rate=0.0)
    cfg["decoder_conf"].update(dropout_rate=0.0, positional_dropout_rate=0.0)
    return cfg


LR, WARMUP = 1e-3, 10


@pytest.fixture(scope="module")
def jax_step(small):
    """The JAX package's train step (Adam, WarmupLR, clip 5) over the
    small model in its deterministic mode, and its optimizer."""
    _, jmodel, _, _ = small
    tx = jax_build_optimizer("adam", lr=LR, scheduler="warmuplr",
                             scheduler_conf={"warmup_steps": WARMUP},
                             grad_clip=5.0, flatten=True)
    return jax.jit(jax_make_train_step(
        lambda p, b, rngs: jmodel.apply(p, **b, deterministic=True),
        tx)), tx


def _port_step(flat):
    # dropout 0 and no SpecAug: training computes the eval function
    model = convert.load_flax_params(build_model(_no_dropout_cfg()), flat)
    opt = build_optimizer(dict(model.named_parameters()), "adam", lr=LR,
                          scheduler="warmuplr",
                          scheduler_conf={"warmup_steps": WARMUP},
                          grad_clip=5.0)
    return model, opt, make_train_step(model, opt)


def test_two_train_steps_match_jax(small, jax_step, record_property):
    _, _, params, flat = small
    jstep, tx = jax_step
    lr, warmup = LR, WARMUP
    model, opt, step = _port_step(flat)
    jparams, jopt = params, tx.init(params)
    grad_min = None
    batch = _batch()
    # the second batch at 1/20 of the amplitude: another gradient norm
    for i, scale in enumerate((1.0, 0.05)):
        b = dict(batch, speech=batch["speech"] * scale)
        jparams, jopt, jstats, _ = jstep(jparams, jopt, _jax_batch(b),
                                         jax.random.PRNGKey(i))
        stats, _ = step(_torch_batch(b))
        assert stats["skipped"] == float(jstats["skipped"]) == 0.0
        assert float(jstats["grad_norm"]) > 5.0    # clipping triggered
        np.testing.assert_allclose(stats["grad_norm"],
                                   float(jstats["grad_norm"]), rtol=1e-5)
        g = {k: np.abs(v) for k, v in
             convert.state_dict_to_flax(model, grad=True).items()}
        grad_min = g if grad_min is None else {
            k: np.minimum(grad_min[k], g[k]) for k in g}
        ours = convert.state_dict_to_flax(model)
        ref = {k: np.asarray(v)
               for k, v in flatten_dict(jparams, sep="/").items()}
        step_lr = lr * warmup ** 0.5 * min((i + 1) ** -0.5,
                                           (i + 1) * warmup ** -1.5)
        assert opt.count == i + 1
        # Adam's first updates are about lr * g / (|g| + 1e-8): where a
        # gradient is within fp32 noise of zero (below 1e-7 in one of
        # the steps) its sign is noise and the two may part by up to the
        # step size; elsewhere the deltas agree to 1e-2 of the LR
        worst = 0.0
        for name in ref:
            diff = np.abs((ours[name] - flat[name]) - (ref[name] - flat[name]))
            sure = grad_min[name] > 1e-7
            assert diff.max() <= 2 * step_lr, name
            if sure.any():
                assert diff[sure].max() <= 1e-2 * step_lr, name
                worst = max(worst, float(diff[sure].max() / step_lr))
        record_property(f"max_delta_err_over_lr:step{i + 1}", worst)


def test_non_finite_batch_is_skipped_in_both(small, jax_step):
    _, _, params, flat = small
    jstep, tx = jax_step
    model, opt, step = _port_step(flat)
    good = _batch()
    bad = dict(good, speech=good["speech"].copy())
    bad["speech"][1, 5] = np.nan
    jparams, jopt, _, _ = jstep(params, tx.init(params), _jax_batch(good),
                                jax.random.PRNGKey(0))
    step(_torch_batch(good))
    before = convert.state_dict_to_flax(model)
    opt_before = {k: {n: t.clone() if torch.is_tensor(t) else t
                      for n, t in v.items()}
                  for k, v in opt.torch_opt.state.items()}
    jparams2, jopt2, jstats, _ = jstep(jparams, jopt, _jax_batch(bad),
                                       jax.random.PRNGKey(1))
    stats, _ = step(_torch_batch(bad))
    assert stats["skipped"] == float(jstats["skipped"]) == 1.0
    assert not np.isfinite(stats["grad_norm"])
    for a, b in zip(jax.tree_util.tree_leaves((jparams2, jopt2)),
                    jax.tree_util.tree_leaves((jparams, jopt))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    after = convert.state_dict_to_flax(model)
    for name in before:
        np.testing.assert_array_equal(after[name], before[name])
    assert opt.count == 1
    for key, state in opt.torch_opt.state.items():
        for n, t in state.items():
            assert torch.equal(t, opt_before[key][n]), n


# ---- the flagship at full width ----------------------------------------

def test_flagship_full_width_eval_loss(record_property):
    corpus = SynthSpeechCorpus()
    utts = [corpus.utterance("test", i) for i in range(2)]
    tokens = read_token_list(FLAGSHIP / "tokens.txt")
    conv, tok = TokenIDConverter(tokens), CharTokenizer()
    ids = [conv.tokens2ids(tok.text2tokens(t)) for _, t, _ in utts]
    batch = {
        "speech": np.zeros((2, max(len(w) for w, _, _ in utts)), np.float32),
        "speech_lengths": np.array([len(w) for w, _, _ in utts], np.int32),
        "text": np.zeros((2, max(map(len, ids))), np.int32),
        "text_lengths": np.array([len(i) for i in ids], np.int32)}
    for j, ((w, _, _), i) in enumerate(zip(utts, ids)):
        batch["speech"][j, :len(w)] = w
        batch["text"][j, :len(i)] = i
    jax_s2t = JaxSpeech2Text(FLAGSHIP / "config.yaml", FLAGSHIP)
    ref_loss, ref_stats, _ = jax.jit(
        lambda p, b: jax_s2t.model.apply(p, **b, deterministic=True))(
        jax_s2t.params, _jax_batch(batch))
    model, _ = ASRTask.build_model_from_file(FLAGSHIP / "config.yaml",
                                             FLAGSHIP, "cpu")
    with torch.no_grad():
        loss, stats, _ = model(**_torch_batch(batch))
    # 6 blocks and 3 decoder layers at d=256 in fp32: about 1e-4 of it
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    for key in ("loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(float(stats[key]), float(ref_stats[key]),
                                   rtol=1e-4)
    record_property("flagship_loss", float(loss))
    record_property("flagship_loss_rel_diff",
                    abs(float(loss) / float(ref_loss) - 1))
