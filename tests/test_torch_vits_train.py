"""The port's VITS training slice against the JAX package, on the CPU:
monotonic alignment search, the HiFi-GAN discriminators and losses, the
training forward, both turns of the GAN step with every gradient, two
GAN steps, the per-turn skip, the GAN tree's converter, the
``init_param`` load of the asset, and the entry point.

A small VITS (tests/test_vits.py's small_conf: z 8, hidden 16, 1 text
block, generator 16 channels x4 x8; periods (2, 3), 1 scale) whose
weights fill the JAX tree from a numpy seed. The JAX side runs with
dropout off on the same draws (scripts/jax_vits_train_reference.py:
jax_vits_train_forward, jax_gan_apply); so does the port, its dropouts
at 0. Paths and durations are integers and must be equal; activations
and losses are fp32 in another order: 1e-5 of the largest entry for the
discriminators' outputs, 1e-6 relative for the losses on the same
inputs, 1e-4 of the largest entry for the training forward, the losses
and each gradient of a turn; after two steps the stats to 1e-4 and the
parameters as Adam allows (see the test).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import optax
from flax.traverse_util import flatten_dict, unflatten_dict

from espnet_tpu.models.tts import hifigan as jax_hifigan
from espnet_tpu.models.tts.vits_gan import VITSGan as JaxVITSGan
from espnet_tpu.ops.monotonic_align import maximum_path as jax_mas
from espnet_tpu.train.gan_trainer import make_gan_train_step as jax_step
from espnet_tpu.train.optim import build_optimizer as jax_optimizer
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import gan_tts_train
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.models.tts import hifigan
from espnet_tpu_torch.models.tts.vits_gan import VITSGan
from espnet_tpu_torch.ops.monotonic_align import maximum_path
from espnet_tpu_torch.tasks.abs_task import load_packed_config
from espnet_tpu_torch.tasks.gan_tts import GANTTSTask
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.train.gan_trainer import (GANOptimizers,
                                                make_gan_train_step)
from espnet_tpu_torch.train.optim import build_optimizer
from espnet_tpu_torch.utils.config import dump_yaml
from scripts.jax_vits_train_reference import (jax_gan_apply,
                                              jax_vits_train_forward)
from tests.torch_streaming_models import flax_params, xla_unoptimized

ROOT = Path(__file__).resolve().parents[1]
ASSET = ROOT / "assets" / "synth_tts_vits"
V = 6
REL = 1e-5
LOSS_REL = 1e-6
GRAD_REL = 1e-4
SMALL = dict(z_channels=8, hidden=16, spec_channels=33, segment_frames=8,
             hop_length=32,
             text_encoder_conf=dict(output_size=16, attention_heads=2,
                                    linear_units=24, num_blocks=1,
                                    input_layer="embed"),
             generator_conf=dict(channels=16, upsample_scales=(4, 8),
                                 upsample_kernel_sizes=(8, 16),
                                 resblock_kernel_sizes=(3,),
                                 resblock_dilations=((1, 3),)))
GAN = dict(fs=8000, n_fft=64, hop_length=32, n_mels=12,
           discriminator_conf=dict(periods=(2, 3), scales=1))
ADAM = dict(lr=2e-4, betas=(0.8, 0.99))


@pytest.fixture(autouse=True, scope="module")
def jax_references_unoptimized():
    """The JAX references compile without XLA's optimisations: they run
    once, at small shapes, where compiling is most of their time."""
    with xla_unoptimized():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), err
    return err


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _batch(B=3, S=6, T=24, seed=0):
    """Ragged text and frames; a wave of T frames of hop 32 and its
    linear spectrogram (n_fft 64)."""
    rng = np.random.RandomState(seed)
    wav = (0.1 * rng.randn(B, T * 32 + 32)).astype(np.float32)
    win = np.hanning(65)[:-1]
    frames = np.stack([wav[:, i * 32:i * 32 + 64] for i in range(T)], 1)
    spec = np.abs(np.fft.rfft(frames * win, axis=-1)).astype(np.float32)
    return {"text": rng.randint(1, V, (B, S)).astype(np.int32),
            "text_lengths": np.asarray([S, S - 2, 3][:B], np.int32),
            "spec": spec,
            "spec_lengths": np.asarray([T, T - 6, 11][:B], np.int32),
            "speech": wav}


def _draws(b, seed):
    rng = np.random.RandomState(seed)
    B, T = b["spec"].shape[:2]
    return {"noise": rng.randn(B, T, SMALL["z_channels"]).astype(
        np.float32),
            "starts": (rng.randint(0, 2 ** 30, B) % np.maximum(
                b["spec_lengths"] - SMALL["segment_frames"], 1)).astype(
                np.int32)}


def _torch_batch(b):
    return {k: (_t(v).long() if v.dtype == np.int32 else _t(v))
            for k, v in b.items()}


@pytest.fixture(scope="module")
def small_gan():
    """The JAX container, its tree filled from a numpy seed (the
    duration predictor's bias near log 3), the port's model (dropouts
    at 0) with the same weights, and the flat GAN dict."""
    jgan = JaxVITSGan(vocab_size=V, vits_conf=SMALL, **GAN)
    b = _batch()
    gflat, _ = flax_params(jgan.generator, b["text"], b["text_lengths"],
                           b["spec"], b["spec_lengths"],
                           jax.random.PRNGKey(0), seed=3)
    gflat["params/duration_predictor/linear/bias"] = np.asarray(
        [1.2], np.float32)
    seg = SMALL["segment_frames"] * SMALL["hop_length"]
    dflat, _ = flax_params(jgan.discriminator, np.zeros((1, seg),
                                                         np.float32), seed=4)
    flat = {**{f"generator/{k}": v for k, v in gflat.items()},
            **{f"discriminator/{k}": v for k, v in dflat.items()}}
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    model = _no_dropout(VITSGan(V, vits_conf=SMALL, **GAN))
    convert.load_flax_params(model, flat)
    return jgan, tree, model, flat


def test_maximum_path_equals_jax():
    # integer scores: ties everywhere; ragged lengths (a frame count of 1
    # among them), S = T
    rng = np.random.RandomState(0)
    jmas = jax.jit(jax_mas)
    for B, S, T, tl, fl in ((4, 7, 15, [7, 5, 1, 3], [15, 9, 1, 3]),
                            (2, 6, 6, [6, 4], [6, 6])):
        for scores in (rng.randint(-2, 2, (B, S, T)),
                       rng.randn(B, S, T) * 3):
            value = scores.astype(np.float32)
            ref = np.asarray(jmas(jnp.asarray(value), jnp.asarray(tl),
                                  jnp.asarray(fl)))
            ours = maximum_path(_t(value), _t(tl), _t(fl)).numpy()
            np.testing.assert_array_equal(ours, ref)
    # T = 1, which the JAX function cannot trace (its backtrack reads the
    # empty choice array): the one path, frame 0 on token 0
    value = rng.randn(2, 3, 1).astype(np.float32)
    ours = maximum_path(_t(value), _t([1, 1]), _t([1, 1])).numpy()
    np.testing.assert_array_equal(ours[:, :, 0], [[1, 0, 0], [1, 0, 0]])


def test_discriminators_at_odd_lengths():
    """Scores and every feature map of a period discriminator, the scale
    discriminator and the multi-discriminator (2 scales) on a wave of 301
    samples: no multiple of the periods 2, 3 and 5 or of the stride 4, and
    neither are the lengths the strided layers see."""
    S = 301
    x = (0.3 * np.random.RandomState(S).randn(2, S)).astype(np.float32)
    cases = [(jax_hifigan.PeriodDiscriminator(3),
              hifigan.PeriodDiscriminator(3), (0, 2, 3, 1)),
             (jax_hifigan.ScaleDiscriminator(),
              hifigan.ScaleDiscriminator(), (0, 2, 1)),
             (jax_hifigan.HiFiGANMultiDiscriminator((2, 5), 2),
              hifigan.HiFiGANMultiDiscriminator((2, 5), 2), None)]
    for jmod, mod, perm in cases:
        flat, tree = flax_params(jmod, x, seed=5)
        ref = jax.jit(jmod.apply)(tree, jnp.asarray(x))
        convert.load_flax_params(mod, flat)
        with torch.no_grad():
            out = mod(_t(x))
        pairs = [(out, ref)] if perm is not None else list(zip(out, ref))
        for (score, feats), (rscore, rfeats) in pairs:
            _close(score.numpy(), rscore, REL)
            assert len(feats) == len(rfeats)
            for f, rf in zip(feats, rfeats):
                p = perm or ((0, 2, 3, 1) if f.dim() == 4 else (0, 2, 1))
                _close(f.permute(*p).numpy(), rf, REL)


def test_losses_on_the_same_inputs():
    rng = np.random.RandomState(1)

    def outs():
        return [(rng.randn(2, 7).astype(np.float32),
                 [rng.randn(2, 4, 3).astype(np.float32) for _ in range(3)])
                for _ in range(3)]

    real, fake = outs(), outs()

    def as_t(o):
        return [(_t(s), [_t(f) for f in fs]) for s, fs in o]

    def as_j(o):
        return [(jnp.asarray(s), [jnp.asarray(f) for f in fs])
                for s, fs in o]

    pairs = [(hifigan.generator_adv_loss(as_t(fake)),
              jax_hifigan.generator_adv_loss(as_j(fake))),
             (hifigan.discriminator_adv_loss(as_t(real), as_t(fake)),
              jax_hifigan.discriminator_adv_loss(as_j(real), as_j(fake))),
             (hifigan.feature_match_loss(as_t(real), as_t(fake)),
              jax_hifigan.feature_match_loss(as_j(real), as_j(fake)))]
    w1, w2 = (0.2 * rng.randn(2, 8192).astype(np.float32) for _ in range(2))
    for kw in (dict(fs=16000, n_fft=512, hop_length=128, n_mels=80),
               dict(fs=8000, n_fft=100, hop_length=30, n_mels=12)):
        pairs.append((hifigan.mel_spectrogram_loss(_t(w1), _t(w2), **kw),
                      jax.jit(lambda a, b, kw=kw: jax_hifigan
                              .mel_spectrogram_loss(a, b, **kw))(w1, w2)))
    for ours, ref in pairs:
        _close(float(ours), float(ref), LOSS_REL)


def _jax_forward(jgan, tree, b, d):
    return jax.jit(lambda p, bb: jgan.generator.apply(
        p, bb["text"], bb["text_lengths"], bb["spec"], bb["spec_lengths"],
        bb["noise"], bb["starts"], method=jax_vits_train_forward))(
        tree["generator"], {**b, **d})


def test_training_forward_on_given_draws(small_gan):
    jgan, tree, model, _ = small_gan
    b = _batch()
    d = _draws(b, 7)
    ref = _jax_forward(jgan, tree, b, d)
    tb = _torch_batch(b)
    model.train()
    with torch.no_grad():
        out = model.generator(tb["text"], tb["text_lengths"], tb["spec"],
                              tb["spec_lengths"], _t(d["noise"]),
                              _t(d["starts"]).long())
    np.testing.assert_array_equal(out["durations"].numpy(),
                                  np.asarray(ref["durations"]))
    assert int(out["durations"][1].sum()) == b["spec_lengths"][1]
    for key in ("kl_loss", "dur_loss"):
        _close(float(out[key]), float(ref[key]), GRAD_REL)
    _close(out["wav_hat"].numpy(), ref["wav_hat"], GRAD_REL)


def _flat(tree):
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(dict(tree)).items()}


def _recording(tx):
    """``tx`` that also keeps the gradient of its last update in its
    state: the JAX step then gives each turn's gradient."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                       params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _port_optimizers(model):
    return GANOptimizers(
        build_optimizer(dict(model.generator.named_parameters()),
                        grad_clip=-1, **ADAM),
        build_optimizer(dict(model.discriminator.named_parameters()),
                        grad_clip=-1, **ADAM))


@pytest.fixture(scope="module")
def two_steps(small_gan):
    """Two GAN steps (Adam 2e-4, betas (0.8, 0.99), no clipping) on two
    batches and their draws, by the JAX package's make_gan_train_step and
    the port's: the stats of each step, the gradients of each turn of the
    first step (the discriminator's at the generator's updated
    parameters), and the parameters at the end."""
    jgan, tree, _, flat = small_gan
    model = _no_dropout(VITSGan(V, vits_conf=SMALL, **GAN))
    convert.load_flax_params(model, flat)
    step = make_gan_train_step(model, _port_optimizers(model))
    tx_g, tx_d = (_recording(jax_optimizer("adam", grad_clip=-1, **ADAM))
                  for _ in range(2))
    jstep = jax.jit(jax_step(
        lambda p, bb, rngs, fg: jax_gan_apply(jgan, p, bb, fg), tx_g, tx_d))
    opt = jax.jit(lambda t: (tx_g.init(t["generator"]),
                             tx_d.init(t["discriminator"])))(tree)
    p, out = tree, {"stats": [], "jax_stats": []}
    for i in range(2):
        b = _batch(seed=10 + i)
        d = _draws(b, 20 + i)
        p, opt, jstats, _ = jstep(p, opt, {k: jnp.asarray(v) for k, v in
                                           {**b, **d}.items()},
                                  jax.random.PRNGKey(i))
        stats, _ = step(_torch_batch(b), draws={
            "noise": _t(d["noise"]), "starts": _t(d["starts"]).long()})
        out["stats"].append(stats)
        out["jax_stats"].append({k: float(v) for k, v in jstats.items()})
        if i == 0:
            out["grads"] = {part: convert.state_dict_to_flax(
                getattr(model, part), grad=True)
                for part in ("generator", "discriminator")}
            out["jax_grads"] = {"generator": _flat(opt[0][1]),
                                "discriminator": _flat(opt[1][1])}
    out["params"] = convert.state_dict_to_flax(model)
    out["jax_params"] = _flat(p)
    return out


def test_both_turns_loss_and_every_gradient(two_steps):
    stats, jstats = two_steps["stats"][0], two_steps["jax_stats"][0]
    assert stats["skipped"] == stats["skipped_d"] == 0.0
    for k, v in jstats.items():
        _close(stats[k], v, GRAD_REL)
    for part, jgrads in two_steps["jax_grads"].items():
        grads = two_steps["grads"][part]
        assert sorted(grads) == sorted(jgrads)
        top = max(float(np.abs(g).max()) for g in jgrads.values())
        for name, g in jgrads.items():
            err = float(np.abs(grads[name] - g).max())
            assert err <= GRAD_REL * top, (part, name, err, top)


def test_two_gan_steps_end_where_jax_does(two_steps):
    for stats, jstats in zip(two_steps["stats"], two_steps["jax_stats"]):
        for k, v in jstats.items():
            _close(stats[k], v, GRAD_REL)
    # Adam moves an entry by ~lr whatever its gradient's size, so an
    # entry whose gradient is rounding noise (the attention key bias's
    # exact gradient is 0) may step the other way: every entry within
    # 4 lr of JAX's, all but 1e-3 of them within 1e-6 (measured: 1270 of
    # 9.1 M entries, 7.4e-4 at most)
    ours, ref = two_steps["params"], two_steps["jax_params"]
    assert sorted(ours) == sorted(ref)
    diffs = np.concatenate([np.abs(ours[k] - v).ravel()
                            for k, v in ref.items()])
    assert diffs.max() <= 4 * ADAM["lr"]
    assert (diffs > 1e-6).mean() <= 1e-3


@pytest.mark.parametrize("bad", ["generator", "discriminator"])
def test_a_non_finite_turn_is_skipped_alone(small_gan, bad):
    """A NaN gradient in one part skips that turn: its parameters and its
    optimizer state stay as they were; the other turn updates."""
    _, _, _, flat = small_gan
    model = _no_dropout(VITSGan(V, vits_conf=SMALL, **GAN))
    convert.load_flax_params(model, flat)
    opts = _port_optimizers(model)
    step = make_gan_train_step(model, opts)
    b = _batch()
    tb, d = _torch_batch(b), _draws(b, 1)
    draws = {"noise": _t(d["noise"]), "starts": _t(d["starts"]).long()}
    step(tb, draws=draws)            # Adam's moments are not zero
    before = {part: convert.state_dict_to_flax(getattr(model, part))
              for part in ("generator", "discriminator")}
    opt_before = {part: {k: v.clone() for k, v in getattr(
        opts, part).torch_opt.state[next(iter(getattr(
            model, part).parameters()))].items()}
        for part in ("generator", "discriminator")}
    handle = next(iter(getattr(model, bad).parameters())).register_hook(
        lambda g: g * float("nan"))
    stats, _ = step(tb, draws=draws)
    handle.remove()
    good = "discriminator" if bad == "generator" else "generator"
    assert stats["skipped" if bad == "generator" else "skipped_d"] == 1.0
    assert stats["skipped_d" if bad == "generator" else "skipped"] == 0.0
    after = {part: convert.state_dict_to_flax(getattr(model, part))
             for part in ("generator", "discriminator")}
    assert all(np.array_equal(after[bad][k], v)
               for k, v in before[bad].items())
    assert any(not np.array_equal(after[good][k], v)
               for k, v in before[good].items())
    state = getattr(opts, bad).torch_opt.state[next(iter(getattr(
        model, bad).parameters()))]
    for k, v in opt_before[bad].items():
        assert torch.equal(state[k], v), k


def test_skip_discriminator_prob_one_skips_every_discriminator_turn(
        small_gan):
    """The coin of skip_discriminator_prob 1 skips the discriminator's
    turn: its parameters stay; the generator's turn runs first and
    updates."""
    _, _, _, flat = small_gan
    model = _no_dropout(VITSGan(V, vits_conf=SMALL, **GAN))
    convert.load_flax_params(model, flat)
    step = make_gan_train_step(model, _port_optimizers(model),
                               skip_discriminator_prob=1.0)
    stats, _ = step(_torch_batch(_batch()), torch.Generator())
    assert (stats["skipped"], stats["skipped_d"]) == (0.0, 1.0)
    after = convert.state_dict_to_flax(model)
    assert all(np.array_equal(after[k], v) for k, v in flat.items()
               if k.startswith("discriminator/"))
    assert any(not np.array_equal(after[k], v) for k, v in flat.items()
               if k.startswith("generator/"))


def test_gan_tree_converter_round_trip(small_gan):
    """The port writes the JAX container's tree, generator/params/... and
    discriminator/params/... with the JAX layouts, and reads it back;
    a tree of other parts raises."""
    _, tree, model, flat = small_gan
    back = convert.state_dict_to_flax(model)
    assert sorted(back) == sorted(_flat(tree)) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    with pytest.raises(KeyError):
        convert.load_flax_params(model, {f"params/{k}": v
                                         for k, v in flat.items()})


def test_init_param_sets_every_array_of_the_asset():
    """The asset's generator (201 arrays) and discriminator (54) both
    load whole."""
    model = GANTTSTask.build_model(load_packed_config(ASSET / "config.yaml"))
    GANTTSTask.load_pretrained(model, str(ASSET))
    assert model.init_param_counts == {"generator": 201,
                                       "discriminator": 54}
    flat = convert.read_npz(ASSET / "params_f16.npz")
    ours = convert.state_dict_to_flax(model)
    assert sorted(ours) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_init_param_refuses_a_part_left_out(small_gan, tmp_path):
    """A spec that sets the generator and nothing of the discriminator
    (here by excluding it) raises, naming the part; a spec whose dst_key
    names the generator asks for it alone."""
    _, _, _, flat = small_gan
    np.savez(tmp_path / "gan.npz", **flat)
    model = VITSGan(V, vits_conf=SMALL, **GAN)
    with pytest.raises(ValueError, match="discriminator"):
        GANTTSTask.load_pretrained(model, f"{tmp_path / 'gan.npz'}:::"
                                          f"discriminator")
    GANTTSTask.load_pretrained(model, f"{tmp_path / 'gan.npz'}:generator:"
                                      f"generator")
    assert model.init_param_counts == {"generator": len(flat) - sum(
        k.startswith("discriminator/") for k in flat)}


def _tiny_cfg(root, **extra):
    toks = ["<blank>"] + list("abcdefghijklmnopqrstuvwxyz") + [
        "<space>", "<sos/eos>"]
    (root / "tokens.txt").write_text("\n".join(toks) + "\n")
    data = root / "data"
    return {"token_list": str(root / "tokens.txt"), "token_type": "char",
            "fs": 16000, "n_fft": 64, "hop_length": 32, "n_mels": 12,
            "tts_conf": SMALL, "discriminator_conf": GAN[
                "discriminator_conf"],
            "grad_clip": -1, "optim_conf": dict(ADAM),
            "optim2_conf": dict(ADAM), "batch_type": "sorted",
            "batch_size": 2, "max_epoch": 1, "num_iters_per_epoch": 1,
            "log_interval": 1, "max_wav_length": 4096,
            "collate_fixed_lengths": {"text": 40, "speech": 4096,
                                      "spec": 127},
            "train_data_path_and_name_and_type": [
                f"{data}/train/text,text,text",
                f"{data}/train/wav.scp,speech,sound"],
            "valid_data_path_and_name_and_type": [
                f"{data}/valid/text,text,text",
                f"{data}/valid/wav.scp,speech,sound"],
            "device": "cpu", **extra}


def test_entry_point_trains_checkpoints_and_resumes(tmp_path):
    """gan_tts_train on a tiny config, one step an epoch: two epochs in
    one run end bit-identical to one epoch and a resumed one, both
    optimizers' states in the checkpoint."""
    SynthSpeechCorpus().materialize(tmp_path / "data", n_train=4,
                                    n_valid=2, n_test=0, speaker_ids=[0])
    runs, trainers = {}, {}
    for name, stops in (("whole", [2]), ("resumed", [1, 2])):
        for max_epoch in stops:
            cfg = _tiny_cfg(tmp_path, output_dir=str(tmp_path / name),
                            max_epoch=max_epoch, resume=True)
            dump_yaml(cfg, tmp_path / f"{name}.yaml")
            _, trainers[name] = gan_tts_train.main(
                ["--config", str(tmp_path / f"{name}.yaml")])
        runs[name] = load_checkpoint(tmp_path / name / "checkpoint",
                                     with_opt=True)
    trainer = trainers["whole"]
    steps = trainer.step_stats
    assert len(steps) == 2 and all(np.isfinite(s["generator_loss"])
                                   and np.isfinite(s["discriminator_loss"])
                                   for s in steps)
    (a, opt_a, meta_a), (b, opt_b, meta_b) = runs["whole"], runs["resumed"]
    assert sorted(a) == sorted(b) and {k.split("/")[0] for k in a} == {
        "generator", "discriminator"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert meta_a["epoch"] == meta_b["epoch"] == 2
    assert set(opt_a) == {"generator", "discriminator"}
    assert opt_a["generator"]["count"] == opt_b["generator"]["count"] == 2
    valid = trainer.reporter.stats[2]["valid"]
    assert valid["loss"] == valid["generator_loss"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gan_tts_train.main(["--config", str(tmp_path / "whole.yaml"),
                                "--device", "null"])
