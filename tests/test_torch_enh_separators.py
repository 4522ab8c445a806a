"""The port's single-channel STFT separators against the JAX package, on
the CPU: DPRNN, TF-GridNet, BSRNN, DPTNet, SkiM (both memory types),
DC-CRN, the Transformer and Conformer separators and DCCRN, each in the
enhancement model at the JAX package's own small configurations
(tests/test_enh.py): the estimates and the separator's masks (or
complex masks, or spectra), the PIT loss and every gradient. Then the
pieces whose layouts flax has and torch lacks: the 2-D SAME transposed
convolution at odd and even F, ``_segment`` / ``_merge``, the LayerNorm
over two axes, flax's self-attention, and the auto-named PReLUs, each
with a case that the wrong layout fails.

Inputs and weights are made with numpy from a seed and fed to both
packages. Both compute in fp32 with sums in another order: estimates and
masks within 1e-5 of their largest entry, the loss within 1e-4 relative
and each gradient within 1e-4 of its own largest entry, or of the
model's largest gradient entry for a gradient below 1e-3 of that (one
that is zero in exact arithmetic, as TF-GridNet's key-norm biases under
the softmax, where both packages hold only rounding).
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models.enh import separators as jax_separators
from espnet_tpu_torch import convert
from espnet_tpu_torch.models.enh import separators
from espnet_tpu_torch.models.enh.model import EnhancementModel
from espnet_tpu_torch.nn.attention import SelfAttention
from espnet_tpu_torch.nn.convolution import SameConvTranspose2d
from tests.torch_enh_models import (flax_two_pass_variance, grad_errors,
                                    jax_outputs, leaves, models,
                                    port_outputs, rel, t)
from tests.torch_streaming_models import flax_params, xla_unoptimized


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


# the JAX package's own small configurations (tests/test_enh.py)
CASES = {
    "dprnn": {"num_blocks": 1, "chunk_size": 8, "hidden": 12,
              "bottleneck": 12},
    "tfgridnet": {"num_blocks": 1, "emb_dim": 8, "hidden": 12},
    "bsrnn": {"num_bands": 4, "feature_dim": 8, "hidden": 12,
              "num_blocks": 1},
    "dptnet": {"num_blocks": 1, "chunk_size": 8, "heads": 2, "hidden": 12,
               "bottleneck": 12},
    "skim": {"num_blocks": 1, "segment_size": 8, "hidden": 12,
             "bottleneck": 12},
    "skim_id": {"num_blocks": 1, "segment_size": 8, "hidden": 12,
                "bottleneck": 12, "mem_type": "id"},
    "dc_crn": {"enc_channels": (4, 8), "hidden": 12},
    "transformer": {"adim": 16, "aheads": 2, "layers": 1,
                    "linear_units": 24},
    "conformer": {"adim": 16, "aheads": 2, "layers": 1, "linear_units": 24,
                  "cnn_module_kernel": 7},
    "dccrn": {"enc_channels": (4, 8), "hidden": 12},
}




# a pair of PReLUs that each case's swapped weights exchange
SWAPPED_PRELUS = {"tfgridnet": ("PReLU_1", "PReLU_2"),
                  "dccrn": ("PReLU_4", "PReLU_5")}


def _models(case, seed=0):
    return models(case.split("_id")[0], CASES[case], seed)


@pytest.mark.parametrize("case", list(CASES))
def test_separator_estimates_loss_and_every_gradient_match_jax(
        case, record_property):
    jmod, tree, flat, model, batch = _models(case)
    # DCCRN's 4-channel LayerNorms: JAX's one-pass variance loses 2e-5 of
    # the masks there, so that case's JAX side takes it two-pass
    with (flax_two_pass_variance() if case == "dccrn"
          else contextlib.nullcontext()):
        want_ests, want_masks, want_loss, want_grads = jax_outputs(
            jmod, tree, batch)
    ests, masks, loss, stats, weight, grads = port_outputs(model, batch)
    errs = [rel(g.numpy(), w) for g, w in zip(ests, want_ests)]
    mask_errs = [rel(g, w) for g, w in zip(leaves(masks),
                                           leaves(want_masks))]
    assert len(ests) == 2 and len(mask_errs) == len(leaves(want_masks))
    assert set(grads) == set(want_grads) == set(flat)
    grad_err = max(grad_errors(grads, want_grads).values())
    loss_err = abs(loss.item() - want_loss) / abs(want_loss)
    record_property(f"rel_err:{case}", [max(errs), max(mask_errs),
                                        loss_err, grad_err])
    assert max(errs) <= 1e-5 and max(mask_errs) <= 1e-5
    assert loss_err <= 1e-4 and grad_err <= 1e-4
    assert weight == 2.0 and stats["si_snr"].item() == -loss.item()
    # and the converter writes the tree back as it read it
    back = convert.state_dict_to_flax(model)
    assert all(np.array_equal(back[k], v) for k, v in flat.items())
    if case in SWAPPED_PRELUS:
        # flax numbers its unnamed PReLUs in the order it creates them: a
        # swapped pair moves the estimates far past the tolerance
        a, b = (f"params/separator_mod/{n}/negative_slope"
                for n in SWAPPED_PRELUS[case])
        convert.load_flax_params(model, dict(flat, **{a: flat[b],
                                                      b: flat[a]}))
        with torch.no_grad():
            swapped, _, _ = model.forward_enhance(
                t(batch["speech_mix"]), t(batch["speech_mix_lengths"]))
        assert min(rel(g.numpy(), w) for g, w in zip(swapped,
                                                     want_ests)) > 1e-3


def test_registry_follows_jax_and_defers_the_rest():
    # every name of the JAX registry, in its order; the deferred ones
    # raise naming ROADMAP A.4
    assert list(separators.SEPARATORS) == list(jax_separators.SEPARATORS)
    for name in ("svoice", "fasnet", "uses", "uses2", "tfgridnetv2",
                 "tfgridnetv3", "ineube", "neural_beamformer", "asteroid"):
        with pytest.raises(NotImplementedError, match="ROADMAP A.4"):
            EnhancementModel(separator=name)


# ---- layouts ----------------------------------------------------------------

@pytest.mark.parametrize("kernel,stride,F", [
    ((1, 3), (1, 2), 9), ((1, 3), (1, 2), 8), ((2, 5), (1, 2), 9),
    ((2, 5), (1, 2), 8), ((3, 2), (2, 3), 7)])
def test_same_transposed_conv2d_matches_flax(kernel, stride, F,
                                             record_property):
    # flax's SAME ConvTranspose on (B, T, F, C) at odd and even F: the
    # converter flips the kernel in both axes, the module crops each axis;
    # loaded unflipped it is far off
    x = np.random.RandomState(F).randn(2, 5, F, 3).astype(np.float32)
    jmod = fnn.ConvTranspose(4, kernel, strides=stride, padding="SAME")
    flat, tree = flax_params(jmod, jnp.asarray(x), seed=F)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    mod = convert.load_flax_params(SameConvTranspose2d(3, 4, kernel, stride),
                                   flat)
    assert np.array_equal(convert.state_dict_to_flax(mod)["params/kernel"],
                          flat["params/kernel"])
    with torch.no_grad():
        got = mod(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, 5 * stride[0], F * stride[1],
                                           4)
        err = rel(got, want)
        mod.weight.copy_(t(flat["params/kernel"].transpose(2, 3, 0, 1)))
        unflipped = mod(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    record_property("rel_err:conv_transpose2d", err)
    assert err <= 1e-6
    assert rel(unflipped.numpy(), want) > 1e-2


@pytest.mark.parametrize("K,T", [(8, 16), (8, 5), (7, 23), (40, 101)])
def test_segment_and_merge_match_jax(K, T):
    # the chunks equal JAX's gather; the overlap-add average equals JAX's
    # scatter-add within rounding (an odd K puts three chunks on some
    # frames), and so does its gradient
    rng = np.random.RandomState(K + T)
    x = rng.randn(2, T, 3).astype(np.float32)
    seg, tp = separators._segment(t(x), K)
    chunks = rng.randn(*seg.shape).astype(np.float32)
    w = rng.randn(2, T, 3).astype(np.float32)

    def jax_side(x_, c_):
        merged, vjp = jax.vjp(lambda c: jax_separators._merge(c, T), c_)
        return jax_separators._segment(x_, K)[0], merged, vjp(w)[0]

    want_seg, want_merged, want_grad = jax.jit(jax_side)(jnp.asarray(x),
                                                         jnp.asarray(chunks))
    assert tp == (seg.shape[1] - 1) * (K // 2) + K >= T
    assert np.array_equal(seg.numpy(), want_seg)
    c = t(chunks).requires_grad_()
    merged = separators._merge(c, T)
    (merged * t(w)).sum().backward()
    assert merged.shape == (2, T, 3)
    assert rel(merged.detach().numpy(), want_merged) <= 1e-6
    assert rel(c.grad.numpy(), want_grad) <= 1e-6


def test_two_axis_layer_norm_matches_flax_and_per_bin_params_do_not_load():
    # flax's LayerNorm(reduction_axes=(-2, -1)): statistics over (F, E),
    # scale and bias per E; a norm over E alone is far off, and
    # torch's LayerNorm((F, E)) holds a scale per (F, E) that the
    # converter refuses
    x = (np.random.RandomState(0).randn(2, 3, 7, 4) * 2 + 1).astype(
        np.float32)
    jmod = fnn.LayerNorm(reduction_axes=(-2, -1))
    flat, tree = flax_params(jmod, jnp.asarray(x), seed=1)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    assert flat["params/scale"].shape == (4,)
    mod = convert.load_flax_params(separators.TwoAxisLayerNorm(4), flat)
    with torch.no_grad():
        assert rel(mod(t(x)).numpy(), want) <= 1e-6
        per_channel = torch.nn.functional.layer_norm(
            t(x), (4,), mod.weight, mod.bias, 1e-6)
    assert rel(per_channel.numpy(), want) > 1e-2
    with pytest.raises(ValueError, match="shape"):
        convert.load_flax_params(torch.nn.LayerNorm((7, 4)), flat)


def test_flax_self_attention_layout():
    # flax's SelfAttention: query/key/value kernels (D, H, dk), out
    # (H, dk, D); 1/sqrt(dk) scaling
    x = np.random.RandomState(3).randn(2, 9, 12).astype(np.float32)
    jmod = fnn.SelfAttention(num_heads=3, deterministic=True)
    flat, tree = flax_params(jmod, jnp.asarray(x), seed=2)
    assert flat["params/query/kernel"].shape == (12, 3, 4)
    assert flat["params/out/kernel"].shape == (3, 4, 12)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    mod = convert.load_flax_params(SelfAttention(12, 3), flat)
    with torch.no_grad():
        assert rel(mod(t(x)).numpy(), want) <= 1e-6
    back = convert.state_dict_to_flax(mod)
    assert all(np.array_equal(back[k], v) for k, v in flat.items())


def test_entry_points_need_a_card_or_the_cpu(tmp_path):
    # SeparateSpeech and enh_train with a new separator (a small
    # Conformer, the attention kernels' path): without a card each raises
    # unless the CPU is asked for; on the CPU the model separates, and
    # the entry point takes a training step
    from espnet_tpu_torch.bin import enh_train
    from espnet_tpu_torch.bin.enh_inference import SeparateSpeech
    from espnet_tpu_torch.data.synth_speech import SynthMixCorpus
    from espnet_tpu_torch.utils.config import dump_yaml
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, flat, _, _ = _models("conformer")
    np.savez(tmp_path / "seed.npz", **flat)
    SynthMixCorpus(seconds=0.25).materialize(tmp_path / "data", n_train=2,
                                             n_valid=0, n_test=0)
    d = tmp_path / "data" / "train"
    cfg = {"output_dir": str(tmp_path / "exp"), "max_epoch": 1,
           "num_iters_per_epoch": 1, "batch_size": 2,
           "encoder_conf": {"n_fft": 128, "hop_length": 64},
           "separator": "conformer", "separator_conf": CASES["conformer"],
           "init_param": str(tmp_path / "seed.npz"),
           "train_data_path_and_name_and_type": [
               f"{d}/wav.scp,speech_mix,sound",
               f"{d}/spk1.scp,speech_ref1,sound",
               f"{d}/spk2.scp,speech_ref2,sound"]}
    dump_yaml(cfg, tmp_path / "config.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SeparateSpeech(tmp_path / "config.yaml", tmp_path / "seed.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enh_train.main(["--config", str(tmp_path / "config.yaml")])
    sep = SeparateSpeech(tmp_path / "config.yaml", tmp_path / "seed.npz",
                         device="cpu")
    ests = sep(np.random.RandomState(1).randn(2, 900).astype(np.float32))
    assert [e.shape for e in ests] == [(2, 900)] * 2
    _, trainer = enh_train.main(["--config", str(tmp_path / "config.yaml"),
                                 "--device", "cpu"])
    assert len(trainer.step_stats) == 1
    assert np.isfinite(trainer.step_stats[0]["loss"])
