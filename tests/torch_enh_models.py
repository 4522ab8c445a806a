"""Shared by the port's separator tests: the JAX and port enhancement
models of one separator with the same weights, one compile of the JAX
side's outputs, and the error measures the tests hold them to.

The weights fill the parameter tree that the port's model writes
(``convert.state_dict_to_flax``) from a numpy seed, key by key in sorted
order at init scale, as ``tests/torch_streaming_models.py:flax_params``
does for the JAX tree, without tracing the JAX init. A JAX parameter the
port lacks makes the JAX apply raise; one that only the port has gets a
zero JAX gradient beside the port's own, which the gradient check sees.
"""

import contextlib
import functools

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import torch

from espnet_tpu.models.enh import losses as jax_losses
from espnet_tpu.models.enh.model import EnhancementModel as JaxEnhancement
from espnet_tpu_torch import convert
from espnet_tpu_torch.models.enh.model import EnhancementModel


def t(x):
    return torch.from_numpy(np.array(x))


def rel(a, b) -> float:
    """Largest |a - b| over b's largest entry."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def grad_errors(grads, want) -> dict:
    """Each gradient's largest difference over its scale: its own largest
    entry, or the model's largest where its own lies below 1e-3 of it
    (a gradient that is zero in exact arithmetic)."""
    top = max(float(np.abs(v).max()) for v in want.values())
    out = {}
    for k, v in want.items():
        own = float(np.abs(v).max())
        scale = own if own >= 1e-3 * top else top
        out[k] = float(np.abs(grads[k] - v).max()) / max(scale, 1e-30)
    return out


def leaves(masks):
    """A separator's outputs as a flat list of arrays: masks, or each
    speaker's (real, imag) pair."""
    out = []
    for m in masks:
        out.extend(m if isinstance(m, (tuple, list)) else [m])
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
            for x in out]


def seeded(shapes: dict, seed: int) -> dict:
    """{key: shape} -> {key: float32 array} from RandomState(seed): kernels
    N(0, 1 / fan-in), LayerNorm scales 1 + N(0, 0.05^2), the rest
    N(0, 0.05^2)."""
    rng = np.random.RandomState(seed)
    flat = {}
    for key in sorted(shapes):
        shape, name = tuple(shapes[key]), key.rsplit("/", 1)[-1]
        x = np.asarray(rng.randn(*shape))
        if name == "kernel":
            x = x / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.05 * x
        else:
            x = 0.05 * x
        flat[key] = x.astype(np.float32)
    return flat


def models(sep, conf, seed=0, B=2, S=1000, **model_kw):
    """The JAX and port models of one separator (n_fft 128, hop 64, two
    speakers) with the same weights, and a batch: mixtures of two
    references, ragged lengths. -> (JAX module, its tree, the flat
    weights, the port's model, the batch)."""
    kw = dict(num_spk=2, n_fft=128, hop_length=64, separator=sep,
              separator_conf=dict(conf), **model_kw)
    model = EnhancementModel(**kw)
    flat = seeded({k: v.shape for k, v in
                   convert.state_dict_to_flax(model).items()}, seed)
    convert.load_flax_params(model, flat)
    rng = np.random.RandomState(seed)
    r1, r2 = (0.3 * rng.randn(2, B, S)).astype(np.float32)
    batch = {"speech_mix": r1 + r2,
             "speech_mix_lengths": np.asarray([S, S - 203][:B]),
             "speech_ref1": r1, "speech_ref2": r2}
    jmod = JaxEnhancement(**dict(kw, separator_conf=dict(conf)))
    tree = convert.nest({k: jnp.asarray(v) for k, v in flat.items()})
    return jmod, tree, flat, model, batch


def jax_outputs(jmod, tree, batch, one_forward=True):
    """One compile: the JAX model's estimates and masks, its PIT SI-SNR
    loss and that loss's gradient tree. With ``one_forward`` all come
    from one forward_enhance with the references (the path the model's
    own loss takes; one trace); else the loss is the model's own
    (``loss_type`` dpcl too), and the estimates and masks those of a
    second forward_enhance without the references (DAN's k-means route,
    DPCL's clustering)."""
    def run(p, b):
        refs = [b["speech_ref1"], b["speech_ref2"]]
        if one_forward:
            def loss_fn(q):
                ests, _, masks = jmod.apply(
                    q, b["speech_mix"], b["speech_mix_lengths"], refs=refs,
                    method=jmod.forward_enhance)
                per_utt, _ = jax_losses.pit_loss(
                    jax_losses.si_snr_loss, ests, refs,
                    b["speech_mix_lengths"])
                return jnp.mean(per_utt), (ests, masks)
            (loss, (ests, masks)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p)
            return ests, masks, loss, grads
        ests, _, masks = jmod.apply(p, b["speech_mix"],
                                    b["speech_mix_lengths"],
                                    method=jmod.forward_enhance)
        loss, grads = jax.value_and_grad(lambda q: jmod.apply(q, **b)[0])(p)
        return ests, masks, loss, grads

    ests, masks, loss, grads = jax.jit(run)(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    return (ests, masks, float(loss),
            convert.flatten(jax.tree_util.tree_map(np.asarray, grads)))


def port_outputs(model, batch, refs_in_forward=True):
    """The port's forward_enhance (no gradient; with the references, or
    without them), its own loss and every gradient in the flax tree's
    layout."""
    refs = [t(batch["speech_ref1"]), t(batch["speech_ref2"])]
    with torch.no_grad():
        ests, _, masks = model.forward_enhance(
            t(batch["speech_mix"]), t(batch["speech_mix_lengths"]),
            refs=refs if refs_in_forward else None)
    loss, stats, weight = model(**{k: t(v) for k, v in batch.items()})
    loss.backward()
    return (ests, masks, loss, stats, weight,
            convert.state_dict_to_flax(model, grad=True))


@contextlib.contextmanager
def flax_two_pass_variance():
    """flax's norms take their variance two-pass, mean((x - mean)^2), the
    port's formula, instead of mean(x^2) - mean^2: over a few channels
    of nearly equal values the one-pass form loses digits (DCCRN's
    4-channel LayerNorms: JAX's masks 2.0e-5 from float64, the port's
    2.2e-6)."""
    orig = flax_norm._compute_stats
    flax_norm._compute_stats = functools.wraps(orig)(
        lambda *a, **k: orig(*a, **dict(k, use_fast_variance=False)))
    try:
        yield
    finally:
        flax_norm._compute_stats = orig
