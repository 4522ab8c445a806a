"""The port's time-domain and multichannel enhancement against the JAX
package, on the CPU: SVoice, FaSNet (three channels), USES, USES2
(one and three channels), TF-GridNetV2 (two mics), TF-GridNetV3,
iNeuBe at each of its three output stages and the MVDR neural beamformer,
each in the enhancement model at the JAX package's own small
configuration (tests/test_enh.py): the estimates and the separator's
masks or spectra, the PIT loss and every gradient. Then the array DSP
(the spatial covariance and the MVDR filter, WPE, the multi-frame
multichannel Wiener filter), MixIT's loss, and the layouts a port could
get wrong, each with a case that the wrong layout fails: the overlap-add
at odd lengths, FaSNet's lag order, the V2 / V3 norm axes, USES2's
reference channel, MVDR's |tr| divisor, the Wiener filter's circular
shifts and MixIT's tie order.

Inputs and weights are made with numpy from a seed and fed to both
packages, held as tests/test_torch_enh_separators.py holds them:
estimates and masks within 1e-5 of their largest entry, the loss within
1e-4 relative, each gradient within 1e-4 of its own largest entry, or of
the model's largest for a gradient below 1e-3 of that. The complex
solves (MVDR, WPE, the Wiener filter) run in both packages in float64
too, held at 1e-9, beside their fp32 legs' distance from float64 and the
systems' condition numbers.
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models.enh import beamformer as jax_bf
from espnet_tpu.models.enh import losses as jax_losses
from espnet_tpu.models.enh import separators as jax_separators
from espnet_tpu.models.enh import wpe as jax_wpe
from espnet_tpu_torch import convert
from espnet_tpu_torch.models.enh import beamformer, losses, separators, wpe
from tests.torch_enh_models import (grad_errors, jax_outputs, leaves, models,
                                    port_outputs, rel, t)
from tests.torch_streaming_models import xla_unoptimized


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


SVOICE = {"enc_dim": 32, "kernel_size": 8, "hidden": 12, "num_layers": 1,
          "segment_size": 8}
FASNET = {"enc_dim": 12, "feature_dim": 12, "hidden": 12, "num_layers": 1,
          "segment_size": 8, "window_ms": 2, "context_ms": 2}
USES = {"enc_channels": 8, "bottleneck": 16, "num_blocks": 1, "heads": 2,
        "hidden": 12, "memory_size": 2}
USES2 = dict(USES, num_blocks=2, num_spatial_blocks=1)
GRID = {"num_blocks": 1, "emb_dim": 8, "hidden": 12}
INEUBE = {"hidden": 8, "layers": 2, "n_chunks": 1, "mic_channels": 2}
BEAMFORMER = {"n_fft": 128, "hop_length": 64, "mask_hidden": 16,
              "mask_layers": 1}

# The Wiener filter's and MVDR's fp32 solves: iNeuBe's mfMCWF spectra
# and the beamformer's mask-net gradients (its MVDR filter is invariant
# to the masks' scale, so their biases' gradients are sums that cancel)
# lie ~1.4e-5 and ~1.3e-4 from float64 in the JAX package's own fp32 run.
# Those two are held in test_solves_in_float64 instead: both packages in
# float64 at 1e-9, and the port's fp32 leg within twice the JAX package's
# fp32 leg's distance from float64.
FLOAT64_HELD = ("ineube_mfmcwf", "neural_beamformer")
F64_REL = 1e-9
FP32_OF_JAX = 2.0

# (separator, conf, mixture channels or None, model options): the JAX
# package's small configurations; SVoice at an odd length
CASES = {
    "svoice": ("svoice", SVOICE, None, {"S": 999}),
    "fasnet_3ch": ("fasnet", FASNET, 3, {}),
    "uses": ("uses", USES, None, {}),
    "uses2": ("uses2", USES2, None, {}),
    "uses2_3ch": ("uses2", dict(USES2, ref_channel=1), 3, {}),
    "tfgridnetv2_2mic": ("tfgridnetv2", dict(GRID, n_imics=2), 2, {}),
    "tfgridnetv3": ("tfgridnetv3", GRID, None, {}),
    "ineube_dnn1": ("ineube", dict(INEUBE, output_from="dnn1"), 2,
                    {"num_spk": 1}),
    "ineube_mfmcwf": ("ineube", dict(INEUBE, output_from="mfmcwf"), 2,
                      {"num_spk": 1}),
    "ineube_dnn2": ("ineube", INEUBE, 2, {"num_spk": 1}),
    "neural_beamformer": ("neural_beamformer", BEAMFORMER, 2,
                          {"num_spk": 1}),
}


def _models(case, seed=0):
    sep, conf, channels, kw = CASES[case]
    return models(sep, conf, seed, channels=channels, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_separator_estimates_loss_and_every_gradient_match_jax(
        case, record_property):
    jmod, tree, flat, model, batch = _models(case)
    want_ests, want_masks, want_loss, want_grads = jax_outputs(
        jmod, tree, batch)
    ests, masks, loss, stats, weight, grads = port_outputs(model, batch)
    errs = [rel(g.numpy(), w) for g, w in zip(ests, want_ests)]
    mask_errs = [rel(g, w) for g, w in zip(leaves(masks),
                                           leaves(want_masks))] or [0.0]
    assert len(ests) == len(want_ests) == model.num_spk
    assert ests[0].shape == batch["speech_ref1"].shape
    assert len(leaves(masks)) == len(leaves(want_masks))
    assert set(grads) == set(want_grads) == set(flat)
    grad_err = max(grad_errors(grads, want_grads).values())
    loss_err = abs(loss.item() - want_loss) / abs(want_loss)
    record_property(f"rel_err:{case}", [max(errs), max(mask_errs),
                                        loss_err, grad_err])
    assert max(errs) <= 1e-5 and loss_err <= 1e-4
    if case not in FLOAT64_HELD:
        assert max(mask_errs) <= 1e-5 and grad_err <= 1e-4
    assert weight == 2.0 and stats["si_snr"].item() == -loss.item()
    back = convert.state_dict_to_flax(model)
    assert all(np.array_equal(back[k], v) for k, v in flat.items())
    if case in WRONG_LAYOUTS:
        with torch.no_grad(), WRONG_LAYOUTS[case](model, flat) as other:
            wrong, _, _ = other.forward_enhance(
                t(batch["speech_mix"]), t(batch["speech_mix_lengths"]))
        assert min(rel(g.numpy(), w) for g, w in zip(wrong, want_ests)) \
            > 1e-3


@contextlib.contextmanager
def _other_ref_channel(model, flat):
    """USES2 collapsing to channel 0 and masking its spectrum."""
    model.separator_mod.ref_channel = 0
    yield model


@contextlib.contextmanager
def _v3_norms(model, flat):
    """V3's norms (over the channel axis) on V2's weights: the same
    parameter shapes."""
    _, _, _, v3, _ = models("tfgridnetv3", CASES["tfgridnetv2_2mic"][1], 0,
                            channels=2)
    yield convert.load_flax_params(v3, flat)


@contextlib.contextmanager
def _lags_reversed(model, flat):
    """FaSNet's lags in reverse order: lag k's window at 2 context - k."""
    lag_windows = separators._lag_windows
    separators._lag_windows = lambda f, w: lag_windows(f, w).flip(-2)
    try:
        yield model
    finally:
        separators._lag_windows = lag_windows


# per case, a wrong layout that must move the estimates far off
WRONG_LAYOUTS = {"uses2_3ch": _other_ref_channel,
                 "tfgridnetv2_2mic": _v3_norms, "fasnet_3ch": _lags_reversed}


@contextlib.contextmanager
def flax_lstm_carry_float64():
    """flax's LSTM carry starts in its param_dtype, fp32, whatever the
    parameters' and inputs' dtype: in float64 it starts in float64."""
    orig = fnn.OptimizedLSTMCell.initialize_carry
    fnn.OptimizedLSTMCell.initialize_carry = (
        lambda self, rng, shape: jax.tree_util.tree_map(
            lambda c: c.astype(jnp.float64), orig(self, rng, shape)))
    try:
        yield
    finally:
        fnn.OptimizedLSTMCell.initialize_carry = orig


@contextlib.contextmanager
def condition_numbers(out: list):
    """Note the largest condition number of every torch.linalg.solve."""
    solve = torch.linalg.solve

    def noting(a, b, **kw):
        out.append(_cond(a.detach().numpy()))
        return solve(a, b, **kw)

    torch.linalg.solve = noting
    try:
        yield out
    finally:
        torch.linalg.solve = solve


def _solve_cores(case, tree, model, rng):
    """The part of a FLOAT64_HELD case around its solve, on inputs of its
    own: iNeuBe's separator on (real, imag) spectra; the beamformer's mask
    net, spatial covariances, MVDR filter and its product with the
    channels' spectra. -> (JAX fn(params, *inputs), its params, the port
    module, port fn(*inputs), the inputs)."""
    B, T, F, C = 2, 12, 65, 2
    if case == "ineube_mfmcwf":
        conf = dict(CASES[case][1])
        jsep = jax_separators.INeuBeSeparator(input_dim=F, **conf)
        sep = model.separator_mod
        ins = tuple(rng.randn(2, B, T, F, C).astype(np.float32))
        return (lambda p, r, i: jsep.apply({"params": p}, (r, i))[0],
                tree["params"]["separator_mod"], sep,
                lambda r, i: sep((r, i))[0], ins)
    conf = CASES[case][1]
    jnet = jax_separators.RNNSeparator(input_dim=F, num_spk=2,
                                       rnn_hidden=conf["mask_hidden"],
                                       num_layers=conf["mask_layers"])
    net = model.separator_mod.bf.mask_net
    spec = _complex(rng, B, T, C, F)
    valid = np.arange(T)[None] < np.asarray([T, 9])[:, None]

    def core(lib, bf, masks_of):
        def fn(spec, valid):
            ms, mn = masks_of(lib.abs(spec[:, :, 0]))
            w = bf.mvdr_filter(bf.spatial_covariance(spec, ms, valid),
                               bf.spatial_covariance(spec, mn, valid))
            enh = lib.einsum("bfc,btcf->btf", w.conj(), spec)
            return enh.real, enh.imag
        return fn

    return (lambda p, s_, v: core(jnp, jax_bf, lambda m: jnet.apply(
                {"params": p}, m))(s_, v),
            tree["params"]["separator_mod"]["bf"]["mask_net"], net,
            core(torch, beamformer, net), (spec, valid))


@pytest.mark.parametrize("case", FLOAT64_HELD)
def test_solves_in_float64(case, record_property):
    # JAX's fp32 and float64 legs, the port's two, one cotangent: outputs
    # and every gradient of the solve's part
    _, tree, _, model, _ = _models(case)
    rng = np.random.RandomState(5)
    jfn, jparams, module, fn, ins = _solve_cores(case, tree, model, rng)
    B, T, F = ins[0].shape[:2] + (65,)
    out = {}
    for bits, wide in (("32", False), ("64", True)):
        xs = [np.asarray(a, {np.dtype(np.complex64): np.complex128,
                             np.dtype(np.float32): np.float64}.get(
                                 a.dtype, a.dtype)) if wide else a
              for a in ins]
        dt = np.float64 if wide else np.float32
        crng = np.random.RandomState(6)
        with jax.enable_x64(wide), flax_lstm_carry_float64() if wide \
                else contextlib.nullcontext():
            p = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dt), jparams)
            cots = [crng.randn(B, T, F).astype(dt) for _ in range(2)]

            def loss(q, *a):
                o = jfn(q, *a)
                return sum(jnp.sum(x * c) for x, c in zip(o, cots)), o

            jgrads, outs = jax.jit(jax.grad(loss, has_aux=True))(
                p, *map(jnp.asarray, xs))
            outs = jax.tree_util.tree_map(np.asarray, outs)
        mod = module.double() if wide else module.float()
        module.zero_grad()
        conds = []
        with condition_numbers(conds):
            pout = fn(*[torch.from_numpy(np.asarray(x)) for x in xs])
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(pout, cots)
            ).backward()
        out[bits] = {
            "jax": (outs, convert.flatten({"params": jax.tree_util.tree_map(
                np.asarray, jgrads)})),
            "port": ([o.detach().numpy() for o in pout],
                     convert.state_dict_to_flax(mod, grad=True)),
            "cond": max(conds)}
    module.float()
    ref_outs, ref_grads = out["64"]["jax"]

    def dist(leg):
        outs, grads = leg
        return (max(rel(o, r) for o, r in zip(outs, ref_outs)),
                max(grad_errors(grads, ref_grads).values()))

    port64, jax32, port32 = (dist(out["64"]["port"]), dist(out["32"]["jax"]),
                             dist(out["32"]["port"]))
    record_property(f"rel_err:{case}", {
        "float64_outputs_grads": port64, "jax_fp32_from_float64": jax32,
        "port_fp32_from_float64": port32, "cond_fp32": out["32"]["cond"],
        "cond_float64": out["64"]["cond"]})
    assert max(port64) <= F64_REL
    assert port32[0] <= FP32_OF_JAX * max(jax32[0], 1e-6)
    assert port32[1] <= FP32_OF_JAX * max(jax32[1], 1e-5)


@pytest.mark.parametrize("T,W,hop", [(7, 16, 4), (5, 5, 2), (9, 64, 32)])
def test_overlap_add_matches_jax_scatter_add(T, W, hop):
    # F.fold against SVoice's and FaSNet's .at[].add at odd lengths, and
    # its gradient; the frames laid out (W, T) are far off
    rng = np.random.RandomState(T + W)
    frames = rng.randn(2, 3, T, W).astype(np.float32)
    n_out = (T - 1) * hop + W
    w = rng.randn(2, 3, n_out).astype(np.float32)
    idx = (np.arange(W)[None] + hop * np.arange(T)[:, None]).reshape(-1)

    def jax_side(f):
        return jnp.zeros((2, 3, n_out)).at[:, :, idx].add(
            f.reshape(2, 3, T * W))

    want, grad = jax.jit(lambda f, c: (jax_side(f), jax.vjp(jax_side, f)[1](
        c)[0]))(jnp.asarray(frames), jnp.asarray(w))
    f = t(frames).requires_grad_()
    out = separators.overlap_add(f, hop)
    (out * t(w)).sum().backward()
    assert out.shape == (2, 3, n_out)
    assert rel(out.detach().numpy(), want) <= 1e-6
    assert rel(f.grad.numpy(), grad) <= 1e-6
    swapped = t(frames.reshape(2, 3, W, T).swapaxes(-1, -2).copy())
    assert rel(separators.overlap_add(swapped, hop).numpy(), want) > 1e-2


# ---- the array DSP ----------------------------------------------------------

def _complex(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def crel(a, b) -> float:
    """``rel`` of complex arrays: the largest |a - b| over b's largest
    modulus."""
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cond(a):
    return float(np.linalg.cond(np.asarray(a, np.complex128)).max())


def _both(jax_fn, port_fn, *arrays):
    """jax_fn and port_fn on the same inputs, in fp32 / complex64 and in
    float64 / complex128 -> {"32": (JAX, port), "64": (JAX, port)}."""
    out = {}
    for bits, wide in (("32", False), ("64", True)):
        ins = [np.asarray(a, {np.dtype(np.complex64): np.complex128,
                              np.dtype(np.float32): np.float64}.get(
                                  a.dtype, a.dtype)) if wide else a
               for a in arrays]
        with jax.enable_x64(wide):
            want = jax.jit(jax_fn)(*map(jnp.asarray, ins))
            want = jax.tree_util.tree_map(np.asarray, want)
        got = port_fn(*[torch.from_numpy(np.asarray(a)) for a in ins])
        got = jax.tree_util.tree_map(lambda x: x.numpy(), got)
        out[bits] = (want, got)
    return out


def test_mvdr_matches_jax_and_divides_by_the_trace_modulus(
        record_property):
    rng = np.random.RandomState(0)
    B, T, C, F = 2, 12, 3, 5
    spec = _complex(rng, B, T, C, F)
    masks = rng.rand(2, B, T, F).astype(np.float32)
    valid = np.arange(T)[None] < np.asarray([T, 9])[:, None]

    def run(cov, mvdr):
        def fn(spec, ms, mn, valid):
            ps, pn = cov(spec, ms, valid), cov(spec, mn, valid)
            return ps, pn, mvdr(ps, pn, 1)
        return fn

    conds = []
    with condition_numbers(conds):
        res = _both(run(jax_bf.spatial_covariance, jax_bf.mvdr_filter),
                    run(beamformer.spatial_covariance,
                        beamformer.mvdr_filter),
                    spec, masks[0], masks[1], valid)
    (jps, jpn, jw), (ps, pn, w) = res["32"]
    (_, _, jw64), (_, _, w64) = res["64"]
    errs = {"psd": max(crel(ps, jps), crel(pn, jpn)), "w": crel(w, jw),
            "w_float64": crel(w64, jw64), "w_fp32_from_float64": crel(w, jw64),
            "cond_psd_n": max(conds)}
    record_property("rel_err:mvdr", errs)
    assert errs["psd"] <= 1e-5 and errs["w"] <= 1e-5
    assert errs["w_float64"] <= F64_REL
    # a speech covariance that is not Hermitian has a complex trace:
    # upstream ESPnet's division by it is far from the JAX package's |tr|
    psd_s = _complex(rng, B, F, C, C).astype(np.complex128)
    with jax.enable_x64(True):
        jw = np.asarray(jax.jit(jax_bf.mvdr_filter, static_argnums=2)(
            jnp.asarray(psd_s), jnp.asarray(jpn.astype(np.complex128)), 1))
    pn64 = torch.from_numpy(jpn.astype(np.complex128))
    w = beamformer.mvdr_filter(torch.from_numpy(psd_s), pn64, 1)
    assert crel(w.numpy(), jw) <= F64_REL
    num = torch.linalg.solve(beamformer.loaded_noise(pn64),
                             torch.from_numpy(psd_s))
    complex_tr = num[..., 1] / beamformer._trace(num)[..., None]
    assert crel(complex_tr.numpy(), jw) > 1e-2


def test_wpe_matches_jax(record_property):
    rng = np.random.RandomState(1)
    spec = _complex(rng, 1, 40, 2, 6)
    # a reverberant tail: each frame carries 0.6 of the one 3 before
    for i in range(3, 40):
        spec[:, i] += 0.6 * spec[:, i - 3]
    conds = []
    with condition_numbers(conds):
        res = _both(lambda x: jax_wpe.wpe_dereverb(x, taps=4, delay=2),
                    lambda x: wpe.wpe_dereverb(x, taps=4, delay=2), spec)
    (j32, p32), (j64, p64) = res["32"], res["64"]
    errs = {"fp32": crel(p32, j32), "float64": crel(p64, j64),
            "port_fp32_from_float64": crel(p32, j64),
            "jax_fp32_from_float64": crel(j32, j64), "cond": max(conds)}
    record_property("rel_err:wpe", errs)
    assert p32.shape == spec.shape and p32.dtype == np.complex64
    # the loaded correlations' fp32 solves put both packages' fp32 legs
    # ~5e-4 from float64: held as FLOAT64_HELD's cases are
    assert errs["float64"] <= F64_REL
    assert errs["port_fp32_from_float64"] <= FP32_OF_JAX * errs[
        "jax_fp32_from_float64"]
    # the stack delays by zero-filling, not by wrapping around
    x = torch.from_numpy(spec).permute(0, 3, 2, 1)
    stack = wpe._stack_taps(x, 2, 2)
    assert torch.equal(stack[..., :2], torch.zeros_like(stack[..., :2]))
    assert torch.equal(stack[:, :, 2:, 3:], x[..., :-3])


def test_mfmcwf_matches_jax_and_wraps_around(record_property):
    # two mics at 3 shifts: 6 unknowns per bin; at T = 8 the wrapped
    # frames are a quarter of the system, and a zero-filled shift is
    # another filter, far off (at T <= 6 any shift would fit the target)
    T = 8
    rng = np.random.RandomState(T)
    real, imag = rng.randn(2, 1, T, 5, 2).astype(np.float32)
    er, ei = rng.randn(2, 1, T, 5).astype(np.float32)
    conds = []
    with condition_numbers(conds):
        res = _both(lambda *a: jax_separators.mfmcwf(*a, n_chunks=1),
                    lambda *a: separators.mfmcwf(*a, n_chunks=1),
                    real, imag, er, ei)
    (j32, p32), (j64, p64) = res["32"], res["64"]
    errs = {"fp32": max(rel(a, b) for a, b in zip(p32, j32)),
            "float64": max(rel(a, b) for a, b in zip(p64, j64)),
            "fp32_from_float64": max(rel(a, b) for a, b in zip(p32, j64)),
            "cond": max(conds)}
    record_property("rel_err:mfmcwf", errs)
    assert errs["float64"] <= F64_REL and errs["fp32"] <= 1e-5

    def zero_filled(x, s, dims):
        out = torch.zeros_like(x)
        if s >= 0:
            out[:, s:] = x[:, :x.shape[1] - s]
        else:
            out[:, :s] = x[:, -s:]
        return out

    roll = torch.roll
    try:
        torch.roll = zero_filled
        other = separators.mfmcwf(*map(torch.from_numpy,
                                       (real, imag, er, ei)), n_chunks=1)
    finally:
        torch.roll = roll
    assert max(rel(a.numpy(), b) for a, b in zip(other, j32)) > 1e-3


def test_mixit_matches_jax_and_takes_the_first_of_a_tie():
    rng = np.random.RandomState(2)
    ests = list(rng.randn(3, 2, 300).astype(np.float32))
    mixes = list(rng.randn(2, 2, 300).astype(np.float32))
    lens = np.asarray([300, 250])
    jax_mixit = jax.jit(lambda e, m, n: jax_losses.mixit_loss(
        jax_losses.si_snr_loss, list(e), list(m), n))
    jl, jb = jax_mixit(jnp.asarray(ests), jnp.asarray(mixes),
                       jnp.asarray(lens))
    pl, pb = losses.mixit_loss(losses.si_snr_loss, [t(e) for e in ests],
                               [t(m) for m in mixes], t(lens))
    assert rel(pl.numpy(), jl) <= 1e-5 and np.array_equal(pb.numpy(), jb)
    # two equal sources against two equal mixtures: assignments 1 and 2
    # (and 5 and 6) tie to the bit; both packages take the first
    same = [ests[0], ests[0], ests[2]]
    tie = [mixes[0], mixes[0]]
    jl, jb = jax_mixit(jnp.asarray(same), jnp.asarray(tie),
                       jnp.asarray(lens))
    pl, pb = losses.mixit_loss(losses.si_snr_loss, [t(e) for e in same],
                               [t(m) for m in tie], t(lens))
    assert np.array_equal(pb.numpy(), jb)
    every = losses.mixit_losses(losses.si_snr_loss, [t(e) for e in same],
                                [t(m) for m in tie], t(lens))
    assert ((every == every.min(1, keepdim=True).values).sum(1) >= 2).all()
    last = every.shape[1] - 1 - every.flip(1).argmin(1)
    assert not np.array_equal(last.numpy(), jb)
