"""chip_smoke.py's grad check, on the CPU: its pins and its float64 leg.

The grad check (chip_smoke.py:grad_check) holds one backward on the card
against the CPU's, with the CPU's pre-activations moved onto the card's
side of every ReLU (tools/grad_pin.py), and runs a float64 backward of
the same model, pinned the same way, as the reference of both fp32 legs.
Here without a card: ``take_side`` puts every unit on the wanted side,
however small its value, with an identity gradient; the pin's moves stay
within rounding between fp32 and float64, and a pin taken from another
batch moves units far past MOVE_TOL; so do the pins of each rel-pos
self-attention's inputs; the float64 leg stays float64 from the
frontend to the loss, and with the pin its gradients are an fp32
backward's to within fp32 rounding; and the losses, which that leg runs
in float64, keep float64 there and still match the JAX package's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.ops import losses as jax_losses
from espnet_tpu.ops.rnnt import rnnt_loss as jax_rnnt_loss
from espnet_tpu_torch import convert
from espnet_tpu_torch.ops import losses, rnnt
from espnet_tpu_torch.tools import grad_pin

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "assets" / "synth_asr_flagship"


@pytest.fixture
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side.
    Not for test_float64_leg_is_float64_and_pinned_as_the_fp32_leg, whose
    fp32 sums keep the default thread count's order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_take_side_puts_each_unit_on_the_wanted_side(dtype):
    # magnitudes from 1e-9 to 10: a negative unit wanted above 0 must come
    # out above 0 (a move to +tiny added to the value itself would round
    # back to 0, which a ReLU masks)
    rng = np.random.RandomState(0)
    x = rng.randn(4096) * 10.0 ** rng.randint(-9, 2, 4096)
    out = torch.tensor(x, dtype=dtype, requires_grad=True)
    want = torch.from_numpy(rng.rand(4096) < 0.5)
    pinned = grad_pin.take_side(out, want)
    assert torch.equal(torch.relu(pinned) > 0, want)
    keep = want == (out > 0)
    assert torch.equal(pinned[keep], out[keep])
    tiny = torch.finfo(dtype).tiny
    assert bool(((pinned - out).abs()[~keep] <= out.abs()[~keep] + tiny)
                .all())
    w = torch.from_numpy(rng.randn(4096)).to(dtype)
    (pinned * w).sum().backward()
    assert torch.equal(out.grad, w)


@pytest.mark.usefixtures("one_torch_thread")
def test_pin_moves_only_rounding_and_its_bound_catches_a_wrong_pin():
    # a linear's outputs in float64 pinned to its fp32 sides on the same
    # inputs move only units within rounding of 0, if any, each module's
    # largest move under MOVE_TOL of its largest output; pinned to the
    # sides of another batch, they move by ~1 of it
    import copy
    g = torch.Generator().manual_seed(0)
    lin = torch.nn.Linear(256, 1024)
    lin64 = copy.deepcopy(lin).double()
    x, other = (torch.randn(2, 300, 256, generator=g) for _ in range(2))
    for fp32_in, bound in ((x, True), (other, False)):
        signs, moved = {}, {}
        with torch.no_grad():
            for h in grad_pin.pin_relus({"w": lin}, signs):
                lin(fp32_in)
                h.remove()
            for h in grad_pin.pin_relus({"w": lin64}, signs, moved):
                out = lin64(x.double())
                h.remove()
        assert torch.equal(out > 0, signs["w"])
        if bound:
            assert all(r[2] <= grad_pin.MOVE_TOL for r in moved.values())
        else:
            assert moved["w"][0] > 1000 and moved["w"][2] > 0.1, moved


def _flagship_batch():
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    utts = [SynthSpeechCorpus().utterance("test", i) for i in range(2)]
    speech = np.zeros((2, max(len(w) for w, _, _ in utts)), np.float32)
    for j, (w, _, _) in enumerate(utts):
        speech[j, :len(w)] = w
    return {"speech": torch.from_numpy(speech),
            "speech_lengths": torch.tensor([len(w) for w, _, _ in utts]),
            "text": torch.tensor([[3, 4, 5, 6], [7, 8, 9, 0]]),
            "text_lengths": torch.tensor([4, 3])}


def test_float64_leg_is_float64_and_pinned_as_the_fp32_leg():
    # the flagship on two held-out utterances, as grad_check runs its CPU
    # legs: an fp32 backward notes its ReLU sides, a float64 one takes
    # them; every gradient of the float64 leg is float64 and within 1e-4
    # of its scale of the fp32 one (fp32 rounding through 6 blocks and 3
    # decoder layers, ~1e-5; a ReLU unit on the other side would move a
    # gradient by a whole unit's term, ~1e-3)
    from espnet_tpu_torch.tasks.asr import ASRTask
    batch = _flagship_batch()
    signs, grads, moved = {}, {}, {}
    for leg in ("fp32", "float64"):
        model, _ = ASRTask.build_model_from_file(FLAGSHIP / "config.yaml",
                                                 FLAGSHIP, "cpu")
        if leg == "float64":
            grad_pin.to_float64(model)
        grad_pin.pin_relus(grad_pin.relu_inputs(model), signs,
                           moved if leg == "float64" else None)
        loss, _, _ = model(**batch)
        loss.backward()
        assert loss.dtype == (torch.float64 if leg == "float64"
                              else torch.float32)
        grads[leg] = convert.state_dict_to_flax(model, grad=True)
    assert {g.dtype for g in grads["float64"].values()} == {
        np.dtype(np.float64)}
    top = max(float(np.abs(g).max()) for g in grads["float64"].values())
    for name, ref in grads["float64"].items():
        scale = max(float(np.abs(ref).max()), 1e-4 * top)
        assert float(np.abs(grads["fp32"][name] - ref).max()) <= 1e-4 * scale
    # the units moved lie within rounding of 0
    assert all(row[2] <= grad_pin.MOVE_TOL for row in moved.values()), moved


@pytest.mark.usefixtures("one_torch_thread")
def test_attention_pin_moves_only_rounding_and_restores_the_modules():
    # the flagship on two held-out utterances: an fp32 forward notes each
    # rel-pos self-attention's inputs, a float64 forward takes them,
    # moved by no more than rounding (the padding's -1e9 bias left out),
    # with an identity gradient into the float64 projections; a pin
    # noted on another batch moves them by ~1 of their scale; removing
    # the handles gives each module its class's kernel_inputs back
    from espnet_tpu_torch.nn.attention import RelPositionMultiHeadedAttention
    from espnet_tpu_torch.tasks.asr import ASRTask
    batch = _flagship_batch()
    other = dict(batch, speech=batch["speech"].flip(1))
    for noted_on, bound in ((batch, True), (other, False)):
        store, moved = {}, {}
        for leg in ("fp32", "float64"):
            model, _ = ASRTask.build_model_from_file(
                FLAGSHIP / "config.yaml", FLAGSHIP, "cpu")
            if leg == "float64":
                grad_pin.to_float64(model)
            hooks = grad_pin.pin_attention(
                model, store, moved if leg == "float64" else None)
            assert len(hooks) == 6
            loss, _, _ = model(**(noted_on if leg == "fp32" else batch))
            if leg == "float64":
                loss.backward()
            for h in hooks:
                h.remove()
        assert sorted(moved) == sorted(store) and len(store) == 6
        if bound:
            assert all(r[2] <= grad_pin.MOVE_TOL for r in moved.values())
            assert model.encoder_mod.layers[0].self_attn.linear_q \
                .weight.grad.abs().max() > 0
        else:
            assert max(r[2] for r in moved.values()) > 0.1, moved
    assert all("kernel_inputs" not in vars(m) for m in model.modules()
               if isinstance(m, RelPositionMultiHeadedAttention))


@pytest.mark.usefixtures("one_torch_thread")
def test_frontend_keeps_a_float64_wave_float64():
    # the float64 leg's frontend: a float64 wave gives float64 log-mel
    # features (fused rule and plain STFT path both), within 1e-5 of
    # their largest of the fp32 features on the same wave (~7e-7 seen:
    # fp32 rounding), and a float64
    # gradient back into the wave
    from espnet_tpu_torch.frontends.default import DefaultFrontend
    wave = _flagship_batch()["speech"]
    lengths = torch.tensor([wave.shape[1]] * 2)
    for fused in ("auto", "never"):
        fe = DefaultFrontend(use_fused_kernel=fused)
        f32, _ = fe(wave, lengths)
        x = wave.double().requires_grad_()
        f64, _ = fe(x, lengths)
        assert f32.dtype == torch.float32 and f64.dtype == torch.float64
        err = (f64.detach() - f32.double()).abs().max()
        assert float(err) <= 1e-5 * float(f64.detach().abs().max())
        f64.sum().backward()
        assert x.grad.dtype == torch.float64


@pytest.mark.usefixtures("one_torch_thread")
def test_losses_keep_float64_and_match_jax():
    # the float64 leg's losses: CTC, label smoothing and RNN-T on float64
    # logits stay float64, and match the JAX package's fp32 losses at the
    # tolerances of their fp32 tests (tests/test_torch_train.py,
    # tests/test_torch_transducer.py)
    rng = np.random.default_rng(0)
    B, T, U, V = 5, 24, 7, 11
    logits = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    ys = rng.integers(1, V, size=(B, U)).astype(np.int32)
    hlens = rng.integers(T // 2, T + 1, size=(B,)).astype(np.int32)
    ylens = rng.integers(1, U + 1, size=(B,)).astype(np.int32)
    args = [jnp.asarray(a) for a in (hlens, ys, ylens)]
    ref, ref_g = jax.jit(jax.value_and_grad(
        lambda x: jax_losses.ctc_loss(x, *args)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).double().requires_grad_()
    loss = losses.ctc_loss(x, *(torch.from_numpy(a).long()
                                for a in (hlens, ys, ylens)))
    (g,) = torch.autograd.grad(loss, (x,))
    assert loss.dtype == g.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=1e-5,
                               rtol=0)

    targets = torch.from_numpy(np.where(np.arange(U)[None] < ylens[:, None],
                                        ys, -1))
    x = torch.from_numpy(logits[:, :U]).double()
    loss = losses.label_smoothing_loss(x, targets, 0.1, -1)
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(
        loss.item(), float(jax_losses.label_smoothing_loss(
            jnp.asarray(logits[:, :U]), jnp.asarray(targets.numpy()), 0.1,
            -1)), rtol=1e-6)

    lat = rng.standard_normal((4, 11, 7, V)).astype(np.float32)
    labels = rng.integers(1, V, (4, 6)).astype(np.int32)
    tl, ul = np.array([11, 9, 7, 11], np.int32), np.array([6, 4, 3, 5],
                                                         np.int32)
    jargs = [jnp.asarray(a) for a in (labels, tl, ul)]
    ref = np.asarray(jax.jit(lambda x: jax_rnnt_loss(
        x, *jargs, reduction="none"))(jnp.asarray(lat)))
    ref_g = np.asarray(jax.jit(jax.grad(lambda x: jax_rnnt_loss(x, *jargs)))(
        jnp.asarray(lat)))
    x = torch.from_numpy(lat).double().requires_grad_()
    nll = rnnt.rnnt_loss(x, *(torch.from_numpy(a).long()
                              for a in (labels, tl, ul)), reduction="none")
    (g,) = torch.autograd.grad(nll.mean(), (x,))
    assert nll.dtype == g.dtype == torch.float64
    np.testing.assert_allclose(nll.detach().numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), ref_g, atol=2e-5, rtol=0)


@pytest.mark.usefixtures("one_torch_thread")
def test_prediction_network_carry_takes_the_weights_dtype():
    from espnet_tpu_torch.models.transducer import RNNDecoder
    dec = RNNDecoder(7, hidden_size=8, num_layers=2)
    assert {c.dtype for pair in dec.init_carry(3) for c in pair} == {
        torch.float32}
    dec.double()
    out, _ = dec.step(dec.init_carry(3), torch.tensor([1, 2, 3]))
    assert out.dtype == torch.float64
