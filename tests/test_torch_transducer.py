"""The port's transducer against the JAX package, on the CPU: K3's plain
sweeps and the RNN-T loss, the chunked-causal streaming encoder, the LSTM
prediction network and the joint, every gradient of a small transducer
(d=32, 2 blocks, chunk 4, 2 left chunks, kernel 5, V=9) with aux CTC, its
greedy and beam-5 hypotheses, the asset's hypotheses on 4 held-out
utterances, the training entry point, and the closed-form CTC gradient.

Inputs are made with numpy from a seed and fed to both packages. Both
compute in fp32 with sums in another order; each tolerance says why.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from espnet_tpu.bin.asr_transducer_inference import \
    Speech2TextTransducer as JaxSpeech2TextTransducer
from espnet_tpu.decode.transducer_search import \
    TransducerSearchConfig as JaxSearchConfig
from espnet_tpu.decode.transducer_search import \
    decode_transducer as jax_decode_transducer
from espnet_tpu.models.transducer import JointNetwork as JaxJoint
from espnet_tpu.models.transducer import RNNDecoder as JaxRNNDecoder
from espnet_tpu.nn import streaming_encoder as jax_streaming
from espnet_tpu.ops import losses as jax_losses
from espnet_tpu.ops.pallas.rnnt_kernel import rnnt_loss_pallas
from espnet_tpu.ops.rnnt import rnnt_loss as jax_rnnt_loss
from espnet_tpu.tasks.asr_transducer import \
    ASRTransducerTask as JaxTransducerTask
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import asr_transducer_train
from espnet_tpu_torch.bin.asr_transducer_inference import \
    Speech2TextTransducer
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.decode.transducer_search import (TransducerSearchConfig,
                                                       decode_transducer)
from espnet_tpu_torch.models.transducer import JointNetwork, RNNDecoder
from espnet_tpu_torch.nn import streaming_encoder
from espnet_tpu_torch.ops import losses, rnnt
from espnet_tpu_torch.tasks.asr_transducer import (ASRTransducerTask,
                                                   build_model)
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.train.trainer import evaluate
from espnet_tpu_torch.utils.config import dump_yaml
from tests.torch_streaming_models import flax_params, xla_unoptimized

ASSET = (Path(__file__).resolve().parents[1] / "assets"
         / "synth_asr_transducer")
V = 9


@pytest.fixture(autouse=True, scope="module")
def jax_references_unoptimized():
    """The JAX references compile without XLA's optimisations: they run
    once, at small shapes, where compiling is most of their time."""
    with xla_unoptimized():
        yield


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


def _perturbed(params, seed=0):
    """The flat flax dict of ``params`` moved off their init values, so
    that zero biases and unit scales take part; and the tree again."""
    rng = np.random.RandomState(seed)
    flat = {k: (np.asarray(v) + 0.05 * rng.randn(*np.shape(v))
                ).astype(np.float32)
            for k, v in flatten_dict(params, sep="/").items()}
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    return flat, tree


def _load(module, flat):
    """flat flax params of one module (keys "params/...") into ``module``."""
    return convert.load_flax_params(module, flat)


# ---- K3: the lattice sweeps and the RNN-T loss --------------------------

LENGTHS = {"ragged": ([11, 9, 7, 11], [6, 4, 3, 5]),
           "edges": ([11, 1, 7, 5], [0, 6, 3, 0])}   # U_b = 0 and T_b = 1


def _rnnt_case(name):
    rng = np.random.RandomState(0)
    B, T, U = 4, 11, 6
    logits = rng.randn(B, T, U + 1, V).astype(np.float32)
    labels = rng.randint(1, V, (B, U)).astype(np.int32)
    tl, ul = (np.asarray(x, np.int32) for x in LENGTHS[name])
    return logits, labels, tl, ul


@pytest.mark.parametrize("name", sorted(LENGTHS))
def test_rnnt_loss_and_sweeps_match_jax(name, record_property):
    logits, labels, tl, ul = _rnnt_case(name)
    jargs = [jnp.asarray(a) for a in (labels, tl, ul)]
    # each JAX function compiled whole: faster than op-by-op dispatch
    ref = np.asarray(jax.jit(lambda x: jax_rnnt_loss(
        x, *jargs, reduction="none"))(jnp.asarray(logits)))
    pallas = np.asarray(jax.jit(lambda x: rnnt_loss_pallas(
        x, *jargs, reduction="none"))(jnp.asarray(logits)))
    ref_g = np.asarray(jax.jit(jax.grad(lambda x: jax_rnnt_loss(x, *jargs)))(
        jnp.asarray(logits)))
    pallas_g = np.asarray(jax.jit(jax.grad(
        lambda x: rnnt_loss_pallas(x, *jargs)))(jnp.asarray(logits)))
    targs = [_t(a).long() for a in (labels, tl, ul)]
    for fn in (rnnt.rnnt_loss, rnnt.rnnt_loss_plain):
        x = _t(logits).requires_grad_()
        nll = fn(x, *targs, reduction="none")
        (g,) = torch.autograd.grad(nll.mean(), (x,))
        # sums over <= 16 diagonals of log-probs of O(3): nll of O(30)
        for r in (ref, pallas):
            np.testing.assert_allclose(nll.detach().numpy(), r, rtol=1e-5)
        # edge occupancies in [0, 1] over 4 samples: gradients O(0.25)
        for rg in (ref_g, pallas_g):
            np.testing.assert_allclose(g.numpy(), rg, atol=2e-5, rtol=0)
        record_property(f"max_abs_err:{fn.__name__}:grad",
                        float(np.abs(g.numpy() - ref_g).max()))
    # the two sweeps agree with each other: alpha at the exit plus its
    # blank, and beta at the start, are both the total log-probability
    blank, emit = rnnt.lattices(_t(logits), *targs)
    alpha, nll = rnnt.rnnt_alpha(blank, emit, targs[1], targs[2])
    beta = rnnt.rnnt_beta(blank, emit, targs[1], targs[2])
    np.testing.assert_allclose(nll.numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(-beta[:, 0, 0].numpy(), ref, rtol=1e-5)
    for b, (T_b, U_b) in enumerate(zip(tl, ul)):
        outside = np.ones(alpha.shape[1:], bool)
        outside[:T_b, :U_b + 1] = False
        assert (alpha[b].numpy()[outside] == rnnt.NEG_INF).all()
        assert (beta[b].numpy()[outside] == rnnt.NEG_INF).all()


def test_rnnt_sweeps_run_no_plain_version_off_the_cpu(monkeypatch):
    # a tensor that is not on the CPU goes to the kernel or raises: never
    # to the plain sweeps
    def forbidden(*args):
        raise AssertionError("plain sweep on a card tensor")

    monkeypatch.setattr(rnnt, "rnnt_alpha_plain", forbidden)
    monkeypatch.setattr(rnnt, "rnnt_beta_plain", forbidden)
    blank = torch.zeros(2, 3, 4, device="meta")
    lens = torch.ones(2, dtype=torch.long, device="meta")
    for sweep in (rnnt.rnnt_alpha, rnnt.rnnt_beta):
        with pytest.raises(RuntimeError, match="no kernel for meta"):
            sweep(blank, blank, lens, lens)


# ---- the streaming encoder ------------------------------------------------

ENC_CONF = {"output_size": 32, "attention_heads": 4, "linear_units": 64,
            "num_blocks": 2, "chunk_size": 4, "left_chunks": 2,
            "cnn_kernel": 5}


def test_chunk_attention_mask_matches_jax():
    for T, chunk, left in ((19, 4, 2), (45, 20, 4), (7, 3, 0)):
        np.testing.assert_array_equal(
            streaming_encoder.chunk_attention_mask(T, chunk, left).numpy(),
            np.asarray(jax_streaming.chunk_attention_mask(T, chunk, left)))


def test_causal_conv_module_matches_jax(record_property):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 13, 32).astype(np.float32)
    valid = np.arange(13)[None] < np.array([13, 6, 9])[:, None]
    jmod = jax_streaming.CausalConvModule(32, 5)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(valid))
    flat, params = _perturbed(params)
    ref, _ = jax.jit(jmod.apply)(params, jnp.asarray(x), jnp.asarray(valid))
    ours = _load(streaming_encoder.CausalConvModule(32, 5), flat)(
        _t(x), _t(valid))
    # two pointwise products of 32 terms and a 5-tap conv: outputs O(1)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    record_property("max_abs_err:causal_conv",
                    float(np.abs(ours.detach().numpy() - ref).max()))


def test_streaming_encoder_matches_jax_on_every_frame(record_property):
    # 80 feature frames -> 19 encoder frames in chunks of 4; the second
    # utterance keeps 2 frames, so its queries from frame 12 on have no
    # valid key in their window and softmax to uniform in both
    rng = np.random.RandomState(2)
    feats = rng.randn(3, 80, 80).astype(np.float32)
    lens = np.array([80, 14, 50], np.int32)
    jenc = jax_streaming.StreamingConformerEncoder(input_size=80, **ENC_CONF)
    # init and apply compiled whole: faster than op-by-op dispatch
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(feats),
                                jnp.asarray(lens))
    flat, params = _perturbed(params)
    ref, ref_lens = jax.jit(jenc.apply)(params, jnp.asarray(feats),
                                        jnp.asarray(lens))
    enc = _load(streaming_encoder.StreamingConformerEncoder(80, **ENC_CONF),
                flat).eval()
    with torch.no_grad():
        ours, olens = enc(_t(feats), _t(lens).long())
    np.testing.assert_array_equal(olens.numpy(), np.asarray(ref_lens))
    assert int(olens[1]) == 2 and ours.shape == ref.shape == (3, 19, 32)
    # two blocks, LayerNorm-ed outputs O(1), fp32 sums in another order
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    record_property("max_abs_err:streaming_encoder",
                    float(np.abs(ours.numpy() - ref).max()))


# ---- the prediction network and the joint ------------------------------

def test_rnn_decoder_and_step_and_joint_match_jax(record_property):
    rng = np.random.RandomState(3)
    labels = rng.randint(0, V, (3, 7)).astype(np.int32)
    jdec = JaxRNNDecoder(V, hidden_size=16, num_layers=2, embed_size=12)
    params = jax.jit(jdec.init)(jax.random.PRNGKey(0), jnp.asarray(labels))
    flat, params = _perturbed(params)
    jstep = jax.jit(lambda p, c, y: jdec.apply(p, c, y, method=jdec.step))
    dec = _load(RNNDecoder(V, hidden_size=16, num_layers=2, embed_size=12),
                flat).eval()
    ref = np.asarray(jdec.apply(params, jnp.asarray(labels)))
    with torch.no_grad():
        ours = dec(_t(labels).long())
        carry = dec.init_carry(3)
        jcarry = jdec.apply(params, 3, method=jdec.init_carry)
        for u in range(labels.shape[1]):
            out, carry = dec.step(carry, _t(labels[:, u]).long())
            jout, jcarry = jstep(params, jcarry, jnp.asarray(labels[:, u]))
            # tanh-bounded states through two cells
            np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                       atol=1e-6, rtol=0)
            for (c, h), (jc, jh) in zip(carry, jcarry):
                np.testing.assert_allclose(c.numpy(), np.asarray(jc),
                                           atol=1e-6, rtol=0)
                np.testing.assert_allclose(h.numpy(), np.asarray(jh),
                                           atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)
    enc = rng.randn(3, 5, 1, 20).astype(np.float32)
    jjoint = JaxJoint(V, joint_space_size=24)
    jparams = jjoint.init(jax.random.PRNGKey(1), jnp.asarray(enc),
                          jnp.asarray(ref[:, None]))
    jflat, jparams = _perturbed(jparams, seed=1)
    joint = _load(JointNetwork(V, 20, 16, joint_space_size=24), jflat)
    jref = np.asarray(jjoint.apply(jparams, jnp.asarray(enc),
                                   jnp.asarray(ref[:, None])))
    with torch.no_grad():
        logits = joint(_t(enc), _t(ref[:, None]))
    assert logits.shape == jref.shape == (3, 5, 7, V)
    np.testing.assert_allclose(logits.numpy(), jref, atol=1e-5, rtol=0)
    record_property("max_abs_err:decoder", float(np.abs(ours.numpy()
                                                         - ref).max()))
    record_property("max_abs_err:joint", float(np.abs(logits.numpy()
                                                       - jref).max()))


# ---- the whole small model ------------------------------------------------

def small_cfg():
    return {
        "token_list": ["<blank>", "a", "e", "i", "o", "u", "n", "<space>",
                       "<sos/eos>"],
        "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
        "normalize": "global_mvn",
        "stats_file": str(ASSET / "feats_stats.npz"),
        "encoder": "streaming_conformer",
        "encoder_conf": dict(ENC_CONF),
        "decoder": "rnn",
        "decoder_conf": {"hidden_size": 32},
        "joint_conf": {"joint_space_size": 32},
        "model_conf": {"aux_ctc_weight": 0.3},
    }


@pytest.fixture(scope="module")
def small():
    cfg = small_cfg()
    jmodel = JaxTransducerTask.build_model(cfg)
    flat, params = flax_params(jmodel, **JaxTransducerTask.example_batch(cfg))
    model = _load(build_model(cfg), flat).eval()
    return cfg, jmodel, params, flat, model


def _batch():
    rng = np.random.RandomState(4)
    lens = (9000, 2100, 7600)
    speech = np.zeros((3, 9000), np.float32)
    for i, n in enumerate(lens):
        speech[i, :n] = 0.3 * rng.randn(n)
    text = rng.randint(1, V, size=(3, 8))
    for i, n in enumerate((8, 2, 5)):
        text[i, n:] = 0
    return {"speech": speech, "speech_lengths": np.asarray(lens, np.int32),
            "text": text.astype(np.int32),
            "text_lengths": np.asarray([8, 2, 5], np.int32)}


def test_small_transducer_loss_and_every_gradient(small, record_property):
    cfg, jmodel, params, flat, model = small
    batch = _batch()

    def loss_fn(p):
        loss, stats, _ = jmodel.apply(p, **{k: jnp.asarray(v) for k, v in
                                            batch.items()})
        return loss, stats

    (ref_loss, ref_stats), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    model.zero_grad()
    loss, stats, weight = model(**{k: _t(v) if v.dtype.kind == "f"
                                   else _t(v).long()
                                   for k, v in batch.items()})
    loss.backward()
    assert weight == 3
    assert set(stats) == set(ref_stats) == {"loss", "loss_rnnt",
                                            "loss_aux_ctc"}
    for key in stats:
        # losses of O(10-50) through two blocks, the LSTM and the joint
        np.testing.assert_allclose(stats[key].item(), float(ref_stats[key]),
                                   rtol=2e-6, atol=1e-6)
    grads = convert.state_dict_to_flax(model, grad=True)
    ref_grads = {k: np.asarray(v)
                 for k, v in flatten_dict(ref_grads, sep="/").items()}
    assert sorted(grads) == sorted(ref_grads)
    worst = 0.0
    for name, ref in ref_grads.items():
        # 1e-4 of each parameter's own gradient scale, and 1e-7 absolute
        # for the key biases, whose gradient is zero by the softmax's
        # shift invariance and so is fp32 noise in both
        scale = np.abs(ref).max()
        np.testing.assert_allclose(grads[name], ref, rtol=0,
                                   atol=1e-4 * scale + 1e-7, err_msg=name)
        if scale > 1e-6:
            worst = max(worst, float(np.abs(grads[name] - ref).max() / scale))
    record_property("max_rel_err:gradients", worst)


@pytest.mark.parametrize("search_type", ["greedy", "default"])
def test_small_transducer_hypotheses_match_jax(small, search_type):
    cfg, jmodel, params, flat, model = small
    batch = _batch()
    jenc, jlens = jmodel.apply(params, jnp.asarray(batch["speech"]),
                               jnp.asarray(batch["speech_lengths"]),
                               method=jmodel.encode)
    ref = jax_decode_transducer(jmodel, params, jenc, jlens,
                                JaxSearchConfig(beam_size=5, nbest=3,
                                                search_type=search_type))
    with torch.no_grad():
        enc, lens = model.encode(_t(batch["speech"]),
                                 _t(batch["speech_lengths"]).long())
        ours = decode_transducer(model, enc, lens, TransducerSearchConfig(
            beam_size=5, nbest=3, search_type=search_type))
    assert [[ids for ids, _ in h] for h in ours] == \
        [[ids for ids, _ in h] for h in ref]
    for h, rh in zip(ours, ref):
        np.testing.assert_allclose([s for _, s in h], [s for _, s in rh],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("search_type", ["greedy", "default"])
def test_asset_hypotheses_match_jax_on_held_out_utterances(search_type):
    utts = [SynthSpeechCorpus().utterance("test", i) for i in range(4)]
    speech = np.zeros((4, 74656), np.float32)   # collate_fixed_lengths
    for i, (w, _, _) in enumerate(utts):
        speech[i, :len(w)] = w
    lens = np.asarray([len(w) for w, _, _ in utts], np.int32)
    kw = dict(train_config=ASSET / "config.yaml", model_file=ASSET,
              beam_size=5, search_type=search_type)
    ref = JaxSpeech2TextTransducer(**kw)(speech, lens)
    ours = Speech2TextTransducer(device="cpu", **kw)(speech, lens)
    assert [n[0][2] for n in ours] == [n[0][2] for n in ref]
    assert [n[0][0] for n in ours] == [text for _, text, _ in utts]


def test_speech2text_transducer_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Speech2TextTransducer(train_config=ASSET / "config.yaml",
                              model_file=ASSET)


def test_unported_search_types_raise(small):
    _, _, _, _, model = small
    enc = torch.zeros(1, 3, 32)
    with pytest.raises(NotImplementedError, match="maes"):
        decode_transducer(model, enc, torch.tensor([3]),
                          TransducerSearchConfig(search_type="maes"))


# ---- the training entry point ---------------------------------------------

def test_entry_point_trains_two_steps_and_the_checkpoint_reloads(
        tmp_path, monkeypatch):
    SynthSpeechCorpus().materialize(tmp_path / "data", n_train=6, n_valid=3,
                                    n_test=0)
    data = {split: [f"{tmp_path}/data/{split}/wav.scp,speech,sound",
                    f"{tmp_path}/data/{split}/text,text,text"]
            for split in ("train", "valid")}
    cfg = {
        "output_dir": str(tmp_path / "exp"), "seed": 0, "max_epoch": 1,
        "num_iters_per_epoch": 2, "batch_type": "sorted", "batch_size": 3,
        "log_interval": 1, "optim": "adam", "optim_conf": {"lr": 0.002},
        "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 600},
        "train_data_path_and_name_and_type": data["train"],
        "valid_data_path_and_name_and_type": data["valid"],
        "token_list": str(ASSET / "tokens.txt"), "normalize": "global_mvn",
        "stats_file": str(ASSET / "feats_stats.npz"), "specaug": "specaug",
        "specaug_conf": {"num_freq_mask": 2, "freq_mask_width_range": [0, 10],
                         "num_time_mask": 2, "time_mask_width_range": [0, 20]},
        "encoder": "streaming_conformer", "encoder_conf": dict(ENC_CONF),
        "decoder": "rnn", "decoder_conf": {"hidden_size": 32},
        "joint_conf": {"joint_space_size": 32},
        "model_conf": {"aux_ctc_weight": 0.3},
        "collate_fixed_lengths": {"speech": 40000, "text": 64}}
    dump_yaml(cfg, tmp_path / "train.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        asr_transducer_train.main(["--config", str(tmp_path / "train.yaml")])
    resolved, trainer = asr_transducer_train.main(
        ["--config", str(tmp_path / "train.yaml"), "--device", "cpu"])
    assert len(trainer.step_stats) == 2
    for stats in trainer.step_stats:
        assert stats["skipped"] == 0.0
        for key in ("loss", "loss_rnnt", "loss_aux_ctc", "grad_norm"):
            assert np.isfinite(stats[key]), key
    valid = trainer.reporter.stats[1]["valid"]
    fresh = _load(build_model(resolved),
                  load_checkpoint(tmp_path / "exp" / "checkpoint")[0])
    reloaded = evaluate(fresh, ASRTransducerTask.build_iter_factory(
        resolved, train=False), "cpu")
    assert reloaded["loss"] == valid["loss"]


def test_entry_point_builds_a_transducer_from_the_asset_config():
    model = build_model({**ASRTransducerTask.default_config(),
                         **_asset_cfg()})
    assert sum(p.numel() for p in model.parameters()) == 11627826
    # every one of the asset's 233 arrays maps to one port parameter
    _load(model, convert.read_npz(ASSET / "params_f16.npz"))
    assert len(model.state_dict()) == 233


def _asset_cfg():
    from espnet_tpu_torch.utils.config import load_yaml
    cfg = load_yaml(ASSET / "config.yaml")
    cfg["token_list"] = str(ASSET / "tokens.txt")
    cfg["stats_file"] = str(ASSET / "feats_stats.npz")
    return cfg


# ---- the CTC repair ---------------------------------------------------------

def _ctc_case(name):
    """The cases of tests/test_torch_train.py's CTC test."""
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
    B, T, U, V_ = 5, 24, 7, 11
    logits = (rng.standard_normal((B, T, V_)) * 2).astype(np.float32)
    ys = rng.integers(1, V_, size=(B, U))
    if name == "repeats":
        ys[:, 1], ys[:, 3] = ys[:, 0], ys[:, 2]
    hlens = rng.integers(T // 2, T + 1, size=(B,))
    ylens = rng.integers(1, U + 1, size=(B,))
    return logits, hlens, ys, ylens


@jax.jit
def _jax_ctc(logits, hlens, ys, ylens, weights):
    """((weighted sum, nll), gradient) of the JAX package's CTC, compiled
    whole (faster than op-by-op dispatch, and once for cases of one
    shape)."""
    def loss(x):
        nll = jax_losses.ctc_nll(x, hlens, ys, ylens, 0)
        return jnp.sum(weights * nll), nll
    (value, nll), grad = jax.value_and_grad(loss, has_aux=True)(logits)
    return (value, nll), grad


@pytest.mark.parametrize("name", ["rand", "repeats", "impossible",
                                  "single"])
def test_ctc_gradient_is_the_closed_form_of_the_jax_package(name):
    logits, hlens, ys, ylens = _ctc_case(name)
    args = [jnp.asarray(a.astype(np.int32)) for a in (hlens, ys, ylens)]
    weights = np.linspace(0.5, 1.5, len(hlens)).astype(np.float32)
    (ref, ref_nll), ref_g = _jax_ctc(jnp.asarray(logits), *args,
                                     jnp.asarray(weights))
    x = _t(logits).requires_grad_()
    nll = losses.ctc_nll(x, _t(hlens), _t(ys), _t(ylens))
    loss = (_t(weights) * nll).sum()
    # the port's own Function: no CtcLossBackward anywhere in the graph
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo.extend(f for f, _ in fn.next_functions)
    names = {type(fn).__name__ for fn in seen}
    assert "_CTCNLLBackward" in names
    assert not any("CtcLoss" in n for n in names)
    (g,) = torch.autograd.grad(loss, (x,))
    ok = nll.detach().numpy() < 1e29   # impossible ones saturate near 1e30
    np.testing.assert_allclose(nll.detach().numpy()[ok],
                               np.asarray(ref_nll)[ok], rtol=1e-5)
    # the same closed form; the port's recursions in fp64, the JAX
    # package's in fp32: gradients of O(0.1) within 1e-5
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=1e-5,
                               rtol=0)
