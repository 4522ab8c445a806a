"""The port's Transformer LM and its shallow fusion in beam search against
the JAX package, on the CPU: a small LM (2 layers, d = 32, 25 tokens) and
a small hybrid ASR model (1 conformer block, d = 32, 1 decoder layer) on
the flagship's token list, weights filled from a numpy seed; the LM
asset at full width; the perplexity entry point and Speech2Text with the
LM. Log-probabilities and per-step scores are held to 1e-5 of their
largest entry: fp32 sums over at most 1024 terms in another order.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.bin.lm_calc_perplexity import \
    calc_perplexity as jax_calc_perplexity
from espnet_tpu.decode.beam_search import \
    BeamSearchConfig as JaxBeamSearchConfig
from espnet_tpu.decode.beam_search import \
    batch_beam_search as jax_batch_beam_search
from espnet_tpu.models.lm import LanguageModel as JaxLanguageModel
from espnet_tpu.tasks.asr import ASRTask as JaxASRTask
from espnet_tpu.tasks.lm import LMTask as JaxLMTask
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin.lm_calc_perplexity import calc_perplexity
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.decode.beam_search import (BeamSearchConfig,
                                                 batch_beam_search)
from espnet_tpu_torch.models.lm import LanguageModel
from espnet_tpu_torch.tasks.asr import build_model, read_token_list
from espnet_tpu_torch.tasks.lm import LMTask
from chip_smoke import lm_sentences, write_text
from tests.torch_streaming_models import flax_params

ROOT = Path(__file__).resolve().parents[1]
LM_ASSET = ROOT / "assets" / "synth_lm"
FLAGSHIP = ROOT / "assets" / "synth_asr_flagship"
TOKENS = read_token_list(FLAGSHIP / "tokens.txt")
V = len(TOKENS)
LM_CONF = {"embed_unit": 16, "att_unit": 32, "head": 2, "unit": 48,
           "layer": 2, "dropout_rate": 0.1}
REL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _jit(module, method):
    """module.apply(params, *args, method=method), compiled once."""
    return jax.jit(lambda params, *args: module.apply(params, *args,
                                                      method=method))


def _rel_close(ours, ref, rel=REL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * float(np.abs(ref).max()), err
    return err


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_lm():
    text = np.ones((2, 8), np.int32)
    jlm = JaxLanguageModel(V, "transformer", LM_CONF)
    flat, tree = flax_params(jlm, text, np.asarray([8, 5], np.int32), seed=3)
    tlm = convert.load_flax_params(
        LanguageModel(V, "transformer", LM_CONF), flat).eval()
    return jlm, {"params": tree["params"]}, tlm


@pytest.fixture(scope="module")
def text_batch():
    rng = np.random.RandomState(4)
    text = rng.randint(1, V - 1, size=(3, 9)).astype(np.int32)
    return text, np.asarray([9, 6, 1], np.int32)


def test_forward_and_nll(small_lm, text_batch):
    jlm, params, tlm = small_lm
    text, lens = text_batch
    jnll, jvalid, jlogits, jt = _jit(jlm, jlm.nll)(
        params, jnp.asarray(text), jnp.asarray(lens))
    with torch.no_grad():
        nll, valid, logits, t = tlm.nll(_t(text).long(), _t(lens).long())
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    _rel_close(logits.numpy(), jlogits)
    _rel_close(nll.numpy(), jnll)


def test_score_step_per_step(small_lm, text_batch):
    """Eight cached steps against the JAX LM's, and against the full
    forward's causal rows (the JAX table's position 2047 clamps too)."""
    jlm, params, tlm = small_lm
    text, _ = text_batch
    jstate = jlm.apply(params, 3, 10, method=jlm.init_carry)
    jstep = _jit(jlm, jlm.score_step)
    state = tlm.init_carry(3, 10)
    with torch.no_grad():
        full = torch.log_softmax(tlm.lm(_t(text).long()), dim=-1)
        for step in range(8):
            jl, jstate = jstep(params, jnp.asarray(text[:, step]), step,
                               jstate)
            lp, state = tlm.score_step(_t(text[:, step]).long(), step, state)
            _rel_close(lp.numpy(), jl)
            _rel_close(lp.numpy(), full[:, step].numpy())
        _rel_close(state["cache_k"].numpy(), jstate["cache_k"])
        far = tlm.lm._embed_pos(_t(text[:, 0]).long(), 5000)
    jfar = jlm.apply(params, jnp.asarray(text[:, 0]), 5000,
                     method=lambda m, t, p: m.lm._embed_pos(t, p))
    _rel_close(far.numpy(), jfar)


RECORDED = []


class RecordingLM(JaxLanguageModel):
    """The JAX LM, recording each beam step's tokens and log-probs."""

    def score_step(self, token, step, state):
        logp, state = super().score_step(token, step, state)
        jax.debug.callback(lambda t, lp: RECORDED.append(
            (np.asarray(t), np.asarray(lp))), token, logp, ordered=True)
        return logp, state


class Recording:
    """The port's LM scorer, recording each beam step's tokens and
    log-probs."""

    def __init__(self, lm):
        self.lm, self.steps = lm, []

    def init_carry(self, *args, **kwargs):
        return self.lm.init_carry(*args, **kwargs)

    def score_step(self, token, step, state):
        logp, state = self.lm.score_step(token, step, state)
        self.steps.append((token.numpy().copy(), logp.numpy().copy()))
        return logp, state

    def select_state(self, state, idx):
        return self.lm.select_state(state, idx)


def test_lm_fused_beam_search_per_step(small_lm):
    """The fused search's LM scores at every step (which the beam's
    reordering feeds: a state gathered one step late scores other
    prefixes) and its n-best against the JAX package's."""
    jlm, lm_params, tlm = small_lm
    cfg = {"token_list": TOKENS, "frontend_conf": {"n_fft": 512,
                                                   "hop_length": 128,
                                                   "n_mels": 80},
           "normalize": "global_mvn",
           "stats_file": str(FLAGSHIP / "feats_stats.npz"),
           "encoder": "conformer",
           "encoder_conf": {"output_size": 32, "attention_heads": 2,
                            "linear_units": 48, "num_blocks": 1,
                            "cnn_module_kernel": 5},
           "decoder": "transformer",
           "decoder_conf": {"attention_heads": 2, "linear_units": 48,
                            "num_blocks": 1},
           "model_conf": {"ctc_weight": 0.3}}
    jasr = JaxASRTask.build_model(cfg)
    flat, tree = flax_params(jasr, **JaxASRTask.example_batch(cfg), seed=5)
    tasr = convert.load_flax_params(build_model(cfg), flat).eval()
    rng = np.random.RandomState(6)
    enc = rng.randn(2, 14, 32).astype(np.float32)
    enc_lens = np.asarray([14, 9], np.int32)
    rec_jlm = RecordingLM(V, "transformer", LM_CONF)
    RECORDED.clear()
    ref = jax_batch_beam_search(
        jasr, {"params": tree["params"]}, jnp.asarray(enc),
        jnp.asarray(enc_lens),
        JaxBeamSearchConfig(beam_size=4, ctc_weight=0.3, lm_weight=0.5,
                            nbest=2), lm=rec_jlm, lm_params=lm_params)
    rec = Recording(tlm)
    out = batch_beam_search(
        tasr, _t(enc), _t(enc_lens).long(),
        BeamSearchConfig(beam_size=4, ctc_weight=0.3, lm_weight=0.5,
                         nbest=2), rec)
    assert len(rec.steps) == len(RECORDED) >= 4
    for (tok, lp), (jtok, jlp) in zip(rec.steps, RECORDED):
        np.testing.assert_array_equal(tok, jtok)
        _rel_close(lp, jlp)
    assert [[ids for ids, _ in h] for h in out] == \
        [[ids for ids, _ in h] for h in ref]
    _rel_close([s for h in out for _, s in h], [s for h in ref for _, s in h])


@pytest.fixture(scope="module")
def lm_asset():
    jmodel, jparams, _ = JaxLMTask.build_model_from_file(
        LM_ASSET / "config.yaml", LM_ASSET)
    tmodel, _ = LMTask.build_model_from_file(LM_ASSET / "config.yaml",
                                             LM_ASSET, "cpu")
    return jmodel, jparams, tmodel


def test_lm_asset_full_width(lm_asset):
    """The committed LM (4 layers, d = 256, 4 heads) on two held-out
    sentences: log-probabilities of the full forward and of 6 steps."""
    jmodel, jparams, tmodel = lm_asset
    pre = LMTask.build_preprocess_fn(
        {"token_list": str(LM_ASSET / "tokens.txt")}, train=False)
    ids = [pre(k, {"text": s})["text"]
           for k, s in lm_sentences(SynthSpeechCorpus(), 2)]
    text = np.zeros((2, max(map(len, ids))), np.int32)
    for i, x in enumerate(ids):
        text[i, :len(x)] = x
    lens = np.asarray([len(x) for x in ids], np.int32)
    jnll = _jit(jmodel, jmodel.nll)(jparams, jnp.asarray(text),
                                    jnp.asarray(lens))[0]
    jstate = jmodel.apply(jparams, 2, 8, method=jmodel.init_carry)
    jstep = _jit(jmodel, jmodel.score_step)
    state = tmodel.init_carry(2, 8)
    with torch.no_grad():
        _rel_close(tmodel.nll(_t(text).long(), _t(lens).long())[0].numpy(),
                   jnll)
        for step in range(6):
            jl, jstate = jstep(jparams, jnp.asarray(text[:, step]), step,
                               jstate)
            lp, state = tmodel.score_step(_t(text[:, step]).long(), step,
                                          state)
            _rel_close(lp.numpy(), jl)


def test_lm_converter_round_trip(lm_asset):
    flat = convert.read_npz(LM_ASSET / "params_f16.npz")
    back = convert.state_dict_to_flax(lm_asset[2])
    assert sorted(back) == sorted(flat) and len(flat) == 71
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_calc_perplexity_entry_point(tmp_path):
    """bin/lm_calc_perplexity on 10 of the recipe's valid sentences in
    batches of 4, and its output file, against the JAX package's."""
    text = tmp_path / "text"
    write_text(text, lm_sentences(SynthSpeechCorpus(), 10))
    kw = dict(train_config=str(LM_ASSET / "config.yaml"),
              model_file=str(LM_ASSET),
              data_path_and_name_and_type=[f"{text},text,text"],
              batch_size=4)
    ref = jax_calc_perplexity(**kw)
    from espnet_tpu_torch.bin import lm_calc_perplexity
    lm_calc_perplexity.main([f"--{k}={v}" for k, v in kw.items()
                             if k != "data_path_and_name_and_type"]
                            + ["--data_path_and_name_and_type",
                               f"{text},text,text", "--device", "cpu",
                               "--output_dir", str(tmp_path / "out")])
    ppl = float((tmp_path / "out" / "ppl").read_text())
    assert abs(ppl / ref - 1) <= 1e-5
    assert calc_perplexity(**kw, device="cpu") == ppl


def test_speech2text_fuses_the_lm():
    """Speech2Text's LM arguments reach the search: its n-best with the
    LM asset at weight 0.3 is the fused search's on the same encoder
    output; an LM given by one of its two files is refused."""
    from espnet_tpu_torch.bin.asr_inference import Speech2Text
    w, _, _ = SynthSpeechCorpus().utterance("test", 0)
    kw = dict(asr_train_config=FLAGSHIP / "config.yaml",
              asr_model_file=FLAGSHIP, beam_size=4, ctc_weight=0.3,
              device="cpu")
    s2t = Speech2Text(lm_train_config=LM_ASSET / "config.yaml",
                      lm_file=LM_ASSET, lm_weight=0.3, **kw)
    ((text, _, ids, score),), = s2t(w)
    lm, _ = LMTask.build_model_from_file(LM_ASSET / "config.yaml", LM_ASSET,
                                         "cpu")
    with torch.no_grad():
        enc, lens = s2t.model.encode(_t(w)[None], torch.tensor([len(w)]))
    (ref_ids, ref_score), = batch_beam_search(
        s2t.model, enc, lens, BeamSearchConfig(beam_size=4, ctc_weight=0.3,
                                               lm_weight=0.3), lm)[0]
    assert (ids, score) == (ref_ids, ref_score) and text
    with pytest.raises(ValueError):
        Speech2Text(lm_file=LM_ASSET, **kw)


@pytest.mark.parametrize("lm_type", ["seq_rnn", "hugging_face"])
def test_unported_lm_types_raise(lm_type):
    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        LanguageModel(V, lm_type, {})
