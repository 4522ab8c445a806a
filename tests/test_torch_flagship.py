"""The port's slice as a whole against the JAX package on the flagship
hybrid CTC/attention Conformer (assets/synth_asr_flagship), on the CPU,
over held-out SynthSpeechCorpus utterances."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.bin.asr_inference import Speech2Text as JaxSpeech2Text
from espnet_tpu_torch.bin.asr_inference import Speech2Text
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus

ASSET = Path(__file__).resolve().parents[1] / "assets" / "synth_asr_flagship"
N_UTTS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flagship():
    kw = dict(asr_train_config=ASSET / "config.yaml", asr_model_file=ASSET,
              beam_size=10, ctc_weight=0.3)
    utts = [SynthSpeechCorpus().utterance("test", i) for i in range(N_UTTS)]
    speech = np.zeros((N_UTTS, max(len(w) for w, _, _ in utts)), np.float32)
    lengths = np.array([len(w) for w, _, _ in utts], np.int64)
    for i, (w, _, _) in enumerate(utts):
        speech[i, :len(w)] = w
    return (JaxSpeech2Text(**kw), Speech2Text(device="cpu", **kw), speech,
            lengths)


@torch.no_grad()
def test_flagship_encoder_and_ctc_log_probs(flagship, record_property):
    jax_s2t, s2t, speech, lengths = flagship
    enc, enc_lens = jax_s2t._encode(jax_s2t.params, jnp.asarray(speech),
                                    jnp.asarray(lengths.astype(np.int32)))
    logp = np.asarray(jax.nn.log_softmax(
        jax_s2t._ctc_logits(jax_s2t.params, enc), axis=-1))
    tenc, tenc_lens = s2t.model.encode(torch.from_numpy(speech),
                                       torch.from_numpy(lengths))
    tlogp = torch.log_softmax(s2t.model.ctc_logits(tenc), dim=-1).numpy()
    np.testing.assert_array_equal(tenc_lens.numpy(), np.asarray(enc_lens))
    enc = np.asarray(enc)
    # fp32 through 6 blocks with sums in another order: about 1e-4 of the
    # output's scale (LayerNorm outputs, O(1))
    np.testing.assert_allclose(tenc.numpy(), enc, atol=1e-4 * np.abs(
        enc).max(), rtol=0)
    valid = np.arange(enc.shape[1])[None] < np.asarray(enc_lens)[:, None]
    np.testing.assert_allclose(tlogp[valid], logp[valid], atol=2e-3)
    record_property("max_abs_err:encoder",
                    float(np.abs(tenc.numpy() - enc).max()))
    record_property("encoder_scale", float(np.abs(enc).max()))
    record_property("max_abs_err:ctc_log_probs",
                    float(np.abs(tlogp[valid] - logp[valid]).max()))


def test_flagship_beam_decode_is_token_identical(flagship):
    jax_s2t, s2t, speech, lengths = flagship
    ref = jax_s2t(speech, lengths.astype(np.int32))
    out = s2t(speech, lengths)
    assert [[h[2] for h in nbest] for nbest in out] == \
        [[h[2] for h in nbest] for nbest in ref]
    assert [nbest[0][0] for nbest in out] == [nbest[0][0] for nbest in ref]
    np.testing.assert_allclose([nbest[0][3] for nbest in out],
                               [nbest[0][3] for nbest in ref], atol=1e-3)


def test_flagship_greedy_decode_matches(flagship):
    jax_s2t, s2t, speech, lengths = flagship
    jax_s2t.beam_size = s2t.beam_size = 1
    try:
        ref = jax_s2t(speech, lengths.astype(np.int32))
        out = s2t(speech, lengths)
    finally:
        jax_s2t.beam_size = s2t.beam_size = 10
    assert [nbest[0][2] for nbest in out] == [nbest[0][2] for nbest in ref]
