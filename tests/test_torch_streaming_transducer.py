"""The port's streaming transducer and its batch-decode CLI against the
JAX package, on the CPU: ``greedy_stream_step`` over encoder chunks
(against the JAX package's and the port's full-utterance greedy search),
``Speech2TextTransducerStreaming`` and ``inference()``, on a small
transducer (d = 32, 2 blocks, chunk 4, 2 left chunks, kernel 5, an LSTM
prediction network of 32, aux CTC) saved as the committed assets are.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.bin import asr_transducer_inference as jax_transducer_bin
from espnet_tpu.decode import transducer_search as jax_search
from espnet_tpu.tasks.asr_transducer import \
    ASRTransducerTask as JaxTransducerTask
from espnet_tpu_torch.bin import asr_transducer_inference
from espnet_tpu_torch.data.fileio import write_wav
from espnet_tpu_torch.decode import transducer_search
from espnet_tpu_torch.frontends.streaming import StreamingFeatureExtractor
from tests.torch_streaming_models import (TRANSDUCER, noise, pushes,
                                          save_model)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def transducer(tmp_path_factory):
    return save_model(tmp_path_factory.mktemp("transducer"), TRANSDUCER,
                      JaxTransducerTask)


def test_greedy_stream_step_matches_jax_and_the_full_search(transducer):
    # the streaming transducer search over encoder chunks of 4 frames
    # (the last ragged through chunk_lens), two rows with other lengths:
    # the JAX package's tokens and counts, and the port's full-utterance
    # greedy search (tests/test_transducer.py asserts the same of the JAX
    # package); Umax 6 saturates the second case's token slots
    model = asr_transducer_inference.Speech2TextTransducerStreaming(
        transducer / "config.yaml", transducer, device="cpu").model
    jmodel, params, _ = JaxTransducerTask.build_model_from_file(
        transducer / "config.yaml", transducer)
    rng = np.random.RandomState(7)
    enc = (2.0 * rng.randn(2, 14, 32)).astype(np.float32)
    lens = np.array([14, 9])
    jstep = jax.jit(lambda p, e, n, st: jax_search.greedy_stream_step(
        jmodel, p, e, n, st, max_sym_exp=3))
    for umax in (64, 6):
        jst = jax_search.greedy_stream_init(jmodel, params, 2, umax)
        st = transducer_search.greedy_stream_init(model, 2, umax)
        for c in range(0, 14, 4):
            n = np.clip(lens - c, 0, 4)
            e = np.zeros((2, 4, 32), np.float32)
            e[:, :min(4, 14 - c)] = enc[:, c:c + 4]
            jst = jstep(params, jnp.asarray(e), jnp.asarray(n, jnp.int32),
                        jst)
            with torch.no_grad():
                st = transducer_search.greedy_stream_step(
                    model, _t(e), _t(n).long(), st, 3)
        assert st.n_tok.tolist() == np.asarray(jst.n_tok).tolist()
        np.testing.assert_array_equal(st.tokens.numpy(),
                                      np.asarray(jst.tokens))
        if umax == 64:
            with torch.no_grad():
                tokens, n_tok = transducer_search.greedy_search(
                    model, _t(enc), _t(lens).long())
            assert n_tok.tolist() == st.n_tok.tolist()
            assert min(n_tok.tolist()) > 0
            for b in range(2):
                assert (tokens[b, :n_tok[b]].tolist()
                        == st.tokens[b, :st.n_tok[b]].tolist())
        else:
            assert max(st.n_tok.tolist()) > umax


def test_transducer_session_matches_jax(transducer):
    # the JAX package's class as it is (no MVN, the padded tail decoded),
    # on the same pushes; the ids after every push
    kw = dict(train_config=transducer / "config.yaml", model_file=transducer)
    ref = jax_transducer_bin.Speech2TextTransducerStreaming(**kw)
    ours = asr_transducer_inference.Speech2TextTransducerStreaming(
        **kw, device="cpu")
    for piece, final in pushes(noise(4500, 3), 1536):
        a, b = ours(piece, is_final=final), ref(piece, is_final=final)
        assert a[0][2] == b[0][2]
    assert a[0][2]


def test_transducer_inference_writes_the_jax_packages_files(tmp_path,
                                                            transducer):
    # 3 utterances of random audio in batches of 2 (the second bucket-
    # padded), beam 3
    d = tmp_path / "data"
    d.mkdir()
    with open(d / "wav.scp", "w") as f:
        for i, n in enumerate((5200, 3900, 4700)):
            write_wav(d / f"u{i}.wav", 8000, noise(n, 20 + i))
            f.write(f"u{i} {d / f'u{i}.wav'}\n")
    kw = dict(data_path_and_name_and_type=[f"{d}/wav.scp,speech,sound"],
              train_config=str(transducer / "config.yaml"),
              model_file=str(transducer), batch_size=2, beam_size=3)
    jax_transducer_bin.inference(output_dir=str(tmp_path / "jax"), **kw)
    asr_transducer_inference.main(
        [f"--{k}={v}" for k, v in kw.items()
         if k != "data_path_and_name_and_type"]
        + ["--data_path_and_name_and_type", f"{d}/wav.scp,speech,sound",
           "--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    for name in ("text", "token", "token_int", "score"):
        ours = (tmp_path / "port" / "1best_recog" / name).read_text()
        ref = (tmp_path / "jax" / "1best_recog" / name).read_text()
        assert len(ours.splitlines()) == 3
        if name != "score":
            assert ours == ref, name
            continue
        # log-probabilities summed over <= 30 steps in fp32, normalised
        # by length: their last digits differ
        for a, b in zip(ours.splitlines(), ref.splitlines()):
            assert a.split()[0] == b.split()[0]
            assert abs(float(a.split()[1]) - float(b.split()[1])) <= 1e-4


def test_entry_points_need_a_card_or_the_cpu(monkeypatch, transducer,
                                             tmp_path):
    from espnet_tpu_torch.bin import lm_calc_perplexity, tts_inference
    from espnet_tpu_torch.bin.asr_inference import Speech2Text
    from espnet_tpu_torch.tasks.gan_tts import GANTTSTask
    from espnet_tpu_torch.tasks.lm import LMTask
    assets = Path(__file__).resolve().parents[1] / "assets"
    lm, tts = assets / "synth_lm", assets / "synth_tts_vits"
    flagship = assets / "synth_asr_flagship"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
            lambda: asr_transducer_inference.Speech2TextTransducerStreaming(
                transducer / "config.yaml", transducer),
            lambda: asr_transducer_inference.inference(
                tmp_path, [], transducer / "config.yaml", transducer),
            StreamingFeatureExtractor,
            lambda: LMTask.build_model_from_file(lm / "config.yaml", lm),
            lambda: lm_calc_perplexity.calc_perplexity(
                lm / "config.yaml", lm, []),
            lambda: Speech2Text(flagship / "config.yaml", flagship,
                                lm_train_config=lm / "config.yaml",
                                lm_file=lm),
            lambda: GANTTSTask.build_model_from_file(tts / "config.yaml",
                                                     tts),
            lambda: tts_inference.Text2Speech(tts / "config.yaml", tts),
            lambda: tts_inference.inference(tmp_path, [],
                                            tts / "config.yaml", tts)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
