"""The port's SpeechLM against the JAX package, on the CPU: the
vocabulary, ``build_example`` over every task template, the delay
layout, the JSON datasets and ``speechlm_prepare_dataset``, the
multimodal vocabulary, the loss with ``loss_mask`` and every gradient,
greedy ``generate_scan`` token for token (ragged prompts, eos), top-k,
the committed asset at full width with the recipe's token list, its
converter round trip, ``SpeechLMInference`` and its CLI through a codec,
and the entry point in both data modes with a resume.

Small models fill the JAX tree from a numpy seed
(``tests/torch_streaming_models.py:flax_params``). Losses and gradients
are held to 1e-4 of the largest entry, the asset's loss to 1e-5.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import espnet_tpu.data.speechlm as jdata
from espnet_tpu.bin.speechlm_inference import \
    SpeechLMInference as JaxSpeechLMInference
from espnet_tpu.bin.speechlm_inference import inference as jax_inference
from espnet_tpu.bin.speechlm_prepare_dataset import main as jax_prepare
from espnet_tpu.models.speechlm import MultimodalVocabulary as JaxMMVocab
from espnet_tpu.models.speechlm import SpeechLM as JaxSpeechLM
from espnet_tpu.models.speechlm import delay_pattern as jax_delay_pattern
from espnet_tpu.models.speechlm import \
    undelay_pattern as jax_undelay_pattern
from espnet_tpu.tasks.speechlm import SpeechLMTask as JaxSpeechLMTask
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import (speechlm_inference,
                                  speechlm_prepare_dataset, speechlm_train)
from espnet_tpu_torch.data import speechlm as data
from espnet_tpu_torch.data.fileio import NpyScpWriter
from espnet_tpu_torch.models.speechlm import (MultimodalVocabulary, SpeechLM,
                                              delay_pattern, undelay_pattern)
from espnet_tpu_torch.tasks.speechlm import (SpeechLMTask,
                                             build_vocab_from_cfg,
                                             recipe_token_list)
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.utils.config import dump_yaml
from tests.torch_streaming_models import flax_params, xla_unoptimized

ROOT = Path(__file__).resolve().parents[1]
SPEECHLM = ROOT / "assets" / "synth_speechlm"
GRAD_REL = 1e-4
TOKENS = ["<blank>", "a", "b", "c", "<space>", "<sos/eos>"]
SMALL = dict(d_model=16, heads=2, units=24, layers=2)


@pytest.fixture(autouse=True, scope="module")
def jax_references_unoptimized():
    with xla_unoptimized():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), err


def _vocabs(n_streams=3, codebook=8):
    ours = data.SpeechLMVocabulary(len(TOKENS), codebook, n_streams)
    theirs = jdata.SpeechLMVocabulary(len(TOKENS), codebook, n_streams)
    return ours, theirs


def _t2i(text):
    tok = {t: i for i, t in enumerate(TOKENS)}
    return [tok.get("<space>" if c == " " else c, 0) for c in text]


def test_vocabulary_build_example_and_delay_match_jax():
    ours, theirs = _vocabs()
    for attr in ("pad", "bos", "eos", "filler", "vocab_sizes", "task_tags",
                 "text_offset", "codec_offset", "size0"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    codes = np.random.RandomState(0).randint(0, 8, (5, 3))
    for task in data.TASK_TEMPLATES:
        for delay in (True, False):
            entries = {"text1": "ab ca", "audio1": codes}
            a = data.build_example(task, entries, ours, _t2i, delay)
            b = jdata.build_example(task, entries, theirs, _t2i, delay)
            for k in ("tokens", "loss_mask"):
                np.testing.assert_array_equal(a[k], b[k])
    d = data.delay_codes(codes, 9)
    np.testing.assert_array_equal(d, jdata.delay_codes(codes, 9))
    np.testing.assert_array_equal(data.undelay_codes(d), codes)
    g = ours.encode_audio(codes)
    np.testing.assert_array_equal(ours.decode_audio(g), codes)
    np.testing.assert_array_equal(ours.decode_text(ours.encode_text(
        [1, 2])[:, 0]), theirs.decode_text(theirs.encode_text([1, 2])[:, 0]))
    with pytest.raises(ValueError):
        ours.encode_audio(codes[:, :2])


def test_delay_pattern_and_its_inverse():
    codes = np.random.RandomState(1).randint(0, 50, (2, 6, 4))
    ours = delay_pattern(torch.from_numpy(codes), pad=7)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(
        jax_delay_pattern(jnp.asarray(codes), pad=7)))
    np.testing.assert_array_equal(undelay_pattern(ours).numpy(), codes)
    np.testing.assert_array_equal(undelay_pattern(ours).numpy(), np.asarray(
        jax_undelay_pattern(jnp.asarray(ours.numpy()))))


def test_multimodal_vocabulary_matches_jax():
    mods = {"text": 5, "codec": 7}
    ours, theirs = MultimodalVocabulary(mods), JaxMMVocab(mods)
    assert ours.intervals == theirs.intervals and ours.size == theirs.size
    np.testing.assert_array_equal(
        ours.build_sequence(("text", [1, 2]), ("codec", [0, 6])).numpy(),
        np.asarray(theirs.build_sequence(("text", [1, 2]),
                                         ("codec", [0, 6]))))
    assert [ours.modality_of(i) for i in range(16)] == \
        [theirs.modality_of(i) for i in range(16)]
    np.testing.assert_array_equal(ours.decode("codec", ours.encode(
        "codec", [3])).numpy(), [3])


def _write_codes(d, n=3, T=6, Q=3, seed=2):
    rng = np.random.RandomState(seed)
    with NpyScpWriter(d / "codes", d / "codes.scp") as w:
        for i in range(n):
            w[f"u{i}"] = rng.randint(0, 8, (T + i, Q)).astype(np.int32)
    (d / "text").write_text("".join(f"u{i} ab c\n" for i in range(n)))


def test_json_datasets_and_prepare_match_jax(tmp_path):
    _write_codes(tmp_path)
    for name, prepare in (("ours", speechlm_prepare_dataset.main),
                          ("theirs", jax_prepare)):
        prepare(["--output", str(tmp_path / f"{name}.json"), "--task",
                 "text_to_audio", "--entry",
                 f"text1:{tmp_path / 'text'}:text", "--entry",
                 f"audio1:{tmp_path / 'codes.scp'}:npy"])
    ours_json = json.loads((tmp_path / "ours.json").read_text())
    assert ours_json == json.loads((tmp_path / "theirs.json").read_text())
    data.write_dataset_json(
        tmp_path / "cont.json", "audio_continuation",
        [{"name": "audio1", "path": str(tmp_path / "codes.scp"),
          "type": "npy"}], ["u0", "u2"])
    with pytest.raises(ValueError):
        data.write_dataset_json(tmp_path / "bad.json", "text_to_audio",
                                [{"name": "text1", "path": "x",
                                  "type": "text"}], ["u0"])
    ours, theirs = _vocabs()
    files = [str(tmp_path / "ours.json"), str(tmp_path / "cont.json")]
    a = data.MultiTaskSpeechLMDataset(files, ours, text_to_ids=_t2i)
    b = jdata.MultiTaskSpeechLMDataset(files, theirs, text_to_ids=_t2i)
    assert a.keys() == b.keys() and len(a) == 5
    assert a.keys()[0] == "text_to_audio@u0"
    for k in a.keys():
        (ka, ea), (kb, eb) = a[k], b[k]
        assert ka == kb
        for n in a.names():
            np.testing.assert_array_equal(ea[n], eb[n])


def _small_model(Q=3, V=20, seed=3):
    jmodel = JaxSpeechLM(vocab_sizes=(V,) * Q, **SMALL)
    flat, tree = flax_params(jmodel, jnp.zeros((1, 4, Q), jnp.int32),
                             jnp.asarray([4]), seed=seed)
    model = convert.load_flax_params(
        SpeechLM((V,) * Q, **SMALL), flat).eval()
    return jmodel, tree, model, flat


def test_loss_with_loss_mask_and_every_gradient():
    jmodel, tree, model, _ = _small_model()
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, 20, (2, 12, 3)).astype(np.int32)
    lens = np.asarray([12, 9])
    mask = (rng.rand(2, 12) > 0.3).astype(np.float32)

    def loss_fn(p):
        loss, stats, _ = jmodel.apply(p, jnp.asarray(tokens),
                                      jnp.asarray(lens),
                                      loss_mask=jnp.asarray(mask))
        return loss, stats

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(tree)
    loss, stats, weight = model(torch.from_numpy(tokens).long(),
                                torch.from_numpy(lens),
                                loss_mask=torch.from_numpy(mask))
    loss.backward()
    assert weight == 2.0
    for k in ("loss", "ppl", "acc"):
        _close(float(stats[k].detach()), float(jstats[k]), 1e-5)
    grads = convert.state_dict_to_flax(model, grad=True)
    jflat = {"params/" + "/".join(k): np.asarray(v)
             for k, v in flatten_dict(jgrads["params"]).items()}
    assert sorted(grads) == sorted(jflat)
    top = max(float(np.abs(g).max()) for g in jflat.values())
    for name, g in jflat.items():
        err = float(np.abs(grads[name] - g).max())
        assert err <= GRAD_REL * top, (name, err, top)
    # the keyword the collated batch carries (tokens_lengths) works alike
    loss2, _, _ = model(torch.from_numpy(tokens).long(),
                        tokens_lengths=torch.from_numpy(lens),
                        loss_mask=torch.from_numpy(mask))
    assert float(loss2.detach()) == float(loss.detach())


def test_greedy_generate_scan_token_for_token():
    """Ragged prompts, then again with eos set to an id the greedy run
    emits past the prompt, so that rows freeze."""
    jmodel, tree, model, _ = _small_model(seed=5)
    prompt = np.random.RandomState(6).randint(0, 20, (2, 4, 3)).astype(
        np.int32)
    plens = np.asarray([4, 2])

    def both(eos_id):
        jt, jl = jax.jit(lambda p, x, l: jmodel.apply(
            p, x, l, 10, jax.random.PRNGKey(0), temperature=0.0,
            eos_id=eos_id, method=jmodel.generate_scan))(
                tree, jnp.asarray(prompt), jnp.asarray(plens))
        t, ln = model.generate_scan(torch.from_numpy(prompt).long(),
                                    torch.from_numpy(plens), 10,
                                    temperature=0.0, eos_id=eos_id)
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ln.numpy(), np.asarray(jl))
        return t.numpy(), ln.numpy()

    toks, lens = both(-1)
    assert (lens == 14).all()
    eos = int(toks[0, 7, 0])
    toks, lens = both(eos)
    assert lens[0] <= 8 and (toks[0, lens[0]:, 0] == eos).all()
    # top-1 sampling is the greedy choice
    t1, _ = model.generate_scan(
        torch.from_numpy(prompt).long(), torch.from_numpy(plens), 10,
        generator=torch.Generator().manual_seed(0), temperature=1.0,
        topk=1, eos_id=eos)
    np.testing.assert_array_equal(t1.numpy(), toks)
    full = model.generate(torch.from_numpy(prompt).long(),
                          torch.from_numpy(np.asarray([4, 4])), 3,
                          torch.Generator().manual_seed(0))
    assert full.shape == (2, 7, 3) and int(full.max()) < 20


def _asset_cfg():
    return {"text_token_list": recipe_token_list()}


@pytest.fixture(scope="module")
def asset():
    return SpeechLMTask.build_model_from_file(
        SPEECHLM / "config.yaml", SPEECHLM, "cpu", _asset_cfg())


def test_asset_at_full_width_with_the_recipe_token_list(asset, tmp_path):
    model, cfg = asset
    vocab, _ = build_vocab_from_cfg(cfg)
    flat = load_checkpoint(SPEECHLM)[0]
    assert vocab.vocab_sizes == (289,) * 4
    assert all(flat[f"params/head{i}/kernel"].shape == (256, 289)
               and flat[f"params/embed{i}/embedding"].shape == (289, 256)
               for i in range(4))
    codes = np.random.RandomState(7).randint(0, 256, (2, 233, 4))
    exs = [data.build_example("audio_continuation", {"audio1": c}, vocab)
           for c in codes]
    tokens = np.stack([e["tokens"] for e in exs])
    masks = np.stack([e["loss_mask"] for e in exs])
    assert tokens.shape == (2, 239, 4)
    tl = tmp_path / "tokens.txt"
    tl.write_text("\n".join(recipe_token_list()) + "\n")
    jcfg = dict(json.loads(json.dumps(cfg)), text_token_list=str(tl))
    jmodel = JaxSpeechLMTask.build_model(jcfg)
    jparams = load_checkpoint(SPEECHLM)[0]
    from flax.traverse_util import unflatten_dict
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in jparams.items()})
    jloss, jstats, _ = jax.jit(lambda p, t, l, m: jmodel.apply(
        p, t, l, loss_mask=m))(tree, jnp.asarray(tokens),
                               jnp.asarray([239, 239]), jnp.asarray(masks))
    with torch.no_grad():
        loss, stats, _ = model(torch.from_numpy(tokens).long(),
                               torch.tensor([239, 239]),
                               loss_mask=torch.from_numpy(masks))
    _close(float(loss), float(jloss), 1e-5)
    assert float(stats["acc"]) == pytest.approx(float(jstats["acc"]),
                                                abs=1e-6)
    back = convert.state_dict_to_flax(model)
    assert sorted(back) == sorted(flat) and len(flat) == 78
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def _save_pair(d):
    """A small codec and a SpeechLM on its codes, written as assets."""
    from espnet_tpu.tasks.ssl import CodecTask as JaxCodecTask
    codec, slm = d / "codec", d / "slm"
    codec.mkdir(parents=True)
    slm.mkdir(parents=True)
    ccfg = {"fs": 8000, "codec_conf": {
        "channels": 4, "strides": [2, 4], "code_dim": 8,
        "num_quantizers": 3, "codebook_size": 8}}
    dump_yaml(ccfg, codec / "config.yaml")
    cflat, _ = flax_params(JaxCodecTask.build_model(ccfg),
                           **JaxCodecTask.example_batch(ccfg), seed=8)
    np.savez_compressed(codec / "params_f16.npz", **{
        k: v.astype(np.float16) for k, v in cflat.items()})
    (slm / "tokens.txt").write_text("\n".join(TOKENS) + "\n")
    scfg = dict(SMALL, text_token_list=str(slm / "tokens.txt"),
                codebook_size=8, n_streams=3,
                multi_task_dataset=["unused.json"])
    dump_yaml(scfg, slm / "config.yaml")
    sflat, _ = flax_params(JaxSpeechLMTask.build_model(scfg),
                           **JaxSpeechLMTask.example_batch(scfg), seed=9)
    np.savez_compressed(slm / "params_f16.npz", **{
        k: v.astype(np.float16) for k, v in sflat.items()})
    return codec, slm


def test_speechlm_inference_and_the_cli_match_jax(tmp_path):
    codec, slm = _save_pair(tmp_path)
    kw = dict(train_config=slm / "config.yaml", model_file=slm,
              codec_train_config=codec / "config.yaml",
              codec_model_file=codec, temperature=0.0)
    ours = speechlm_inference.SpeechLMInference(**kw, device="cpu")
    theirs = JaxSpeechLMInference(**kw)
    speech = (0.3 * np.random.RandomState(10).randn(160)).astype(
        np.float32)
    for task, cond in (("audio_continuation", {"speech": speech}),
                       ("text_to_audio", {"text": "ab c"}),
                       ("audio_to_text", {"speech": speech})):
        a = ours(task, steps=12, **cond)
        b = theirs(task, steps=12, **cond)
        assert a["prompt_len"] == b["prompt_len"]
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        for k in ("codes", "text"):
            if k in b:
                np.testing.assert_array_equal(a[k], b[k])
        if "wav" in b:
            _close(a["wav"], b["wav"], 1e-5)
    from espnet_tpu_torch.data.fileio import write_wav
    write_wav(tmp_path / "u0.wav", 8000, speech)
    (tmp_path / "wav.scp").write_text(f"u0 {tmp_path / 'u0.wav'}\n")
    (tmp_path / "text").write_text("u0 ab c\n")
    cli = {k: str(v) for k, v in kw.items() if k != "temperature"}
    args = [x for k, v in cli.items() for x in (f"--{k}", v)]
    speechlm_inference.main(["--output_dir", str(tmp_path / "ours"),
                             "--task", "audio_to_text",
                             "--wav_scp", str(tmp_path / "wav.scp"),
                             "--temperature", "0", "--device", "cpu",
                             *args])
    jax_inference(tmp_path / "theirs", "audio_to_text",
                  wav_scp=str(tmp_path / "wav.scp"), temperature=0.0,
                  **cli)
    assert (tmp_path / "ours" / "text").read_text() == \
        (tmp_path / "theirs" / "text").read_text()


def test_entry_point_in_both_data_modes(tmp_path):
    """The JSON mode on two dataset JSONs (two epochs in one run equal
    one epoch and a resumed one), and the plain mode on npy tokens."""
    _write_codes(tmp_path, n=4)
    (tmp_path / "tokens.txt").write_text("\n".join(TOKENS) + "\n")
    entries = [{"name": "audio1", "path": str(tmp_path / "codes.scp"),
                "type": "npy"}]
    data.write_dataset_json(tmp_path / "train.json", "audio_continuation",
                            entries, ["u0", "u1", "u2"])
    data.write_dataset_json(tmp_path / "valid.json", "audio_continuation",
                            entries, ["u3"])

    def run(name, max_epoch, resume=False, **extra):
        cfg = dict(SMALL, output_dir=str(tmp_path / name),
                   max_epoch=max_epoch, batch_type="unsorted", batch_size=2,
                   num_iters_per_epoch=1, resume=resume, device="cpu",
                   optim_conf={"lr": 3e-4}, **extra)
        dump_yaml(cfg, tmp_path / f"{name}.yaml")
        return speechlm_train.main(["--config",
                                    str(tmp_path / f"{name}.yaml")])

    json_mode = dict(multi_task_dataset=[str(tmp_path / "train.json")],
                     valid_multi_task_dataset=[str(tmp_path / "valid.json")],
                     text_token_list=str(tmp_path / "tokens.txt"),
                     codebook_size=8, n_streams=3,
                     collate_fixed_lengths={"tokens": 16, "loss_mask": 16})
    _, trainer = run("a", 2, **json_mode)
    assert len(trainer.step_stats) == 2
    assert all(np.isfinite(s["loss"]) for s in trainer.step_stats)
    assert trainer.reporter.stats[2]["valid"]["loss"] > 0
    run("b", 1, **json_mode)
    run("b", 2, resume=True, **json_mode)
    a = load_checkpoint(tmp_path / "a" / "checkpoint")[0]
    b = load_checkpoint(tmp_path / "b" / "checkpoint")[0]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    _, trainer = run("plain", 1, vocab_sizes=[8, 8, 8],
                     train_data_path_and_name_and_type=[
                         f"{tmp_path / 'codes.scp'},tokens,npy"])
    assert np.isfinite(trainer.step_stats[0]["loss"])
