"""Support modules of the PyTorch port against the JAX package, and the
port's own rules: no JAX or PyYAML imports, the card unless the CPU is
asked for."""

import ast
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from espnet_tpu.data.synth_speech import SynthSpeechCorpus as JaxCorpus
from espnet_tpu.tasks.asr import read_token_list as jax_read_token_list
from espnet_tpu.text.tokenizer import CharTokenizer as JaxCharTokenizer
from espnet_tpu.text.tokenizer import TokenIDConverter as JaxConverter
from espnet_tpu.utils.native import score_corpus as jax_score_corpus
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin.asr_inference import Speech2Text
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.ops import _cuda
from espnet_tpu_torch.tasks.asr import ASRTask, read_token_list
from espnet_tpu_torch.text.tokenizer import CharTokenizer, TokenIDConverter
from espnet_tpu_torch.utils.config import load_yaml, loads_yaml
from espnet_tpu_torch.utils.scoring import score_corpus

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "assets" / "synth_asr_flagship"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "yaml", "espnet_tpu"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_yaml():
    files = sorted((ROOT / "espnet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize("path", sorted(
    (ROOT / "assets").glob("*/config.yaml")), ids=lambda p: p.parent.name)
def test_config_reader_equals_pyyaml(path):
    with open(path, encoding="utf-8") as f:
        assert load_yaml(path) == yaml.safe_load(f)


def test_config_reader_subset():
    text = """\
a:
- - x          # a comment
  - 1e-5
  - 1.0e-5
- &one
  - 1
  - .5
- *one
b: 'it''s'
c: "hi # not a comment"
d:
  e: -3
  f: ~
  g: {}
  h: []
  i: true
"""
    assert loads_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        loads_yaml("a: [1, 2]\n")


@pytest.mark.parametrize("split,index", [("test", 0), ("test", 7),
                                         ("train", 3)])
def test_corpus_is_bit_identical(split, index):
    ours, ref = SynthSpeechCorpus(), JaxCorpus()
    assert ours.words == ref.words and ours.char_vocab == ref.char_vocab
    wave, text, sid = ours.utterance(split, index)
    rwave, rtext, rsid = ref.utterance(split, index)
    assert (text, sid) == (rtext, rsid)
    assert wave.dtype == rwave.dtype
    np.testing.assert_array_equal(wave, rwave)
    assert ours.transcript(split, index) == ref.transcript(split, index)


def test_scorer_matches_score_corpus():
    rng = np.random.RandomState(0)
    corpus = SynthSpeechCorpus()
    refs = [corpus.transcript("test", i)[0] for i in range(40)]
    hyps = []
    for ref in refs:
        words = ref.split()
        for _ in range(rng.randint(0, 3)):
            op, j = rng.randint(3), rng.randint(len(words))
            if op == 0:
                words[j] = words[j][::-1]
            elif op == 1 and len(words) > 1:
                del words[j]
            else:
                words.insert(j, corpus.words[rng.randint(20)])
        hyps.append(" ".join(words))
    hyps[0] = ""
    for unit in ("word", "char"):
        assert score_corpus(refs, hyps, unit) == jax_score_corpus(
            refs, hyps, unit)


def test_tokens_and_token_list():
    tokens = read_token_list(FLAGSHIP / "tokens.txt")
    assert tokens == jax_read_token_list(FLAGSHIP / "tokens.txt")
    conv, ref_conv = TokenIDConverter(tokens), JaxConverter(tokens)
    tok, ref_tok = CharTokenizer(), JaxCharTokenizer()
    text = "moro wiku yo"
    assert tok.text2tokens(text) == ref_tok.text2tokens(text)
    ids = conv.tokens2ids(tok.text2tokens(text))
    assert ids == ref_conv.tokens2ids(ref_tok.text2tokens(text))
    assert tok.tokens2text(conv.ids2tokens(ids)) == text


def test_speech2text_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Speech2Text(FLAGSHIP / "config.yaml", FLAGSHIP)
    s2t = Speech2Text(FLAGSHIP / "config.yaml", FLAGSHIP, device="cpu")
    assert next(s2t.model.parameters()).device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_asset_files_next_to_config_win_over_configured_paths(tmp_path):
    # the configured paths exist but hold other data: another checkout's
    # work directory must not be read when the asset carries its own files
    decoy = tmp_path / "work"
    decoy.mkdir()
    (decoy / "tokens.txt").write_text("<blank>\na\n<sos/eos>\n")
    (decoy / "feats_stats.npz").write_bytes(b"not an npz")
    text = (FLAGSHIP / "config.yaml").read_text()
    text = "\n".join(
        f"{ln.split(':')[0]}: {decoy / Path(ln.split(': ')[1]).name}"
        if ln.startswith(("token_list:", "stats_file:")) else ln
        for ln in text.splitlines())
    asset = tmp_path / "asset"
    asset.mkdir()
    (asset / "config.yaml").write_text(text)
    for name in ("tokens.txt", "feats_stats.npz"):
        (asset / name).write_bytes((FLAGSHIP / name).read_bytes())
    assert load_yaml(asset / "config.yaml")["token_list"] == str(
        decoy / "tokens.txt")
    model, cfg = ASRTask.build_model_from_file(asset / "config.yaml",
                                               FLAGSHIP, "cpu")
    assert cfg["token_list"] == str(asset / "tokens.txt")
    assert cfg["stats_file"] == str(asset / "feats_stats.npz")
    assert list(model.token_list) == read_token_list(FLAGSHIP / "tokens.txt")


@pytest.mark.parametrize("kwargs", [{"lm": "seq_rnn"}, {"ngram_file": "x"},
                                    {"time_sync": True}])
def test_speech2text_unported_options_raise(kwargs, tmp_path):
    """The Transformer LM fuses (tests/test_torch_lm.py); an RNN LM, n-gram
    fusion and time-synchronous decoding raise."""
    if "lm" in kwargs:
        lm_dir = FLAGSHIP.parent / "synth_lm"
        cfg = dict(load_yaml(lm_dir / "config.yaml"), **kwargs)
        (tmp_path / "config.yaml").write_text(yaml.safe_dump(cfg))
        shutil.copy(lm_dir / "tokens.txt", tmp_path)
        kwargs = {"lm_train_config": tmp_path / "config.yaml",
                  "lm_file": lm_dir}
    with pytest.raises(NotImplementedError):
        Speech2Text(FLAGSHIP / "config.yaml", FLAGSHIP, device="cpu",
                    **kwargs)


def test_converter_rejects_missing_and_unused_keys():
    model = torch.nn.Sequential()
    model.add_module("w_1", torch.nn.Linear(3, 2))
    flat = {"params/w_1/kernel": np.ones((3, 2), np.float32),
            "params/w_1/bias": np.zeros(2, np.float32)}
    convert.load_flax_params(model, flat)
    np.testing.assert_array_equal(model.w_1.weight.detach().numpy(),
                                  np.ones((2, 3)))
    with pytest.raises(KeyError):
        convert.load_flax_params(model, {**flat, "params/extra/bias":
                                         np.zeros(2, np.float32)})
    with pytest.raises(KeyError):
        convert.load_flax_params(model, {"params/w_1/kernel":
                                         flat["params/w_1/kernel"]})


def test_kernel_build_digest_covers_every_file_under_csrc(tmp_path,
                                                        monkeypatch):
    # a header that the sources include (attn_common.cuh, attn_bwd.cuh)
    # must trigger a rebuild when it changes, as a source does
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert {h.name for h in headers} >= {"attn_common.cuh", "attn_bwd.cuh"}
    digests = [_cuda._source_hash()]
    for path in (headers[0], csrc / _cuda.SOURCES[0]):
        path.write_text(path.read_text() + "\n// changed\n")
        digests.append(_cuda._source_hash())
    (csrc / "new_helper.cuh").write_text("#pragma once\n")
    digests.append(_cuda._source_hash())
    assert len(set(digests)) == len(digests)
    assert _cuda._source_hash() == digests[-1]
