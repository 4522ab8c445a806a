"""SpeechLM task (counterpart of espnet_tpu/tasks/speechlm.py): a
multi-stream token LM over multimodal sequences, in two data modes:

1. ``multi_task_dataset: [task.json, ...]``: prepared dataset JSONs
   (data/speechlm.py) rendered through the task templates into (T, Q)
   global ids with loss masks; the vocabulary comes from
   ``text_token_list``, ``codebook_size`` and ``n_streams``;
2. plain (path, name, type) triples of token arrays (npy), through
   AbsTask's dataset, with ``vocab_sizes`` given.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

from espnet_tpu_torch.tasks.abs_task import AbsTask
from espnet_tpu_torch.tasks.asr import fp32_and_deterministic


def build_vocab_from_cfg(cfg):
    """-> (SpeechLMVocabulary, text -> local ids): characters, " " as
    <space>, unknown characters as id 0."""
    from espnet_tpu_torch.data.speechlm import SpeechLMVocabulary
    tl = cfg.get("text_token_list")
    if isinstance(tl, (str, Path)):
        tokens = [ln for ln in Path(tl).read_text(
            encoding="utf-8").splitlines() if ln]
    else:
        tokens = list(tl or [])
    vocab = SpeechLMVocabulary(
        text_vocab_size=max(len(tokens), 1),
        codebook_size=int(cfg.get("codebook_size", 256)),
        n_streams=int(cfg.get("n_streams", 1)))
    tok2id = {t: i for i, t in enumerate(tokens)}

    def text_to_ids(text: str):
        return [tok2id.get("<space>" if ch == " " else ch, 0)
                for ch in text.strip()]

    return vocab, text_to_ids


def recipe_token_list(corpus=None):
    """The SpeechLM recipe's stage-1 token list (egs/synth_asr/speechlm1/
    run.py: <blank>, the corpus's characters, <space>, <sos/eos>), which
    the asset's config names by a work-dir path."""
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    corpus = corpus or SynthSpeechCorpus()
    return ["<blank>"] + corpus.char_vocab + ["<space>", "<sos/eos>"]


class SpeechLMTask(AbsTask):
    name = "speechlm"

    @classmethod
    def task_defaults(cls) -> Dict[str, Any]:
        return {
            "vocab_sizes": [1024],
            "d_model": 256,
            "heads": 4,
            "units": 1024,
            "layers": 4,
            "use_preprocessor": False,
            "multi_task_dataset": None,
            "valid_multi_task_dataset": None,
            "text_token_list": None,
            "codebook_size": 256,
            "n_streams": 1,
            "delay_pattern": True,
        }

    @classmethod
    def build_dataset(cls, cfg, train: bool):
        jsons = cfg.get("multi_task_dataset")
        if not train and cfg.get("valid_multi_task_dataset"):
            jsons = cfg["valid_multi_task_dataset"]
        if jsons:
            from espnet_tpu_torch.data.speechlm import \
                MultiTaskSpeechLMDataset
            vocab, text_to_ids = build_vocab_from_cfg(cfg)
            return MultiTaskSpeechLMDataset(
                jsons, vocab, text_to_ids=text_to_ids,
                delay=cfg.get("delay_pattern", True))
        return super().build_dataset(cfg, train)

    @classmethod
    def vocab_sizes(cls, cfg):
        if cfg.get("multi_task_dataset"):
            return build_vocab_from_cfg(cfg)[0].vocab_sizes
        return tuple(cfg["vocab_sizes"])

    @classmethod
    def build_model(cls, cfg: Dict[str, Any]):
        from espnet_tpu_torch.models.speechlm import SpeechLM
        fp32_and_deterministic()
        return SpeechLM(vocab_sizes=cls.vocab_sizes(cfg),
                        d_model=cfg.get("d_model", 256),
                        heads=cfg.get("heads", 4),
                        units=cfg.get("units", 1024),
                        layers=cfg.get("layers", 4))
