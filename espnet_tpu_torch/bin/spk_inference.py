"""SpeakerEmbedding, the port's speaker-verification API, the trial
helpers of the speaker recipe, and the embedding CLI (counterpart of
espnet_tpu/bin/spk_inference.py and of egs/synth_asr/spk1/run.py's trial
list and stage 3).

``SpeakerEmbedding(train_config, model_file)`` embeds a (S,) or (B, S)
wave, every row S samples long (``embed`` takes the lengths), and
``score`` gives the cosine of two utterances' embeddings.
``write_trials`` is the recipe's balanced trial list and
``embed_utterances`` its stage-3 batching (each utterance cut to
``length`` samples and zero-padded to it, batches of ``batch`` rows,
zero rows filling the last); ``tasks/spk.py:trial_scores`` scores the
trials.
``main`` writes ``embed/<key>.npy`` and ``embed.scp`` for a data dir:

    python -m espnet_tpu_torch.bin.spk_inference --output_dir exp/emb \\
        --data_path_and_name_and_type data/test/wav.scp,speech,sound \\
        --train_config exp/spk/config.yaml --model_file exp/spk/checkpoint \\
        [--device cpu]

It runs on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from espnet_tpu_torch.utils.config import parse_cli_overrides
from espnet_tpu_torch.utils.device import resolve_device


class SpeakerEmbedding:
    def __init__(self, train_config=None, model_file=None, device=None):
        from espnet_tpu_torch.tasks.spk import SpeakerTask
        self.device = resolve_device(device)
        self.model, self.cfg = SpeakerTask.build_model_from_file(
            train_config, model_file, self.device)

    @torch.no_grad()
    def embed(self, speech: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """(B, S) wave, (B,) lengths -> (B, embed_dim) embeddings."""
        return self.model.extract_embedding(
            torch.from_numpy(np.asarray(speech, np.float32)).to(self.device),
            torch.from_numpy(np.asarray(lengths)).long().to(self.device)
        ).cpu().numpy()

    def __call__(self, speech: np.ndarray) -> np.ndarray:
        speech = np.asarray(speech, np.float32)
        if speech.ndim == 1:
            speech = speech[None]
        B, S = speech.shape
        return self.embed(speech, np.full((B,), S))

    def score(self, speech_a: np.ndarray, speech_b: np.ndarray) -> float:
        """The cosine of two utterances' embeddings."""
        ea, eb = self(speech_a)[0], self(speech_b)[0]
        return float(np.dot(ea, eb) /
                     max(np.linalg.norm(ea) * np.linalg.norm(eb), 1e-9))


def write_trials(data_dir, split: str, n_trials: int,
                 seed: int = 17) -> Path:
    """A balanced target / non-target trial list over a split's
    utterances (its ``utt2spk``), written to ``<data_dir>/<split>/trials``
    as the speaker recipe writes it."""
    data_dir = Path(data_dir)
    spk2utt: Dict[str, List[str]] = {}
    for line in open(data_dir / split / "utt2spk", encoding="utf-8"):
        u, s = line.split()
        spk2utt.setdefault(s, []).append(u)
    rng = np.random.RandomState(seed)
    spks = sorted(spk2utt)
    multi = [s for s in spks if len(spk2utt[s]) >= 2]
    lines = []
    for _ in range(n_trials // 2):
        if multi:
            # target: two different utterances of one speaker
            s = multi[rng.randint(len(multi))]
            a, b = rng.choice(len(spk2utt[s]), 2, replace=False)
            lines.append(f"1 {spk2utt[s][a]} {spk2utt[s][b]}")
        # non-target: utterances of two different speakers
        s1, s2 = rng.choice(len(spks), 2, replace=False)
        u1 = spk2utt[spks[s1]][rng.randint(len(spk2utt[spks[s1]]))]
        u2 = spk2utt[spks[s2]][rng.randint(len(spk2utt[spks[s2]]))]
        lines.append(f"0 {u1} {u2}")
    out = data_dir / split / "trials"
    out.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return out


def embed_utterances(se: SpeakerEmbedding, waves: Sequence[np.ndarray],
                     length: int = 74656, batch: int = 25) -> np.ndarray:
    """(N, embed_dim) L2-normalised embeddings of ``waves``, each cut to
    ``length`` samples and zero-padded to it with its true length, in
    batches of ``batch`` rows (zero rows of length ``length`` filling the
    last, so that every batch has one shape)."""
    out = []
    for i in range(0, len(waves), batch):
        chunk = waves[i:i + batch]
        speech = np.zeros((batch, length), np.float32)
        lens = np.full((batch,), length)
        for j, w in enumerate(chunk):
            w = np.asarray(w, np.float32)[:length]
            speech[j, :len(w)] = w
            lens[j] = len(w)
        out.append(se.embed(speech, lens)[:len(chunk)])
    e = np.concatenate(out)
    return e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-9)


def main(argv=None):
    from espnet_tpu_torch.data.dataset import ESPnetDataset
    from espnet_tpu_torch.data.fileio import NpyScpWriter
    from espnet_tpu_torch.tasks.abs_task import parse_triples
    args = parse_cli_overrides(sys.argv[1:] if argv is None else argv)
    out = Path(args.pop("output_dir"))
    data = args.pop("data_path_and_name_and_type")
    se = SpeakerEmbedding(train_config=args.pop("train_config"),
                          model_file=args.pop("model_file"), **args)
    ds = ESPnetDataset(parse_triples(data))
    with NpyScpWriter(out / "embed", out / "embed.scp") as w:
        for k in ds.keys():
            _, dat = ds[k]
            w[k] = se(dat["speech"])[0]
    return out / "embed.scp"


if __name__ == "__main__":
    main()
