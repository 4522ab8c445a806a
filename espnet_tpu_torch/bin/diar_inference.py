"""DiarizeSpeech, the port's diarization API, the frame DER, and the CLI
(counterpart of espnet_tpu/bin/diar_inference.py and of the scoring in
egs/synth_asr/diar1/run.py).

``DiarizeSpeech(train_config, model_file, threshold)`` turns a (S,) or
(B, S) wave into a list of (T', num_spk) 0/1 activities, sigmoid >
threshold over each row's output frames. ``frame_der`` is the recipe's
frame DER (miss + false alarm + confusion over the reference's speech
frames, the best speaker permutation, no collar), and ``dialog_der`` its
eval loop: batches of 8 dialogs zero-padded to the window, each scored
over min(label, output) frames, the mean over dialogs. ``main`` writes
``diarize.rttm`` for a data dir:

    python -m espnet_tpu_torch.bin.diar_inference --output_dir exp/diar \\
        --data_path_and_name_and_type data/test/wav.scp,speech,sound \\
        --train_config exp/diar/config.yaml --model_file exp/diar/checkpoint \\
        [--device cpu]

It runs on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import itertools
import sys
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from espnet_tpu_torch.utils.config import parse_cli_overrides
from espnet_tpu_torch.utils.device import resolve_device


class DiarizeSpeech:
    def __init__(self, train_config=None, model_file=None,
                 threshold: float = 0.5, device=None):
        from espnet_tpu_torch.tasks.spk import DiarizationTask
        self.device = resolve_device(device)
        self.model, self.cfg = DiarizationTask.build_model_from_file(
            train_config, model_file, self.device)
        self.threshold = threshold

    @torch.no_grad()
    def probabilities(self, speech: np.ndarray):
        """(B, S) -> (sigmoid activities (B, T', num_spk), lengths (B,)),
        numpy, every row S samples long."""
        speech = np.asarray(speech, np.float32)
        B, S = speech.shape
        logits, olens = self.model.predict(
            torch.from_numpy(speech).to(self.device),
            torch.full((B,), S, dtype=torch.long, device=self.device))
        return torch.sigmoid(logits).cpu().numpy(), olens.cpu().numpy()

    def __call__(self, speech: np.ndarray, fs=None) -> List[np.ndarray]:
        """(S,) or (B, S) -> per row (T', num_spk) int32 0/1 activity."""
        speech = np.asarray(speech)
        if speech.ndim == 1:
            speech = speech[None]
        probs, olens = self.probabilities(speech)
        return [(probs[b, :olens[b]] > self.threshold).astype(np.int32)
                for b in range(len(probs))]


def frame_der(ref: np.ndarray, hyp: np.ndarray) -> float:
    """Frame DER of (T, S) 0/1 arrays under the best speaker permutation
    (md-eval's semantics without a collar, overlap scored)."""
    S = ref.shape[1]
    best = None
    for p in itertools.permutations(range(S)):
        h = hyp[:, list(p)]
        n_ref = ref.sum(-1)
        n_hyp = h.sum(-1)
        n_cor = np.minimum(ref, h).sum(-1)
        miss = np.maximum(n_ref - n_hyp, 0)
        fa = np.maximum(n_hyp - n_ref, 0)
        conf = np.minimum(n_ref, n_hyp) - n_cor
        err = (miss + fa + conf).sum() / max(n_ref.sum(), 1)
        if best is None or err < best:
            best = err
    return float(best)


def dialog_der(diarize: DiarizeSpeech, waves: Sequence[np.ndarray],
               labels: Sequence[np.ndarray], window: int, batch: int = 8):
    """-> (mean frame DER, the (T, S) decisions per dialog): the recipe's
    eval, every batch of ``batch`` rows of ``window`` samples (the last
    one zero rows past the dialogs), sigmoid > threshold."""
    ders, acts = [], []
    for i in range(0, len(waves), batch):
        chunk = waves[i:i + batch]
        w = np.zeros((batch, window), np.float32)
        for j, a in enumerate(chunk):
            w[j, :min(len(a), window)] = a[:window]
        probs, _ = diarize.probabilities(w)
        act = (probs > diarize.threshold).astype(np.int32)
        for j in range(len(chunk)):
            ref = labels[i + j]
            T = min(ref.shape[0], act.shape[1])
            ders.append(frame_der(ref[:T], act[j, :T]))
            acts.append(act[j, :T])
    return float(np.mean(ders)), acts


def rttm_lines(key: str, act: np.ndarray) -> List[str]:
    """SPEAKER lines of each speaker's runs of active frames."""
    lines = []
    for spk in range(act.shape[1]):
        on = None
        for t, a in enumerate(list(act[:, spk]) + [0]):
            if a and on is None:
                on = t
            elif not a and on is not None:
                lines.append(f"SPEAKER {key} 1 {on} {t - on} <NA> <NA> "
                             f"spk{spk} <NA> <NA>\n")
                on = None
    return lines


def main(argv=None):
    from espnet_tpu_torch.data.dataset import ESPnetDataset
    from espnet_tpu_torch.tasks.abs_task import parse_triples
    args = parse_cli_overrides(sys.argv[1:] if argv is None else argv)
    out = Path(args.pop("output_dir"))
    data = args.pop("data_path_and_name_and_type")
    d = DiarizeSpeech(train_config=args.pop("train_config"),
                      model_file=args.pop("model_file"), **args)
    ds = ESPnetDataset(parse_triples(data))
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "diarize.rttm", "w") as f:
        for k in ds.keys():
            _, dat = ds[k]
            f.writelines(rttm_lines(k, d(dat["speech"])[0]))
    return out


if __name__ == "__main__":
    main()
