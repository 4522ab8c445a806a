"""ClassifySpeech, the port's audio-classification and language-ID API,
and its CLI (counterpart of espnet_tpu/bin/cls_inference.py).

``ClassifySpeech(train_config, model_file, task)`` turns a (S,) or
(B, S) wave, every row S samples long, into (predicted class ids (B,),
class probabilities (B, n_classes)); ``logits`` takes the lengths.
``main`` writes ``prediction`` and ``score`` (the predicted class's
probability) for a data dir:

    python -m espnet_tpu_torch.bin.cls_inference --output_dir exp/cls_out \\
        --data_path_and_name_and_type data/test/wav.scp,speech,sound \\
        --train_config exp/cls/config.yaml --model_file exp/cls/checkpoint \\
        [--device cpu]

It runs on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from espnet_tpu_torch.utils.config import parse_cli_overrides
from espnet_tpu_torch.utils.device import resolve_device


class ClassifySpeech:
    def __init__(self, train_config=None, model_file=None, task=None,
                 device=None):
        from espnet_tpu_torch.tasks.spk import ClassificationTask
        task = task or ClassificationTask
        self.device = resolve_device(device)
        self.model, self.cfg = task.build_model_from_file(
            train_config, model_file, self.device)

    @torch.no_grad()
    def logits(self, speech: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """(B, S) wave, (B,) lengths -> (B, n_classes) logits."""
        return self.model.predict(
            torch.from_numpy(np.asarray(speech, np.float32)).to(self.device),
            torch.from_numpy(np.asarray(lengths)).long().to(self.device)
        ).cpu().numpy()

    def __call__(self, speech: np.ndarray):
        speech = np.asarray(speech, np.float32)
        if speech.ndim == 1:
            speech = speech[None]
        B, S = speech.shape
        logits = torch.from_numpy(self.logits(speech, np.full((B,), S)))
        probs = torch.softmax(logits, dim=-1).numpy()
        return probs.argmax(axis=-1), probs


def main(argv=None, task=None):
    from espnet_tpu_torch.data.dataset import ESPnetDataset
    from espnet_tpu_torch.data.fileio import DatadirWriter
    from espnet_tpu_torch.tasks.abs_task import parse_triples
    args = parse_cli_overrides(sys.argv[1:] if argv is None else argv)
    out = args.pop("output_dir")
    data = args.pop("data_path_and_name_and_type")
    c = ClassifySpeech(train_config=args.pop("train_config"),
                       model_file=args.pop("model_file"), task=task, **args)
    ds = ESPnetDataset(parse_triples(data))
    with DatadirWriter(out) as w:
        for k in ds.keys():
            _, dat = ds[k]
            pred, probs = c(dat["speech"])
            w["prediction"][k] = str(int(pred[0]))
            w["score"][k] = str(float(probs[0, pred[0]]))
    return out


if __name__ == "__main__":
    main()
