"""ExtractSpeech, the port's target-speaker extraction API (counterpart
of espnet_tpu/bin/enh_tse_inference.py).

``ExtractSpeech(train_config, model_file, device)`` takes a (S,) or
(B, S) mixture and a (Se,) or (B, Se) enrollment utterance of the target
speaker and returns the target's (B, S) float32 estimate. It runs on the
card unless ``device`` says otherwise:

    python -m espnet_tpu_torch.bin.enh_tse_inference \
        --train_config exp/tse/config.yaml --model_file exp/tse/checkpoint \
        [--device cpu]

builds the extractor, as the JAX package's CLI does.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from espnet_tpu_torch.tasks.enh import EnhTSETask
from espnet_tpu_torch.utils.config import parse_cli_overrides
from espnet_tpu_torch.utils.device import resolve_device


class ExtractSpeech:
    def __init__(self, train_config=None, model_file=None, device=None):
        self.device = resolve_device(device)
        self.model, self.cfg = EnhTSETask.build_model_from_file(
            train_config, model_file, self.device)

    @torch.no_grad()
    def __call__(self, speech_mix: np.ndarray, enroll: np.ndarray
                 ) -> np.ndarray:
        speech_mix = np.asarray(speech_mix, np.float32)
        enroll = np.asarray(enroll, np.float32)
        if speech_mix.ndim == 1:
            speech_mix = speech_mix[None]
        if enroll.ndim == 1:
            enroll = enroll[None]

        def on_card(x):
            return torch.as_tensor(x, device=self.device)

        est = self.model.extract(
            on_card(speech_mix),
            on_card(np.full(len(speech_mix), speech_mix.shape[1])),
            on_card(enroll), on_card(np.full(len(enroll), enroll.shape[1])))
        return est.cpu().numpy()


def main(argv=None):
    return ExtractSpeech(**parse_cli_overrides(
        sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
