"""Forward and backward times of the flagship at its train batch.

Builds the flagship hybrid CTC/attention Conformer
(assets/synth_asr_flagship) on the card in train mode and times its loss's
forward and backward on one batch of 25 held-out SynthSpeechCorpus
utterances (speech padded to 74656 samples, text to 64 tokens, as the
train batches are): 20 steps after 3 warm-up ones, each ended by a
synchronize, by the host clock; and the device time of every kernel over
5 steps by torch.profiler, with the share of the attention kernels.
``--root`` times another checkout of the repository, so a parent commit
can be timed beside a change in one call, in turns. One card; prints one
JSON line with the card's name and power limit:

    python3 espnet_tpu_torch/tools/train_step_times.py [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[2])
    args = parser.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from espnet_tpu_torch.data.preprocessor import CommonPreprocessor
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.tasks.asr import ASRTask
    if not torch.cuda.is_available():
        sys.exit("train_step_times: no card")
    asset = root / "assets" / "synth_asr_flagship"
    model, _ = ASRTask.build_model_from_file(asset / "config.yaml", asset,
                                             "cuda")
    model.train()
    utts = [SynthSpeechCorpus().utterance("test", i) for i in range(25)]
    pre = CommonPreprocessor("char", list(model.token_list))
    ids = [pre("u", {"text": words})["text"] for _, words, _ in utts]
    speech = np.zeros((25, max(74656, *(len(w) for w, _, _ in utts))),
                      np.float32)
    text = np.zeros((25, max(64, *map(len, ids))), np.int64)
    for i, ((wave, _, _), x) in enumerate(zip(utts, ids)):
        speech[i, :len(wave)] = wave
        text[i, :len(x)] = x
    batch = {"speech": torch.from_numpy(speech).cuda(),
             "speech_lengths": torch.tensor([len(w) for w, _, _ in utts],
                                            device="cuda"),
             "text": torch.from_numpy(text).cuda(),
             "text_lengths": torch.tensor([len(x) for x in ids],
                                          device="cuda")}
    torch.manual_seed(0)

    def step():
        model.zero_grad(set_to_none=True)
        loss, _, _ = model(**batch)
        loss.backward()
        torch.cuda.synchronize()

    for _ in range(3):
        step()
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        step()
        host.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step()
    kernels = [(e.key, e.device_time_total / 5 / 1e3)
               for e in prof.key_averages() if e.device_time_total > 0]
    attn = sum(ms for key, ms in kernels if "attn" in key)
    print(json.dumps({
        "root": str(root), "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip().splitlines()[0],
        "host_ms": host, "host_ms_median": statistics.median(host),
        "device_ms_per_step": sum(ms for _, ms in kernels),
        "attention_kernels_ms_per_step": attn,
        "top_kernels": sorted(([k[:80], ms] for k, ms in kernels),
                              key=lambda x: -x[1])[:8]}), flush=True)


if __name__ == "__main__":
    main()
