"""Enhancement scoring (counterpart of espnet_tpu/bin/enh_scoring.py):
SI-SNR, SDR and SNR between reference and enhanced wav.scp files, each
utterance under the speaker permutation of the best mean SI-SNR.

    python -m espnet_tpu_torch.bin.enh_scoring \\
        --ref_scp data/test/spk1.scp,data/test/spk2.scp \\
        --inf_scp exp/enh/spk1.scp,exp/enh/spk2.scp \\
        [--output_dir exp/enh/score]

(one wav.scp per speaker, comma-separated)

writes ``SI_SNR``, ``SDR`` and ``SNR`` (one line per utterance) and
``RESULTS`` (the means) under ``output_dir``. Scoring runs on the CPU.
"""

from __future__ import annotations

import sys
from itertools import permutations
from pathlib import Path

import numpy as np
import torch

from espnet_tpu_torch.data.fileio import SoundScpReader
from espnet_tpu_torch.models.enh.losses import si_snr_loss, snr_loss
from espnet_tpu_torch.utils.config import parse_cli_overrides


def sdr(est: np.ndarray, ref: np.ndarray, eps: float = 1e-8) -> float:
    """Plain SDR (no scaling or projection)."""
    noise = est - ref
    return float(10 * np.log10((np.sum(ref ** 2) + eps)
                               / (np.sum(noise ** 2) + eps)))


def _db(loss_fn, est: np.ndarray, ref: np.ndarray) -> float:
    return -float(loss_fn(torch.from_numpy(est)[None],
                          torch.from_numpy(ref)[None])[0])


def score_pairs(ref_scps, enh_scps, output_dir=None):
    """ref_scps, enh_scps: wav.scp paths, one per speaker -> the mean
    si_snr, sdr and snr over the utterances of the first reference."""
    refs = [SoundScpReader(p) for p in ref_scps]
    enhs = [SoundScpReader(p) for p in enh_scps]
    n_spk = len(refs)
    keys = list(refs[0].keys())
    totals = {"si_snr": 0.0, "sdr": 0.0, "snr": 0.0}
    per_utt = {}
    for k in keys:
        r = [rd[k][1] for rd in refs]
        e = [rd[k][1] for rd in enhs]
        S = min(min(len(x) for x in r), min(len(x) for x in e))
        r = [x[:S] for x in r]
        e = [x[:S] for x in e]
        best = None
        for perm in permutations(range(n_spk)):
            si = np.mean([_db(si_snr_loss, e[i], r[p])
                          for i, p in enumerate(perm)])
            if best is None or si > best[0]:
                best = (si, perm)
        si, perm = best
        per_utt[k] = {
            "si_snr": si,
            "sdr": np.mean([sdr(e[i], r[p]) for i, p in enumerate(perm)]),
            "snr": np.mean([_db(snr_loss, e[i], r[p])
                            for i, p in enumerate(perm)])}
        for m, v in per_utt[k].items():
            totals[m] += v
    means = {m: v / max(len(keys), 1) for m, v in totals.items()}
    if output_dir is not None:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        for m in totals:
            with open(out / m.upper(), "w") as f:
                for k in keys:
                    f.write(f"{k} {per_utt[k][m]:.4f}\n")
        (out / "RESULTS").write_text(
            "".join(f"{m}: {v:.4f}\n" for m, v in means.items()))
    return means


def main(argv=None):
    args = parse_cli_overrides(sys.argv[1:] if argv is None else argv)
    ref = args.pop("ref_scp")
    enh = args.pop("inf_scp", None) or args.pop("enh_scp")
    if isinstance(ref, str):
        ref = ref.split(",")
    if isinstance(enh, str):
        enh = enh.split(",")
    means = score_pairs(ref, enh, args.get("output_dir"))
    print(" ".join(f"{m}={v:.3f}" for m, v in means.items()))


if __name__ == "__main__":
    main()
