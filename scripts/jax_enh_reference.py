#!/usr/bin/env python3
"""The JAX package's own fp32 figures for enhancement and the joint
enhancement + ASR model, on the CPU, on the input chip_smoke.py gives the
PyTorch port:

- ``stage3``: the recipe's stage 3 (egs/synth_asr/enh1/run.py): the 50
  SynthMixCorpus test mixtures (4 s) through SeparateSpeech(fs=16000) on
  assets/synth_enh_tcn in batches of 10, each estimate scaled down to a
  0.95 peak when it passes one and written as a 16-bit WAV, scored by
  bin/enh_scoring.py:score_pairs against the materialized references,
  and the mixture itself scored as the baseline: SI-SNR, SI-SNRi, SDR;
- ``streaming``: SeparateSpeechStreaming(segment_size=1.0, fs=16000) over
  the same 50 mixtures in pushes of 10240 samples (640 ms), each stream
  cut to the mixture's length; SI-SNRi = the mean over mixtures of the
  best permutation's mean SI-SNR (float64 numpy, chip_smoke.py's
  ``pit_si_snr``) less the mixture's;
- ``enh_s2t``: the joint model built from assets/synth_enh_tcn (the
  enhancement branch; the ASR branch reads its first estimate) and
  assets/synth_asr_flagship (the ASR branch, its GlobalMVN), decoding the
  first 16 rows of chip_smoke's batch of the flagship's 64 held-out clean
  test utterances (padded to 74656 samples), beam 10, CTC 0.3: the ids
  and WER.

Prints one JSON object (``--out`` writes it with every id). With
``--port``, the PyTorch port (espnet_tpu_torch, on the CPU) computes the
same figures, and each entry gains them beside the JAX package's
(``port_*``) and, for enh_s2t, the number of utterances whose ids equal.
Run from the repository root:

    python scripts/jax_enh_reference.py [--port] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# chip_smoke's own metric and batch, so that both measure the same thing
from chip_smoke import (held_out_batch, pit_si_snr,  # noqa: E402
                        si_snr_db)

ENH = ROOT / "assets" / "synth_enh_tcn"
ASR = ROOT / "assets" / "synth_asr_flagship"
N_MIX = 50
SEP_BATCH = 10
PEAK = 0.95
CHUNK = 10240
N_S2T = 64
N_S2T_REF = 16
BEAM = 10
CTC_WEIGHT = 0.3


def _score(refs, hyps):
    from espnet_tpu.utils.native import score_corpus
    w = score_corpus(refs, hyps, unit="word")
    c = score_corpus(refs, hyps, unit="char")
    return {"wer": w["err_rate"], "cer": c["err_rate"],
            "word_errors": w["sub"] + w["del"] + w["ins"],
            "ref_words": w["ref_len"]}


def stage3(sep, mixes, data: Path, out: Path, write_wav, score_pairs):
    """The recipe's stage 3 with ``sep``: -> SI-SNR, its baseline,
    SI-SNRi and SDR."""
    (out / "wav").mkdir(parents=True)
    scps = [open(out / f"spk{s + 1}.scp", "w") for s in range(2)]
    for b in range(0, len(mixes), SEP_BATCH):
        ests = sep(np.stack(mixes[b:b + SEP_BATCH]))
        for j in range(len(ests[0])):
            uid = f"test_{b + j:05d}"
            for s in range(2):
                e = np.asarray(ests[s][j], np.float32)
                peak = np.abs(e).max()
                if peak > PEAK:
                    e = e * (PEAK / peak)
                p = out / "wav" / f"{uid}_e{s + 1}.wav"
                write_wav(p, 16000, e)
                scps[s].write(f"{uid} {p}\n")
    for f in scps:
        f.close()
    refs = [str(data / "test" / f"spk{s}.scp") for s in (1, 2)]
    enh = score_pairs(refs, [str(out / f"spk{s}.scp") for s in (1, 2)])
    base = score_pairs(refs, [str(data / "test" / "wav.scp")] * 2)
    return {"si_snr": enh["si_snr"], "si_snr_mix": base["si_snr"],
            "si_snri": enh["si_snr"] - base["si_snr"], "sdr": enh["sdr"],
            "n_utts": len(mixes)}


def streamed(stream, mixtures):
    """Each mixture pushed in CHUNK pieces -> SI-SNRi (see above) and the
    streams (cut to the mixture's length)."""
    outs, gains = [], []
    for mix, r1, r2 in mixtures:
        parts = [[], []]
        for i in range(0, len(mix), CHUNK):
            got = stream(mix[i:i + CHUNK], is_final=i + CHUNK >= len(mix))
            for s, g in enumerate(got):
                parts[s].append(g)
        ests = [np.concatenate(p)[:len(mix)] for p in parts]
        outs.append(ests)
        gains.append(pit_si_snr(ests, [r1, r2])
                     - np.mean([si_snr_db(mix, r) for r in (r1, r2)]))
    return float(np.mean(gains)), outs


def jax_enh_s2t():
    """The JAX package's EnhS2TModel from the two assets and its params."""
    from espnet_tpu.frontends.default import GlobalMVN
    from espnet_tpu.tasks.enh import EnhS2TTask
    from espnet_tpu.train.checkpoint import load_checkpoint
    from espnet_tpu.utils.config import load_yaml
    ec, ac = load_yaml(ENH / "config.yaml"), load_yaml(ASR / "config.yaml")
    mc = dict(ac.get("model_conf") or {})
    cfg = {"token_list": str(ASR / "tokens.txt"), "enh_weight": 0.2,
           "enh_conf": {"num_spk": ec["num_spk"], "encoder": ec["encoder"],
                        "n_fft": ec["encoder_conf"]["n_fft"],
                        "hop_length": ec["encoder_conf"]["hop_length"],
                        "separator": ec["separator"],
                        "separator_conf": dict(ec["separator_conf"] or {}),
                        "loss_type": ec["loss_type"]},
           "asr_conf": {"frontend_conf": dict(ac["frontend_conf"]),
                        "specaug_conf": dict(ac["specaug_conf"]),
                        "normalize": "global_mvn",
                        "normalize_stats": GlobalMVN.from_file(
                            ASR / "feats_stats.npz"),
                        "encoder": ac["encoder"],
                        "encoder_conf": dict(ac["encoder_conf"]),
                        "decoder": ac["decoder"],
                        "decoder_conf": dict(ac["decoder_conf"]),
                        "ctc_weight": mc["ctc_weight"],
                        "lsm_weight": mc.get("lsm_weight", 0.0)}}
    model = EnhS2TTask.build_model(cfg)
    params = {"params": {"enh": load_checkpoint(ENH)[0]["params"],
                         "s2t": load_checkpoint(ASR)[0]["params"]}}
    return model, params, ac["collate_fixed_lengths"]["speech"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from espnet_tpu.bin.enh_inference import SeparateSpeech
    from espnet_tpu.bin.enh_inference_streaming import \
        SeparateSpeechStreaming
    from espnet_tpu.bin.enh_scoring import score_pairs
    from espnet_tpu.data.fileio import write_wav
    from espnet_tpu.data.synth_speech import SynthMixCorpus, \
        SynthSpeechCorpus
    from espnet_tpu.decode.beam_search import (BeamSearchConfig,
                                               batch_beam_search)
    from espnet_tpu.text.tokenizer import TokenIDConverter

    corpus = SynthMixCorpus()
    mixtures = [corpus.mixture("test", i) for i in range(N_MIX)]
    mixes = [m for m, _, _ in mixtures]
    result = {"assets": [ENH.name, ASR.name]}
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "data"
        corpus.materialize(data, n_train=0, n_valid=0, n_test=N_MIX)

        t0 = time.perf_counter()
        sep = SeparateSpeech(train_config=ENH / "config.yaml",
                             model_file=ENH, fs=16000)
        result["stage3"] = stage3(sep, mixes, data, Path(tmp) / "jax_sep",
                                  write_wav, score_pairs)
        result["stage3"]["seconds"] = time.perf_counter() - t0
        result["stage3"]["results_json_si_snri"] = json.loads(
            (ENH / "RESULTS.json").read_text())["si_snri"]

        t0 = time.perf_counter()
        stream = SeparateSpeechStreaming(train_config=ENH / "config.yaml",
                                         model_file=ENH, segment_size=1.0,
                                         fs=16000)
        gain, jax_streams = streamed(stream, mixtures)
        result["streaming"] = {"si_snri": gain, "chunk_samples": CHUNK,
                               "seconds": time.perf_counter() - t0}

        t0 = time.perf_counter()
        model, params, min_len = jax_enh_s2t()
        speech, lengths, refs = held_out_batch(SynthSpeechCorpus(), N_S2T,
                                               min_len)
        enc, enc_lens = jax.jit(lambda p, x, n: model.apply(
            p, x, n, method=model.encode))(
            params, jnp.asarray(speech[:N_S2T_REF]),
            jnp.asarray(lengths[:N_S2T_REF].astype(np.int32)))
        res = batch_beam_search(model, params, enc, enc_lens,
                                BeamSearchConfig(beam_size=BEAM,
                                                 ctc_weight=CTC_WEIGHT))
        conv = TokenIDConverter(model.token_list)
        ids = [list(map(int, h[0][0])) for h in res]
        hyps = ["".join(" " if t == "<space>" else t
                        for t in conv.ids2tokens(i)) for i in ids]
        result["enh_s2t"] = _score(refs[:N_S2T_REF], hyps) | {
            "n_utts": N_S2T_REF, "batch_shape": list(speech.shape),
            "beam": BEAM, "ctc_weight": CTC_WEIGHT, "ids": ids,
            "examples": [[r, h] for r, h in zip(refs[:3], hyps[:3])],
            "seconds": time.perf_counter() - t0}
        if args.port:
            port_figures(result, mixtures, data, Path(tmp), jax_streams,
                         speech, lengths, refs)
    text = json.dumps(result)
    if args.out:
        Path(args.out).write_text(text + "\n", encoding="utf-8")
    print(json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "ids"}
                          if isinstance(v, dict) else v)
                      for k, v in result.items()}))


def port_figures(result, mixtures, data, tmp, jax_streams, speech, lengths,
                 refs):
    """The port on the CPU over the same input, beside each entry."""
    import torch

    from espnet_tpu_torch.bin.enh_inference import SeparateSpeech
    from espnet_tpu_torch.bin.enh_inference_streaming import \
        SeparateSpeechStreaming
    from espnet_tpu_torch.bin.enh_scoring import score_pairs
    from espnet_tpu_torch.data.fileio import write_wav
    from espnet_tpu_torch.decode.beam_search import (BeamSearchConfig,
                                                     batch_beam_search)
    from espnet_tpu_torch import convert
    from espnet_tpu_torch.tasks.enh import EnhS2TTask
    from espnet_tpu_torch.text.tokenizer import TokenIDConverter

    sep = SeparateSpeech(ENH / "config.yaml", ENH, fs=16000, device="cpu")
    port = stage3(sep, [m for m, _, _ in mixtures], data, tmp / "port_sep",
                  write_wav, score_pairs)
    result["stage3"] |= {f"port_{k}": v for k, v in port.items()
                         if k != "n_utts"}

    stream = SeparateSpeechStreaming(ENH / "config.yaml", ENH,
                                     segment_size=1.0, fs=16000,
                                     device="cpu")
    gain, streams = streamed(stream, mixtures)
    result["streaming"]["port_si_snri"] = gain
    result["streaming"]["port_max_rel_err"] = max(
        float(np.abs(a - b).max() / np.abs(b).max())
        for p, j in zip(streams, jax_streams) for a, b in zip(p, j))

    cfg = EnhS2TTask.config_from_assets(ENH, ASR)
    model = convert.load_flax_params(EnhS2TTask.build_model(cfg),
                                     EnhS2TTask.weights_from_assets(ENH, ASR))
    model.eval()
    n = N_S2T_REF
    with torch.no_grad():
        enc, enc_lens = model.encode(torch.from_numpy(speech[:n]),
                                     torch.from_numpy(lengths[:n]))
        res = batch_beam_search(model, enc, enc_lens, BeamSearchConfig(
            beam_size=BEAM, ctc_weight=CTC_WEIGHT))
    conv = TokenIDConverter(list(model.token_list))
    ids = [h[0][0] for h in res]
    hyps = ["".join(" " if t == "<space>" else t
                    for t in conv.ids2tokens(i)) for i in ids]
    entry = result["enh_s2t"]
    entry["port_wer"] = _score(refs[:n], hyps)["wer"]
    entry["port_ids_equal"] = sum(a == b for a, b in zip(ids, entry["ids"]))


if __name__ == "__main__":
    main()
