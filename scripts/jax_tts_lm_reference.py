#!/usr/bin/env python3
"""The JAX package's own fp32 figures for the Transformer LM and VITS
serving, on the CPU, on the input chip_smoke.py gives the PyTorch port:

- ``lm_perplexity``: the LM recipe's stage 3 (egs/synth_asr/lm1/run.py):
  the 300 ``lmtext-valid`` sentences drawn as its stage 1 draws them,
  bin/lm_calc_perplexity.py:calc_perplexity on assets/synth_lm, batch 64;
- ``lm_fused_decode``: its stage 4: the flagship Speech2Text on the first
  64 SynthSpeechCorpus test utterances in one batch padded to their
  length bucket (base 4096, x1.3), beam 10, CTC weight 0.3, without the
  LM and with it at weight 0.3: WER, CER and every utterance's ids;
- ``tts_vits``: the VITS recipe's stage 3 (egs/synth_asr/tts1/run_vits.py):
  the first 50 sorted keys of the speaker-0 corpus's 60 ``valid`` texts,
  each padded to 64 tokens and synthesized by assets/synth_tts_vits at
  max_frames 640 with noise scales 0.333 and 0.667, z_p's standard normal
  draw being numpy's ``RandomState(NOISE_SEED + i).randn(1, 640, 192)``
  for the i-th text at both scales (the JAX model's own pieces through
  ``apply(..., method=...)``, as VITS.inference composes them); each wave
  cut at its frames x hop, padded to its length bucket (base 4096, x1.3)
  and transcribed alone by the flagship (beam 10, CTC 0.3): every
  utterance's durations, frame count and ids, and WER / CER per scale.

Prints one JSON object (``--out`` writes it). With ``--port``, the port
(espnet_tpu_torch) computes the same on the CPU, and each entry gains its
figures (``port_*``) and the counts of utterances whose ids (and, for
VITS, durations) equal the JAX package's. Run from the repository root:

    python scripts/jax_tts_lm_reference.py [--port] [--out FILE]
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

# chip_smoke's own inputs and constants, so that both measure the same
from chip_smoke import (ASSET as ASR, BEAM, CTC_WEIGHT, LM,  # noqa: E402
                        LM_WEIGHT, MAX_FRAMES, N_EVAL_TTS, N_UTTS,
                        N_VALID_LM, N_VALID_TTS, NOISE_SCALES, NOISE_SEED,
                        PPL_BATCH, TEXT_PAD, TTS, decode_batch, lm_sentences,
                        padded_ids, tts_noise, wave_batch, wer_cer,
                        write_text)


def jax_vits_infer(m, text, lens, noise, noise_scale, max_frames):
    """VITS.inference (espnet_tpu/models/tts/vits.py) with z_p's draw
    given: the same pieces in the same order. -> (wav, olens, durations)."""
    import jax.numpy as jnp

    from espnet_tpu.models.tts.fastspeech2 import length_regulator
    from espnet_tpu.utils.masks import make_non_pad_mask
    h_text, m_p, logs_p, _ = m._prior(text, lens)
    t_mask = make_non_pad_mask(lens, text.shape[1])
    d_pred = m.duration_predictor(h_text, t_mask, deterministic=True)
    durations = jnp.clip(jnp.round(jnp.exp(d_pred) - 1.0), 0,
                         None).astype(jnp.int32)
    durations = jnp.where(t_mask, durations, 0)
    m_p_f, total = length_regulator(m_p, durations, max_frames)
    logs_p_f, _ = length_regulator(logs_p, durations, max_frames)
    olens = jnp.minimum(total, max_frames).astype(jnp.int32)
    f_mask = make_non_pad_mask(olens, max_frames)
    z_p = m_p_f + jnp.exp(logs_p_f) * noise_scale * noise
    z = m.flow(z_p, f_mask, reverse=True)
    return m._decode(z), olens, durations


def jax_figures(corpus, work: Path, bucket_length, score_corpus) -> dict:
    import jax
    import jax.numpy as jnp

    from espnet_tpu.bin.asr_inference import Speech2Text
    from espnet_tpu.bin.lm_calc_perplexity import calc_perplexity
    from espnet_tpu.data.fileio import read_2columns_text
    from espnet_tpu.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu.tasks.gan_tts import GANTTSTask

    out = {}
    t0 = time.perf_counter()
    text_file = work / "lm" / "valid" / "text"
    write_text(text_file, lm_sentences(corpus))
    out["lm_perplexity"] = {
        "n_sentences": N_VALID_LM, "batch_size": PPL_BATCH,
        "ppl": calc_perplexity(
            train_config=str(LM / "config.yaml"), model_file=str(LM),
            data_path_and_name_and_type=[f"{text_file},text,text"],
            batch_size=PPL_BATCH),
        "asset_results_json": json.loads(
            (LM / "RESULTS.json").read_text())["valid_ppl"],
        "seconds": time.perf_counter() - t0}
    print(json.dumps({"lm_perplexity": out["lm_perplexity"]}), flush=True)

    t0 = time.perf_counter()
    speech, lens, refs = decode_batch(corpus, bucket_length)
    fused = {"n_utts": N_UTTS, "beam": BEAM, "ctc_weight": CTC_WEIGHT,
             "batch_shape": list(speech.shape)}
    for lw in (0.0, LM_WEIGHT):
        s2t = Speech2Text(
            asr_train_config=ASR / "config.yaml", asr_model_file=ASR,
            beam_size=BEAM, ctc_weight=CTC_WEIGHT,
            lm_train_config=(LM / "config.yaml") if lw else None,
            lm_file=LM if lw else None, lm_weight=lw)
        nb = s2t(speech, lens)
        fused[f"lm_weight_{lw}"] = wer_cer(
            score_corpus, refs, [n[0][0] for n in nb]) | {
            "ids": [list(map(int, n[0][2])) for n in nb]}
    fused["seconds"] = time.perf_counter() - t0
    out["lm_fused_decode"] = fused
    print(json.dumps({"lm_fused_decode": {
        k: {kk: vv for kk, vv in v.items() if kk != "ids"}
        if isinstance(v, dict) else v for k, v in fused.items()}}),
        flush=True)

    # the recipe's data stage for the valid texts alone: no train wavs
    t0 = time.perf_counter()
    SynthSpeechCorpus().materialize(work / "tts", n_train=0,
                                    n_valid=N_VALID_TTS, n_test=0,
                                    speaker_ids=[0])
    texts = read_2columns_text(work / "tts" / "valid" / "text")
    keys = sorted(texts)[:N_EVAL_TTS]
    model, params, cfg = GANTTSTask.build_model_from_file(
        TTS / "config.yaml", TTS)
    pre = GANTTSTask.build_preprocess_fn(cfg, train=False)
    gen = model.inner.generator
    hop = int(cfg["hop_length"])
    s2t = Speech2Text(asr_train_config=ASR / "config.yaml",
                      asr_model_file=ASR, beam_size=BEAM,
                      ctc_weight=CTC_WEIGHT)
    synth = jax.jit(lambda p, t, tl, n, ns: gen.apply(
        p, t, tl, n, ns, MAX_FRAMES, method=jax_vits_infer),
        static_argnums=(4,))
    tts = {"keys": keys, "texts": [texts[k] for k in keys],
           "noise": f"RandomState({NOISE_SEED} + i).randn(1, "
                    f"{MAX_FRAMES}, 192), i the text's index",
           "max_frames": MAX_FRAMES, "text_pad": TEXT_PAD, "hop": hop}
    for ns in NOISE_SCALES:
        rows = {"durations": [], "frames": [], "ids": []}
        hyps = []
        for i, k in enumerate(keys):
            ids = pre("<synth>", {"text": texts[k], "speech": np.zeros(
                512, np.float32)})["text"]
            wav, olens, dur = synth(
                params["generator"], jnp.asarray(padded_ids(ids), jnp.int32),
                jnp.asarray([len(ids)], jnp.int32),
                jnp.asarray(tts_noise(i)), ns)
            n = int(np.asarray(olens)[0])
            wav = np.asarray(wav, np.float32)[0, :n * hop]
            nb = s2t(*wave_batch(wav, bucket_length))
            rows["durations"].append(
                np.asarray(dur)[0, :len(ids)].tolist())
            rows["frames"].append(n)
            rows["ids"].append(list(map(int, nb[0][0][2])))
            hyps.append(nb[0][0][0])
        tts[f"ns_{ns}"] = wer_cer(score_corpus, tts["texts"], hyps) | rows
        print(json.dumps({f"tts_vits ns {ns}": wer_cer(
            score_corpus, tts["texts"], hyps)}), flush=True)
    tts["asset_results_json"] = json.loads((TTS / "RESULTS.json")
                                           .read_text())
    tts["seconds"] = time.perf_counter() - t0
    out["tts_vits"] = tts
    return out


def port_figures(ref: dict, corpus, work: Path, bucket_length,
                 score_corpus) -> None:
    """The port on the CPU on the same input, into ``ref``'s entries."""
    import torch

    from espnet_tpu_torch.bin.asr_inference import Speech2Text
    from espnet_tpu_torch.bin.lm_calc_perplexity import calc_perplexity
    from espnet_tpu_torch.tasks.gan_tts import GANTTSTask

    text_file = work / "lm" / "valid" / "text"
    ref["lm_perplexity"]["port_ppl"] = calc_perplexity(
        train_config=str(LM / "config.yaml"), model_file=str(LM),
        data_path_and_name_and_type=[f"{text_file},text,text"],
        batch_size=PPL_BATCH, device="cpu")

    speech, lens, refs = decode_batch(corpus, bucket_length)
    fused = ref["lm_fused_decode"]
    for lw in (0.0, LM_WEIGHT):
        s2t = Speech2Text(
            asr_train_config=ASR / "config.yaml", asr_model_file=ASR,
            beam_size=BEAM, ctc_weight=CTC_WEIGHT,
            lm_train_config=(LM / "config.yaml") if lw else None,
            lm_file=LM if lw else None, lm_weight=lw, device="cpu")
        nb = s2t(speech, lens)
        ids = [list(map(int, n[0][2])) for n in nb]
        entry = fused[f"lm_weight_{lw}"]
        entry["port"] = wer_cer(score_corpus, refs, [n[0][0] for n in nb])
        entry["port_ids_equal"] = sum(a == b for a, b in
                                      zip(ids, entry["ids"]))

    tts = ref["tts_vits"]
    model, cfg = GANTTSTask.build_model_from_file(TTS / "config.yaml", TTS,
                                                  "cpu")
    pre = GANTTSTask.build_preprocess_fn(cfg, train=False)
    s2t = Speech2Text(asr_train_config=ASR / "config.yaml",
                      asr_model_file=ASR, beam_size=BEAM,
                      ctc_weight=CTC_WEIGHT, device="cpu")
    hop = tts["hop"]
    for ns in NOISE_SCALES:
        entry = tts[f"ns_{ns}"]
        hyps, same_dur, same_ids = [], 0, 0
        for i, text in enumerate(tts["texts"]):
            ids = pre("<synth>", {"text": text, "speech": np.zeros(
                512, np.float32)})["text"]
            t = torch.from_numpy(padded_ids(ids))
            tl = torch.tensor([len(ids)])
            with torch.no_grad():
                dur = model.generator.prior_and_durations(t, tl)[2]
                wav, olens = model.decode(
                    t, tl, noise=torch.from_numpy(tts_noise(i)),
                    noise_scale=ns, max_frames=MAX_FRAMES)
            wav = wav[0, :int(olens[0]) * hop].numpy()
            nb = s2t(*wave_batch(wav, bucket_length))
            same_dur += dur[0, :len(ids)].tolist() == entry["durations"][i]
            same_ids += list(map(int, nb[0][0][2])) == entry["ids"][i]
            hyps.append(nb[0][0][0])
        entry["port"] = wer_cer(score_corpus, tts["texts"], hyps)
        entry["port_durations_equal"] = same_dur
        entry["port_ids_equal"] = same_ids


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")

    from espnet_tpu.data.batching import bucket_length
    from espnet_tpu.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu.utils.native import score_corpus

    corpus = SynthSpeechCorpus()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        ref = jax_figures(corpus, work, bucket_length, score_corpus)
        if args.port:
            port_figures(ref, corpus, work, bucket_length, score_corpus)
    text = json.dumps(ref)
    if args.out:
        Path(args.out).write_text(text + "\n", encoding="utf-8")
    print(json.dumps({k: {kk: vv for kk, vv in v.items()
                          if not isinstance(vv, (list, dict))}
                      for k, v in ref.items()}))


if __name__ == "__main__":
    main()
