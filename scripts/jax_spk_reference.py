#!/usr/bin/env python3
"""The JAX package's own fp32 figures for speaker verification and
keyword classification, on the CPU, on the inputs chip_smoke.py's phases
33-35 give the PyTorch port.

- ``spk``: assets/synth_spk_ecapa (its f16 weights) on the speaker
  recipe's held-out set, egs/synth_asr/spk1/run.py: the corpus's test
  split (``materialize(n_train=0, n_valid=100, n_test=200)``, 16-bit
  WAVs), its 600-trial list (``write_trials(..., "test", 600)``, seed
  17), and stage 3's embedding (each utterance cut to 74656 samples and
  zero-padded to it with its true length, batches of 25, zero rows
  filling the last; cosines of L2-normalised embeddings). Records the
  EER, its threshold, the minDCF, every trial's score, and the
  embeddings of the first 8 test utterances, each embedded alone at its
  own length (what the embedding CLIs write).
- ``cls``: the cls1 recipe's model (egs/synth_asr/cls1/run.py: a 4-block
  Transformer, d=144, 4 heads, 576 units, conv2d, 30 keywords) with the
  weights ``chip_smoke.seed_flat(..., CLS_SEED)``, on the recipe's 200
  single-keyword test utterances scored as its stage 3 scores them (one
  batch, padded to the bucket of the longest): the logits and
  predictions.

The input waves are held by their energies (another numpy or scipy may
round the synthesis otherwise). ``--port`` adds the port on the CPU on
the same inputs. Arrays are stored zlib-compressed in base64
(``chip_smoke.unpack``). Nothing in espnet_tpu/ changes. Run from the
repository root (~2 minutes with ``--port`` on 8 CPU cores):

    python scripts/jax_spk_reference.py --port \\
        --out scripts/jax_spk_reference.json
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (CLS_N_KEYWORDS, CLS_SEED, N_SPK_CLI,  # noqa: E402
                        SPK, SPK_BATCH, SPK_LEN, SPK_N_TEST, SPK_N_VALID,
                        SPK_TRIALS, cls_config_dict, cls_data, seed_flat)
from scripts.jax_a5_reference import pack  # noqa: E402


def recipe(name: str):
    spec = importlib.util.spec_from_file_location(
        f"recipe_{name}", ROOT / "egs" / "synth_asr" / name / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def energies(waves) -> list:
    return [float(np.sum(np.square(w, dtype=np.float64))) for w in waves]


def stage3_batches(waves):
    """spk1/run.py:195-212: (speech, lengths, n rows) of each batch."""
    for i in range(0, len(waves), SPK_BATCH):
        chunk = waves[i:i + SPK_BATCH]
        speech = np.zeros((SPK_BATCH, SPK_LEN), np.float32)
        lens = np.full((SPK_BATCH,), SPK_LEN, np.int32)
        for j, w in enumerate(chunk):
            w = w[:SPK_LEN]
            speech[j, :len(w)] = w
            lens[j] = len(w)
        yield speech, lens, len(chunk)


def normalised(e):
    return e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-9)


def jax_figures(work: Path) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from espnet_tpu.bin.spk_inference import SpeakerEmbedding
    from espnet_tpu.data.batching import bucket_length
    from espnet_tpu.data.fileio import SoundScpReader, read_wav, write_wav
    from espnet_tpu.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu.tasks.spk import ClassificationTask, SpeakerTask
    from espnet_tpu.utils.eer import compute_eer, compute_min_dcf

    out = {}
    t0 = time.perf_counter()
    data = work / "spk"
    SynthSpeechCorpus().materialize(data, n_train=0, n_valid=SPK_N_VALID,
                                    n_test=SPK_N_TEST)
    trials_path = recipe("spk1").write_trials(data, "test", SPK_TRIALS)
    trials = [tuple(parts) for line in open(trials_path, encoding="utf-8")
              if len(parts := line.split()) == 3]
    reader = SoundScpReader(data / "test" / "wav.scp")
    utt_ids = sorted({u for _, e, t in trials for u in (e, t)})
    waves = [np.asarray(reader[u][1], np.float32) for u in utt_ids]
    model, params, _ = SpeakerTask.build_model_from_file(
        SPK / "config.yaml", SPK)
    embed = jax.jit(lambda p, s, sl: model.apply(
        p, s, sl, method=model.extract_embedding))
    embs = []
    for speech, lens, n in stage3_batches(waves):
        embs.append(np.asarray(embed(params, jnp.asarray(speech),
                                     jnp.asarray(lens)))[:n])
    embs = dict(zip(utt_ids, normalised(np.concatenate(embs))))
    labels = np.asarray([int(lab) for lab, _, _ in trials])
    scores = np.asarray([float(embs[e] @ embs[t]) for _, e, t in trials])
    eer, thr = compute_eer(scores, labels)
    test_keys = sorted(reader.keys())[:N_SPK_CLI]
    se = SpeakerEmbedding(SPK / "config.yaml", SPK)
    cli = np.stack([se(np.asarray(reader[k][1], np.float32))[0]
                    for k in test_keys])
    out["spk"] = {
        "n_trials": len(trials), "n_utts": len(utt_ids),
        "n_target": int(labels.sum()), "eer": eer, "threshold": thr,
        "min_dcf": compute_min_dcf(scores, labels),
        "scores": pack(scores.astype(np.float64)),
        "trials": trials_path.read_text(encoding="utf-8"),
        "waves_energy": energies(waves),
        "results_json": json.loads((SPK / "RESULTS.json").read_text()),
        "cli_keys": test_keys, "cli_embeddings": pack(cli),
        "seconds": time.perf_counter() - t0}
    print("spk", eer, out["spk"]["min_dcf"], flush=True)

    t0 = time.perf_counter()
    corpus = SynthSpeechCorpus(n_words=CLS_N_KEYWORDS, min_words=1,
                               max_words=1)
    keys, speech, lens, labels = cls_data(
        corpus, write_wav, read_wav, bucket_length, work / "cls",
        splits=(("test", 200),))
    cfg = dict(ClassificationTask.task_defaults(),
               **cls_config_dict(work / "cls"))
    cmodel = ClassificationTask.build_model(cfg)
    shapes = jax.eval_shape(cmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(speech[:2]), jnp.asarray(lens[:2]),
                            jnp.zeros((2,), jnp.int32))
    from flax.traverse_util import flatten_dict, unflatten_dict
    flat = seed_flat({k: v.shape for k, v in flatten_dict(
        shapes, sep="/").items()}, CLS_SEED)
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    logits = np.asarray(jax.jit(lambda p, s, sl: cmodel.apply(
        p, s, sl, deterministic=True, method=cmodel.predict))(
        tree, jnp.asarray(speech), jnp.asarray(lens.astype(np.int32))))
    out["cls"] = {"n_utts": len(keys), "shape": list(speech.shape),
                  "waves_energy": energies(speech),
                  "labels": labels.tolist(), "logits": pack(logits),
                  "predictions": logits.argmax(-1).tolist(),
                  "seconds": time.perf_counter() - t0}
    print("cls", speech.shape, flush=True)
    return out


def port_figures(work: Path, ref: dict) -> dict:
    """The port on the CPU on the same inputs."""
    import torch

    from chip_smoke import unpack
    from espnet_tpu_torch import convert
    from espnet_tpu_torch.bin.spk_inference import (SpeakerEmbedding,
                                                    embed_utterances)
    from espnet_tpu_torch.data.batching import bucket_length
    from espnet_tpu_torch.data.fileio import (SoundScpReader, read_wav,
                                              write_wav)
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.tasks.spk import ClassificationTask, trial_scores
    from espnet_tpu_torch.utils.eer import compute_eer, compute_min_dcf
    trials = [tuple(line.split()) for line in
              ref["spk"]["trials"].splitlines()]
    reader = SoundScpReader(work / "spk" / "test" / "wav.scp")
    utt_ids = sorted({u for _, e, t in trials for u in (e, t)})
    se = SpeakerEmbedding(SPK / "config.yaml", SPK, device="cpu")
    embs = embed_utterances(se, [np.asarray(reader[u][1], np.float32)
                                 for u in utt_ids], SPK_LEN, SPK_BATCH)
    scores, labels = trial_scores(dict(zip(utt_ids, embs)), trials)
    jscores = unpack(ref["spk"]["scores"])
    cli = np.stack([se(np.asarray(reader[k][1], np.float32))[0]
                    for k in ref["spk"]["cli_keys"]])
    jcli = unpack(ref["spk"]["cli_embeddings"])
    corpus = SynthSpeechCorpus(n_words=CLS_N_KEYWORDS, min_words=1,
                               max_words=1)
    _, speech, lens, _ = cls_data(corpus, write_wav, read_wav,
                                  bucket_length, work / "cls_port",
                                  splits=(("test", 200),))
    model = ClassificationTask.build_model(cls_config_dict(work))
    flat = seed_flat({k: v.shape for k, v in
                      convert.state_dict_to_flax(model).items()}, CLS_SEED)
    convert.load_flax_params(model, flat).eval()
    with torch.no_grad():
        logits = model.predict(torch.from_numpy(speech),
                               torch.from_numpy(lens)).numpy()
    jlogits = unpack(ref["cls"]["logits"])
    return {"eer": compute_eer(scores, labels)[0],
            "min_dcf": compute_min_dcf(scores, labels),
            "max_score_diff": float(np.abs(scores - jscores).max()),
            "cli_embedding_max_rel": float(np.abs(cli - jcli).max()
                                           / np.abs(jcli).max()),
            "cls_logit_max_rel": float(np.abs(logits - jlogits).max()
                                       / np.abs(jlogits).max()),
            "cls_predictions_differ": int((logits.argmax(-1)
                                           != jlogits.argmax(-1)).sum())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "scripts" /
                                         "jax_spk_reference.json"))
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref = jax_figures(Path(tmp))
        if args.port:
            ref["port_cpu"] = port_figures(Path(tmp), ref)
    ref["seconds"] = time.perf_counter() - t0
    Path(args.out).write_text(json.dumps(ref, indent=1) + "\n",
                              encoding="utf-8")


if __name__ == "__main__":
    main()
