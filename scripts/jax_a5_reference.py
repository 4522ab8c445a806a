#!/usr/bin/env python3
"""The JAX package's own fp32 figures for diarization, the codec and the
SpeechLM, on the CPU, on the inputs chip_smoke.py's phases 29-32 give
the PyTorch port.

- ``diar``: assets/synth_diar on 50 test dialogs made by the diarization
  recipe's ``build_dialog`` (egs/synth_asr/diar1/run.py) from one
  RandomState(chip_smoke.DIAR_TEST_SEED), in order. The recipe seeded
  each split with ``hash(split)``, which Python salts per process, so
  RESULTS.json's 24.4% was measured on dialogs that cannot be made
  again. The recipe's eval (:164-199): batches of 8 rows of 128000
  samples, sigmoid > 0.5, each dialog's frame DER over min(label,
  output) frames, the mean. Records the DER and the decisions.
- ``codec``: assets/synth_codec through ``CodecCoder`` (encode cuts the
  wave to a multiple of the hop, 74560 samples) on the codec recipe's
  50 test utterances (``materialize``'s 16-bit WAVs, sorted keys),
  batches of 8 padded to 74656: SI-SNR and mel-L1 (n_fft 512, hop 128,
  80 mels) as egs/synth_asr/codec1/run.py:103-140 computes them, and the
  codes.
- ``speechlm``: the SpeechLM recipe's 100 valid utterances
  (egs/synth_asr/speechlm1/run.py stage 3: its valid split does not
  depend on n_train) tokenized by the committed codec in batches of 32
  (the codec that made the asset's own tokens was never committed, so
  RESULTS.json's perplexity 1.04 is on other tokens), then stage 5's
  teacher-forced perplexity and accuracy (batch 16, length 239, the last
  4 utterances left out as there) on assets/synth_speechlm; the tokens;
  greedy ``generate_scan`` continuations (temperature 0, 120 steps) of
  1 s prompts of the first 4 utterances, with their prompts; and stage
  6's sampled continuations (top-k 30, the JAX package's PRNGKey(0)),
  decoded by the codec: how many are non-silent (RMS > 1e-3).

The SpeechLM config names a token list of its training run; the recipe's
stage 1 writes it (<blank>, the corpus's characters, <space>,
<sos/eos>), and so does this script. ``--port`` adds the port on the
CPU on the same inputs (its DER and decisions, SI-SNR, mel-L1 and codes,
perplexity on the JAX package's tokens, greedy tokens). Arrays are
stored zlib-compressed in base64 (``chip_smoke.unpack``). Nothing in
espnet_tpu/ changes. Run from the repository root (~10 minutes with
``--port`` on 8 CPU cores):

    python scripts/jax_a5_reference.py --port \\
        --out scripts/jax_a5_reference.json
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import importlib.util
import json
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (CODEC, CODEC_BATCH, DIAR, DIAR_BATCH,  # noqa: E402
                        DIAR_TEST_SEED, GEN_STEPS, N_CODEC_UTTS, N_DIALOGS,
                        N_PROMPTS, N_SLM_VALID, PROMPT_SAMPLES, SAMPLE_TOPK,
                        SLM_BATCH, SLM_LEN, SLM_TOKEN_BATCH, SPEECHLM,
                        unpack)

UTT_SAMPLES = 74656
WIN = 128000


def pack(a) -> dict:
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "zlib_b64": base64.b64encode(zlib.compress(a.tobytes(), 9)
                                         ).decode()}


def recipe(name: str):
    spec = importlib.util.spec_from_file_location(
        f"recipe_{name}", ROOT / "egs" / "synth_asr" / name / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_recon_scores(est, ref, stft_power, log_mel):
    """codec1/run.py:122-136 on one batch with the JAX package's ops ->
    (per-row SI-SNR, mel-L1)."""
    import jax.numpy as jnp

    from espnet_tpu_torch.bin.gan_codec_inference import si_snr
    p1, _ = stft_power(jnp.asarray(est), None, n_fft=512, hop_length=128)
    p2, _ = stft_power(jnp.asarray(ref), None, n_fft=512, hop_length=128)
    m1 = log_mel(p1, fs=16000, n_fft=512, n_mels=80)
    m2 = log_mel(p2, fs=16000, n_fft=512, n_mels=80)
    return si_snr(est, ref), float(jnp.mean(jnp.abs(m1 - m2)))


def codec_batches(wav_scp, keys, read_wav, read_2columns_text):
    wavs = read_2columns_text(wav_scp)
    for i in range(0, len(keys), CODEC_BATCH):
        chunk = keys[i:i + CODEC_BATCH]
        w = np.zeros((CODEC_BATCH, UTT_SAMPLES), np.float32)
        for j, k in enumerate(chunk):
            _, a = read_wav(wavs[k])
            w[j, :min(len(a), UTT_SAMPLES)] = a[:UTT_SAMPLES]
        yield chunk, w


def slm_batches(ds, n_streams, pad):
    """speechlm1/run.py:181-196: full batches of 16 at length 239."""
    keys = list(ds.keys())
    for i in range(0, len(keys) - SLM_BATCH + 1, SLM_BATCH):
        toks, masks = [], []
        for k in keys[i:i + SLM_BATCH]:
            _, ex = ds[k]
            t = np.full((SLM_LEN, n_streams), pad, np.int32)
            m = np.zeros((SLM_LEN,), np.float32)
            L = min(len(ex["tokens"]), SLM_LEN)
            t[:L] = ex["tokens"][:L]
            m[:L] = ex["loss_mask"][:L]
            toks.append(t)
            masks.append(m)
        yield np.stack(toks), np.stack(masks)


def jax_figures(work: Path) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from espnet_tpu.bin.gan_codec_inference import CodecCoder
    from espnet_tpu.bin.speechlm_inference import SpeechLMInference
    from espnet_tpu.data.fileio import (NpyScpWriter, read_2columns_text,
                                        read_wav)
    from espnet_tpu.data.speechlm import (MultiTaskSpeechLMDataset,
                                          write_dataset_json)
    from espnet_tpu.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu.ops.mel import log_mel
    from espnet_tpu.ops.stft import stft_power
    from espnet_tpu.tasks.speechlm import SpeechLMTask, build_vocab_from_cfg
    from espnet_tpu.tasks.spk import DiarizationTask
    from espnet_tpu.utils.config import dump_yaml, load_yaml

    out = {}
    corpus = SynthSpeechCorpus()
    data = work / "data"
    corpus.materialize(data, n_train=0, n_valid=N_SLM_VALID,
                       n_test=N_CODEC_UTTS)

    # diarization
    t0 = time.perf_counter()
    diar1 = recipe("diar1")
    rng = np.random.RandomState(DIAR_TEST_SEED)
    dialogs = [diar1.build_dialog(corpus, "test", i, rng)
               for i in range(N_DIALOGS)]
    model, params, _ = DiarizationTask.build_model_from_file(
        DIAR / "config.yaml", DIAR)
    predict = jax.jit(lambda p, s, sl: model.apply(
        p, s, sl, deterministic=True, method=model.predict))
    ders, acts = [], []
    for i in range(0, N_DIALOGS, DIAR_BATCH):
        chunk = dialogs[i:i + DIAR_BATCH]
        w = np.zeros((DIAR_BATCH, WIN), np.float32)
        for j, (mix, _) in enumerate(chunk):
            w[j] = mix
        logits, _ = predict(params, jnp.asarray(w),
                            jnp.full((DIAR_BATCH,), WIN, jnp.int32))
        act = np.asarray(jax.nn.sigmoid(logits) > 0.5, np.int32)
        for j, (_, ref) in enumerate(chunk):
            T = min(ref.shape[0], act.shape[1])
            ders.append(diar1.frame_der(ref[:T], act[j, :T]))
            acts.append(act[j, :T])
    out["diar"] = {
        "seed": DIAR_TEST_SEED, "n_dialogs": N_DIALOGS,
        "der": float(np.mean(ders)), "ders": ders,
        "decisions": pack(np.stack(acts).astype(np.uint8)),
        "waves_sha256": hashlib.sha256(np.stack(
            [m for m, _ in dialogs]).tobytes()).hexdigest(),
        # another numpy / scipy may round the synthesis otherwise: each
        # dialog's energy, to hold the dialogs to without their bits
        "waves_energy": [float(np.sum(np.square(m, dtype=np.float64)))
                         for m, _ in dialogs],
        "labels_sha256": hashlib.sha256(np.stack(
            [lab for _, lab in dialogs]).tobytes()).hexdigest(),
        "results_json_der": json.loads(
            (DIAR / "RESULTS.json").read_text())["der"],
        "seconds": time.perf_counter() - t0}
    print("diar", out["diar"]["der"], flush=True)

    # the codec
    t0 = time.perf_counter()
    coder = CodecCoder(CODEC / "config.yaml", CODEC)
    cm, cp = coder.model, coder.params
    hop = cm.hop
    encode = jax.jit(lambda p, w: cm.apply(p, w, method=cm.encode))
    decode = jax.jit(lambda p, c: cm.apply(p, c, method=cm.decode))
    keys = sorted(read_2columns_text(data / "test" / "wav.scp"))[
        :N_CODEC_UTTS]
    si_all, mel_all, codes_all, si_raw, mel_raw = [], [], [], [], []
    for chunk, w in codec_batches(data / "test" / "wav.scp", keys,
                                  read_wav, read_2columns_text):
        S = (w.shape[1] // hop) * hop
        codes = np.asarray(encode(cp, jnp.asarray(w[:, :S])))
        recon = np.asarray(decode(cp, jnp.asarray(codes)))[:len(chunk)]
        ref = w[:len(chunk), :recon.shape[1]]
        si, mel = jax_recon_scores(recon[:, :ref.shape[1]], ref,
                                   stft_power, log_mel)
        si_all.extend(si.tolist())
        mel_all.append(mel)
        codes_all.append(codes[:len(chunk)])
        # the recipe's own round trip encodes the uncut 74656 samples
        recon = np.asarray(decode(cp, encode(cp, jnp.asarray(w))))[
            :len(chunk)]
        ref = w[:len(chunk), :recon.shape[1]]
        si, mel = jax_recon_scores(recon[:, :ref.shape[1]], ref,
                                   stft_power, log_mel)
        si_raw.extend(si.tolist())
        mel_raw.append(mel)
    res = json.loads((CODEC / "RESULTS.json").read_text())
    out["codec"] = {
        "n_utts": N_CODEC_UTTS, "si_snr_db": float(np.mean(si_all)),
        "mel_l1": float(np.mean(mel_all)),
        "codes": pack(np.concatenate(codes_all).astype(np.uint8)),
        "uncut_74656": {"si_snr_db": float(np.mean(si_raw)),
                        "mel_l1": float(np.mean(mel_raw))},
        "results_json": res, "seconds": time.perf_counter() - t0}
    print("codec", out["codec"]["si_snr_db"], out["codec"]["mel_l1"],
          flush=True)

    # the SpeechLM: the valid set tokenized by the committed codec
    t0 = time.perf_counter()
    token_list = ["<blank>"] + corpus.char_vocab + ["<space>", "<sos/eos>"]
    (data / "tokens.txt").write_text("\n".join(token_list) + "\n",
                                     encoding="utf-8")
    reader = read_2columns_text(data / "valid" / "wav.scp")
    vkeys = list(reader)
    S = (UTT_SAMPLES // hop) * hop
    with NpyScpWriter(data / "valid" / "codes",
                      data / "valid" / "codes.scp") as wr:
        for i in range(0, len(vkeys), SLM_TOKEN_BATCH):
            chunk = vkeys[i:i + SLM_TOKEN_BATCH]
            wavs = []
            for k in chunk:
                wav = read_wav(reader[k])[1][:S]
                wavs.append(np.pad(wav, (0, S - len(wav))))
            wavs += [np.zeros((S,), np.float32)] * (SLM_TOKEN_BATCH
                                                     - len(chunk))
            codes = np.asarray(encode(cp, jnp.asarray(np.stack(wavs))))
            for j, k in enumerate(chunk):
                wr[k] = codes[j].astype(np.int32)
    write_dataset_json(
        data / "valid_continuation.json", "audio_continuation",
        [{"name": "audio1", "path": str(data / "valid" / "codes.scp"),
          "type": "npy"}], vkeys)
    cfg = load_yaml(SPEECHLM / "config.yaml")
    cfg["text_token_list"] = str(data / "tokens.txt")
    dump_yaml(cfg, work / "speechlm.yaml")
    model, params, cfg = SpeechLMTask.build_model_from_file(
        work / "speechlm.yaml", SPEECHLM)
    vocab, t2i = build_vocab_from_cfg(cfg)
    ds = MultiTaskSpeechLMDataset([str(data / "valid_continuation.json")],
                                  vocab, text_to_ids=t2i)
    nll_fn = jax.jit(lambda p, b: model.apply(p, **b, deterministic=True)[1])
    tot_nll = tot_tok = tot_acc = 0.0
    for toks, masks in slm_batches(ds, vocab.n_streams, vocab.pad):
        stats = nll_fn(params, {
            "tokens": jnp.asarray(toks),
            "token_lengths": jnp.full((SLM_BATCH,), SLM_LEN, jnp.int32),
            "loss_mask": jnp.asarray(masks)})
        n = float(np.sum(masks))
        tot_nll += float(stats["loss"]) * n
        tot_acc += float(stats["acc"]) * n
        tot_tok += n
    valid_codes = np.stack([np.load(data / "valid" / "codes" / f"{k}.npy")
                            for k in vkeys])
    slm = {"n_utts": N_SLM_VALID, "ppl": float(np.exp(tot_nll / tot_tok)),
           "acc": tot_acc / tot_tok, "n_scored_tokens": int(tot_tok),
           "tokens": pack(valid_codes.astype(np.uint8)),
           "results_json": json.loads((SPEECHLM / "RESULTS.json"
                                       ).read_text())}
    print("speechlm", slm["ppl"], slm["acc"], flush=True)

    inf = SpeechLMInference(work / "speechlm.yaml", SPEECHLM,
                            CODEC / "config.yaml", CODEC, temperature=0.0)
    prompts, greedy, lengths = [], [], []
    for k in vkeys[:N_PROMPTS]:
        wav = read_wav(reader[k])[1][:PROMPT_SAMPLES]
        prompt = inf._prompt("audio_continuation", speech=wav)
        toks, lens = inf._gen(inf.params, jnp.asarray(prompt),
                              jnp.asarray([prompt.shape[1]], jnp.int32),
                              jax.random.PRNGKey(0), GEN_STEPS)
        prompts.append(np.asarray(prompt[0]))
        greedy.append(np.asarray(toks[0]))
        lengths.append(int(lens[0]))
    slm["prompts"] = pack(np.stack(prompts).astype(np.int32))
    slm["greedy"] = pack(np.stack(greedy).astype(np.int32))
    slm["greedy_lengths"] = lengths
    sampler = SpeechLMInference(work / "speechlm.yaml", SPEECHLM,
                                CODEC / "config.yaml", CODEC,
                                topk=SAMPLE_TOPK)
    n_ok = 0
    for k in vkeys[:N_PROMPTS]:
        wav = read_wav(reader[k])[1][:PROMPT_SAMPLES]
        res = sampler("audio_continuation", speech=wav, steps=GEN_STEPS)
        gen = np.asarray(res.get("wav", np.zeros(0)), np.float32)
        n_ok += int(len(gen) > 0
                    and float(np.sqrt(np.mean(gen ** 2))) > 1e-3)
    slm["n_continuations_nonsilent"] = n_ok
    slm["seconds"] = time.perf_counter() - t0
    out["speechlm"] = slm
    return out


def port_figures(work: Path, ref: dict) -> dict:
    """The port on the CPU on the same inputs."""
    import torch

    from espnet_tpu_torch.bin.diar_inference import DiarizeSpeech, dialog_der
    from espnet_tpu_torch.bin.gan_codec_inference import (CodecCoder,
                                                          recon_scores)
    from espnet_tpu_torch.data.fileio import read_2columns_text, read_wav
    from espnet_tpu_torch.data.synth_speech import dialogs
    from espnet_tpu_torch.tasks.speechlm import (SpeechLMTask,
                                                 build_vocab_from_cfg,
                                                 recipe_token_list)
    data = work / "data"
    out = {}
    waves, labels = dialogs("test", N_DIALOGS, DIAR_TEST_SEED)
    d = DiarizeSpeech(DIAR / "config.yaml", DIAR, device="cpu")
    der, acts = dialog_der(d, waves, labels, WIN, DIAR_BATCH)
    jax_acts = unpack(ref["diar"]["decisions"])
    out["diar"] = {"der": der, "frames_differ": int(
        (np.stack(acts) != jax_acts).any(-1).sum()),
        "waves_equal": hashlib.sha256(np.stack(waves).tobytes()).hexdigest()
        == ref["diar"]["waves_sha256"]}
    print("port diar", out["diar"], flush=True)

    coder = CodecCoder(CODEC / "config.yaml", CODEC, device="cpu")
    keys = sorted(read_2columns_text(data / "test" / "wav.scp"))[
        :N_CODEC_UTTS]
    si_all, mel_all, codes_all = [], [], []
    for chunk, w in codec_batches(data / "test" / "wav.scp", keys,
                                  read_wav, read_2columns_text):
        codes = coder.encode(w)
        recon = coder.decode(codes)[:len(chunk)]
        ref_w = w[:len(chunk), :recon.shape[1]]
        si, mel = recon_scores(recon[:, :ref_w.shape[1]], ref_w)
        si_all.extend(si.tolist())
        mel_all.append(mel)
        codes_all.append(codes[:len(chunk)])
    codes = np.concatenate(codes_all)
    out["codec"] = {"si_snr_db": float(np.mean(si_all)),
                    "mel_l1": float(np.mean(mel_all)),
                    "codes_differ": int((codes != unpack(
                        ref["codec"]["codes"])).sum())}
    print("port codec", out["codec"], flush=True)

    model, cfg = SpeechLMTask.build_model_from_file(
        SPEECHLM / "config.yaml", SPEECHLM, "cpu",
        {"text_token_list": recipe_token_list()})
    vocab, _ = build_vocab_from_cfg(cfg)
    jtoks = unpack(ref["speechlm"]["tokens"]).astype(np.int32)
    from espnet_tpu_torch.data.speechlm import build_example
    exs = [build_example("audio_continuation", {"audio1": c}, vocab)
           for c in jtoks]

    class _DS:
        def keys(self):
            return list(range(len(exs)))

        def __getitem__(self, k):
            return k, exs[k]

    tot_nll = tot_tok = tot_acc = 0.0
    with torch.no_grad():
        for toks, masks in slm_batches(_DS(), vocab.n_streams, vocab.pad):
            _, stats, _ = model(
                torch.from_numpy(toks).long(),
                torch.full((SLM_BATCH,), SLM_LEN),
                loss_mask=torch.from_numpy(masks))
            n = float(masks.sum())
            tot_nll += float(stats["loss"]) * n
            tot_acc += float(stats["acc"]) * n
            tot_tok += n
        prompts = unpack(ref["speechlm"]["prompts"])
        greedy = []
        for p in prompts:
            toks, _ = model.generate_scan(
                torch.from_numpy(p[None]).long(),
                torch.tensor([p.shape[0]]), GEN_STEPS, temperature=0.0,
                topk=SAMPLE_TOPK, eos_id=vocab.eos)
            greedy.append(toks[0].numpy())
    out["speechlm"] = {
        "ppl_on_jax_tokens": float(np.exp(tot_nll / tot_tok)),
        "acc_on_jax_tokens": tot_acc / tot_tok,
        "greedy_differ": int((np.stack(greedy) != unpack(
            ref["speechlm"]["greedy"])).sum())}
    print("port speechlm", out["speechlm"], flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "scripts" /
                                         "jax_a5_reference.json"))
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
