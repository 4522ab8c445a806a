#!/usr/bin/env python3
"""The JAX package's own fp32 figures for the streaming decode and the
transducer batch-decode CLI, on the CPU, on the input chip_smoke.py gives
the PyTorch port:

- the 100 utterances ("valid", 0..99) of SynthSpeechCorpus, written as
  16-bit WAV data dirs and read back, pushed in chunks of 10240 samples
  (640 ms) in sorted key order, as egs/synth_asr/asr1/run_streaming.py
  pushes them:
  - ``streaming``: Speech2TextStreaming (greedy) on
    assets/synth_asr_streaming;
  - ``transducer_recipe``: the loop of run_transducer_streaming.py (MVN,
    stream_step, greedy_stream_step with valid lengths, umax 128) on
    assets/synth_asr_transducer;
  - ``transducer_class``: Speech2TextTransducerStreaming on the same
    asset (no MVN, the padded tail decoded: the class as it is);
- ``transducer_cli``: bin/asr_transducer_inference.py:inference over the
  64 utterances ("test", 0..63) at natural lengths, batch 16, beam 5.

Prints one JSON object: WER, CER, word errors and reference words of
each (``--out`` also writes the hypotheses' token ids per utterance).
With ``--port``, the PyTorch port (espnet_tpu_torch, on the CPU) decodes
the same input through its counterparts, and each entry gains the port's
WER and the number of utterances whose ids equal the JAX package's. Run
from the repository root:

    python scripts/jax_streaming_reference.py [--port] [--out FILE]

About two minutes on eight CPU cores, four more with ``--port``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STREAMING = ROOT / "assets" / "synth_asr_streaming"
TRANSDUCER = ROOT / "assets" / "synth_asr_transducer"
N_STREAM = 100
N_CLI = 64
CHUNK = 10240
CLI_BATCH = 16


def _score(refs, hyps):
    from espnet_tpu.utils.native import score_corpus
    w = score_corpus(refs, hyps, unit="word")
    c = score_corpus(refs, hyps, unit="char")
    return {"wer": w["err_rate"], "cer": c["err_rate"],
            "word_errors": w["sub"] + w["del"] + w["ins"],
            "ref_words": w["ref_len"]}


def _stream_all(reader, keys, push):
    """push(audio_chunk, is_final) per chunk; -> per-utterance result of
    the last push."""
    import numpy as np
    out = []
    for k in keys:
        _, audio = reader[k]
        audio = np.asarray(audio, np.float32)
        res = None
        for i in range(0, len(audio), CHUNK):
            res = push(audio[i:i + CHUNK], i + CHUNK >= len(audio))
        out.append(res)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import functools

    import jax.numpy as jnp
    import numpy as np

    from espnet_tpu.bin.asr_inference_streaming import Speech2TextStreaming
    from espnet_tpu.bin.asr_transducer_inference import (
        Speech2TextTransducerStreaming, inference)
    from espnet_tpu.data.fileio import SoundScpReader, read_2columns_text
    from espnet_tpu.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu.decode.transducer_search import (greedy_stream_init,
                                                     greedy_stream_step)
    from espnet_tpu.frontends.streaming import (StreamingFeatureExtractor,
                                                subsample_window,
                                                subsampled_valid_len)
    from espnet_tpu.tasks.asr_transducer import ASRTransducerTask
    from espnet_tpu.text.tokenizer import TokenIDConverter

    result = {"chunk_samples": CHUNK}
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp)
        SynthSpeechCorpus().materialize(data, n_train=0, n_valid=N_STREAM,
                                        n_test=N_CLI)
        reader = SoundScpReader(data / "valid" / "wav.scp")
        texts = read_2columns_text(data / "valid" / "text")
        keys = sorted(reader.keys())
        refs = [texts[k] for k in keys]

        t0 = time.perf_counter()
        s2t = Speech2TextStreaming(asr_train_config=STREAMING / "config.yaml",
                                   asr_model_file=STREAMING)
        res = _stream_all(reader, keys, lambda a, f: s2t(a, is_final=f))
        result["streaming"] = _score(refs, [r[0][0] for r in res]) | {
            "ids": [r[0][2] for r in res],
            "seconds": time.perf_counter() - t0}

        # run_transducer_streaming.py:149-188, umax 128
        t0 = time.perf_counter()
        model, params, mcfg = ASRTransducerTask.build_model_from_file(
            TRANSDUCER / "config.yaml", TRANSDUCER)
        conv = TokenIDConverter(
            [t for t in (TRANSDUCER / "tokens.txt").read_text().split("\n")
             if t])
        fc, ec = mcfg["frontend_conf"], mcfg["encoder_conf"]
        W, A = subsample_window(4, ec["chunk_size"])
        mvn = model.normalize_stats

        def _stream(p, f, st):
            f, _ = mvn(f, jnp.full((f.shape[0],), f.shape[1], jnp.int32))
            return model.apply(p, f, st, method=lambda m, f_, st_:
                               m.encoder_mod.stream_step(f_, st_))

        stream_step = jax.jit(_stream)
        gstep = jax.jit(functools.partial(greedy_stream_step, model))
        hyps, ids_all = [], []
        for k in keys:
            _, audio = reader[k]
            audio = np.asarray(audio, np.float32)
            fe = StreamingFeatureExtractor(
                n_fft=fc["n_fft"], hop_length=fc["hop_length"],
                n_mels=fc["n_mels"], fs=16000)
            enc_state = model.apply(
                params, 1,
                method=lambda m, b: m.encoder_mod.init_stream_state(b))
            dec_state = greedy_stream_init(model, params, 1, umax=128)
            for i in range(0, len(audio), CHUNK):
                is_final = i + CHUNK >= len(audio)
                fe.push(audio[i:i + CHUNK], is_final=is_final)
                while True:
                    popped = fe.pop_one_window(W, A, is_final=is_final,
                                               with_valid=True)
                    if popped is None:
                        break
                    win, n_valid = popped
                    enc, enc_state = stream_step(
                        params, jnp.asarray(win[None]), enc_state)
                    n_out = subsampled_valid_len(4, n_valid)
                    dec_state = gstep(params, enc,
                                      jnp.asarray([n_out], jnp.int32),
                                      dec_state)
            n_tok = int(np.asarray(dec_state.n_tok)[0])
            ids = np.asarray(dec_state.tokens)[0, :n_tok].tolist()
            ids_all.append(ids)
            hyps.append("".join(conv.ids2tokens(ids))
                        .replace("<space>", " ").strip())
        result["transducer_recipe"] = _score(refs, hyps) | {
            "ids": ids_all, "umax": 128,
            "seconds": time.perf_counter() - t0}

        t0 = time.perf_counter()
        s2tt = Speech2TextTransducerStreaming(
            train_config=TRANSDUCER / "config.yaml", model_file=TRANSDUCER)
        res = _stream_all(reader, keys, lambda a, f: s2tt(a, is_final=f))
        result["transducer_class"] = _score(refs, [r[0][0] for r in res]) | {
            "ids": [r[0][2] for r in res],
            "seconds": time.perf_counter() - t0}

        t0 = time.perf_counter()
        inference(output_dir=str(data / "cli"),
                  data_path_and_name_and_type=[
                      f"{data}/test/wav.scp,speech,sound"],
                  train_config=str(TRANSDUCER / "config.yaml"),
                  model_file=str(TRANSDUCER), batch_size=CLI_BATCH)
        ctexts = read_2columns_text(data / "test" / "text")
        recog = read_2columns_text(data / "cli" / "1best_recog" / "text")
        ckeys = sorted(ctexts)
        result["transducer_cli"] = _score(
            [ctexts[k] for k in ckeys], [recog.get(k, "") for k in ckeys]) | {
            "batch_size": CLI_BATCH, "beam": 5,
            "token_int": {k: v for k, v in read_2columns_text(
                data / "cli" / "1best_recog" / "token_int").items()},
            "seconds": time.perf_counter() - t0}
        if args.port:
            port_figures(result, data, reader, keys, refs)
    text = json.dumps(result)
    if args.out:
        Path(args.out).write_text(text + "\n", encoding="utf-8")
    print(json.dumps({k: ({kk: vv for kk, vv in v.items()
                           if kk not in ("ids", "token_int")}
                          if isinstance(v, dict) else v)
                      for k, v in result.items()}))


def port_figures(result, data, reader, keys, refs):
    """The port on the CPU over the same input: its WER and its equal ids
    beside each of the JAX package's entries."""
    import numpy as np
    import torch

    from espnet_tpu.data.fileio import read_2columns_text
    from espnet_tpu_torch.bin.asr_inference_streaming import \
        Speech2TextStreaming
    from espnet_tpu_torch.bin.asr_transducer_inference import (
        Speech2TextTransducerStreaming, inference)
    from espnet_tpu_torch.decode.transducer_search import (
        greedy_stream_init, greedy_stream_step)
    from espnet_tpu_torch.frontends.streaming import (
        StreamingFeatureExtractor, subsample_window, subsampled_valid_len)

    def note(name, hyps, ids):
        entry = result[name]
        entry["port_wer"] = _score(refs, hyps)["wer"]
        entry["port_ids_equal"] = sum(
            a == b for a, b in zip(ids, entry["ids"]))

    s2t = Speech2TextStreaming(STREAMING / "config.yaml", STREAMING,
                               device="cpu")
    res = _stream_all(reader, keys, lambda a, f: s2t(a, is_final=f))
    note("streaming", [r[0][0] for r in res], [r[0][2] for r in res])

    s2tt = Speech2TextTransducerStreaming(TRANSDUCER / "config.yaml",
                                          TRANSDUCER, device="cpu")
    model = s2tt.model
    W, A = subsample_window(4, model.encoder_mod.chunk_size)
    hyps, ids_all = [], []
    with torch.no_grad():
        for k in keys:
            audio = np.asarray(reader[k][1], np.float32)
            fe = StreamingFeatureExtractor(device="cpu")
            enc_st = model.encoder_mod.init_stream_state(1)
            dec_st = greedy_stream_init(model, 1, 128)
            for i in range(0, len(audio), CHUNK):
                final = i + CHUNK >= len(audio)
                fe.push(audio[i:i + CHUNK], is_final=final)
                while (popped := fe.pop_one_window(W, A, is_final=final,
                                                   with_valid=True)):
                    win, n_valid = popped
                    f, _ = model.normalize(torch.from_numpy(win[None]),
                                           torch.tensor([W]))
                    enc, enc_st = model.encoder_mod.stream_step(f, enc_st)
                    dec_st = greedy_stream_step(
                        model, enc,
                        torch.tensor([subsampled_valid_len(4, n_valid)]),
                        dec_st)
            ids = dec_st.tokens[0, :int(dec_st.n_tok[0])].tolist()
            ids_all.append(ids)
            hyps.append("".join(s2tt.converter.ids2tokens(ids))
                        .replace("<space>", " ").strip())
    note("transducer_recipe", hyps, ids_all)

    res = _stream_all(reader, keys, lambda a, f: s2tt(a, is_final=f))
    note("transducer_class", [r[0][0] for r in res], [r[0][2] for r in res])

    inference(output_dir=str(data / "port_cli"),
              data_path_and_name_and_type=[
                  f"{data}/test/wav.scp,speech,sound"],
              train_config=str(TRANSDUCER / "config.yaml"),
              model_file=str(TRANSDUCER), batch_size=CLI_BATCH,
              device="cpu")
    entry = result["transducer_cli"]
    texts = read_2columns_text(data / "test" / "text")
    recog = read_2columns_text(data / "port_cli" / "1best_recog" / "text")
    tokens = read_2columns_text(data / "port_cli" / "1best_recog"
                                / "token_int")
    ckeys = sorted(texts)
    entry["port_wer"] = _score([texts[k] for k in ckeys],
                               [recog.get(k, "") for k in ckeys])["wer"]
    entry["port_ids_equal"] = sum(tokens.get(k) == entry["token_int"].get(k)
                                  for k in ckeys)


if __name__ == "__main__":
    main()
