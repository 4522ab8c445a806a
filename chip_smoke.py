"""Drive the PyTorch port (espnet_tpu_torch) on one NVIDIA card and check it.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and the nvidia-smi name and power limit line;
2. build: compiles the port's CUDA kernels from espnet_tpu_torch/csrc;
3. kernel_checks: each kernel against its plain PyTorch version at the
   shapes of the main path, with the stated tolerance; each kernel is
   timed beside the plain version and one PyTorch library call (a
   yardstick only);
4. main_path: the flagship hybrid CTC/attention Conformer
   (assets/synth_asr_flagship) built by Speech2Text on the card decodes the
   first 64 held-out SynthSpeechCorpus utterances in fp32 (beam 10, CTC
   weight 0.3): one warm-up decode, then the counted one and two more,
   all three timed; WER, CER, audio seconds per second and kernel launches.

Then the nvidia-smi line, one {"kernels": [...]} line (errors, times and
bounds of phase 3, launches from the counted decode) and last
{"ok": true, "device": {...}}. Without a card,
or when any phase fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ASSET = ROOT / "assets" / "synth_asr_flagship"
N_UTTS = 64
BEAM = 10
CTC_WEIGHT = 0.3
REPEATS = 2              # timed decodes after the counted one
MAX_WER = 0.03          # the JAX package's fp32 decode of this subset: 2.39%
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
# fp32 with the sums taken in another order than the plain version: the
# attention output is a convex mix of v (|v| ~ 1), so 1e-4 is ~100x the
# expected rounding; the log-mel is compared in the log domain where the
# mel energy exceeds 1e-8 (below that, cancellation in the 512-term DFT
# sums leaves too few significant bits in the power for a log to compare)
K1_TOL = 1e-4
K2_TOL = 1e-3
K2_MIN_MEL = 1e-8


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of fn over iters launches, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def held_out_batch(corpus, n: int, min_len: int):
    import numpy as np
    utts = [corpus.utterance("test", i) for i in range(n)]
    S = max(min_len, max(len(w) for w, _, _ in utts))
    speech = np.zeros((n, S), np.float32)
    lengths = np.zeros((n,), np.int64)
    for j, (w, _, _) in enumerate(utts):
        speech[j, :len(w)] = w
        lengths[j] = len(w)
    return speech, lengths, [text for _, text, _ in utts]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from espnet_tpu_torch.bin.asr_inference import Speech2Text
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.ops import _cuda
    from espnet_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_plain)
    from espnet_tpu_torch.ops.logmel import (fused_logmel,
                                             fused_logmel_plain)
    from espnet_tpu_torch.ops.mel import mel_matrix
    from espnet_tpu_torch.utils.scoring import score_corpus

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    so = _cuda.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": _cuda.BUILD_SECONDS is not None,
          "library": str(so.relative_to(ROOT))})

    # the main path's model and batch
    s2t = Speech2Text(asr_train_config=ASSET / "config.yaml",
                      asr_model_file=ASSET, beam_size=BEAM,
                      ctc_weight=CTC_WEIGHT)
    model = s2t.model
    speech_np, lengths_np, refs = held_out_batch(
        SynthSpeechCorpus(), N_UTTS,
        s2t.cfg["collate_fixed_lengths"]["speech"])
    speech = torch.from_numpy(speech_np).cuda()
    lengths = torch.from_numpy(lengths_np).cuda()
    fe = model.frontend

    # 3. kernels against their plain versions, at the main path's shapes:
    # the wave batch, and the first conformer block's attention inputs
    captured = {}

    def capture(module, args):
        captured["args"] = args

    hook = model.encoder_mod.layers[0].self_attn.register_forward_pre_hook(
        capture)
    with torch.no_grad():
        model.encode(speech, lengths)
        hook.remove()
        attn = model.encoder_mod.layers[0].self_attn
        q, k, v, bias, sm_scale = attn.kernel_inputs(*captured["args"])
        B, H, T, d = q.shape

        def k1():
            return fused_attention(q, k, v, bias, sm_scale=sm_scale)

        def k1_plain():
            return fused_attention_plain(q, k, v, bias, sm_scale=sm_scale)

        def k1_library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                  scale=sm_scale)

        k1_err = float((k1() - k1_plain()).abs().max())
        logmel_kw = dict(fs=fe.fs, n_fft=fe.n_fft, hop_length=fe.hop_length,
                         n_mels=fe.n_mels)
        window = torch.hann_window(fe.n_fft, device="cuda")
        melw = mel_matrix(fe.fs, fe.n_fft, fe.n_mels, 0.0, None, False,
                          "cuda:0")

        def k2():
            return fused_logmel(speech, **logmel_kw)

        def k2_plain():
            return fused_logmel_plain(speech, **logmel_kw)

        def k2_library():
            spec = torch.stft(speech, fe.n_fft, fe.hop_length,
                              window=window, center=True, pad_mode="reflect",
                              return_complex=True)
            power = spec.real.square() + spec.imag.square()
            return torch.log(torch.clamp(power.transpose(1, 2) @ melw,
                                         min=1e-10))

        out2, ref2 = k2(), k2_plain()
        sel = ref2 > float(torch.log(torch.tensor(K2_MIN_MEL)))
        k2_err = float((out2 - ref2)[sel].abs().max())
        Bw, S = speech.shape
        frames = Bw * out2.shape[1]
        nf, n_fft = fe.n_fft // 2 + 1, fe.n_fft
        mel_nnz = int((melw != 0).sum())
        checks = [
            {"name": "flash_attn_fwd", "shape": [B, H, T, d],
             "tol": K1_TOL},
            {"name": "logmel_fwd", "shape": [Bw, S], "tol": K2_TOL,
             "min_mel": K2_MIN_MEL,
             "max_abs_err_all_frames": float((out2 - ref2).abs().max())},
        ]
        # the least work of each function, for its bound: K1's two
        # products of the attention; for K2 not the dense DFT the kernel
        # does but an FFT (2.5 N log2 N per frame), the window, the power
        # and only the nonzero mel weights
        kernels = [
            {"name": "flash_attn_fwd", "route": "cuda",
             "source": "espnet_tpu_torch/csrc/flash_attn.cu",
             "replaces": "espnet_tpu/ops/attention_kernels.py:31",
             "max_abs_err": k1_err,
             "ms": time_ms(torch, k1), "plain_ms": time_ms(torch, k1_plain),
             "library_ms": time_ms(torch, k1_library),
             "flops": 4.0 * B * H * T * T * d,
             "bytes": 4.0 * (4 * B * H * T * d + B * H * T * T)},
            {"name": "logmel_fwd", "route": "cuda",
             "source": "espnet_tpu_torch/csrc/logmel.cu",
             "replaces": "espnet_tpu/ops/pallas/logmel_kernel.py:35",
             "max_abs_err": k2_err,
             "ms": time_ms(torch, k2), "plain_ms": time_ms(torch, k2_plain),
             "library_ms": time_ms(torch, k2_library),
             "flops": frames * (2.5 * n_fft * math.log2(n_fft) + n_fft
                                + 3 * nf + 2 * mel_nnz + fe.n_mels),
             "bytes": 4.0 * (Bw * S + n_fft + mel_nnz
                             + frames * fe.n_mels)},
        ]
    for kern in kernels:
        t_bytes = kern["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = kern["flops"] / FP32_FLOPS * 1e3
        kern["bound_ms"] = max(t_bytes, t_ops)
        kern["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    emit({"phase": "kernel_checks", "checks": checks})
    for kern, check in zip(kernels, checks):
        if not kern["max_abs_err"] <= check["tol"]:
            raise AssertionError(f"{kern['name']} disagrees with its plain "
                                 f"version: {kern['max_abs_err']}")

    # 4. main path: one warm-up decode, then the counted and timed one,
    # then REPEATS more timed ones for the spread
    s2t(speech, lengths)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = s2t(speech, lengths)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = dict(_cuda.LAUNCHES)
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        s2t(speech, lengths)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    # the share of the frontend and encoder, timed alone
    t0 = time.perf_counter()
    with torch.no_grad():
        model.encode(speech, lengths)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    hyps = [nbest[0][0] for nbest in out]
    words = score_corpus(refs, hyps, "word")
    wer = words["err_rate"]
    cer = score_corpus(refs, hyps, "char")["err_rate"]
    audio_s = float(lengths_np.sum()) / fe.fs
    emit({"phase": "main_path", "n_utts": N_UTTS, "beam": BEAM,
          "ctc_weight": CTC_WEIGHT, "batch_shape": list(speech.shape),
          "wer": wer, "cer": cer, "ref_words": words["ref_len"],
          "word_errors": words["sub"] + words["del"] + words["ins"],
          "audio_seconds": audio_s,
          "wall_seconds": walls, "encode_seconds": encode_s,
          "audio_s_per_s_median": audio_s / wall,
          "launches": launches, "examples": [[r, h] for r, h in
                                             zip(refs[:3], hyps[:3])]})
    if len(out) != N_UTTS or not all(nbest and nbest[0][2]
                                     for nbest in out):
        raise AssertionError("an utterance decoded to nothing")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if not wer <= MAX_WER:
        raise AssertionError(f"WER {wer} above {MAX_WER}")

    print(smi, flush=True)
    emit({"kernels": [
        {key: kern[key] for key in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
        | {"launches": launches[kern["name"]]} for kern in kernels],
        "nvidia_smi": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
