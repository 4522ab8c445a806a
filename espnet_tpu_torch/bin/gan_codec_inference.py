"""CodecCoder, the port's codec API, and the CLI (counterpart of
espnet_tpu/bin/gan_codec_inference.py).

``CodecCoder(train_config, model_file)`` encodes (S,) or (B, S) waves,
cut to a multiple of the hop, to (B, T, Q) RVQ codes and decodes codes
to (B, T * hop) waves. ``recon_scores`` is the codec recipe's scoring
(egs/synth_asr/codec1/run.py:122-136). ``inference`` writes
``codes/<key>.npy`` and ``wav/<key>.wav`` for every utterance of a
wav.scp:

    python -m espnet_tpu_torch.bin.gan_codec_inference \\
        --output_dir exp/codec_out --wav_scp data/test/wav.scp \\
        --train_config exp/codec/config.yaml \\
        --model_file exp/codec/checkpoint [--device cpu]

It runs on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from espnet_tpu_torch.utils.device import resolve_device


class CodecCoder:
    def __init__(self, train_config=None, model_file=None, device=None):
        from espnet_tpu_torch.tasks.ssl import CodecTask
        self.device = resolve_device(device)
        self.model, self.cfg = CodecTask.build_model_from_file(
            train_config, model_file, self.device)

    @torch.no_grad()
    def encode(self, wav: np.ndarray) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        S = (wav.shape[1] // self.model.hop) * self.model.hop
        codes = self.model.encode(torch.from_numpy(
            np.ascontiguousarray(wav[:, :S])).to(self.device))
        return codes.cpu().numpy().astype(np.int32)

    @torch.no_grad()
    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self.model.decode(torch.from_numpy(
            np.asarray(codes, np.int64)).to(self.device)).cpu().numpy()


def si_snr(est: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per-row SI-SNR in dB of (B, S) float arrays, the recipe's way."""
    ref0 = ref - ref.mean(-1, keepdims=True)
    est0 = est - est.mean(-1, keepdims=True)
    s = (np.sum(est0 * ref0, -1, keepdims=True)
         / (np.sum(ref0 ** 2, -1, keepdims=True) + 1e-8)) * ref0
    return 10 * np.log10(np.sum(s ** 2, -1)
                         / (np.sum((est0 - s) ** 2, -1) + 1e-8))


def recon_scores(est: np.ndarray, ref: np.ndarray):
    """-> (per-row SI-SNR, the batch's mean |log-mel(est) - log-mel(ref)|
    at n_fft 512, hop 128, 80 mels), on the CPU with the plain STFT and
    log-mel, as the codec recipe scores a batch."""
    from espnet_tpu_torch.ops.mel import log_mel
    from espnet_tpu_torch.ops.stft import stft_power
    mels = [log_mel(stft_power(torch.from_numpy(np.ascontiguousarray(x)),
                               None, n_fft=512, hop_length=128)[0],
                    fs=16000, n_fft=512, n_mels=80) for x in (est, ref)]
    return si_snr(est, ref), float(torch.mean(torch.abs(mels[0]
                                                        - mels[1])))


def inference(output_dir, wav_scp, train_config=None, model_file=None,
              device=None):
    from espnet_tpu_torch.data.fileio import SoundScpReader, write_wav
    out = Path(output_dir)
    (out / "codes").mkdir(parents=True, exist_ok=True)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    coder = CodecCoder(train_config, model_file, device=device)
    reader = SoundScpReader(wav_scp)
    fs = coder.cfg.get("fs", 16000)
    for k in reader.keys():
        _, wav = reader[k]
        codes = coder.encode(np.asarray(wav, np.float32))
        np.save(out / "codes" / f"{k}.npy", codes[0])
        write_wav(out / "wav" / f"{k}.wav", fs, coder.decode(codes)[0])
    return out


def main(argv=None):
    from espnet_tpu_torch.utils.config import parse_cli_overrides
    return inference(**parse_cli_overrides(
        sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
