"""SpeechLMInference, the port's SpeechLM API, and the corpus CLI
(counterpart of espnet_tpu/bin/speechlm_inference.py).

A call builds the task template's prompt ([bos][tag][condition...], and
for ``audio_continuation`` with speech the prompt audio's delayed codes),
runs ``SpeechLM.generate_scan`` (top-k, temperature, eos) from the
instance's torch.Generator (seeded with ``seed``, on the model's device),
and routes the generated frames back: un-delayed and decoded by the
codec for an audio target, the token list's characters for a text one.

    python -m espnet_tpu_torch.bin.speechlm_inference --output_dir out \\
        --task audio_continuation --wav_scp data/valid/wav.scp \\
        --train_config exp/slm/config.yaml --model_file exp/slm/checkpoint \\
        --codec_train_config exp/codec/config.yaml \\
        --codec_model_file exp/codec/checkpoint [--device cpu]

It runs on the card unless ``device`` says otherwise. ``text_token_list``
(a list or a file) replaces the config's, which for the committed asset
names a file of its training run (``tasks/speechlm.py:recipe_token_list``
rebuilds it).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from espnet_tpu_torch.data.speechlm import (TASK_TEMPLATES, build_example,
                                            delay_codes, undelay_codes)
from espnet_tpu_torch.tasks.speechlm import SpeechLMTask, build_vocab_from_cfg
from espnet_tpu_torch.utils.device import resolve_device


class SpeechLMInference:
    def __init__(self, train_config=None, model_file=None,
                 codec_train_config=None, codec_model_file=None,
                 temperature: float = 1.0, topk: int = 30,
                 maxlenratio: float = 4.0, seed: int = 0,
                 text_token_list=None, device=None):
        self.device = resolve_device(device)
        overrides = ({"text_token_list": text_token_list}
                     if text_token_list is not None else None)
        self.model, self.cfg = SpeechLMTask.build_model_from_file(
            train_config, model_file, self.device, overrides)
        self.vocab, self.text_to_ids = build_vocab_from_cfg(self.cfg)
        tl = self.cfg.get("text_token_list")
        if isinstance(tl, (str, Path)):
            self.token_list = [ln for ln in Path(tl).read_text(
                encoding="utf-8").splitlines() if ln]
        else:
            self.token_list = list(tl or [])
        self.coder = None
        if codec_train_config is not None:
            from espnet_tpu_torch.bin.gan_codec_inference import CodecCoder
            self.coder = CodecCoder(codec_train_config, codec_model_file,
                                    device=self.device)
        self.temperature = temperature
        self.topk = topk
        self.maxlenratio = maxlenratio
        self.generator = torch.Generator(self.device).manual_seed(seed)

    @property
    def delay(self) -> bool:
        return self.cfg.get("delay_pattern", True)

    def _codes(self, speech) -> np.ndarray:
        if self.coder is None:
            raise ValueError("audio input requires a codec "
                             "(codec_train_config)")
        return self.coder.encode(np.asarray(speech, np.float32))[0]

    def prompt(self, task: str, text: Optional[str] = None,
               speech: Optional[np.ndarray] = None) -> np.ndarray:
        """[bos][tag][condition...] as (1, Tp, Q) global ids."""
        tpl = TASK_TEMPLATES[task]
        entries = {name: (text if name.startswith("text")
                          else self._codes(speech))
                   for name in tpl["condition"]}
        # render with an empty target, then cut the target's eos off
        for name in tpl["target"]:
            entries.setdefault(
                name, np.zeros((0,) if name.startswith("text")
                               else (0, self.vocab.n_streams), np.int32))
        ex = build_example(task, entries, self.vocab,
                           text_to_ids=self.text_to_ids, delay=self.delay)
        toks = ex["tokens"][:len(ex["tokens"]) - int(ex["loss_mask"].sum())]
        if task == "audio_continuation" and speech is not None:
            # the prompt audio is the target region's prefix, delayed
            codes = self._codes(speech)
            g = self.vocab.encode_audio(codes)
            if self.delay:
                g = delay_codes(g, self.vocab.filler)[:len(codes)]
            toks = np.concatenate([toks, g], axis=0)
        return toks[None]

    def __call__(self, task: str, text: Optional[str] = None,
                 speech: Optional[np.ndarray] = None,
                 steps: Optional[int] = None):
        """-> {"tokens", "prompt_len"} and "codes" / "wav" for an audio
        target or "text" for a text one."""
        prompt = torch.from_numpy(self.prompt(task, text, speech)).to(
            self.device)
        Tp = prompt.shape[1]
        if steps is None:
            steps = max(int(self.maxlenratio * Tp), 16)
        out, lengths = self.model.generate_scan(
            prompt, torch.tensor([Tp], device=self.device), int(steps),
            generator=self.generator, temperature=self.temperature,
            topk=self.topk, eos_id=self.vocab.eos)
        out = out[0].cpu().numpy()
        gen = out[Tp:int(lengths[0])]
        if len(gen) and gen[-1, 0] == self.vocab.eos:
            gen = gen[:-1]
        result = {"tokens": gen, "prompt_len": Tp}
        if any(e.startswith("audio") for e in TASK_TEMPLATES[task]["target"]):
            codes = gen
            if self.delay and len(codes) >= self.vocab.n_streams:
                codes = undelay_codes(codes)
            codes = self.vocab.decode_audio(codes)
            result["codes"] = codes
            if self.coder is not None and len(codes):
                result["wav"] = self.coder.decode(codes[None])[0]
        else:
            toks = [self.token_list[i] if i < len(self.token_list)
                    else "<unk>" for i in self.vocab.decode_text(gen[:, 0])]
            result["text"] = "".join(" " if t == "<space>" else t
                                     for t in toks)
        return result


def inference(output_dir, task, train_config=None, model_file=None,
              codec_train_config=None, codec_model_file=None,
              text_scp=None, wav_scp=None, nbest: int = 1, **kw):
    """Generation over a text or wav scp: ``wav/<key>.wav`` for an audio
    target, a ``text`` file for a text one."""
    from espnet_tpu_torch.data.fileio import (SoundScpReader,
                                              read_2columns_text, write_wav)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    slm = SpeechLMInference(train_config, model_file, codec_train_config,
                            codec_model_file, **kw)
    if text_scp:
        conds = {k: {"text": v}
                 for k, v in read_2columns_text(text_scp).items()}
    elif wav_scp:
        r = SoundScpReader(wav_scp)
        conds = {k: {"speech": np.asarray(r[k][1], np.float32)}
                 for k in r.keys()}
    else:
        raise ValueError("need text_scp or wav_scp")
    fs = slm.cfg.get("fs", 16000)
    text_out = []
    (out / "wav").mkdir(exist_ok=True)
    for k in sorted(conds):
        res = slm(task, **conds[k])
        if "wav" in res:
            write_wav(out / "wav" / f"{k}.wav", fs, res["wav"])
        if "text" in res:
            text_out.append(f"{k} {res['text']}")
    if text_out:
        (out / "text").write_text("\n".join(text_out) + "\n",
                                  encoding="utf-8")
    return out


def main(argv=None):
    from espnet_tpu_torch.utils.config import parse_cli_overrides
    return inference(**parse_cli_overrides(
        sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
