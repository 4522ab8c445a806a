"""Deterministic formant-synthesis speech corpus (Klatt-lite), numpy only.

A copy of espnet_tpu/data/synth_speech.py:SynthSpeechCorpus and the
synthesis it needs, so that the port can make the held-out utterances
and training data directories without the JAX package. Utterances are
reproducible from (split, index) and come out bit-identical to the JAX
package's.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

FS = 16000

# phoneme -> (F1, F2, F3, kind, rel_dur)
# kind: v = vowel/voiced sonorant, n = nasal, f = unvoiced fricative,
#       z = voiced fricative, s = stop (unvoiced), b = voiced stop
_PHONES: Dict[str, Tuple[float, float, float, str, float]] = {
    # vowels (Peterson & Barney-ish male targets)
    "a": (730, 1090, 2440, "v", 1.3),
    "e": (530, 1840, 2480, "v", 1.2),
    "i": (270, 2290, 3010, "v", 1.1),
    "o": (570, 840, 2410, "v", 1.25),
    "u": (300, 870, 2240, "v", 1.15),
    # sonorants
    "l": (380, 1200, 2600, "v", 0.7),
    "r": (420, 1300, 1600, "v", 0.7),
    "w": (300, 700, 2200, "v", 0.6),
    "y": (280, 2100, 2900, "v", 0.6),
    "m": (280, 1100, 2200, "n", 0.8),
    "n": (280, 1600, 2500, "n", 0.8),
    # fricatives (center freq in F2 slot)
    "s": (0, 5500, 0, "f", 0.9),
    "h": (0, 1500, 0, "f", 0.6),
    "f": (0, 3800, 0, "f", 0.8),
    "z": (250, 5200, 0, "z", 0.9),
    "v": (250, 3500, 0, "z", 0.7),
    # stops: closure + burst (center freq in F2 slot)
    "p": (0, 1200, 0, "s", 0.55),
    "t": (0, 4000, 0, "s", 0.55),
    "k": (0, 2200, 0, "s", 0.55),
    "b": (200, 1200, 0, "b", 0.5),
    "d": (200, 4000, 0, "b", 0.5),
    "g": (200, 2200, 0, "b", 0.5),
}
VOWELS = "aeiou"
CONS = "lrwymnshfzvptkbdg"
_BASE_DUR = 0.085  # seconds, scaled by rel_dur, rate and jitter


def _resonator(x: np.ndarray, f: float, bw: float, fs: int = FS
               ) -> np.ndarray:
    """2nd-order IIR resonator (one Klatt cascade stage)."""
    from scipy.signal import lfilter
    f = min(max(f, 60.0), 0.45 * fs)
    r = np.exp(-np.pi * bw / fs)
    theta = 2 * np.pi * f / fs
    a = [1.0, -2 * r * np.cos(theta), r * r]
    b = [1 - r]
    return lfilter(b, a, x)


def _glottal_source(n: int, f0: np.ndarray, rng) -> np.ndarray:
    """Impulse train at time-varying f0 + shimmer, lowpassed (rough
    glottal pulse shaping)."""
    phase = np.cumsum(f0 / FS)
    pulses = np.zeros(n, np.float32)
    idx = np.nonzero(np.diff(np.floor(phase)) > 0)[0]
    amp = 1.0 + 0.08 * rng.randn(len(idx))
    pulses[idx] = amp
    # leaky integration twice ~ -12dB/oct glottal spectrum
    from scipy.signal import lfilter
    g = lfilter([1.0], [1.0, -0.92], pulses)
    g = lfilter([1.0], [1.0, -0.92], g)
    return g.astype(np.float32)


class Speaker:
    def __init__(self, rng: np.random.RandomState):
        self.f0_base = float(rng.uniform(85, 235))
        self.f0_range = float(rng.uniform(0.1, 0.3))
        self.formant_scale = float(rng.uniform(0.85, 1.2))
        self.rate = float(rng.uniform(0.85, 1.2))
        self.breath = float(rng.uniform(0.002, 0.01))


def _synth_phone(ph: str, dur_s: float, spk: Speaker, f0_frac: float,
                 rng) -> np.ndarray:
    f1, f2, f3, kind, _ = _PHONES[ph]
    n = max(int(dur_s * FS), 32)
    sc = spk.formant_scale
    f0 = spk.f0_base * (1 + spk.f0_range * (0.6 - f0_frac)) \
        * (1 + 0.02 * rng.randn())
    f0_t = np.full(n, f0, np.float32) * (1 + 0.01 * np.sin(
        2 * np.pi * np.arange(n) * 5.0 / FS))
    if kind in ("v", "n"):
        src = _glottal_source(n, f0_t, rng)
        y = _resonator(src, f1 * sc, 90)
        y = _resonator(y, f2 * sc, 110)
        y = _resonator(y, f3 * sc, 160)
        if kind == "n":
            y = _resonator(y, 250 * sc, 100) * 2.0  # murmur emphasis
        y = y + spk.breath * rng.randn(n)
    elif kind in ("f",):
        noise = rng.randn(n).astype(np.float32)
        y = _resonator(noise, f2 * sc, 900)
    elif kind in ("z",):
        noise = rng.randn(n).astype(np.float32)
        buzz = _glottal_source(n, f0_t, rng)
        y = _resonator(noise, f2 * sc, 900) * 0.7 \
            + _resonator(buzz, f1 * sc, 120) * 0.5
    else:  # stops: closure then burst (+ voice bar for voiced)
        closure = int(0.55 * n)
        y = np.zeros(n, np.float32)
        burst = rng.randn(n - closure).astype(np.float32)
        y[closure:] = _resonator(burst, f2 * sc, 1200)
        if kind == "b":
            bar = _glottal_source(closure, f0_t[:closure], rng)
            y[:closure] = 0.25 * _resonator(bar, 200 * sc, 120)
    # amplitude envelope (6 ms edges)
    e = min(int(0.006 * FS), n // 4)
    env = np.ones(n, np.float32)
    env[:e] = np.linspace(0, 1, e)
    env[-e:] = np.linspace(1, 0, e)
    y = y * env
    rms = np.sqrt(np.mean(y ** 2) + 1e-12)
    gain = {"v": 1.0, "n": 0.6, "f": 0.35, "z": 0.5, "s": 0.4, "b": 0.5}
    return (y / rms * gain[kind]).astype(np.float32)


class SynthSpeechCorpus:
    """Deterministic multi-speaker corpus. `lexicon_seed` fixes the word
    inventory; utterances are reproducible from (split, index)."""

    def __init__(self, n_words: int = 100, n_speakers: int = 24,
                 lexicon_seed: int = 7, min_words: int = 2,
                 max_words: int = 8):
        rng = np.random.RandomState(lexicon_seed)
        self.words: List[str] = []
        seen = set()
        while len(self.words) < n_words:
            n_syll = rng.randint(1, 4)
            w = ""
            for _ in range(n_syll):
                w += rng.choice(list(CONS))
                w += rng.choice(list(VOWELS))
                if rng.rand() < 0.3:
                    w += rng.choice(list("snmltr"))
            if w not in seen:
                seen.add(w)
                self.words.append(w)
        self.speakers = [Speaker(np.random.RandomState(1000 + i))
                         for i in range(n_speakers)]
        self.min_words = min_words
        self.max_words = max_words
        # zipf-ish unigram over the lexicon
        p = 1.0 / np.arange(1, n_words + 1) ** 0.7
        self.word_p = p / p.sum()

    @property
    def char_vocab(self) -> List[str]:
        return sorted(set("".join(self.words)))

    def _rng_for(self, split: str, index: int) -> np.random.RandomState:
        h = hashlib.md5(f"{split}:{index}".encode()).digest()
        return np.random.RandomState(
            np.frombuffer(h[:4], np.uint32)[0])

    def transcript(self, split: str, index: int,
                   speaker_ids: Optional[List[int]] = None
                   ) -> Tuple[str, int]:
        """-> (text, speaker_id) of utterance(split, index) without the
        waveform cost: draws the same rng stream prefix (sid, n_words,
        word indices) so texts match utterance() exactly."""
        rng = self._rng_for(split, index)
        sids = speaker_ids if speaker_ids is not None \
            else list(range(len(self.speakers)))
        sid = int(sids[rng.randint(len(sids))])
        n_w = rng.randint(self.min_words, self.max_words + 1)
        widx = rng.choice(len(self.words), size=n_w, p=self.word_p)
        return " ".join(self.words[i] for i in widx), sid

    def utterance(self, split: str, index: int,
                  speaker_ids: Optional[List[int]] = None
                  ) -> Tuple[np.ndarray, str, int]:
        """-> (wave float32 @16k, text, speaker_id)"""
        rng = self._rng_for(split, index)
        sids = speaker_ids if speaker_ids is not None \
            else list(range(len(self.speakers)))
        sid = int(sids[rng.randint(len(sids))])
        spk = self.speakers[sid]
        n_w = rng.randint(self.min_words, self.max_words + 1)
        widx = rng.choice(len(self.words), size=n_w, p=self.word_p)
        words = [self.words[i] for i in widx]
        phones = []
        for w in words:
            phones.extend(list(w))
            phones.append(" ")  # word-boundary silence
        total = sum(_PHONES[p][4] if p != " " else 1.0 for p in phones)
        segs = [np.zeros(int(rng.uniform(0.05, 0.12) * FS), np.float32)]
        t_acc = 0.0
        for ph in phones:
            if ph == " ":
                segs.append(np.zeros(int(rng.uniform(0.04, 0.1) * FS),
                                     np.float32))
                t_acc += 1.0
                continue
            rel = _PHONES[ph][4]
            dur = _BASE_DUR * rel / spk.rate * rng.uniform(0.85, 1.2)
            segs.append(_synth_phone(ph, dur, spk, t_acc / total, rng))
            t_acc += rel
        segs.append(np.zeros(int(rng.uniform(0.05, 0.12) * FS), np.float32))
        # overlap-add with 6ms crossfades for coarticulation-ish blending
        xl = int(0.006 * FS)
        wave = segs[0]
        for s in segs[1:]:
            if len(wave) >= xl and len(s) >= xl:
                ramp = np.linspace(0, 1, xl).astype(np.float32)
                s = s.copy()
                s[:xl] = s[:xl] * ramp + wave[-xl:] * (1 - ramp)
                wave = np.concatenate([wave[:-xl], s])
            else:
                wave = np.concatenate([wave, s])
        wave = wave / (np.max(np.abs(wave)) + 1e-6) * 0.5
        snr_db = rng.uniform(18, 38)
        noise = rng.randn(len(wave)).astype(np.float32)
        sig_p = np.mean(wave ** 2)
        noise = noise * np.sqrt(sig_p / (10 ** (snr_db / 10)))
        wave = (wave + noise).astype(np.float32)
        return wave, " ".join(words), sid

    def materialize(self, root, n_train: int = 800, n_valid: int = 50,
                    n_test: int = 50, speaker_ids=None) -> None:
        """Write Kaldi-style data dirs root/{train,valid,test} (wav.scp,
        text, utt2spk, 16-bit wavs), utterance ids ``{split}_{index:05d}``,
        speakers ``spk{id:02d}``, as the JAX package's ``materialize``
        does; ``speaker_ids`` restricts the voices (the TTS recipes' [0]:
        one speaker)."""
        from pathlib import Path

        from espnet_tpu_torch.data.fileio import write_wav
        for split, n in (("train", n_train), ("valid", n_valid),
                         ("test", n_test)):
            d = Path(root) / split
            (d / "wav").mkdir(parents=True, exist_ok=True)
            with open(d / "wav.scp", "w") as fw, \
                    open(d / "text", "w") as ft, \
                    open(d / "utt2spk", "w") as fu:
                for i in range(n):
                    wave, text, sid = self.utterance(
                        split, i, speaker_ids=speaker_ids)
                    uid = f"{split}_{i:05d}"
                    write_wav(d / "wav" / f"{uid}.wav", FS, wave)
                    fw.write(f"{uid} {d / 'wav' / f'{uid}.wav'}\n")
                    ft.write(f"{uid} {text}\n")
                    fu.write(f"{uid} spk{sid:02d}\n")


class SynthMixCorpus:
    """Deterministic 2-speaker mixtures (the JAX package's corpus, sample
    for sample): two SynthSpeechCorpus utterances of different speakers,
    cropped or zero-padded to a fixed ``seconds`` window, speaker 2
    scaled to a uniform [-2.5, 2.5] dB SIR against speaker 1, and all
    three rescaled together when the mixture's peak passes 0.99."""

    def __init__(self, seconds: float = 4.0, **kw):
        self.base = SynthSpeechCorpus(**kw)
        self.n_samples = int(seconds * FS)

    def _fit(self, w: np.ndarray, rng) -> np.ndarray:
        n = self.n_samples
        if len(w) >= n:
            off = rng.randint(len(w) - n + 1)
            return w[off:off + n]
        out = np.zeros((n,), np.float32)
        off = rng.randint(n - len(w) + 1)
        out[off:off + len(w)] = w
        return out

    def mixture(self, split: str, index: int):
        """-> (mix, ref1, ref2), float32 (n_samples,) each."""
        rng = self.base._rng_for(f"mix-{split}", index)
        i1 = int(rng.randint(10 ** 6))
        w1, _, s1 = self.base.utterance(f"mixsrc-{split}", i1)
        for _ in range(50):
            i2 = int(rng.randint(10 ** 6))
            w2, _, s2 = self.base.utterance(f"mixsrc-{split}",
                                            10 ** 6 + i2)
            if s2 != s1:
                break
        r1 = self._fit(np.asarray(w1, np.float32), rng)
        r2 = self._fit(np.asarray(w2, np.float32), rng)
        sir_db = rng.uniform(-2.5, 2.5)
        p1 = np.mean(r1 ** 2) + 1e-10
        p2 = np.mean(r2 ** 2) + 1e-10
        r2 = r2 * np.sqrt(p1 / p2 * 10 ** (-sir_db / 10.0))
        mix = r1 + r2
        peak = np.abs(mix).max()
        if peak > 0.99:
            g = 0.99 / peak
            mix, r1, r2 = mix * g, r1 * g, r2 * g
        return (mix.astype(np.float32), r1.astype(np.float32),
                r2.astype(np.float32))

    def materialize(self, root, n_train: int = 500, n_valid: int = 50,
                    n_test: int = 50) -> None:
        """Write root/{train,valid,test}: wav.scp (the mixtures),
        spk1.scp, spk2.scp (16-bit wavs) and speech_mix_shape, utterance
        ids ``{split}_{index:05d}``; a split of 0 is skipped."""
        from pathlib import Path

        from espnet_tpu_torch.data.fileio import write_wav
        for split, n in (("train", n_train), ("valid", n_valid),
                         ("test", n_test)):
            if n <= 0:
                continue
            d = Path(root) / split
            (d / "wav").mkdir(parents=True, exist_ok=True)
            with open(d / "wav.scp", "w") as fm, \
                    open(d / "spk1.scp", "w") as f1, \
                    open(d / "spk2.scp", "w") as f2, \
                    open(d / "speech_mix_shape", "w") as fs:
                for i in range(n):
                    uid = f"{split}_{i:05d}"
                    for tag, w, f in zip(("mix", "s1", "s2"),
                                         self.mixture(split, i),
                                         (fm, f1, f2)):
                        p = d / "wav" / f"{uid}_{tag}.wav"
                        write_wav(p, FS, w)
                        f.write(f"{uid} {p}\n")
                    fs.write(f"{uid} {self.n_samples}\n")


def concat_data_dir(src, dst, min_samples: int) -> List[Tuple[str, int, str]]:
    """Write a Kaldi-style data dir ``dst`` (wav.scp, text, 16-bit wavs)
    of long recordings: each joins consecutive utterances of ``src`` (in
    wav.scp order) until it holds at least ``min_samples`` samples, and
    their transcripts with a space. Utterances left over at the end, too
    few to make one more, are dropped. -> [(uid, samples, text)]."""
    from pathlib import Path

    from espnet_tpu_torch.data.fileio import (SoundScpReader,
                                              read_2columns_text, write_wav)
    src, dst = Path(src), Path(dst)
    waves, texts = SoundScpReader(src / "wav.scp"), read_2columns_text(
        src / "text")
    (dst / "wav").mkdir(parents=True, exist_ok=True)
    out, parts, words = [], [], []
    for key in waves.keys():
        rate, wave = waves[key]
        parts.append(np.round(wave * 32768.0).astype(np.int16))
        words.append(texts[key])
        if sum(len(p) for p in parts) >= min_samples:
            uid = f"{dst.name}_{len(out):05d}"
            write_wav(dst / "wav" / f"{uid}.wav", rate, np.concatenate(parts))
            out.append((uid, sum(len(p) for p in parts), " ".join(words)))
            parts, words = [], []
    with open(dst / "wav.scp", "w") as fw, open(dst / "text", "w") as ft:
        for uid, _, text in out:
            fw.write(f"{uid} {dst / 'wav' / f'{uid}.wav'}\n")
            ft.write(f"{uid} {text}\n")
    return out


DIALOG_WIN = 8 * FS     # samples of a diarization dialog
LABEL_HOP = 512         # label frame: frontend hop 128 x conv2d subsampling 4
DIALOG_FRAMES = DIALOG_WIN // LABEL_HOP   # 250


def build_dialog(corpus: SynthSpeechCorpus, split: str, index: int,
                 rng: np.random.RandomState):
    """A copy of egs/synth_asr/diar1/run.py:build_dialog: two speakers,
    1-2 utterances each, placed at random in an 8 s window (overlap
    allowed), with low noise -> (mix (DIALOG_WIN,), labels
    (DIALOG_FRAMES, 2) int32). Draws from ``rng`` as the recipe does."""
    sids = rng.choice(len(corpus.speakers), size=2, replace=False)
    mix = np.zeros((DIALOG_WIN,), np.float32)
    labels = np.zeros((DIALOG_FRAMES, 2), np.int32)
    for s, sid in enumerate(sids):
        n_utt = rng.randint(1, 3)
        for u in range(n_utt):
            wave, _, _ = corpus.utterance(
                f"{split}-dia{index}-s{s}u{u}", rng.randint(1 << 30),
                speaker_ids=[int(sid)])
            if len(wave) > DIALOG_WIN:
                wave = wave[:DIALOG_WIN]
            start = rng.randint(0, DIALOG_WIN - len(wave) + 1)
            gain = 10 ** (rng.uniform(-3, 3) / 20)
            mix[start:start + len(wave)] += gain * wave
            f0, f1 = start // LABEL_HOP, (start + len(wave)) // LABEL_HOP
            labels[f0:min(f1 + 1, DIALOG_FRAMES), s] = 1
    mix += 0.002 * rng.randn(DIALOG_WIN).astype(np.float32)
    peak = np.abs(mix).max()
    if peak > 0.99:
        mix *= 0.99 / peak
    return mix, labels


def dialogs(split: str, n: int, seed: int, corpus=None):
    """n dialogs of ``build_dialog`` from one RandomState(seed), in order
    -> (waves, labels)."""
    corpus = corpus or SynthSpeechCorpus()
    rng = np.random.RandomState(seed)
    out = [build_dialog(corpus, split, i, rng) for i in range(n)]
    return [m for m, _ in out], [lab for _, lab in out]


def materialize_dialogs(root, split: str, n: int, seed: int) -> None:
    """The diarization recipe's stage-1 data dir root/split (wav.scp of
    16-bit wavs, labels.scp of (T, 2) npy labels, ids ``{split}_{i:05d}``)
    from RandomState(seed) in place of the recipe's hash(split)."""
    from pathlib import Path

    from espnet_tpu_torch.data.fileio import NpyScpWriter, write_wav
    d = Path(root) / split
    (d / "wav").mkdir(parents=True, exist_ok=True)
    waves, labels = dialogs(split, n, seed)
    with open(d / "wav.scp", "w") as fw, \
            NpyScpWriter(d / "lab", d / "labels.scp") as fl:
        for i, (mix, lab) in enumerate(zip(waves, labels)):
            uid = f"{split}_{i:05d}"
            write_wav(d / "wav" / f"{uid}.wav", FS, mix)
            fw.write(f"{uid} {d / 'wav' / f'{uid}.wav'}\n")
            fl[uid] = lab
