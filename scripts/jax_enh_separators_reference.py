#!/usr/bin/env python3
"""The JAX package's own fp32 figures for the single-channel STFT
separators, on the CPU, on the input chip_smoke.py's phases 36-38 give
the PyTorch port.

For each case of ``chip_smoke.SEPARATOR_CASES`` (the JAX class at its
default width in the TCN asset's config, ``chip_smoke.separator_config``,
weights ``chip_smoke.seed_flat(..., SEP_SEED)`` over the JAX model's
parameter tree), the 50 SynthMixCorpus test mixtures (4 s, 16 kHz, n_fft
512, hop 128) are separated in batches of 10 by the model's
forward_enhance at full length (what SeparateSpeech does with no
segment_size). Per estimate it records the SI-SNR against its reference
in the best permutation (``chip_smoke.pit_si_snr``'s order), the rms, the
largest |sample| and SLICE_LEN samples from SLICE_AT; for DPCL and DAN
the bins' embedding on frames EMBED_FRAMES of the first mixture (what the
network gives before k-means: a label flipped at a near-tie moves a
DPCL estimate by a whole bin) and its k-means labels (a sha256 of all
50 mixtures' labels, each mixture's count of bins in cluster 1, and the
first N_LABEL_MIX mixtures' labels and every mixture's labels on the
frames SLICE_FRAMES under the slice, bit-packed); for DAN also every
mixture's k-means centers, its attractors at inference (a trace that
diverges at a near-tie moves them: the card's embeddings are held with
these). ``--port`` adds the port on
the CPU on the first batch: each estimate's largest difference from
JAX's over its largest |sample|, and its labels' agreement. Arrays are
stored zlib-compressed in base64 (``chip_smoke.unpack``). Nothing in
espnet_tpu/ changes. Run from the repository root:

    python scripts/jax_enh_separators_reference.py [--port] \\
        [--only NAME ...] --out scripts/jax_enh_separators_reference.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (CLUSTERING, EMBED_FRAMES, N_LABEL_MIX,  # noqa
                        N_MIX, SLICE_FRAMES,
                        SEP_BATCH, SEP_SEED, SEPARATOR_CASES, SLICE_AT,
                        SLICE_LEN, pit_si_snr, seed_flat, separator_config,
                        si_snr_db)
from scripts.jax_a5_reference import pack  # noqa: E402


def summary(name, ests, refs, labels, embed, n_frames, centers=None):
    """The JSON entry of one separator: ests (S, N, L), refs (N, 2, L),
    labels (N, T * F) and the embedding's frames or None, the k-means
    centers (N, K, D) to keep or None."""
    ests = np.asarray(ests, np.float32)
    out = {
        "pit_si_snr": [pit_si_snr([e[i] for e in ests], list(refs[i]))
                       for i in range(ests.shape[1])],
        "si_snr": [[si_snr_db(ests[s, i], refs[i, s])
                    for s in range(ests.shape[0])]
                   for i in range(ests.shape[1])],
        "rms": pack(np.sqrt(np.mean(np.square(ests, dtype=np.float64),
                                    axis=-1)).astype(np.float32)),
        "peak": pack(np.abs(ests).max(-1)),
        "slice": pack(ests[:, :, SLICE_AT:SLICE_AT + SLICE_LEN])}
    if labels is not None:
        lab = np.asarray(labels, np.uint8)
        n_freq = lab.shape[-1] // n_frames
        lo, hi = (f * n_freq for f in SLICE_FRAMES)
        out["labels"] = {
            "sha256": hashlib.sha256(lab.tobytes()).hexdigest(),
            "ones_per_mixture": lab.sum(-1).astype(int).tolist(),
            "first": pack(np.packbits(lab[:N_LABEL_MIX], axis=-1)),
            "slice_frames": pack(np.packbits(lab[:, lo:hi], axis=-1)),
            "n_bins": int(lab.shape[-1])}
        out["embed_frames"] = pack(np.asarray(embed, np.float32))
    if centers is not None:
        out["centers"] = pack(np.asarray(centers, np.float32))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--only", nargs="*")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict, unflatten_dict

    from espnet_tpu.data.synth_speech import SynthMixCorpus
    from espnet_tpu.models.enh.separators import kmeans_tf_bins
    from espnet_tpu.tasks.enh import EnhancementTask

    corpus = SynthMixCorpus()
    mixtures = [corpus.mixture("test", i) for i in range(N_MIX)]
    mixes = np.stack([m for m, _, _ in mixtures])
    refs = np.stack([np.stack([r1, r2]) for _, r1, r2 in mixtures])
    out = json.loads(Path(args.out).read_text()) if (
        args.only and Path(args.out).exists()) else {}
    out.update({"n_mixtures": N_MIX, "batch": SEP_BATCH,
                "samples": int(mixes.shape[1]), "seed": SEP_SEED,
                "slice_at": SLICE_AT, "slice_len": SLICE_LEN,
                "mix_energy": [float(np.sum(np.square(m, dtype=np.float64)))
                               for m in mixes]})
    seps = out.setdefault("separators", {})
    for name, sep, conf in SEPARATOR_CASES:
        if args.only and name not in args.only:
            continue
        t0 = time.time()
        cfg = separator_config(sep, conf)
        model = EnhancementTask.build_model(cfg)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                **{k: jnp.asarray(v) for k, v in
                                   EnhancementTask.example_batch(cfg)
                                   .items()})
        flat = seed_flat({k: v.shape for k, v in
                          flatten_dict(shapes, sep="/").items()}, SEP_SEED)
        params = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                 for k, v in flat.items()})
        clustering = name in CLUSTERING

        def enhance(p, x, n):
            ests, _, _ = model.apply(p, x, n, method=model.forward_enhance)
            if not clustering:
                return ests, None
            _, inter = model.apply(
                p, x, n, method=model.forward_enhance,
                capture_intermediates=lambda m, _: m.name == "embed",
                mutable=["intermediates"])
            e = jnp.tanh(inter["intermediates"]["separator_mod"]["embed"]
                         ["__call__"][0])
            B, T, _ = e.shape
            emb = e.reshape(B, -1, {"dpcl": 20, "dan": 40}[sep])
            return ests, (*kmeans_tf_bins(emb, 2),
                          e[0, EMBED_FRAMES[0]:EMBED_FRAMES[1]])

        run = jax.jit(enhance)
        ests, labels, centers, embed = [[], []], [], [], None
        for b in range(0, N_MIX, SEP_BATCH):
            x = mixes[b:b + SEP_BATCH]
            e, lab = run(params, jnp.asarray(x),
                         jnp.full((len(x),), x.shape[1], jnp.int32))
            for s in range(2):
                ests[s].append(np.asarray(e[s]))
            if clustering:
                labels.append(np.asarray(lab[0]))
                centers.append(np.asarray(lab[1]))
                embed = np.asarray(lab[2]) if embed is None else embed
        ests = np.stack([np.concatenate(e) for e in ests])
        labels = np.concatenate(labels) if clustering else None
        seps[name] = summary(name, ests, refs, labels, embed,
                             mixes.shape[1] // 128 + 1,
                             np.concatenate(centers) if sep == "dan"
                             else None) | {
            "separator": sep, "separator_conf": conf,
            "n_params": len(flat), "seconds": time.time() - t0}
        if args.port:
            seps[name]["port"] = port_first_batch(cfg, flat, mixes, ests,
                                                  labels, embed)
        print(name, f"{time.time() - t0:.1f} s", "mean pit SI-SNR",
              float(np.mean(seps[name]["pit_si_snr"])), seps[name].get(
                  "port", ""), flush=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")


def port_first_batch(cfg, flat, mixes, ests, labels, embed):
    """The port on the CPU, the first batch: each estimate's largest
    difference from JAX's over its largest |sample|; the embedding's
    frames over their largest entry, the share of labels equal."""
    import torch

    from espnet_tpu_torch import convert
    from espnet_tpu_torch.models.enh.separators import kmeans_tf_bins
    from espnet_tpu_torch.tasks.enh import EnhancementTask
    model = convert.load_flax_params(EnhancementTask.build_model(cfg),
                                     flat).eval()
    captured = {}
    if labels is not None:
        model.separator_mod.embed.register_forward_hook(
            lambda m, a, o: captured.update(embed=o))
    x = torch.from_numpy(mixes[:SEP_BATCH])
    with torch.no_grad():
        got, _, _ = model.forward_enhance(
            x, torch.full((len(x),), x.shape[1]))
    err = max(float(np.abs(g.numpy()[i] - ests[s, i]).max()
                    / np.abs(ests[s, i]).max())
              for s, g in enumerate(got) for i in range(len(x)))
    row = {"max_rel_err": err}
    if labels is not None:
        e = torch.tanh(captured["embed"])
        lab = kmeans_tf_bins(e.reshape(len(x), -1, model.separator_mod.emb_D),
                             2)[0].numpy()
        row["labels_equal"] = float((lab == labels[:SEP_BATCH]).mean())
        got_e = e[0, EMBED_FRAMES[0]:EMBED_FRAMES[1]].numpy()
        row["embed_rel_err"] = float(np.abs(got_e - embed).max()
                                     / np.abs(embed).max())
    return row


if __name__ == "__main__":
    main()
