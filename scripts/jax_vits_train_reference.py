#!/usr/bin/env python3
"""The JAX package's own fp32 figures for VITS training, on the CPU, on
the input chip_smoke.py's ``vits_train`` phase gives the PyTorch port.

The VITS recipe's data stage (egs/synth_asr/tts1/run_vits.py stage 1) at
chip_smoke's size: 160 train and 60 valid utterances of the speaker-0
corpus. The asset (assets/synth_tts_vits, generator and discriminator)
and its config with those data dirs; batches from the JAX task's own
iterators (sorted, batch 16, fixed lengths text 64 / speech 74656 /
spec 580). With dropout off, and the posterior's noise and the window
starts given (``chip_smoke.vits_draws``: numpy's RandomState(2000 + i)
for the i-th batch), it records:

- ``first_batch``: the first train batch's keys, each loss term of the
  generator's turn (adv, fm, mel, kl, dur, and their weighted sum) and
  the discriminator's loss at the asset's weights, and the MAS durations
  of every utterance (its valid tokens);
- ``steps``: two GAN steps (espnet_tpu/train/gan_trainer.py:
  make_gan_train_step, Adam 2e-4, betas (0.8, 0.99), no clipping) on the
  first two train batches, each step's stats;
- ``valid``: the 60 valid utterances' loss terms at the asset's weights,
  the j-th batch's draws ``vits_draws(VALID_DRAW_OFFSET + j)``, weighted
  by batch size.

The JAX modules run through ``apply(..., method=...)`` with the draws
given: ``jax_vits_train_forward`` is VITS.__call__ with its noise and
starts taken as arguments, ``jax_gan_apply`` VITSGan.apply on them.
Nothing in espnet_tpu/ changes. Run from the repository root (~10
minutes on 8 CPU cores):

    python scripts/jax_vits_train_reference.py --out \\
        scripts/jax_vits_train_reference.json
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

from chip_smoke import (TTS, VITS_N_TRAIN, VITS_N_VALID,  # noqa: E402
                        VALID_DRAW_OFFSET, vits_config_dict, vits_draws)


def jax_vits_train_forward(m, text, text_lengths, spec, spec_lengths,
                           noise, starts):
    """VITS.__call__ (espnet_tpu/models/tts/vits.py) at dropout off with
    the posterior's standard normal draw and the window starts given, the
    same pieces in the same order; -> its dict, with ``durations``."""
    import jax
    import jax.numpy as jnp

    from espnet_tpu.ops.monotonic_align import maximum_path
    from espnet_tpu.utils.masks import make_non_pad_mask
    B, S = text.shape
    h_text, m_p, logs_p, _ = m._prior(text, text_lengths, None,
                                      deterministic=True)
    t_mask = make_non_pad_mask(text_lengths, S)
    f_mask = make_non_pad_mask(spec_lengths, spec.shape[1])
    _, m_q, logs_q = m.posterior(spec, f_mask, jax.random.PRNGKey(0))
    z = jnp.where(f_mask[:, :, None], m_q + jnp.exp(logs_q) * noise, 0.0)
    z_p = m.flow(z, f_mask, reverse=False)
    neg_cent = (
        -0.5 * jnp.einsum("btd,bsd->bst", z_p ** 2, jnp.exp(-2 * logs_p))
        + jnp.einsum("btd,bsd->bst", z_p, m_p * jnp.exp(-2 * logs_p))
        - 0.5 * jnp.sum(m_p ** 2 * jnp.exp(-2 * logs_p) + 2 * logs_p,
                        axis=-1)[:, :, None]
        - 0.5 * jnp.log(2 * jnp.pi) * m.z_channels)
    path = jax.lax.stop_gradient(
        maximum_path(neg_cent, text_lengths, spec_lengths))
    durations = jnp.sum(path, axis=2)
    d_pred = m.duration_predictor(h_text, t_mask, deterministic=True)
    log_d_tgt = jnp.log(durations + 1.0)
    dur_loss = jnp.sum(jnp.where(t_mask, (d_pred - log_d_tgt) ** 2, 0.0)
                       ) / jnp.maximum(jnp.sum(t_mask), 1)
    m_p_f = jnp.einsum("bst,bsd->btd", path, m_p)
    logs_p_f = jnp.einsum("bst,bsd->btd", path, logs_p)
    kl = (logs_p_f - logs_q - 0.5
          + 0.5 * (z_p - m_p_f) ** 2 * jnp.exp(-2 * logs_p_f))
    kl = jnp.sum(jnp.where(f_mask[:, :, None], kl, 0.0)) / jnp.maximum(
        jnp.sum(f_mask), 1)
    seg = m.segment_frames
    z_seg = jax.vmap(lambda zb, s: jax.lax.dynamic_slice_in_dim(
        zb, s, seg, axis=0))(z, starts)
    return {"wav_hat": m._decode(z_seg), "starts": starts, "kl_loss": kl,
            "dur_loss": dur_loss, "durations": durations}


def jax_gan_apply(gan, params, batch, forward_generator: bool):
    """VITSGan.apply (espnet_tpu/models/tts/vits_gan.py) at dropout off on
    the draws ``batch["noise"]`` and ``batch["starts"]``, with the
    feature-matching loss in the stats. -> (loss, stats, weight)."""
    import jax
    import jax.numpy as jnp

    from espnet_tpu.models.tts.hifigan import (discriminator_adv_loss,
                                               feature_match_loss,
                                               generator_adv_loss,
                                               mel_spectrogram_loss)
    out = gan.generator.apply(
        params["generator"], batch["text"], batch["text_lengths"],
        batch["spec"], batch["spec_lengths"], batch["noise"],
        batch["starts"], method=jax_vits_train_forward)
    wav_hat = out["wav_hat"]
    wav_real = gan._slice_real(batch["speech"], out["starts"])
    if forward_generator:
        d_stop = jax.lax.stop_gradient(params["discriminator"])
        fake_outs = gan.discriminator.apply(d_stop, wav_hat)
        real_outs = gan.discriminator.apply(d_stop, wav_real)
        adv = generator_adv_loss(fake_outs)
        fm = feature_match_loss(real_outs, fake_outs)
        mel = mel_spectrogram_loss(wav_hat, wav_real, fs=gan.fs,
                                   n_fft=gan.n_fft,
                                   hop_length=gan.hop_length,
                                   n_mels=gan.n_mels)
        loss = (gan.lambda_adv * adv + gan.lambda_feat_match * fm
                + gan.lambda_mel * mel + gan.lambda_kl * out["kl_loss"]
                + gan.lambda_dur * out["dur_loss"])
        stats = {"generator_loss": loss, "generator_adv_loss": adv,
                 "generator_mel_loss": mel,
                 "generator_kl_loss": out["kl_loss"],
                 "generator_dur_loss": out["dur_loss"],
                 "generator_feat_match_loss": fm}
    else:
        wav_hat = jax.lax.stop_gradient(wav_hat)
        real_outs = gan.discriminator.apply(params["discriminator"],
                                            wav_real)
        fake_outs = gan.discriminator.apply(params["discriminator"],
                                            wav_hat)
        loss = discriminator_adv_loss(real_outs, fake_outs)
        stats = {"discriminator_loss": loss}
    return loss, stats, jnp.asarray(batch["text"].shape[0], jnp.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from espnet_tpu.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu.tasks.gan_tts import GANTTSTask
    from espnet_tpu.train.gan_trainer import make_gan_train_step
    from espnet_tpu.train.checkpoint import load_checkpoint
    from espnet_tpu.train.optim import build_optimizer

    ref = {"asset": TTS.name, "n_train": VITS_N_TRAIN,
           "n_valid": VITS_N_VALID, "dropout": "off",
           "draws": "chip_smoke.vits_draws"}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        SynthSpeechCorpus().materialize(work / "data", n_train=VITS_N_TRAIN,
                                        n_valid=VITS_N_VALID, n_test=0,
                                        speaker_ids=[0])
        cfg = dict(GANTTSTask.default_config(), **vits_config_dict(work))
        gan = GANTTSTask.build_model(cfg).inner
        params, _, _ = load_checkpoint(TTS)
        params = jax.tree_util.tree_map(jnp.asarray, params)
        train_if = GANTTSTask.build_iter_factory(cfg, train=True)
        valid_if = GANTTSTask.build_iter_factory(cfg, train=False)
        batches = []
        for keys, b in train_if.build_iter(1):
            batches.append((keys, b))
            if len(batches) == 2:
                break
        ref["data_seconds"] = time.perf_counter() - t0

        def with_draws(b, i):
            draws = vits_draws(i, np.asarray(b["spec_lengths"]),
                               b["spec"].shape[1])
            return {**{k: jnp.asarray(v) for k, v in b.items()},
                    **{k: jnp.asarray(v) for k, v in draws.items()}}

        def stats_of(p, b):
            _, gs, _ = jax_gan_apply(gan, p, b, True)
            _, ds, _ = jax_gan_apply(gan, p, b, False)
            return {**gs, **ds}

        jit_stats = jax.jit(stats_of)

        def evaluate(p, b):
            return {k: float(v) for k, v in jit_stats(p, b).items()}

        t0 = time.perf_counter()
        keys0, b0 = batches[0]
        batch0 = with_draws(b0, 0)
        fwd = jax.jit(lambda p, b: gan.generator.apply(
            p["generator"], b["text"], b["text_lengths"], b["spec"],
            b["spec_lengths"], b["noise"], b["starts"],
            method=jax_vits_train_forward))
        out0 = fwd(params, batch0)
        tl = np.asarray(b0["text_lengths"])
        ref["first_batch"] = {
            "keys": list(keys0), "text_lengths": tl.tolist(),
            "spec_lengths": np.asarray(b0["spec_lengths"]).tolist(),
            "starts": np.asarray(batch0["starts"]).tolist(),
            "stats": evaluate(params, batch0),
            "durations": [np.asarray(out0["durations"])[u, :tl[u]]
                          .astype(int).tolist() for u in range(len(tl))],
            "seconds": time.perf_counter() - t0}
        print(json.dumps({"first_batch": ref["first_batch"]["stats"]}),
              flush=True)

        t0 = time.perf_counter()
        tx_g = build_optimizer("adam", lr=2e-4, betas=(0.8, 0.99),
                               grad_clip=-1)
        tx_d = build_optimizer("adam", lr=2e-4, betas=(0.8, 0.99),
                               grad_clip=-1)
        step = jax.jit(make_gan_train_step(
            lambda p, b, rngs, fg: jax_gan_apply(gan, p, b, fg), tx_g, tx_d))
        opt = (tx_g.init(params["generator"]),
               tx_d.init(params["discriminator"]))
        p = params
        ref["steps"] = []
        for i, (keys, b) in enumerate(batches):
            p, opt, stats, _ = step(p, opt, with_draws(b, i),
                                    jax.random.PRNGKey(i))
            ref["steps"].append({"keys": list(keys), **{
                k: float(v) for k, v in stats.items()}})
            print(json.dumps({f"step {i + 1}": ref["steps"][-1]}),
                  flush=True)
        ref["steps_seconds"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        sums, n = {}, 0
        for j, (keys, b) in enumerate(valid_if.build_iter(1, shuffle=False)):
            s = evaluate(params, with_draws(b, VALID_DRAW_OFFSET + j))
            w = len(keys)
            for k, v in s.items():
                sums[k] = sums.get(k, 0.0) + v * w
            n += w
        ref["valid"] = {"n_utts": n, **{k: v / n for k, v in sums.items()},
                        "seconds": time.perf_counter() - t0}
        print(json.dumps({"valid": ref["valid"]}), flush=True)
    text = json.dumps(ref)
    if args.out:
        Path(args.out).write_text(text + "\n", encoding="utf-8")


if __name__ == "__main__":
    main()
