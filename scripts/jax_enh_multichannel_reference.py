#!/usr/bin/env python3
"""The JAX package's own fp32 figures for the time-domain and multichannel
separators, the array DSP and target-speaker extraction, on the CPU, on
the inputs chip_smoke.py's phases 39-42 give the PyTorch port.

The inputs are ``chip_smoke.multichannel_data``'s: the 50 SynthMixCorpus
test mixtures (4 s, 16 kHz), their 4-channel reverberant versions and
their TSE enrollments (3 s). The JSON holds:

- ``energy``: each input's sum of squares, which the card's inputs must
  equal;
- ``separators``: for SVoice and FaSNet on the mixtures, FaSNet on the
  4-channel mixtures (``fasnet_4ch``) and each case of
  ``chip_smoke.MULTICHANNEL_CASES`` (the JAX class at its default width
  in the TCN asset's config, ``chip_smoke.separator_config``; weights
  ``chip_smoke.seed_flat(..., SEP_SEED)`` over the parameter tree, which
  must equal the port's), the first MC_CPU_MIX mixtures one at a time
  through the model's forward_enhance: each estimate's largest |sample|
  ("peak"), its MC_WINDOW samples ("window") and its SI-SNR against its
  reference (the dry sources for the single-channel mixtures, the
  sources' mic-0 images for the 4-channel ones);
- ``tse``: TSEModel at n_fft 512, hop 128 with seed_flat's weights, its
  extract on the first MC_CPU_MIX triples with whole lengths (what
  ExtractSpeech passes), the same figures against ref1;
- ``dsp``: on all 50 4-channel mixtures, WPE on mic 0, the oracle MVDR
  and the oracle mfMCWF computed as ``chip_smoke.array_dsp`` computes
  them, with the JAX package's functions: each mixture's SI-SNRs
  (``chip_smoke.dsp_si_snrs``).

``--port`` adds the port on the CPU on the same inputs: each
separator's and the TSE model's largest difference from JAX over JAX's
largest |sample|, and the DSP outputs' with the largest condition number
of each one's systems. Arrays are stored zlib-compressed in base64
(``chip_smoke.unpack``). Nothing in espnet_tpu/ changes. Run from the
repository root (about 2.5 minutes on 8 CPU cores, the port's leg
included):

    python scripts/jax_enh_multichannel_reference.py [--port] \\
        [--only NAME ...] --out scripts/jax_enh_multichannel_reference.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (MC_CPU_MIX, MC_WINDOW, MULTICHANNEL_CASES,  # noqa
                        N_MIX, SEP_BATCH, SEP_SEED, TIME_DOMAIN_CASES,
                        array_dsp, dsp_si_snrs, energies,
                        multichannel_data, seed_flat, separator_config,
                        si_snr_db)
from scripts.jax_a5_reference import pack  # noqa: E402

N_FFT, HOP = 512, 128


def figures(ests, refs) -> dict:
    """ests (S', n, L), refs (n, 2, L) -> the JSON entry of one model."""
    ests = np.asarray(ests, np.float32)
    at, width = MC_WINDOW
    return {"peak": pack(np.abs(ests).max(-1)),
            "window": pack(ests[:, :, at:at + width]),
            "si_snr": [[si_snr_db(ests[s, i], refs[i][s])
                        for s in range(len(ests))]
                       for i in range(ests.shape[1])]}


def jax_weights(jmodel, port_model, *example):
    """seed_flat's weights over the JAX model's tree, after checking that
    tree against the port's (key for key, shape for shape). -> (the flat
    dict, the JAX tree)."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict, unflatten_dict

    from espnet_tpu_torch import convert
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *example)
    jshapes = {k: tuple(v.shape)
               for k, v in flatten_dict(shapes, sep="/").items()}
    pshapes = {k: tuple(v.shape) for k, v in
               convert.state_dict_to_flax(port_model).items()}
    if jshapes != pshapes:
        raise AssertionError(f"trees differ: {set(jshapes) ^ set(pshapes)}")
    flat = seed_flat(jshapes, SEP_SEED)
    return flat, unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                 for k, v in flat.items()})


def port_err(got, want) -> float:
    """Each estimate's largest difference over JAX's largest |sample|."""
    return float(max(np.abs(g - w).max() / np.abs(w).max()
                     for g, w in zip(np.asarray(got).reshape(-1, got.shape[-1]),
                                     np.asarray(want).reshape(
                                         -1, want.shape[-1]))))


def separator_entry(name, sep, conf, x, refs, port: bool) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from espnet_tpu.tasks.enh import EnhancementTask
    from espnet_tpu_torch import convert
    from espnet_tpu_torch.tasks.enh import EnhancementTask as PortTask
    cfg = separator_config(sep, conf)
    jmodel = EnhancementTask.build_model(cfg)
    pmodel = PortTask.build_model(cfg)
    x = x[:MC_CPU_MIX]
    n = jnp.asarray([x.shape[1]], jnp.int32)
    flat, params = jax_weights(jmodel, pmodel, jnp.asarray(x[:1]), n,
                               jnp.zeros((1, x.shape[1]), jnp.float32),
                               jnp.zeros((1, x.shape[1]), jnp.float32))
    run = jax.jit(lambda p, xs: jmodel.apply(p, xs, n,
                                             method=jmodel.forward_enhance)[0])
    ests = np.concatenate([np.stack([np.asarray(e) for e in
                                     run(params, jnp.asarray(x[i:i + 1]))])
                           for i in range(len(x))], axis=1)
    out = figures(ests, refs) | {"separator": sep, "separator_conf": conf,
                                 "input_shape": list(x.shape),
                                 "n_params": len(flat)}
    if port:
        convert.load_flax_params(pmodel, flat).eval()
        with torch.no_grad():
            got = np.concatenate([np.stack([g.numpy() for g in (
                pmodel.forward_enhance(torch.from_numpy(x[i:i + 1]),
                                       torch.full((1,), x.shape[1]))[0])])
                for i in range(len(x))], axis=1)
        out["port_max_rel_err"] = port_err(got, ests)
    return out


def tse_entry(mixes, enroll, refs, port: bool) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from espnet_tpu.models.enh.tse import TSEModel as JaxTSE
    from espnet_tpu_torch import convert
    from espnet_tpu_torch.models.enh.tse import TSEModel
    conf = {"n_fft": N_FFT, "hop_length": HOP}
    jmodel, pmodel = JaxTSE(**conf), TSEModel(**conf)
    mixes, enroll = mixes[:MC_CPU_MIX], enroll[:MC_CPU_MIX]
    n, ne = (jnp.full((len(mixes),), mixes.shape[1]),
             jnp.full((len(mixes),), enroll.shape[1]))
    flat, params = jax_weights(jmodel, pmodel, jnp.asarray(mixes), n,
                               jnp.asarray(enroll), jnp.asarray(mixes), ne)
    est = np.asarray(jax.jit(lambda p, m, e: jmodel.apply(
        p, m, n, e, ne, method=jmodel.extract))(
            params, jnp.asarray(mixes), jnp.asarray(enroll)))[None]
    out = figures(est, refs) | {"tse_conf": conf, "n_params": len(flat)}
    if port:
        convert.load_flax_params(pmodel, flat).eval()
        with torch.no_grad():
            got = pmodel.extract(torch.from_numpy(mixes), torch.from_numpy(
                np.asarray(n)), torch.from_numpy(enroll), torch.from_numpy(
                    np.asarray(ne)))
        out["port_max_rel_err"] = port_err(got.numpy()[None], est)
    return out


def jax_array_dsp(mix4, images) -> dict:
    """chip_smoke.array_dsp with the JAX package's STFT, WPE, covariance,
    MVDR filter and mfMCWF, in batches of SEP_BATCH."""
    import jax
    import jax.numpy as jnp

    from espnet_tpu.models.enh.beamformer import (mvdr_filter,
                                                  spatial_covariance)
    from espnet_tpu.models.enh.separators import mfmcwf
    from espnet_tpu.models.enh.wpe import wpe_dereverb
    from espnet_tpu.ops.stft import istft, stft
    kw = {"n_fft": N_FFT, "hop_length": HOP}

    @jax.jit
    def one(x, s1):
        B, S, C = x.shape
        re, im, _ = stft(x.transpose(0, 2, 1).reshape(B * C, S), None, **kw)
        T, Fq = re.shape[1:]
        re, im = re.reshape(B, C, T, Fq), im.reshape(B, C, T, Fq)
        spec = (re + 1j * im).transpose(0, 2, 1, 3)        # (B, T, C, F)
        y = wpe_dereverb(spec[:, :, :1])[:, :, 0]
        wpe = istft(y.real, y.imag, length=S, **kw)
        sr, si, _ = stft(s1, None, **kw)
        s_mag = jnp.sqrt(sr * sr + si * si)
        n_mag = jnp.abs(spec[:, :, 0] - (sr + 1j * si))
        irm = s_mag / (s_mag + n_mag + 1e-8)
        valid = jnp.ones((B, T), bool)
        w = mvdr_filter(spatial_covariance(spec, irm, valid),
                        spatial_covariance(spec, 1 - irm, valid))
        enh = jnp.einsum("bfc,btcf->btf", jnp.conj(w), spec)
        mvdr = istft(enh.real, enh.imag, length=S, **kw)
        br, bi = mfmcwf(re.transpose(0, 2, 3, 1), im.transpose(0, 2, 3, 1),
                        sr, si)
        return wpe, mvdr, istft(br, bi, length=S, **kw)

    out = {"wpe": [], "mvdr": [], "mfmcwf": []}
    for b in range(0, len(mix4), SEP_BATCH):
        for k, v in zip(out, one(jnp.asarray(mix4[b:b + SEP_BATCH]),
                                 jnp.asarray(images[b:b + SEP_BATCH, 0, :,
                                                    0]))):
            out[k].append(np.asarray(v))
    return {k: np.concatenate(v) for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--only", nargs="*")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    data = multichannel_data()
    mixes, mix4 = data["mixes"], data["mix4"]
    refs = [list(r) for r in data["refs"]]
    refs4 = [list(r) for r in data["images"][:, :, :, 0]]
    out = json.loads(Path(args.out).read_text()) if (
        args.only and Path(args.out).exists()) else {}
    out.update({"n_mixtures": N_MIX, "samples": int(mixes.shape[1]),
                "seed": SEP_SEED, "window": list(MC_WINDOW),
                "energy": {k: energies(data[k])
                           for k in ("mixes", "mix4", "enroll")}})
    seps = out.setdefault("separators", {})
    cases = ([(n, s, c, mixes, refs) for n, s, c in TIME_DOMAIN_CASES]
             + [("fasnet_4ch", "fasnet", {}, mix4, refs4)]
             + [(n, s, c, mix4 if ch > 1 else
                 np.ascontiguousarray(mix4[..., 0]), refs4)
                for n, s, c, ch in MULTICHANNEL_CASES])
    for name, sep, conf, x, r in cases:
        if args.only and name not in args.only:
            continue
        t0 = time.time()
        seps[name] = separator_entry(name, sep, conf, x, r, args.port)
        seps[name]["seconds"] = time.time() - t0
        print(name, f"{time.time() - t0:.1f} s", seps[name]["si_snr"],
              seps[name].get("port_max_rel_err", ""), flush=True)
    if not args.only or "tse" in args.only:
        t0 = time.time()
        out["tse"] = tse_entry(mixes, data["enroll"], refs, args.port)
        print("tse", f"{time.time() - t0:.1f} s", out["tse"]["si_snr"],
              out["tse"].get("port_max_rel_err", ""), flush=True)
    if not args.only or "dsp" in args.only:
        t0 = time.time()
        outs = jax_array_dsp(mix4, data["images"])
        out["dsp"] = {"si_snr": dsp_si_snrs(outs, mix4, data["images"],
                                            data["direct"])}
        if args.port:
            conds = {}
            got = array_dsp(torch, mix4, data["images"], "cpu", conds=conds)
            out["dsp"]["port_max_rel_err"] = {
                k: port_err(got[k], outs[k]) for k in outs}
            out["dsp"]["port_cond_max"] = conds
        out["dsp"]["seconds"] = time.time() - t0
        print("dsp", {k: float(np.mean(v))
                      for k, v in out["dsp"]["si_snr"].items()},
              out["dsp"].get("port_max_rel_err", ""), flush=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
