#!/usr/bin/env python3
"""How far fp32 rounding alone moves TF-GridNet's (or TF-GridNetV2's)
worst gradient in chip_smoke.py's grad check.

chip_smoke.py's phases 38 and 43 train TF-GridNet and TF-GridNetV2 from
seed_flat's weights; a grad check would hold one backward on the first
valid batch against a float64 backward on the CPU that takes the fp32
leg's ReLU sides (tools/grad_pin.py), each parameter within 1e-3 of its
scale. For TF-GridNet the worst parameters are the Q- and K-branch PReLU
slopes of block 1, head 1 (``PReLU_10``, ``PReLU_11``): each gradient is
the sum over the negative inputs x of x * dy, whose terms cancel. This
script measures each such sum's condition number (the terms' absolute
sum over the sum's magnitude, in float64) and, for every leg, the worst
parameters' distances from the float64 backward, the fp32 leg's worst
among them, for fp32 legs that differ only in their rounding: the port
as it is, and with one part of the separator run in float64 (the
PReLUs, the norms over (F, channel), the frame attention or its scores,
softmax or product with the values alone, the LSTMs, or several).

    python scripts/tfgridnet_grad_conditioning.py [--device cpu|cuda] \\
        [--separator tfgridnet|tfgridnetv2] [--batch 1] \\
        [--legs fp32 attention64 ...] [--out FILE.jsonl]

Run from the repository root; it writes its data and a seed model under
$TMPDIR. One JSON line per leg.
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

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from espnet_tpu_torch import convert  # noqa: E402
from espnet_tpu_torch.data.synth_speech import SynthMixCorpus  # noqa: E402
from espnet_tpu_torch.models.enh import separators as S  # noqa: E402
from espnet_tpu_torch.tasks.enh import EnhancementTask  # noqa: E402
from espnet_tpu_torch.tools import grad_pin  # noqa: E402
from espnet_tpu_torch.train.trainer import to_device  # noqa: E402

# TF-GridNet's block 1, head 1: Q and K branches
SLOPES = {"tfgridnet": ("PReLU_10", "PReLU_11"), "tfgridnetv2": ()}


def prelu64(self, x):
    return torch.where(x >= 0, x.double(), self.negative_slope.double()
                       * x.double()).to(x.dtype)


def norm64(self, x):
    xd = x.double()
    var, mean = torch.var_mean(xd, dim=self.dims, unbiased=False,
                               keepdim=True)
    return ((xd - mean) * torch.rsqrt(var + self.eps) * self.weight.double()
            + self.bias.double()).to(x.dtype)


def attention64(q, k, v, temperature):
    return ORIGINAL["attention"](q.double(), k.double(), v.double(),
                                 temperature).to(q.dtype)


def scores64(q, k, v, temperature):
    s = (q.double() @ k.double().transpose(1, 2) / temperature).float()
    return torch.softmax(s, dim=-1) @ v


def softmax64(q, k, v, temperature):
    s = q @ k.transpose(1, 2) / temperature
    return torch.softmax(s.double(), dim=-1).float() @ v


def values64(q, k, v, temperature):
    p = torch.softmax(q @ k.transpose(1, 2) / temperature, dim=-1)
    return (p.double() @ v.double()).float()


def lstm64(cells, xs, reverse=None, carry=None):
    """separators.lstm_scans in float64, one cell after another."""
    reverse = reverse or (False,) * len(cells)
    outs, cs, hs = [], [], []
    for k, (cell, x, r) in enumerate(zip(cells, xs, reverse)):
        w = torch.cat([getattr(cell, f"i{g}").weight for g in cell.GATES])
        b = torch.cat([getattr(cell, f"h{g}").bias for g in cell.GATES])
        wt = cell.hidden_kernel().double()
        proj = (x.double() @ w.double().t() + b.double()).unbind(1)
        B, T, _ = x.shape
        c, h = ((carry[0][k].double(), carry[1][k].double())
                if carry is not None else
                (x.new_zeros(B, wt.shape[0], dtype=torch.float64),) * 2)
        out = [None] * T
        for t in (range(T - 1, -1, -1) if r else range(T)):
            c, h = cell((c, h), proj[t], wt)
            out[t] = h
        outs.append(torch.stack(out, dim=1))
        cs.append(c)
        hs.append(h)
    dt = xs[0].dtype
    return torch.stack(outs).to(dt), (torch.stack(cs).to(dt),
                                      torch.stack(hs).to(dt))


ORIGINAL = {"prelu": S.PReLU.forward, "norm": S.TwoAxisLayerNorm.forward,
            "attention": S.frame_attention, "lstm": S.lstm_scans}
FLOAT64 = {"prelu": prelu64, "norm": norm64, "attention": attention64,
           "scores": scores64, "softmax": softmax64, "values": values64,
           "lstm": lstm64}
LEGS = {"fp32": (), "prelu64": ("prelu",), "norm64": ("norm",),
        "attention64": ("attention",), "scores64": ("scores",),
        "softmax64": ("softmax",), "values64": ("values",),
        "lstm64": ("lstm",),
        "prelu_norm_attention64": ("prelu", "norm", "attention"),
        "all_four64": ("prelu", "norm", "attention", "lstm")}
ATTENTION_PARTS = ("attention", "scores", "softmax", "values")


def use(parts):
    S.PReLU.forward = FLOAT64["prelu"] if "prelu" in parts \
        else ORIGINAL["prelu"]
    S.TwoAxisLayerNorm.forward = FLOAT64["norm"] if "norm" in parts \
        else ORIGINAL["norm"]
    S.frame_attention = next((FLOAT64[a] for a in ATTENTION_PARTS
                              if a in parts), ORIGINAL["attention"])
    S.lstm_scans = FLOAT64["lstm"] if "lstm" in parts else ORIGINAL["lstm"]


def backward(cfg, weights, batch, device, parts, signs, moved,
             float64=False, terms=None, slopes=()):
    """One pinned backward -> (loss, {flax name: gradient})."""
    use(parts)
    m, _ = EnhancementTask.build_model_from_file(cfg, weights, device)
    if float64:
        grad_pin.to_float64(m)
    hooks = grad_pin.pin_relus(grad_pin.relu_inputs(m), signs, moved)
    if terms is not None:
        def note(name):
            def hook(mod, args, out):
                neg = torch.where(args[0] < 0, args[0], 0).detach()
                out.register_hook(lambda gy: terms.__setitem__(name, {
                    "sum": float((neg * gy).sum()),
                    "abs_sum": float((neg * gy).abs().sum()),
                    "n_negative": int((neg < 0).sum())}))
            return hook
        hooks += [getattr(m.separator_mod, n).register_forward_hook(note(n))
                  for n in slopes]
    loss, _, _ = m(**to_device(batch, device))
    loss.backward()
    for h in hooks:
        h.remove()
    use(())
    return loss.item(), convert.state_dict_to_flax(m, grad=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--separator", default="tfgridnet",
                    choices=list(SLOPES))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--legs", nargs="*", default=list(LEGS),
                    choices=list(LEGS))
    ap.add_argument("--out")
    args = ap.parse_args()
    sep, slopes = args.separator, SLOPES[args.separator]
    work = Path(tempfile.mkdtemp(prefix=f"{sep}_grad_"))
    cfg, weights = cs.seed_model_dir(work, f"{sep}_train", sep, {},
                                     loss_type="si_snr")
    SynthMixCorpus(seconds=4.0).materialize(
        work / "enh_data", n_train=cs.ENH_N_TRAIN, n_valid=cs.ENH_N_VALID,
        n_test=0)
    ecfg, _ = cs.enh_config(work, "grad", separator=sep,
                            separator_conf={}, loss_type="si_snr",
                            init_param=str(weights))
    valid_if = EnhancementTask.build_iter_factory(ecfg, train=False)
    _, batch = valid_if.collate_fn([valid_if.dataset[k] for k in
                                    valid_if.epoch_batches(0)[0]
                                    [:args.batch]])
    signs, terms = {}, {}
    t0 = time.perf_counter()
    first = backward(cfg, weights, batch, args.device, (), signs, None)
    moved = {}
    loss64, ref = backward(cfg, weights, batch, "cpu", (), signs, moved,
                           float64=True, terms=terms, slopes=slopes)
    top = max(float(abs(g).max()) for g in ref.values())
    watch = None
    for name in args.legs:
        parts = LEGS[name]
        try:
            loss, grads = first if name == "fp32" else backward(
                cfg, weights, batch, args.device, parts, signs, {})
        except torch.cuda.OutOfMemoryError:
            # a float64 part at the train batch may not fit on the card
            use(())
            torch.cuda.empty_cache()
            print(json.dumps({"leg": name, "out_of_memory": True}),
                  flush=True)
            continue
        ratios = {n: float(abs(grads[n] - g).max())
                  / max(float(abs(g).max()), 1e-4 * top)
                  for n, g in ref.items()}
        worst = sorted(ratios, key=ratios.get, reverse=True)[:3]
        watch = watch or worst[0]
        row = {"leg": name, "separator": sep, "float64_parts": list(parts),
               "device": args.device, "batch": args.batch, "loss": loss,
               "loss_float64": loss64,
               "worst": [[n, ratios[n]] for n in worst],
               "first_legs_worst": [watch, ratios[watch]],
               "slopes": {n: {
                   "ratio": ratios[f"params/separator_mod/{n}/"
                                   "negative_slope"],
                   "condition": terms[n]["abs_sum"] / abs(terms[n]["sum"]),
                   "float64_terms": terms[n]} for n in slopes},
               "float64_pins_moved": moved,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del grads
        if args.device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
