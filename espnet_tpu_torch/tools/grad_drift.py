"""Where the card's fp32 gradients leave float64, tensor by tensor.

One forward and backward of a model in eval mode on one batch, three
times: on the card in fp32 (its kernels), on the CPU in fp32 and on the
CPU in float64 (the kernels' plain versions). The two CPU legs take the
card's side at every ReLU (tools/grad_pin.py), as chip_smoke.py's
grad_check does, so the three follow one path through the network. A
forward hook on every module
records its output (and a leaf module's first input), and a tensor
hook on each output records the gradient the backward brings to it. For every
such tensor and for every parameter's gradient it prints

    card = max |x_card - x_f64| / max |x_f64|,  cpu = the same for x_cpu,

the forward's tensors in the order the forward made them, the output
gradients in the order the card's backward reached them. The first
tensor whose card figure is far above the CPU's is where the card's fp32
arithmetic departs from what the CPU's keeps.

The state: ``--train DIR`` runs chip_smoke.py's long-form training (its
data and config, 6 steps from the seed) and saves the trained
parameters, the config and chip_smoke's grad-check batch (the first two
train recordings) under DIR, then probes them; ``--state DIR`` probes a
saved state. One card:

    python3 espnet_tpu_torch/tools/grad_drift.py --train DIR
    python3 espnet_tpu_torch/tools/grad_drift.py --state DIR

It prints JSON lines: the legs' losses and seconds, the grad check's
ratio (card against CPU, as chip_smoke.py computes it), the first tensor
of the forward, of the backward and of the parameters where the card
departs (card >= DEPART x cpu and >= FLOOR), the parameters' rows and
the rows with the highest card / cpu; every row goes to
DIR/rows_card.json.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DEPART = 10.0   # card's distance at least this many times the CPU's
FLOOR = 1e-5    # and at least this far from float64, relative


def run_leg(torch, state: Path, batch, leg: str, dev: str, signs):
    """One forward and backward on ``dev`` -> (loss, {name: tensor} of
    the forward, [(name, grad)] in the backward's order, {param: grad}).
    The card leg notes its ReLU sides, the other legs take them."""
    from espnet_tpu_torch import convert
    from espnet_tpu_torch.tasks.asr import ASRTask
    from espnet_tpu_torch.tools import grad_pin
    from espnet_tpu_torch.train.trainer import to_device
    model, _ = ASRTask.build_model_from_file(state / "config.yaml", state,
                                             dev)
    if leg == "float64":
        grad_pin.to_float64(model)
    grad_pin.pin_relus(grad_pin.relu_inputs(model), signs,
                       None if leg == "card" else {})
    fwd, bwd, count = {}, [], {}

    def keep(t):
        return t.detach().to("cpu", copy=True)

    def tap(name, leaf):
        def hook(module, args, out):
            n = count.get(name, 0)
            count[name] = n + 1
            key = f"{name}#{n}" if n else name
            if leaf and args and torch.is_tensor(args[0]) \
                    and args[0].is_floating_point():
                fwd[f"{key}:in"] = keep(args[0])
            outs = out if isinstance(out, tuple) else (out,)
            for i, o in enumerate(outs):
                if not (torch.is_tensor(o) and o.is_floating_point()):
                    continue
                k = f"{key}[{i}]" if len(outs) > 1 else key
                fwd[k] = keep(o)
                if o.requires_grad:
                    o.register_hook(lambda g, k=k: bwd.append((k, keep(g))))
        return hook

    for name, mod in model.named_modules():
        if name:
            mod.register_forward_hook(
                tap(name, next(mod.children(), None) is None))
    loss, _, _ = model(**to_device(batch, dev))
    loss.backward()
    if dev == "cuda":
        torch.cuda.synchronize()
    return (loss.item(), fwd, bwd,
            {k: torch.from_numpy(v) for k, v in
             convert.state_dict_to_flax(model, grad=True).items()})


def distance(torch, x, ref) -> float:
    if x.shape != ref.shape:
        return float("nan")
    ref = ref.double()
    return float((x.double() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


def compare(torch, legs: dict) -> dict:
    """Rows [name, card, cpu] of the forward, the backward and the
    parameters, and the first row of each where the card departs."""
    ref, cpu, c = legs["float64"], legs["cpu"], legs["card"]
    out = {}
    for part, names in (("forward", list(c[1])),
                        ("backward", [k for k, _ in c[2]])):
        getter = ((lambda leg, k: leg[1].get(k)) if part == "forward" else
                  (lambda leg, k: dict(leg[2]).get(k)))
        rows = []
        for k in names:
            r = getter(ref, k)
            if r is None or getter(cpu, k) is None:
                continue
            rows.append([k, distance(torch, getter(c, k), r),
                         distance(torch, getter(cpu, k), r)])
        out[part] = rows
    top = max(float(g.abs().max()) for g in ref[3].values())

    def scaled(g, r):
        return float((g.double() - r.double()).abs().max()) / max(
            float(r.abs().max()), 1e-4 * top)
    out["params"] = sorted(([k, scaled(c[3][k], r), scaled(cpu[3][k], r)]
                            for k, r in ref[3].items()),
                           key=lambda row: -row[1])
    out["first_departure"] = {
        part: next((row for row in out[part]
                    if row[1] >= FLOOR and row[1] >= DEPART * row[2]), None)
        for part in ("forward", "backward", "params")}
    # where the first departing tensors of the forward and the backward
    # are furthest from float64: the index, and the three legs' values
    for part, get in (("forward", lambda leg, k: leg[1][k]),
                      ("backward", lambda leg, k: dict(leg[2])[k])):
        row = out["first_departure"][part]
        if row is None:
            continue
        x, r, y = (get(leg, row[0]).double() for leg in (c, ref, cpu))
        dev = (x - r).abs()
        idx = [int(i) for i in torch.unravel_index(dev.argmax(), dev.shape)]
        out["first_departure"][f"{part}_worst_entry"] = {
            "index": idx, "card": float(x[tuple(idx)]),
            "float64": float(r[tuple(idx)]), "cpu": float(y[tuple(idx)]),
            "n_over_half_max": int((dev > 0.5 * dev.max()).sum())}
    return out


def grad_check_ratio(legs: dict) -> list:
    """chip_smoke.py's check: [worst param, its ratio] of the card
    against the CPU's fp32 gradients (pinned)."""
    c, cpu = legs["card"][3], legs["cpu"][3]
    top = max(float(g.abs().max()) for g in cpu.values())
    ratios = {k: float((c[k] - g).abs().max())
              / max(float(g.abs().max()), 1e-4 * top)
              for k, g in cpu.items()}
    worst = max(ratios, key=ratios.get)
    return [worst, ratios[worst]]


def train_state(torch, out: Path):
    """chip_smoke.py's long-form training into a temporary directory;
    its parameters, config and grad-check batch saved under ``out``."""
    import chip_smoke as cs
    from espnet_tpu_torch.bin import asr_train
    from espnet_tpu_torch.data.synth_speech import (SynthSpeechCorpus,
                                                    concat_data_dir)
    from espnet_tpu_torch.tasks.asr import ASRTask
    work = Path(tempfile.mkdtemp(prefix="grad_drift_"))
    try:
        data = work / "data"
        SynthSpeechCorpus().materialize(data, n_train=cs.N_TRAIN,
                                        n_valid=cs.N_VALID, n_test=0)
        for split in ("train", "valid"):
            concat_data_dir(data / split, data / f"{split}_long",
                            cs.LONG_MIN_SAMPLES)
        cfg, path = cs.longform_config(work, "longform")
        asr_train.main(["--config", str(path)])
        train_if = ASRTask.build_iter_factory(cfg, train=True)
        _, batch = train_if.collate_fn(
            [train_if.dataset[k] for k in train_if.dataset.keys()[:2]])
        out.mkdir(parents=True, exist_ok=True)
        lout = Path(cfg["output_dir"])
        shutil.copy(lout / "config.yaml", out / "config.yaml")
        shutil.copy(lout / "checkpoint" / "params.pkl", out / "params.pkl")
        torch.save({k: torch.as_tensor(v) for k, v in batch.items()},
                   out / "batch.pt")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--train", type=Path)
    group.add_argument("--state", type=Path)
    parser.add_argument("--rows", type=int, default=40,
                        help="rows of each table to print")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("grad_drift: no card")
    print(json.dumps({"nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]}), flush=True)
    state = args.train or args.state
    if args.train:
        t0 = time.perf_counter()
        train_state(torch, state)
        print(json.dumps({"trained": str(state),
                          "seconds": time.perf_counter() - t0}), flush=True)
    batch = torch.load(state / "batch.pt", weights_only=False)
    signs, legs, seconds = {}, {}, {}
    for leg, dev in (("card", "cuda"), ("cpu", "cpu"), ("float64", "cpu")):
        t0 = time.perf_counter()
        legs[leg] = run_leg(torch, state, batch, leg, dev, signs)
        seconds[leg] = time.perf_counter() - t0
    print(json.dumps({"losses": {k: v[0] for k, v in legs.items()},
                      "seconds": seconds}), flush=True)
    res = compare(torch, legs)
    (state / "rows_card.json").write_text(json.dumps(res))
    print(json.dumps({"leg": "card", "loss": legs["card"][0],
                      "grad_check": grad_check_ratio(legs),
                      "first_departure": res["first_departure"],
                      "params": res["params"][:args.rows]}), flush=True)
    for part in ("forward", "backward"):
        rows = res[part]
        worst = sorted(rows, key=lambda r: -(r[1] / max(r[2], 1e-30)))
        print(json.dumps({"leg": "card", "part": part, "n": len(rows),
                          "highest_card_over_cpu": worst[:args.rows]}),
              flush=True)


if __name__ == "__main__":
    main()
