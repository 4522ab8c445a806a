"""Drive the PyTorch port (espnet_tpu_torch) on one NVIDIA card and check it.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and the nvidia-smi name and power limit line;
2. build: compiles the port's CUDA kernels from espnet_tpu_torch/csrc;
3. longform_data: the long-form data dirs, train_long and valid_long,
   each recording joining consecutive utterances of the train and valid
   dirs of phase 5 until it holds at least 1,100,000 samples (past 2048
   encoder frames after conv2d x4), and decode_long (valid_long and two
   train_long recordings): counts, samples, encoder frames, tokens;
4. kernel_checks: each kernel against its plain PyTorch version at the
   shapes of its path, with the stated tolerance: the attention forward
   at the decode shape, its backward at the train shape (with the real
   rel-pos + padding bias of the first conformer block, which needs a
   gradient) and on a small causal case with Tq != Tk, the log-mel, the
   RNN-T lattice sweeps with their closed-form gradient on the
   transducer's real joint logits of its first train batch and on a small
   ragged case, and the banded attention forward and backward on the
   first Longformer block's q, k, v and valid frames of the long-form
   decode batch and of the first long-form train batch, and on small
   ragged cases (T not a multiple of 64, W >= T, W = 0, a padded tail
   longer than W); each kernel is timed beside the plain version and,
   where one exists, one PyTorch library call (a yardstick only);
5. main_path: the flagship hybrid CTC/attention Conformer
   (assets/synth_asr_flagship) built by Speech2Text on the card decodes the
   first 64 held-out SynthSpeechCorpus utterances in fp32 (beam 10, CTC
   weight 0.3): one warm-up decode, then the counted one and two more,
   all three timed; WER, CER, audio seconds per second and kernel launches;
6. train_path: 300 train and 50 valid SynthSpeechCorpus utterances
   written as Kaldi data dirs under a temporary directory, then the
   training entry point (espnet_tpu_torch.bin.asr_train.main) on the
   flagship config, initialised from the flagship's weights: batch 25,
   10 steps, validation, checkpoint. Per step: the losses, accuracy,
   gradient norm, skip flag and kernel launches; the median step time,
   the peak device memory, the validation loss and accuracy before and
   after, and a reload of the checkpoint that must give the same
   validation loss;
7. grad_check: one fixed batch through the flagship in eval mode, on the
   card (kernels) and on the CPU (plain versions): the loss and every
   parameter's gradient must agree;
8. transducer_decode: the Conformer transducer
   (assets/synth_asr_transducer) built by Speech2TextTransducer on the
   card decodes the same 64 utterances (beam 5), as main_path does;
9. transducer_train: its entry point
   (espnet_tpu_torch.bin.asr_transducer_train.main) on the transducer
   config over the same data dirs, as train_path does;
10. transducer_grad_check: grad_check for the transducer;
11. longform_train: the training entry point on the long-form config
    (the flagship's, with a 6-block Longformer encoder at the flagship's
    widths and a +-64-frame band, natural padding), initialised as flax
    would from the seed: batch 4, sorted batches, 3 epochs (6 steps),
    validation, checkpoint, with train_path's records per step and at
    the end;
12. longform_grad_check: grad_check for the long-form model, on the
    first 2 train_long recordings;
13. longform_decode: the batch-decode CLI's inference() with the trained
    checkpoint over decode_long, batch 4, greedy CTC, after one warm-up
    run: launches per encode, the written 1best_recog/text, audio seconds
    per second, and the card's CTC log-probabilities and greedy tokens
    against the CPU's;
14. determinism: for each of the three models, two 3-step runs of its
    entry point from one seed (dropout and SpecAug on) must end with
    bit-identical parameters, and a run stopped after step 2 and resumed
    from its checkpoint must equal them at step 3; no CTC gradient may
    come from torch's CTC loss.

Then the nvidia-smi line, one {"kernels": [...]} line (errors, times and
bounds of phase 4, launches from the paths that run each kernel) and last
{"ok": true, "device": {...}}. Without a card, or when any phase fails,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ASSET = ROOT / "assets" / "synth_asr_flagship"
TRANSDUCER = ROOT / "assets" / "synth_asr_transducer"
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
# the attention backward: sums over at most T = 145 terms in fp32, each
# gradient measured against its own largest entry (~1e-6 expected)
K1B_TOL = 2e-5
N_TRAIN, N_VALID = 300, 50
TRAIN_BATCH = 25
TRAIN_STEPS = 10
# warmup 600 keeps the LR under 4e-5 for 10 steps: the model barely
# moves, so validation accuracy may not fall by more than 1 point
ACC_MARGIN = 0.01
# a reload of the checkpoint runs the same kernels on the same batches
RELOAD_TOL = 1e-5
# card (kernels, cuBLAS) against CPU (plain versions) through 6 blocks
# and 3 decoder layers in fp32: each parameter's gradient within 1e-3 of
# its own largest entry; the key biases, whose gradient is zero in exact
# arithmetic (a shift of a row of scores does not change its softmax),
# against 1e-4 of the largest gradient of the model instead
GRAD_TOL = 1e-3
GRAD_BATCH = 8
# the RNN-T sweeps: the kernel and the plain version take the same fp32
# steps in the same order (a log-add per edge along one diagonal chain),
# so they should agree to ~1e-6 relative; nll, alpha and beta (inside
# each sample's lattice) against their largest entry, and the
# closed-form dlogits against its largest entry
K3_TOL = 1e-5
TRANSDUCER_BEAM = 5
# the JAX package's own fp32 decode of these 64 utterances (same
# padding, beam 5, its Speech2TextTransducer on a CPU): WER 4/335 =
# 1.194%; the port may be at most 0.5 points above it, and at most 3%
JAX_TRANSDUCER_WER = 4 / 335
MAX_TRANSDUCER_WER = min(JAX_TRANSDUCER_WER + 0.005, 0.03)
DETERMINISM_STEPS = 3
# the long-form slice: recordings of at least 68.75 s, so every one is
# past the JAX package's splash threshold (T' >= 2048 after conv2d x4);
# the Longformer encoder at the flagship's widths
LONG_MIN_SAMPLES = 1_100_000
LONG_ENCODER = {"output_size": 256, "attention_heads": 4,
                "linear_units": 1024, "num_blocks": 6,
                "attention_window": 64}
# 300 train and 50 valid utterances make 8 and 1 recordings: 2 batches
# of 4 an epoch, so 3 epochs for 6 steps
LONG_BATCH = 4
LONG_EPOCHS = 3
LONG_MIN_STEPS = 6
LONG_DECODE_TRAIN = 2    # train_long recordings in the decode set
LONG_MIN_FRAMES = 2048
# the banded attention: as K1 and K1b (sums over at most 2W + 1 = 129
# keys); the kernels and the plain versions give a row with no allowed
# key 0, so the forward is compared on every row. A gradient that is zero
# in exact arithmetic (dq and dk at W = 0, where each row attends itself
# alone, its largest plain entry below 1e-3 of the case's largest) keeps
# only fp32 rounding of do.v - D, and is measured against the case's
# largest gradient entry instead of its own
K4_TOL = 1e-4
K4B_TOL = 2e-5
# the long-form model's CTC log-probabilities, card (kernels, cuBLAS)
# against CPU (plain versions), through 6 blocks in fp32
LOGPROB_TOL = 1e-4


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


def bound(kern):
    """The larger of bytes / HBM rate and operations / fp32 rate, in ms."""
    t_bytes = kern["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = kern["flops"] / FP32_FLOPS * 1e3
    kern["bound_ms"] = max(t_bytes, t_ops)
    kern["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def train_config(task, asset: Path, workdir: Path, name: str, **extra):
    """The asset's config with its data, token list, stats and initial
    weights pointed at this run's files, written to workdir/name.yaml."""
    from espnet_tpu_torch.utils.config import dump_yaml, resolve_config
    data = workdir / "data"
    cfg = resolve_config(task.default_config(), asset / "config.yaml", {
        "output_dir": str(workdir / name),
        "train_data_path_and_name_and_type": [
            f"{data}/train/wav.scp,speech,sound",
            f"{data}/train/text,text,text"],
        "valid_data_path_and_name_and_type": [
            f"{data}/valid/wav.scp,speech,sound",
            f"{data}/valid/text,text,text"],
        "train_shape_file": [], "valid_shape_file": [],
        "token_list": str(asset / "tokens.txt"),
        "stats_file": str(asset / "feats_stats.npz"),
        "init_param": str(asset / "params_f16.npz"),
        "batch_size": TRAIN_BATCH, "max_epoch": 1,
        "num_iters_per_epoch": TRAIN_STEPS, "log_interval": 1, **extra})
    dump_yaml(cfg, workdir / f"{name}.yaml")
    return cfg, workdir / f"{name}.yaml"


def longform_config(workdir: Path, name: str, **extra):
    """The long-form slice's config, written to workdir/name.yaml: the
    flagship's, with the Longformer encoder at the flagship's widths,
    batches padded to their longest recording (no collate_fixed_lengths),
    no initial weights (the entry point initialises as flax would, from
    the seed), over the long-form data dirs."""
    from espnet_tpu_torch.tasks.asr import ASRTask
    from espnet_tpu_torch.utils.config import (dump_yaml, load_yaml,
                                               resolve_config)
    base = load_yaml(ASSET / "config.yaml")
    base.pop("collate_fixed_lengths")
    data = workdir / "data"
    cfg = resolve_config(ASRTask.default_config(), overrides={
        **base, "encoder": "longformer", "encoder_conf": dict(LONG_ENCODER),
        "output_dir": str(workdir / name),
        "train_data_path_and_name_and_type": [
            f"{data}/train_long/wav.scp,speech,sound",
            f"{data}/train_long/text,text,text"],
        "valid_data_path_and_name_and_type": [
            f"{data}/valid_long/wav.scp,speech,sound",
            f"{data}/valid_long/text,text,text"],
        "train_shape_file": [], "valid_shape_file": [],
        "token_list": str(ASSET / "tokens.txt"),
        "stats_file": str(ASSET / "feats_stats.npz"), "init_param": None,
        "batch_size": LONG_BATCH, "max_epoch": LONG_EPOCHS,
        "num_iters_per_epoch": None, "log_interval": 1, **extra})
    dump_yaml(cfg, workdir / f"{name}.yaml")
    return cfg, workdir / f"{name}.yaml"


def encoder_frames(samples: int, hop: int) -> int:
    """Encoder frames of a recording: the frontend's frames, then
    conv2d x4's two (k=3, s=2) convolutions."""
    from espnet_tpu_torch.nn.subsampling import sub_out_len
    return sub_out_len(sub_out_len(samples // hop + 1, 3, 2), 3, 2)


def grad_errors(kern, plain) -> dict:
    """Each gradient's max abs error, and that error against its own
    largest plain entry, or against the case's largest gradient entry
    for a gradient that is zero in exact arithmetic (below 1e-3 of it)."""
    top = max(float(b.abs().max()) for b in plain)
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), kern, plain):
        own = float(b.abs().max())
        err = float((a - b).abs().max())
        out[name] = {"max_abs_err": err,
                     "rel_err": err / max(own if own >= 1e-3 * top else top,
                                          1e-30)}
    return out


def first_batch(iter_factory, device):
    """The first batch of epoch 1, collated and on ``device``."""
    from espnet_tpu_torch.train.trainer import to_device
    keys = iter_factory.epoch_batches(1)[0]
    _, batch = iter_factory.collate_fn([iter_factory.dataset[k]
                                        for k in keys])
    return to_device(batch, device)


def train_run(torch, _cuda, entry_main, cfg_path: Path, model_cls):
    """Train through an entry point with every launch count at 0 first.
    A forward pre-hook on the model notes the counts at each forward, so
    a train step's launches are the difference to the next forward (its
    backward and update lie between). -> the trainer, launches per step,
    all launches, wall seconds, peak device bytes."""
    snaps = []

    def note(module, args):
        if isinstance(module, model_cls):
            snaps.append((module.training, dict(_cuda.LAUNCHES)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    handle = torch.nn.modules.module.register_module_forward_pre_hook(note)
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        _, trainer = entry_main(["--config", str(cfg_path)])
    finally:
        handle.remove()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    snaps.append((None, launches))
    per_step = [{n: nxt[n] - cur[n] for n in cur}
                for (training, cur), (_, nxt) in zip(snaps, snaps[1:])
                if training]
    return (trainer, per_step, launches, wall,
            torch.cuda.max_memory_allocated())


def check_steps(steps, per_step, want, loss_keys, n_steps=TRAIN_STEPS):
    """n_steps finite, unskipped steps with launches ``want`` each."""
    if len(steps) != n_steps or len(per_step) != n_steps:
        raise AssertionError(f"{len(steps)} train steps, not {n_steps}")
    for s, n in zip(steps, per_step):
        if not all(math.isfinite(s[k]) for k in loss_keys + ("grad_norm",)):
            raise AssertionError(f"a non-finite train step: {s}")
        if s["skipped"]:
            raise AssertionError(f"a train step was skipped: {s}")
        if n != want:
            raise AssertionError(f"launches per step {n}, not {want}")


def relu_inputs(model) -> dict:
    """The modules whose outputs go into a ReLU: the subsampling's two
    convolutions and the first linear of each ReLU feed-forward."""
    import torch.nn.functional as F

    from espnet_tpu_torch.nn.subsampling import Conv2dSubsampling
    from espnet_tpu_torch.nn.transformer import PositionwiseFeedForward
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, Conv2dSubsampling):
            out.update({f"{name}.conv0": m.conv0, f"{name}.conv1": m.conv1})
        elif isinstance(m, PositionwiseFeedForward) and m.act is F.relu:
            out[f"{name}.w_1"] = m.w_1
    return out


def grad_check(torch, config: Path, model_file: Path, build, batch) -> dict:
    """One backward of the model of (config, model_file) in eval mode on
    ``batch``, on the card and on the CPU: the loss and each parameter's
    gradient must agree within GRAD_TOL of its scale (the larger of its
    own largest entry and 1e-4 of the model's largest gradient).

    A ReLU has no derivative at 0, and fp32 rounding decides on which
    side of it a pre-activation within ~1e-7 of 0 falls: the two devices
    may then differ by a whole unit's term in the gradient of the weights
    before it, though both are right. So the CPU's backward takes the
    card's side at every ReLU (its pre-activations where the signs differ
    are moved onto the card's side, by less than their rounding, with an
    identity gradient); how many units moved, and the worst ratio
    without the move, are reported beside the check."""
    from espnet_tpu_torch import convert
    from espnet_tpu_torch.tasks.asr import build_model_from_file
    from espnet_tpu_torch.train.trainer import to_device
    signs, moved = {}, {}

    def pin(name, dev):
        def hook(module, args, out):
            if dev == "cuda":
                signs[name] = out > 0
                return None
            want = signs[name].to(out.device)
            moved[name] = int((want != (out > 0)).sum())
            side = torch.where(want, out.clamp(min=torch.finfo(out.dtype)
                                               .tiny), out.clamp(max=0.0))
            return out + (side - out).detach()
        return hook

    losses, grads = {}, {}
    for dev in ("cuda", "cpu_free", "cpu"):
        m, _ = build_model_from_file(config, model_file, dev.split("_")[0],
                                     build=build)
        hooks = ([mod.register_forward_hook(pin(name, dev))
                  for name, mod in relu_inputs(m).items()]
                 if dev != "cpu_free" else [])
        loss, _, _ = m(**to_device(batch, dev.split("_")[0]))
        loss.backward()
        for h in hooks:
            h.remove()
        losses[dev] = loss.item()
        grads[dev] = convert.state_dict_to_flax(m, grad=True)
    top = max(float(abs(g).max()) for g in grads["cpu"].values())

    def ratios(ref):
        return {n: float(abs(grads["cuda"][n] - g).max())
                / max(float(abs(g).max()), 1e-4 * top)
                for n, g in grads[ref].items()}

    pinned, free = ratios("cpu"), ratios("cpu_free")
    worst = max(pinned, key=pinned.get)
    worst_free = max(free, key=free.get)
    out = {"batch": len(batch["speech"]), "loss_card": losses["cuda"],
           "loss_cpu": losses["cpu"], "max_grad_ratio": pinned[worst],
           "worst_param": worst, "n_params": len(pinned), "tol": GRAD_TOL,
           "relu_units_moved": {k: v for k, v in moved.items() if v},
           "max_grad_ratio_unmoved": free[worst_free],
           "worst_param_unmoved": worst_free}
    if not pinned[worst] <= GRAD_TOL:
        raise AssertionError(f"card and CPU gradients disagree: {worst} "
                             f"{pinned[worst]}")
    if not abs(losses["cuda"] / losses["cpu"] - 1) <= GRAD_TOL:
        raise AssertionError(f"card and CPU losses disagree: {losses}")
    return out


def ctc_backward_nodes(loss) -> list:
    """Names of the autograd nodes under ``loss`` that belong to torch's
    own CTC loss."""
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo.extend(f for f, _ in fn.next_functions)
    return sorted({type(fn).__name__ for fn in seen
                   if "ctcloss" in type(fn).__name__.lower()})


def determinism(task, make_config, name: str) -> dict:
    """Two whole runs of DETERMINISM_STEPS steps (one per epoch) from one
    seed, and one stopped an epoch early and resumed: the three must end
    with bit-identical parameters. ``make_config(name, **extra)`` writes a
    config of the model and returns (cfg, path)."""
    import numpy as np
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    finals = {}
    for run_name, stops in (("a", [DETERMINISM_STEPS]),
                            ("b", [DETERMINISM_STEPS]),
                            ("resumed", [DETERMINISM_STEPS - 1,
                                         DETERMINISM_STEPS])):
        for i, max_epoch in enumerate(stops):
            cfg, path = make_config(
                f"det_{name}_{run_name}", num_iters_per_epoch=1,
                max_epoch=max_epoch, valid_data_path_and_name_and_type=[],
                resume=i > 0)
            task.main(argv=["--config", str(path)])
        finals[run_name] = load_checkpoint(Path(cfg["output_dir"])
                                           / "checkpoint")
    ref, _, ref_meta = finals["a"]
    out = {"steps": DETERMINISM_STEPS, "n_params": len(ref)}
    for run_name in ("b", "resumed"):
        flat, _, meta = finals[run_name]
        differ = sorted(k for k in ref if not np.array_equal(flat[k],
                                                             ref[k]))
        out[f"{run_name}_differs"] = differ[:5]
        out[f"{run_name}_n_differ"] = len(differ)
        if differ or meta["epoch"] != ref_meta["epoch"]:
            raise AssertionError(f"{name}: run {run_name} differs from run "
                                 f"a in {len(differ)} parameters, e.g. "
                                 f"{differ[:3]}")
    return out


def banded_checks(torch, lmodel, dspeech, dlens, tbatch) -> dict:
    """K4 and K4b against their plain versions: on the first Longformer
    block's q, k, v and valid frames of the long-form decode batch
    (forward) and of the first long-form train batch (backward, the
    output gradient zero on padded rows), and on small ragged cases; each
    timed beside its plain version and SDPA with the band as a float mask.
    -> {"checks": [...], "kernels": [...], "k4_err", "k4b_err"}."""
    import torch.nn.functional as F

    from espnet_tpu_torch.ops.banded_attention import (
        banded_allowed, banded_attention, banded_attention_bwd,
        banded_attention_bwd_plain, banded_attention_plain,
        banded_stats_plain)
    captured = {}
    lattn = lmodel.encoder_mod.layers[0].self_attn
    hook = lattn.register_forward_pre_hook(
        lambda module, args: captured.__setitem__("args", args))
    with torch.no_grad():
        lmodel.encode(dspeech, dlens)
        dargs = captured["args"]
        lq, lk, lv = lattn.qkv(*dargs[:3])
        band, lvalid = dargs[4], dargs[5]
        lmodel.encode(tbatch["speech"], tbatch["speech_lengths"])
        targs = captured["args"]
        bq, bk, bv = (t.contiguous() for t in lattn.qkv(*targs[:3]))
        bvalid = targs[5]
    hook.remove()
    lscale = lattn.dk ** -0.5
    Bl, Hl, Tl, dl = lq.shape
    Bb, Hb, Tb, db = bq.shape
    g4 = torch.Generator(device="cuda").manual_seed(4)
    bdout = torch.randn(bq.shape, generator=g4, device="cuda") \
        * bvalid[:, None, :, None]

    def errors(q_, k_, v_, w_, valid_, scale, dout_):
        """Forward max abs error, and the gradients through autograd."""
        with torch.no_grad():
            fwd = float((banded_attention(q_, k_, v_, w_, valid_,
                                          sm_scale=scale)
                         - banded_attention_plain(q_, k_, v_, w_, valid_,
                                                  sm_scale=scale))
                        .abs().max())
        ins = [t.detach().clone().requires_grad_() for t in (q_, k_, v_)]
        kern = torch.autograd.grad(
            banded_attention(*ins, w_, valid_, sm_scale=scale), ins, dout_)
        plain = torch.autograd.grad(
            banded_attention_plain(*ins, w_, valid_, sm_scale=scale), ins,
            dout_)
        return fwd, grad_errors(kern, plain)

    k4_errs, k4b_errs = {}, {}
    with torch.no_grad():
        k4_errs["decode"] = float(
            (banded_attention(lq, lk, lv, band, lvalid, sm_scale=lscale)
             - banded_attention_plain(lq, lk, lv, band, lvalid,
                                      sm_scale=lscale)).abs().max())
    k4_errs["train"], k4b_errs["train"] = errors(bq, bk, bv, band, bvalid,
                                                 lscale, bdout)
    # T = 70 (not a multiple of 64) with a padded tail of 50 > W = 3;
    # W = 100 >= T = 50; W = 0 with 30 padded frames
    for name, (B_, H_, T_, d_, w_, lens_) in {
            "t70_w3_tail50": (2, 3, 70, 40, 3, (70, 20)),
            "w_ge_t": (2, 2, 50, 16, 100, (50, 7)),
            "w0": (1, 2, 130, 128, 0, (100,))}.items():
        rq, rk, rv, rdout = (torch.randn(B_, H_, T_, d_, generator=g4,
                                         device="cuda") for _ in range(4))
        rvalid = (torch.arange(T_, device="cuda")[None]
                  < torch.tensor(lens_, device="cuda")[:, None])
        k4_errs[name], k4b_errs[name] = errors(rq, rk, rv, w_, rvalid,
                                               d_ ** -0.5, rdout)
    with torch.no_grad():
        bout = banded_attention_plain(bq, bk, bv, band, bvalid,
                                      sm_scale=lscale)
        bstats = banded_stats_plain(bq, bk, band, bvalid, sm_scale=lscale)
    dmask = torch.where(banded_allowed(Tl, band, lvalid, "cuda"), 0.0,
                        -1e9)
    bmask = torch.where(banded_allowed(Tb, band, bvalid, "cuda"), 0.0,
                        -1e9)
    # the function's data-dependent work: the allowed (i, j) pairs of
    # these inputs' lengths, in every head
    d_pairs = Hl * float((dmask == 0).sum())
    b_pairs = Hb * float((bmask == 0).sum())
    blib_ins = [t.detach().clone().requires_grad_() for t in (bq, bk, bv)]
    blib_out = F.scaled_dot_product_attention(*blib_ins, attn_mask=bmask,
                                              scale=lscale)
    try:
        k4b_library_ms, k4b_library_note = time_ms(
            torch, lambda: torch.autograd.grad(blib_out, blib_ins, bdout,
                                               retain_graph=True)), None
    except RuntimeError as e:   # a yardstick only: no backend may take it
        k4b_library_ms, k4b_library_note = None, str(e)[:300]
    return {
        "k4_err": max(k4_errs.values()),
        "k4b_err": max(e["rel_err"] for case in k4b_errs.values()
                       for e in case.values()),
        "checks": [
            {"name": "banded_attn_fwd", "shape": [Bl, Hl, Tl, dl],
             "window": band, "valid_frames": lvalid.sum(1).tolist(),
             "tol": K4_TOL, "tol_of": "max abs err, every row",
             "cases": k4_errs},
            {"name": "banded_attn_bwd", "shape": [Bb, Hb, Tb, db],
             "window": band, "valid_frames": bvalid.sum(1).tolist(),
             "tol": K4B_TOL,
             "tol_of": ("max abs err / max |plain| (the case's largest "
                        "gradient for a gradient zero in exact arithmetic)"),
             "cases": k4b_errs}],
        # the least work: 4 d operations per allowed (i, j) pair (q k^T
        # and P v) with q, k, v and out moved once; the backward's five
        # products (q k^T, do v^T, P^T do, dS^T q, dS k) with q, k, v, o,
        # do, the row statistics, dq, dk and dv moved once
        "kernels": [
            {"name": "banded_attn_fwd", "route": "cuda",
             "source": "espnet_tpu_torch/csrc/banded_attn.cu",
             "replaces": ("espnet_tpu/ops/attention_kernels.py:88 "
                          "(banded_attention -> _splash_banded_kernel :71, "
                          "splash _splash_attention_forward)"),
             "max_abs_err": k4_errs["decode"],
             "ms": time_ms(torch, lambda: banded_attention(
                 lq, lk, lv, band, lvalid, sm_scale=lscale)),
             "plain_ms": time_ms(torch, lambda: banded_attention_plain(
                 lq, lk, lv, band, lvalid, sm_scale=lscale)),
             "library_ms": time_ms(torch, lambda: (
                 F.scaled_dot_product_attention(lq, lk, lv, attn_mask=dmask,
                                                scale=lscale))),
             "library_note": ("scaled_dot_product_attention with the band "
                              "and the valid keys as a float mask"),
             "flops": 4.0 * dl * d_pairs,
             "bytes": 4.0 * 4 * Bl * Hl * Tl * dl + Bl * Tl},
            {"name": "banded_attn_bwd", "route": "cuda",
             "source": "espnet_tpu_torch/csrc/banded_attn_bwd.cu",
             "replaces": ("jax/experimental/pallas/ops/tpu/splash_attention/"
                          "splash_attention_kernel.py:2241 "
                          "(_splash_attention_bwd, reached from "
                          "espnet_tpu/ops/attention_kernels.py:116)"),
             "max_abs_err": max(e["max_abs_err"]
                                for e in k4b_errs["train"].values()),
             "ms": time_ms(torch, lambda: banded_attention_bwd(
                 bq, bk, bv, bvalid, bout, bstats, bdout, window=band,
                 sm_scale=lscale)),
             "plain_ms": time_ms(torch, lambda: banded_attention_bwd_plain(
                 bq, bk, bv, bvalid, bout, bstats, bdout, window=band,
                 sm_scale=lscale)),
             "library_ms": k4b_library_ms,
             "library_note": k4b_library_note or (
                 "autograd backward of scaled_dot_product_attention with "
                 "the band and the valid keys as a float mask"),
             "flops": 10.0 * db * b_pairs,
             "bytes": 4.0 * (8 * Bb * Hb * Tb * db + 2 * Bb * Hb * Tb)
             + Bb * Tb}]}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        run(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run(torch, workdir: Path):
    import torch.nn.functional as F

    from espnet_tpu_torch import convert
    from espnet_tpu_torch.bin import asr_train, asr_transducer_train
    from espnet_tpu_torch.bin.asr_inference import (Speech2Text,
                                                    decode_batches,
                                                    inference)
    from espnet_tpu_torch.bin.asr_transducer_inference import \
        Speech2TextTransducer
    from espnet_tpu_torch.data.dataset import ESPnetDataset
    from espnet_tpu_torch.data.synth_speech import (SynthSpeechCorpus,
                                                    concat_data_dir)
    from espnet_tpu_torch.decode.ctc_greedy import ctc_greedy_decode
    from espnet_tpu_torch.models.asr import ASRModel
    from espnet_tpu_torch.models.transducer import TransducerModel
    from espnet_tpu_torch.nn.initialize import init_like_flax
    from espnet_tpu_torch.ops import _cuda, rnnt
    from espnet_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_bwd,
                                                fused_attention_bwd_plain,
                                                fused_attention_plain,
                                                softmax_stats_plain)
    from espnet_tpu_torch.ops.logmel import (fused_logmel,
                                             fused_logmel_plain)
    from espnet_tpu_torch.ops.losses import ctc_loss
    from espnet_tpu_torch.ops.mel import mel_matrix
    from espnet_tpu_torch.tasks import asr_transducer
    from espnet_tpu_torch.tasks.abs_task import parse_triples
    from espnet_tpu_torch.tasks.asr import (ASRTask, build_model,
                                            build_model_from_file)
    from espnet_tpu_torch.tasks.asr_transducer import ASRTransducerTask
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    from espnet_tpu_torch.train.trainer import evaluate
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

    # the train path's data, config and first batch
    t0 = time.perf_counter()
    SynthSpeechCorpus().materialize(workdir / "data", n_train=N_TRAIN,
                                    n_valid=N_VALID, n_test=0)
    data_s = time.perf_counter() - t0
    cfg, cfg_path = train_config(ASRTask, ASSET, workdir, "flagship")
    train_if = ASRTask.build_iter_factory(cfg, train=True)
    valid_if = ASRTask.build_iter_factory(cfg, train=False)
    train_batch = first_batch(train_if, "cuda")

    # the transducer's model, config and first train batch (same data)
    s2tt = Speech2TextTransducer(train_config=TRANSDUCER / "config.yaml",
                                 model_file=TRANSDUCER,
                                 beam_size=TRANSDUCER_BEAM)
    tmodel = s2tt.model
    tcfg, tcfg_path = train_config(ASRTransducerTask, TRANSDUCER, workdir,
                                   "transducer")
    ttrain_if = ASRTransducerTask.build_iter_factory(tcfg, train=True)
    tvalid_if = ASRTransducerTask.build_iter_factory(tcfg, train=False)
    ttrain_batch = first_batch(ttrain_if, "cuda")

    # 3. the long-form data: recordings joined from the same data dirs;
    # the decode set is valid_long and two train_long recordings
    t0 = time.perf_counter()
    data = workdir / "data"
    long_recs = {split: concat_data_dir(data / split, data / f"{split}_long",
                                        LONG_MIN_SAMPLES)
                 for split in ("train", "valid")}
    dec_dir = data / "decode_long"
    dec_dir.mkdir()
    n_dec_train = LONG_DECODE_TRAIN
    dec_recs = long_recs["valid"] + long_recs["train"][:n_dec_train]
    for fname in ("wav.scp", "text"):
        lines = []
        for split, n in (("valid", None), ("train", n_dec_train)):
            lines += (data / f"{split}_long" / fname).read_text(
                encoding="utf-8").splitlines()[:n]
        (dec_dir / fname).write_text("\n".join(lines) + "\n",
                                     encoding="utf-8")
    long_s = time.perf_counter() - t0
    lcfg, lcfg_path = longform_config(workdir, "longform")
    tokenize = ASRTask.build_preprocess_fn(lcfg, train=True)
    emit({"phase": "longform_data", "seconds": long_s,
          "min_samples": LONG_MIN_SAMPLES} | {
        split: {"n": len(recs), "samples": [n for _, n, _ in recs],
                "frames": [encoder_frames(n, fe.hop_length)
                           for _, n, _ in recs],
                "tokens": [len(tokenize(u, {"text": t})["text"])
                           for u, _, t in recs]}
        for split, recs in (("train_long", long_recs["train"]),
                            ("valid_long", long_recs["valid"]),
                            ("decode_long", dec_recs))})
    if not all(encoder_frames(n, fe.hop_length) >= LONG_MIN_FRAMES
               for recs in long_recs.values() for _, n, _ in recs):
        raise AssertionError("a long-form recording below 2048 frames")
    n_long_steps = LONG_EPOCHS * -(-len(long_recs["train"]) // LONG_BATCH)
    if n_long_steps < LONG_MIN_STEPS or len(dec_recs) > LONG_BATCH:
        raise AssertionError(f"long-form data too small: {n_long_steps} "
                             f"steps, {len(dec_recs)} decode recordings")
    ltrain_if = ASRTask.build_iter_factory(lcfg, train=True)
    lvalid_if = ASRTask.build_iter_factory(lcfg, train=False)
    ltrain_batch = first_batch(ltrain_if, "cuda")
    # the model the entry point starts from: flax's initialisers from the
    # seed (they set every parameter, whatever torch drew before)
    lmodel = init_like_flax(build_model(lcfg), torch.Generator().manual_seed(
        lcfg["seed"])).to("cuda").eval()
    dec_ds = ESPnetDataset(parse_triples([f"{dec_dir}/wav.scp,speech,sound"]))

    # 4. kernels against their plain versions, at the paths' shapes: the
    # wave batch, the first conformer block's attention inputs of the
    # decode batch, and those of the first train batch for the backward
    captured = {}

    def capture(module, args):
        captured["args"] = args

    attn = model.encoder_mod.layers[0].self_attn
    hook = attn.register_forward_pre_hook(capture)
    with torch.no_grad():
        model.encode(speech, lengths)
        q, k, v, bias, sm_scale = attn.kernel_inputs(*captured["args"])
        model.encode(train_batch["speech"], train_batch["speech_lengths"])
        tq, tk, tv, tbias, _ = attn.kernel_inputs(*captured["args"])
        tq, tk, tv = tq.contiguous(), tk.contiguous(), tv.contiguous()
    hook.remove()
    B, H, T, d = q.shape
    with torch.no_grad():
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

    # K1b: the kernel through autograd against the plain version's
    # autograd, with every input (the bias too) needing a gradient
    def backward_errors(q_, k_, v_, b_, causal, scale, seed):
        ins = [t.detach().clone().requires_grad_() for t in (q_, k_, v_, b_)]
        g = torch.Generator(device="cuda").manual_seed(seed)
        dout = torch.randn(q_.shape, generator=g, device="cuda")
        kern = torch.autograd.grad(
            fused_attention(*ins, causal=causal, sm_scale=scale), ins, dout)
        plain = torch.autograd.grad(
            fused_attention_plain(*ins, causal=causal, sm_scale=scale), ins,
            dout)
        return {name: {"max_abs_err": float((a - b).abs().max()),
                       "rel_err": rel_err(a, b)}
                for name, a, b in zip(("dq", "dk", "dv", "dbias"), kern,
                                      plain)}

    g = torch.Generator(device="cuda").manual_seed(0)
    cq, ck, cv = (torch.randn(2, 3, T_, 40, generator=g, device="cuda")
                  for T_ in (70, 50, 50))
    cbias = torch.randn(2, 3, 70, 50, generator=g, device="cuda")
    k1b_errs = {"train": backward_errors(tq, tk, tv, tbias, False, sm_scale,
                                         1),
                "causal_tq_ne_tk": backward_errors(cq, ck, cv, cbias, True,
                                                   40 ** -0.5, 2)}
    k1b_err = max(e["rel_err"] for case in k1b_errs.values()
                  for e in case.values())
    Bt, Ht, Tt, dt = tq.shape
    with torch.no_grad():
        tout = fused_attention_plain(tq, tk, tv, tbias, sm_scale=sm_scale)
        tstats = softmax_stats_plain(tq, tk, tbias, sm_scale=sm_scale)
        tdout = torch.randn(tq.shape, generator=g, device="cuda")

    def k1b():
        return fused_attention_bwd(tq, tk, tv, tbias, tout, tstats, tdout,
                                   sm_scale=sm_scale)

    def k1b_plain():
        return fused_attention_bwd_plain(tq, tk, tv, tbias, tout, tstats,
                                         tdout, sm_scale=sm_scale)

    lib_ins = [t.detach().clone().requires_grad_()
               for t in (tq, tk, tv, tbias)]
    lib_out = F.scaled_dot_product_attention(*lib_ins[:3],
                                             attn_mask=lib_ins[3],
                                             scale=sm_scale)

    def k1b_library():
        return torch.autograd.grad(lib_out, lib_ins, tdout,
                                   retain_graph=True)

    try:
        k1b_library_ms, k1b_library_note = time_ms(torch, k1b_library), None
    except RuntimeError as e:   # a yardstick only: no backend may take it
        k1b_library_ms, k1b_library_note = None, str(e)[:300]

    # K3: the lattice sweeps on the transducer's joint logits of its first
    # train batch (real ragged T_b and U_b), and on a small ragged case
    # with U_b = 0 and T_b < T; nll, alpha, beta and the closed-form
    # dlogits against the plain sweeps plus the same assembly
    def k3_case(logits, labels, tl, ul):
        lat = rnnt.lattices(logits, labels, tl, ul)
        alpha, nll = rnnt.rnnt_alpha(*lat, tl, ul)
        beta = rnnt.rnnt_beta(*lat, tl, ul)
        alpha0, nll0 = rnnt.rnnt_alpha_plain(*lat, tl, ul)
        beta0 = rnnt.rnnt_beta_plain(*lat, tl, ul)
        grad = rnnt.rnnt_grad(logits, labels, *lat, alpha, beta, nll, tl,
                              ul)
        grad0 = rnnt.rnnt_grad(logits, labels, *lat, alpha0, beta0, nll0,
                               tl, ul)
        inside = alpha0 > rnnt.NEG_INF / 2
        if not (torch.equal(inside, alpha > rnnt.NEG_INF / 2)
                and torch.equal(inside, beta > rnnt.NEG_INF / 2)
                and torch.equal(inside, beta0 > rnnt.NEG_INF / 2)):
            raise AssertionError("rnnt sweeps: the lattices' extents differ")
        errs = {"nll": (nll, nll0), "alpha": (alpha[inside], alpha0[inside]),
                "beta": (beta[inside], beta0[inside]),
                "dlogits": (grad, grad0)}
        return lat, {key: {"max_abs_err": float((a - b).abs().max()),
                           "rel_err": rel_err(a, b)}
                     for key, (a, b) in errs.items()}

    with torch.no_grad():
        enc, enc_lens = tmodel.encode(ttrain_batch["speech"],
                                      ttrain_batch["speech_lengths"])
        text, text_lens = ttrain_batch["text"], ttrain_batch["text_lengths"]
        tlogits = tmodel.lattice_logits(enc, text)
        k3_lat, k3_errs = {}, {}
        k3_lat["train"], k3_errs["train"] = k3_case(tlogits, text, enc_lens,
                                                    text_lens)
        g3 = torch.Generator(device="cuda").manual_seed(3)
        k3_lat["ragged"], k3_errs["ragged"] = k3_case(
            torch.randn(3, 7, 5, 6, generator=g3, device="cuda"),
            torch.randint(1, 6, (3, 4), generator=g3, device="cuda"),
            torch.tensor([7, 1, 4], device="cuda"),
            torch.tensor([0, 4, 2], device="cuda"))
    k3_err = max(e["rel_err"] for case in k3_errs.values()
                 for e in case.values())
    Bk, Tk3, U1k, Vk = tlogits.shape

    k3_args = (*k3_lat["train"], enc_lens, text_lens)
    # the cells inside each sample's lattice: the sweeps' data-dependent
    # work, ~9 operations each (two adds and a log-add)
    k3_cells = float(((enc_lens.clamp(max=Tk3))
                      * (text_lens.clamp(max=U1k - 1) + 1)).sum())
    # K4 and K4b, their tensors freed on return (the train phases' peak
    # memory would count them)
    _, dspeech, dlens, _ = next(decode_batches(dec_ds, dec_ds.keys(),
                                               LONG_BATCH))
    banded = banded_checks(torch, lmodel, torch.from_numpy(dspeech).cuda(),
                           torch.from_numpy(dlens).long().cuda(),
                           ltrain_batch)

    Bw, S = speech.shape
    frames = Bw * out2.shape[1]
    nf, n_fft = fe.n_fft // 2 + 1, fe.n_fft
    mel_nnz = int((melw != 0).sum())
    checks = [
        {"name": "flash_attn_fwd", "shape": [B, H, T, d], "tol": K1_TOL},
        {"name": "flash_attn_bwd", "shape": [Bt, Ht, Tt, dt],
         "tol": K1B_TOL, "tol_of": "max abs err / max |plain|",
         "cases": k1b_errs},
        {"name": "logmel_fwd", "shape": [Bw, S], "tol": K2_TOL,
         "min_mel": K2_MIN_MEL,
         "max_abs_err_all_frames": float((out2 - ref2).abs().max())},
        {"name": "rnnt_alpha+rnnt_beta", "shape": [Bk, Tk3, U1k, Vk],
         "tol": K3_TOL, "tol_of": "max abs err / max |plain|",
         "T_b": enc_lens.tolist(), "U_b": text_lens.tolist(),
         "cases": k3_errs},
        *banded["checks"],
    ]
    # the least work of each function, for its bound: K1's two products
    # of the attention; K1b's five (q k^T, do v^T, P^T do, dS^T q, dS k)
    # with q, k, v, o, do and the bias read and dq, dk, dv and dbias
    # written; for K2 not the dense DFT the kernel does but an FFT
    # (2.5 N log2 N per frame), the window, the power and only the
    # nonzero mel weights; for K3 the blank and emit entries inside each
    # sample's lattice read, the whole (B, T, U+1) lattice written
    kernels = [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "espnet_tpu_torch/csrc/flash_attn.cu",
         "replaces": "espnet_tpu/ops/attention_kernels.py:31",
         "max_abs_err": k1_err,
         "ms": time_ms(torch, k1), "plain_ms": time_ms(torch, k1_plain),
         "library_ms": time_ms(torch, k1_library),
         "flops": 4.0 * B * H * T * T * d,
         "bytes": 4.0 * (4 * B * H * T * d + B * H * T * T)},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "espnet_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": ("jax/experimental/pallas/ops/tpu/flash_attention.py"
                      ":254 (_flash_attention_bwd, reached from "
                      "espnet_tpu/ops/attention_kernels.py:55)"),
         "max_abs_err": max(e["max_abs_err"] for e in
                            k1b_errs["train"].values()),
         "ms": time_ms(torch, k1b), "plain_ms": time_ms(torch, k1b_plain),
         "library_ms": k1b_library_ms,
         "library_note": k1b_library_note or (
             "autograd backward of scaled_dot_product_attention with the "
             "float bias needing a gradient"),
         "flops": 10.0 * Bt * Ht * Tt * Tt * dt,
         "bytes": 4.0 * (8 * Bt * Ht * Tt * dt + 2 * Bt * Ht * Tt * Tt)},
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
        {"name": "rnnt_alpha", "route": "cuda",
         "source": "espnet_tpu_torch/csrc/rnnt.cu",
         "replaces": ("espnet_tpu/ops/pallas/rnnt_kernel.py:53 (_alpha_kernel"
                      ", launched by _sweep's pallas_call :118)"),
         "max_abs_err": max(k3_errs["train"][key]["max_abs_err"]
                            for key in ("alpha", "nll")),
         "ms": time_ms(torch, lambda: rnnt.rnnt_alpha(*k3_args)),
         "plain_ms": time_ms(torch, lambda: rnnt.rnnt_alpha_plain(*k3_args)),
         "library_ms": None,
         "library_note": ("no PyTorch call computes the RNN-T loss "
                          "(torchaudio's rnnt_loss is not installed here)"),
         "flops": 9.0 * k3_cells,
         "bytes": 4.0 * (2 * k3_cells + Bk * Tk3 * U1k + Bk)},
        {"name": "rnnt_beta", "route": "cuda",
         "source": "espnet_tpu_torch/csrc/rnnt.cu",
         "replaces": ("espnet_tpu/ops/pallas/rnnt_kernel.py:75 (_beta_kernel"
                      ", launched by _sweep's pallas_call :118)"),
         "max_abs_err": k3_errs["train"]["beta"]["max_abs_err"],
         "ms": time_ms(torch, lambda: rnnt.rnnt_beta(*k3_args)),
         "plain_ms": time_ms(torch, lambda: rnnt.rnnt_beta_plain(*k3_args)),
         "library_ms": None,
         "library_note": ("no PyTorch call computes the RNN-T loss "
                          "(torchaudio's rnnt_loss is not installed here)"),
         "flops": 9.0 * k3_cells,
         "bytes": 4.0 * (2 * k3_cells + Bk * Tk3 * U1k)},
        *banded["kernels"],
    ]
    for kern in kernels:
        bound(kern)
    emit({"phase": "kernel_checks", "checks": checks})
    if not k1_err <= K1_TOL:
        raise AssertionError(f"flash_attn_fwd disagrees: {k1_err}")
    if not k1b_err <= K1B_TOL:
        raise AssertionError(f"flash_attn_bwd disagrees: {k1b_errs}")
    if not k2_err <= K2_TOL:
        raise AssertionError(f"logmel_fwd disagrees: {k2_err}")
    if not k3_err <= K3_TOL:
        raise AssertionError(f"rnnt sweeps disagree: {k3_errs}")
    if not banded["k4_err"] <= K4_TOL:
        raise AssertionError(f"banded_attn_fwd disagrees: "
                             f"{banded['checks'][0]}")
    if not banded["k4b_err"] <= K4B_TOL:
        raise AssertionError(f"banded_attn_bwd disagrees: "
                             f"{banded['checks'][1]}")

    # 5. main path: one warm-up decode, then the counted and timed one,
    # then REPEATS more timed ones for the spread
    s2t(speech, lengths)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = s2t(speech, lengths)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    decode_launches = dict(_cuda.LAUNCHES)
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
          "launches": decode_launches,
          "examples": [[r, h] for r, h in zip(refs[:3], hyps[:3])]})
    if len(out) != N_UTTS or not all(nbest and nbest[0][2]
                                     for nbest in out):
        raise AssertionError("an utterance decoded to nothing")
    for name in ("flash_attn_fwd", "logmel_fwd"):
        if decode_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if not wer <= MAX_WER:
        raise AssertionError(f"WER {wer} above {MAX_WER}")

    # 6. train path: the flagship's validation before, then the entry
    # point, then a reload of its checkpoint into a fresh model
    before = evaluate(model, valid_if, "cuda")
    trainer, per_step, train_launches, train_wall, peak_bytes = train_run(
        torch, _cuda, asr_train.main, cfg_path, ASRModel)
    steps = trainer.step_stats
    after = trainer.reporter.stats[1]["valid"]
    flat, _, meta = load_checkpoint(Path(cfg["output_dir"]) / "checkpoint")
    fresh = convert.load_flax_params(build_model(cfg), flat).to("cuda")
    reloaded = evaluate(fresh, valid_if, "cuda")
    step_ms = [1e3 * s["train_time"] for s in steps]
    emit({"phase": "train_path", "n_train": N_TRAIN, "n_valid": N_VALID,
          "batch_size": TRAIN_BATCH, "data_seconds": data_s,
          "batch_shape": list(train_batch["speech"].shape),
          "steps": [{k: s[k] for k in ("loss", "loss_ctc", "loss_att",
                                       "acc", "grad_norm", "skipped")}
                    | {"ms": ms, "launches": n}
                    for s, ms, n in zip(steps, step_ms, per_step)],
          "step_ms_median_3_10": statistics.median(step_ms[2:]),
          "peak_memory_bytes": peak_bytes, "wall_seconds": train_wall,
          "launches": train_launches,
          "valid_before": before, "valid_after": after,
          "valid_reloaded": reloaded, "checkpoint_epoch": meta["epoch"]})
    want = {"flash_attn_fwd": 6, "flash_attn_bwd": 12, "logmel_fwd": 1,
            "rnnt_alpha": 0, "rnnt_beta": 0, "banded_attn_fwd": 0,
            "banded_attn_bwd": 0}
    check_steps(steps, per_step, want, ("loss", "loss_ctc", "loss_att"))
    if not after["acc"] >= before["acc"] - ACC_MARGIN:
        raise AssertionError(f"validation accuracy fell: {before['acc']} -> "
                             f"{after['acc']}")
    if not abs(reloaded["loss"] / after["loss"] - 1) <= RELOAD_TOL:
        raise AssertionError(f"the reloaded checkpoint's validation loss "
                             f"{reloaded['loss']} != {after['loss']}")

    # 7. one step's gradients, card against CPU, on a fixed batch
    _, batch = valid_if.collate_fn([valid_if.dataset[k] for k in
                                    valid_if.epoch_batches(0)[0][:GRAD_BATCH]])
    emit({"phase": "grad_check"} | grad_check(
        torch, ASSET / "config.yaml", ASSET, build_model, batch))

    # 8. the transducer's decode: as main_path
    s2tt(speech, lengths)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    tout = s2tt(speech, lengths)
    torch.cuda.synchronize()
    twalls = [time.perf_counter() - t0]
    tdecode_launches = dict(_cuda.LAUNCHES)
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        s2tt(speech, lengths)
        torch.cuda.synchronize()
        twalls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    with torch.no_grad():
        tmodel.encode(speech, lengths)
    torch.cuda.synchronize()
    tencode_s = time.perf_counter() - t0
    thyps = [nbest[0][0] for nbest in tout]
    twords = score_corpus(refs, thyps, "word")
    emit({"phase": "transducer_decode", "n_utts": N_UTTS,
          "beam": TRANSDUCER_BEAM, "batch_shape": list(speech.shape),
          "wer": twords["err_rate"],
          "cer": score_corpus(refs, thyps, "char")["err_rate"],
          "ref_words": twords["ref_len"],
          "word_errors": twords["sub"] + twords["del"] + twords["ins"],
          "wer_limit": MAX_TRANSDUCER_WER,
          "wall_seconds": twalls, "encode_seconds": tencode_s,
          "audio_s_per_s_median": audio_s / statistics.median(twalls),
          "launches": tdecode_launches,
          "examples": [[r, h] for r, h in zip(refs[:3], thyps[:3])]})
    if len(tout) != N_UTTS or not all(nbest and nbest[0][2]
                                      for nbest in tout):
        raise AssertionError("an utterance decoded to nothing")
    want_decode = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "logmel_fwd": 1,
                   "rnnt_alpha": 0, "rnnt_beta": 0, "banded_attn_fwd": 0,
                   "banded_attn_bwd": 0}
    if tdecode_launches != want_decode:
        raise AssertionError(f"transducer decode launches {tdecode_launches}"
                             f", not {want_decode}")
    if not twords["err_rate"] <= MAX_TRANSDUCER_WER:
        raise AssertionError(f"transducer WER {twords['err_rate']} above "
                             f"{MAX_TRANSDUCER_WER}")

    # 9. the transducer's training: as train_path
    tbefore = evaluate(tmodel, tvalid_if, "cuda")
    ttrainer, tper_step, ttrain_launches, ttrain_wall, tpeak = train_run(
        torch, _cuda, asr_transducer_train.main, tcfg_path, TransducerModel)
    tsteps = ttrainer.step_stats
    tafter = ttrainer.reporter.stats[1]["valid"]
    flat, _, tmeta = load_checkpoint(Path(tcfg["output_dir"])
                                     / "checkpoint")
    fresh = convert.load_flax_params(asr_transducer.build_model(tcfg),
                                     flat).to("cuda")
    treloaded = evaluate(fresh, tvalid_if, "cuda")
    tstep_ms = [1e3 * s["train_time"] for s in tsteps]
    emit({"phase": "transducer_train", "batch_size": TRAIN_BATCH,
          "batch_shape": list(ttrain_batch["speech"].shape),
          "steps": [{k: s[k] for k in ("loss", "loss_rnnt", "loss_aux_ctc",
                                       "grad_norm", "skipped")}
                    | {"ms": ms, "launches": n}
                    for s, ms, n in zip(tsteps, tstep_ms, tper_step)],
          "step_ms_median_3_10": statistics.median(tstep_ms[2:]),
          "peak_memory_bytes": tpeak, "wall_seconds": ttrain_wall,
          "launches": ttrain_launches,
          "valid_before": tbefore, "valid_after": tafter,
          "valid_reloaded": treloaded, "checkpoint_epoch": tmeta["epoch"]})
    twant = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "logmel_fwd": 1,
             "rnnt_alpha": 1, "rnnt_beta": 1, "banded_attn_fwd": 0,
             "banded_attn_bwd": 0}
    check_steps(tsteps, tper_step, twant,
                ("loss", "loss_rnnt", "loss_aux_ctc"))
    if not abs(treloaded["loss"] / tafter["loss"] - 1) <= RELOAD_TOL:
        raise AssertionError(f"the reloaded transducer checkpoint's "
                             f"validation loss {treloaded['loss']} != "
                             f"{tafter['loss']}")

    # 10. the transducer's gradients, card against CPU
    _, batch = tvalid_if.collate_fn(
        [tvalid_if.dataset[k]
         for k in tvalid_if.epoch_batches(0)[0][:GRAD_BATCH]])
    emit({"phase": "transducer_grad_check"}
         | grad_check(torch, TRANSDUCER / "config.yaml", TRANSDUCER,
                      asr_transducer.build_model, batch))

    # 11. the long-form model's training: as train_path, from the seed's
    # flax-default initialisation, over 3 epochs of the long recordings
    lbefore = evaluate(lmodel, lvalid_if, "cuda")
    ltrainer, lper_step, ltrain_launches, ltrain_wall, lpeak = train_run(
        torch, _cuda, asr_train.main, lcfg_path, ASRModel)
    lsteps = ltrainer.step_stats
    lafter = ltrainer.reporter.stats[LONG_EPOCHS]["valid"]
    lout = Path(lcfg["output_dir"])
    flat, _, lmeta = load_checkpoint(lout / "checkpoint")
    fresh = convert.load_flax_params(build_model(lcfg), flat).to("cuda")
    lreloaded = evaluate(fresh, lvalid_if, "cuda")
    del fresh
    lstep_ms = [1e3 * s["train_time"] for s in lsteps]
    # the closed-form CTC's share of a step, by the host clock: its
    # forward and backward alone (loops over the batch's T' frames) on the
    # first train batch's CTC logits, median of 3 after a warm-up
    with torch.no_grad():
        lenc, lenc_lens = lmodel.encode(ltrain_batch["speech"],
                                        ltrain_batch["speech_lengths"])
        ctc_logits = lmodel.ctc_logits(lenc)
    ctc_ms = []
    for _ in range(4):
        x = ctc_logits.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctc_loss(x, lenc_lens, ltrain_batch["text"],
                 ltrain_batch["text_lengths"], lmodel.blank_id).backward()
        torch.cuda.synchronize()
        ctc_ms.append(1e3 * (time.perf_counter() - t0))
    ctc_ms = statistics.median(ctc_ms[1:])
    emit({"phase": "longform_train", "batch_size": LONG_BATCH,
          "epochs": LONG_EPOCHS,
          "batch_shape": list(ltrain_batch["speech"].shape),
          "encoder_frames_padded": banded["checks"][1]["shape"][2],
          "steps": [{k: s[k] for k in ("loss", "loss_ctc", "loss_att",
                                       "acc", "grad_norm", "skipped")}
                    | {"ms": ms, "launches": n}
                    for s, ms, n in zip(lsteps, lstep_ms, lper_step)],
          "step_ms_median_3_on": statistics.median(lstep_ms[2:]),
          "ctc_fwd_bwd_ms": ctc_ms,
          "ctc_share_of_step": ctc_ms / statistics.median(lstep_ms[2:]),
          "peak_memory_bytes": lpeak, "wall_seconds": ltrain_wall,
          "launches": ltrain_launches,
          "valid_before": lbefore, "valid_after": lafter,
          "valid_reloaded": lreloaded, "checkpoint_epoch": lmeta["epoch"]})
    lwant = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "logmel_fwd": 1,
             "rnnt_alpha": 0, "rnnt_beta": 0, "banded_attn_fwd": 6,
             "banded_attn_bwd": 12}
    check_steps(lsteps, lper_step, lwant, ("loss", "loss_ctc", "loss_att"),
                n_steps=n_long_steps)
    if not abs(lreloaded["loss"] / lafter["loss"] - 1) <= RELOAD_TOL:
        raise AssertionError(f"the reloaded long-form checkpoint's "
                             f"validation loss {lreloaded['loss']} != "
                             f"{lafter['loss']}")

    # 12. the long-form model's gradients, card against CPU, on the first
    # 2 recordings of train_long
    _, batch = ltrain_if.collate_fn(
        [ltrain_if.dataset[k] for k in ltrain_if.dataset.keys()[:2]])
    emit({"phase": "longform_grad_check"}
         | grad_check(torch, lout / "config.yaml", lout / "checkpoint",
                      build_model, batch))

    # 13. the batch-decode CLI with the trained checkpoint over the
    # decode set, greedy CTC: one warm-up run, then the counted one; and
    # the card's CTC log-probabilities and greedy tokens against the CPU's
    infer_kw = dict(
        data_path_and_name_and_type=[f"{dec_dir}/wav.scp,speech,sound"],
        asr_train_config=str(lout / "config.yaml"),
        asr_model_file=str(lout / "checkpoint"), batch_size=LONG_BATCH,
        ctc_weight=1.0)
    inference(output_dir=str(workdir / "decode_warmup"), **infer_kw)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    inference(output_dir=str(workdir / "decode_long"), **infer_kw)
    torch.cuda.synchronize()
    ldecode_launches = dict(_cuda.LAUNCHES)
    dstats = [json.loads(line) for line in (
        workdir / "decode_long" / "decode_stats.jsonl").read_text()
        .splitlines()]
    recog = workdir / "decode_long" / "1best_recog"
    written = dict(line.split(" ", 1) for line in (recog / "token_int")
                   .read_text().splitlines())
    duids, dspeech_np, dlens_np, dn = next(decode_batches(
        dec_ds, dec_ds.keys(), LONG_BATCH))
    logprobs, greedy = {}, {}
    for dev in ("cuda", "cpu"):
        m, _ = build_model_from_file(lout / "config.yaml",
                                     lout / "checkpoint", dev)
        with torch.no_grad():
            enc, enc_lens = m.encode(torch.from_numpy(dspeech_np).to(dev),
                                     torch.from_numpy(dlens_np).long()
                                     .to(dev))
            lp = torch.log_softmax(m.ctc_logits(enc), dim=-1)
            toks, n_tok = ctc_greedy_decode(lp, enc_lens, m.blank_id)
        frames_ok = (torch.arange(lp.shape[1], device=dev)[None]
                     < enc_lens[:, None])
        logprobs[dev] = (lp.cpu(), frames_ok.cpu(), enc_lens.cpu())
        greedy[dev] = [toks[b, :n_tok[b]].tolist() for b in range(dn)]
        del m
    lp_err = float((logprobs["cuda"][0] - logprobs["cpu"][0]).abs()
                   [logprobs["cpu"][1]].max())
    drefs = dict(line.split(" ", 1) for line in (dec_dir / "text")
                 .read_text(encoding="utf-8").splitlines())
    dhyps = dict(line.split(" ", 1) if " " in line else (line, "")
                 for line in (recog / "text").read_text(encoding="utf-8")
                 .splitlines())
    emit({"phase": "longform_decode", "n_recordings": len(dhyps),
          "batch_size": LONG_BATCH, "ctc_weight": 1.0,
          "batch_shape": list(dspeech_np.shape),
          "encoder_frames": logprobs["cpu"][2].tolist(),
          "launches": ldecode_launches, "decode_stats": dstats,
          "audio_s_per_s": sum(x["audio_secs"] for x in dstats)
          / sum(x["decode_secs"] for x in dstats),
          "logprob_max_abs_err": lp_err, "tol": LOGPROB_TOL,
          "greedy_equal_card_cpu": sum(a == b for a, b in zip(
              greedy["cuda"], greedy["cpu"])),
          "cer": score_corpus([drefs[u] for u in duids[:dn]],
                              [dhyps[u] for u in duids[:dn]],
                              "char")["err_rate"],
          "text": (recog / "text").read_text(encoding="utf-8")})
    ldwant = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "logmel_fwd": 1,
              "rnnt_alpha": 0, "rnnt_beta": 0, "banded_attn_fwd": 6,
              "banded_attn_bwd": 0}
    if ldecode_launches != ldwant or len(dstats) != 1:
        raise AssertionError(f"long-form decode launches {ldecode_launches}"
                             f" in {len(dstats)} batches, not {ldwant}")
    if not lp_err <= LOGPROB_TOL:
        raise AssertionError(f"card and CPU CTC log-probabilities "
                             f"disagree: {lp_err}")
    if [written[u].split() if written[u].strip() else []
            for u in duids[:dn]] != [list(map(str, t))
                                     for t in greedy["cuda"]]:
        raise AssertionError("inference() wrote other tokens than the "
                             "card's greedy CTC")

    # 14. determinism: runs of each entry point from one seed repeat
    # themselves bit for bit, resumed or not; and the CTC gradient is the
    # port's own closed form, not torch's CTC loss
    ctc_nodes = {}
    for name, m, b in (("flagship", model, train_batch),
                       ("transducer", tmodel, ttrain_batch),
                       ("longform", lmodel, ltrain_batch)):
        m.train()
        loss, _, _ = m(**b)
        ctc_nodes[name] = ctc_backward_nodes(loss)
        m.eval()
        del loss
    emit({"phase": "determinism", "ctc_loss_nodes": ctc_nodes,
          "flagship": determinism(ASRTask, lambda n, **kw: train_config(
              ASRTask, ASSET, workdir, n, **kw), "flagship"),
          "transducer": determinism(
              ASRTransducerTask, lambda n, **kw: train_config(
                  ASRTransducerTask, TRANSDUCER, workdir, n, **kw),
              "transducer"),
          "longform": determinism(ASRTask, lambda n, **kw: longform_config(
              workdir, n, **kw), "longform")})
    if any(ctc_nodes.values()):
        raise AssertionError(f"a CTC gradient from torch's CTC loss: "
                             f"{ctc_nodes}")

    print(smi, flush=True)
    # launches of each kernel per decode and per train step on the paths
    # that run it; "launches" is the count on its main path's run: the
    # flagship's decode (K1, K2), the flagship's train path (K1b), the
    # transducer's train path (K3), the long-form decode (K4) and the
    # long-form train path (K4b)
    paths = {"decode": {"flagship": decode_launches,
                        "transducer": tdecode_launches,
                        "longform": ldecode_launches},
             "train_step": {"flagship": want, "transducer": twant,
                            "longform": lwant}}
    main_runs = {"flash_attn_fwd": decode_launches,
                 "flash_attn_bwd": train_launches,
                 "logmel_fwd": decode_launches,
                 "rnnt_alpha": ttrain_launches, "rnnt_beta": ttrain_launches,
                 "banded_attn_fwd": ldecode_launches,
                 "banded_attn_bwd": ltrain_launches}
    for name, n in main_runs.items():
        if n[name] <= 0:
            raise AssertionError(f"{name} was not launched on its path")
    emit({"kernels": [
        {key: kern[key] for key in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
        | {"launches": main_runs[kern["name"]][kern["name"]]}
        | {f"launches_per_{kind_}": {
            model_: counts[kern["name"]]
            for model_, counts in per_model.items() if counts[kern["name"]]}
           for kind_, per_model in paths.items()}
        | ({"library_note": kern["library_note"]}
           if "library_note" in kern else {})
        for kern in kernels],
        "nvidia_smi": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
