"""Enhancement training on the CPU: the JAX package's
``steps_per_dispatch`` only groups steps (K = 8 ends where K = 1 does),
so the port runs such a config one step at a time; and the port's
``enh_train`` entry point on a tiny TCN config ends where the JAX
package's trainer does from the same weights and batches.

Data: 16 SynthMixCorpus mixtures of 0.25 s (8 batches of 2 of one
shape); weights: the JAX tree filled from a numpy seed, given to every
run as ``init_param``.
"""

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from espnet_tpu.tasks.enh import EnhancementTask as JaxEnhancementTask
from espnet_tpu.train.checkpoint import load_checkpoint as jax_load
from espnet_tpu_torch.bin import enh_train
from espnet_tpu_torch.data.synth_speech import SynthMixCorpus
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.utils.config import dump_yaml
from tests.torch_streaming_models import flax_params, xla_unoptimized

# the asset's optimizer (assets/synth_enh_tcn/config.yaml), and plain SGD
OPTIMIZERS = {
    "asset": {"optim": "adam", "optim_conf": {"lr": 1e-3},
              "scheduler": "warmuplr",
              "scheduler_conf": {"warmup_steps": 300}, "grad_clip": 5.0},
    "sgd": {"optim": "sgd", "optim_conf": {"lr": 1e-3}, "scheduler": None,
            "grad_clip": 5.0},
}


@pytest.fixture(autouse=True, scope="module")
def jax_references_unoptimized():
    """The JAX references compile without XLA's optimisations: they run
    once, at small shapes, where compiling is most of their time."""
    with xla_unoptimized():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("enh_train")
    SynthMixCorpus(seconds=0.25).materialize(root / "data", n_train=16,
                                             n_valid=2, n_test=0)
    base = {"num_spk": 2, "encoder": "stft",
            "encoder_conf": {"n_fft": 128, "hop_length": 64},
            "separator": "tcn",
            "separator_conf": {"layers": 2, "stacks": 1,
                               "bottleneck_dim": 8, "hidden_dim": 16},
            "loss_type": "si_snr", "batch_type": "sorted", "batch_size": 2,
            "max_epoch": 1, "log_interval": 1, "use_tensorboard": False,
            "valid_data_path_and_name_and_type": [],
            "init_param": str(root / "init.npz")}
    d = root / "data" / "train"
    base["train_data_path_and_name_and_type"] = [
        f"{d}/wav.scp,speech_mix,sound", f"{d}/spk1.scp,speech_ref1,sound",
        f"{d}/spk2.scp,speech_ref2,sound"]
    base["train_shape_file"] = [f"{d}/speech_mix_shape"]
    flat, _ = flax_params(JaxEnhancementTask.build_model(base),
                          **JaxEnhancementTask.example_batch(base), seed=1)
    np.savez(root / "init.npz", **flat)
    return root, base


def _jax_run(root, base, opt: str, k: int):
    cfg = dict(base, **OPTIMIZERS[opt], steps_per_dispatch=k,
               output_dir=str(root / f"jax_{opt}_{k}"))
    JaxEnhancementTask.main(cfg)
    params = jax_load(root / f"jax_{opt}_{k}" / "checkpoint")[0]
    return {"/".join(key): np.asarray(v)
            for key, v in flatten_dict(dict(params)).items()}


@pytest.fixture(scope="module")
def jax_runs(setup):
    root, base = setup
    return {(opt, k): _jax_run(root, base, opt, k)
            for opt in OPTIMIZERS for k in (1, 8)}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_jax_steps_per_dispatch_only_groups_steps(jax_runs, opt,
                                                  record_property):
    # 8 steps as one scanned dispatch against 8 dispatches: the same
    # parameters within 1e-6 (the scan compiles the step into another
    # program, which rounds its sums in another order)
    one, eight = jax_runs[(opt, 1)], jax_runs[(opt, 8)]
    assert set(one) == set(eight)
    worst = max(float(np.abs(one[k] - eight[k]).max()) for k in one)
    record_property(f"max_abs_diff:{opt}", worst)
    assert worst <= 1e-6


def test_enh_train_entry_point_ends_where_jax_does(setup, jax_runs,
                                                   record_property):
    # the asset's optimizer and steps_per_dispatch 8 (run one step at a
    # time): 8 steps on the CPU from the JAX run's weights and batches;
    # every parameter within 1e-5 of the JAX run's (Adam's first steps
    # magnify the fp32 rounding of small gradients)
    root, base = setup
    cfg = dict(base, **OPTIMIZERS["asset"], steps_per_dispatch=8,
               device="cpu", output_dir=str(root / "port"))
    dump_yaml(cfg, root / "port.yaml")
    out_cfg, trainer = enh_train.main(["--config", str(root / "port.yaml")])
    assert out_cfg["steps_per_dispatch"] == 8
    steps = trainer.step_stats
    assert len(steps) == 8
    assert all(np.isfinite(s["loss"]) and not s["skipped"] for s in steps)
    ours = load_checkpoint(root / "port" / "checkpoint")[0]
    ref = jax_runs[("asset", 1)]
    assert set(ours) == set(ref)
    worst = max(float(np.abs(ours[k] - ref[k]).max()) for k in ref)
    record_property("max_abs_diff:port_vs_jax", worst)
    assert worst <= 1e-5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            enh_train.main(["--config", str(root / "port.yaml"),
                            "--device", "null"])
