"""The port's target-speaker extraction against the JAX package, on the
CPU: a small TSEModel (tests/test_wpe_tse.py's, with two BLSTM layers)
from the same numpy-seeded weights: the estimate, the -SI-SNR loss and
every gradient on ragged mixtures and enrollments; EnhTSETask's model;
ExtractSpeech on the CPU against the JAX model's extract; two 2-step
enh_tse_train runs on the CPU, equal to the bit; and the entry points,
which need a card unless the CPU is asked for.

Estimates within 1e-5 of their largest sample, the loss within 1e-4
relative, each gradient within 1e-4 of its own largest entry, or of the
model's largest for a gradient below 1e-3 of that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models.enh.tse import TSEModel as JaxTSEModel
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin import enh_tse_train
from espnet_tpu_torch.bin.enh_tse_inference import ExtractSpeech
from espnet_tpu_torch.models.enh.tse import TSEModel
from espnet_tpu_torch.tasks.enh import EnhTSETask
from espnet_tpu_torch.train.checkpoint import load_checkpoint
from espnet_tpu_torch.utils.config import dump_yaml
from tests.torch_enh_models import grad_errors, rel, seeded, t
from tests.torch_streaming_models import xla_unoptimized

TSE = {"n_fft": 128, "hop_length": 64, "hidden": 16, "num_layers": 2,
       "emb_dim": 8}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tse():
    """The port's model, its flat weights, a batch, and the JAX model's
    loss, gradients and estimates from one compile. The first row's
    mixture and enrollment are whole, as ExtractSpeech passes them."""
    model = TSEModel(**TSE)
    flat = seeded({k: v.shape for k, v in
                   convert.state_dict_to_flax(model).items()}, 3)
    convert.load_flax_params(model, flat)
    rng = np.random.RandomState(3)
    r1, r2 = (0.3 * rng.randn(2, 2, 1024)).astype(np.float32)
    batch = {"speech_mix": r1 + r2,
             "speech_mix_lengths": np.asarray([1024, 900]),
             "enroll_ref1": (0.3 * rng.randn(2, 800)).astype(np.float32),
             "enroll_ref1_lengths": np.asarray([800, 650]),
             "speech_ref1": r1}
    jmod = JaxTSEModel(**TSE)
    tree = convert.nest({k: jnp.asarray(v) for k, v in flat.items()})

    def run(p, b):
        (loss, _), grads = jax.value_and_grad(lambda q: jmod.apply(
            q, b["speech_mix"], b["speech_mix_lengths"], b["enroll_ref1"],
            b["speech_ref1"], b["enroll_ref1_lengths"])[:2], has_aux=True)(p)
        est = jmod.apply(p, b["speech_mix"], b["speech_mix_lengths"],
                         b["enroll_ref1"], b["enroll_ref1_lengths"],
                         method=jmod.extract)
        return loss, grads, est

    with xla_unoptimized():
        loss, grads, est = jax.jit(run)(
            tree, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"model": model, "flat": flat, "batch": batch,
            "loss": float(loss), "est": np.asarray(est),
            "grads": convert.flatten(jax.tree_util.tree_map(np.asarray,
                                                            grads))}


def test_tse_estimate_loss_and_every_gradient_match_jax(tse,
                                                        record_property):
    model, b = tse["model"], {k: t(v) for k, v in tse["batch"].items()}
    with torch.no_grad():
        est = model.extract(b["speech_mix"], b["speech_mix_lengths"],
                            b["enroll_ref1"], b["enroll_ref1_lengths"])
    loss, stats, weight = model(**b)
    model.zero_grad()
    loss.backward()
    grads = convert.state_dict_to_flax(model, grad=True)
    assert set(grads) == set(tse["grads"]) == set(tse["flat"])
    errs = [rel(est.numpy(), tse["est"]),
            abs(loss.item() - tse["loss"]) / abs(tse["loss"]),
            max(grad_errors(grads, tse["grads"]).values())]
    record_property("rel_err:tse", errs)
    assert errs[0] <= 1e-5 and errs[1] <= 1e-4 and errs[2] <= 1e-4
    assert weight == 2.0 and stats["si_snr"].item() == -loss.item()
    back = convert.state_dict_to_flax(model)
    assert all(np.array_equal(back[k], v) for k, v in tse["flat"].items())
    # the enrollment's padding is out of the speaker's mean: taken whole,
    # the second utterance's estimate moves past the tolerance
    with torch.no_grad():
        whole = model.extract(b["speech_mix"], b["speech_mix_lengths"],
                              b["enroll_ref1"], torch.full((2,), 800))
    assert rel(whole[1].numpy(), tse["est"][1]) > 1e-4


def _config(tmp_path, flat):
    """A data dir of two 0.25 s utterances (noise from a seed: a mixture,
    an enrollment and a target each), the seed weights and an enh_tse
    config over them. -> the config's path."""
    from espnet_tpu_torch.data.fileio import write_wav
    np.savez(tmp_path / "seed.npz", **flat)
    d = tmp_path / "data"
    d.mkdir()
    rng = np.random.RandomState(4)
    names = ("speech_mix", "enroll_ref1", "speech_ref1")
    for name in names:
        with open(d / f"{name}.scp", "w") as f:
            for i in range(2):
                write_wav(d / f"{name}_{i}.wav", 16000,
                          (0.3 * rng.randn(4000)).astype(np.float32))
                f.write(f"utt{i} {d / f'{name}_{i}.wav'}\n")
    cfg = {"output_dir": str(tmp_path / "exp"), "max_epoch": 1,
           "num_iters_per_epoch": 2, "batch_size": 2, "seed": 4,
           "tse_conf": TSE, "init_param": str(tmp_path / "seed.npz"),
           "train_data_path_and_name_and_type": [
               f"{d}/{name}.scp,{name},sound" for name in names]}
    dump_yaml(cfg, tmp_path / "config.yaml")
    return tmp_path / "config.yaml"


def test_task_and_extract_speech_on_the_cpu(tse, tmp_path):
    cfg, path = {"tse_conf": TSE}, tmp_path / "config.yaml"
    dump_yaml(cfg, path)
    np.savez(tmp_path / "seed.npz", **tse["flat"])
    model = EnhTSETask.build_model(cfg)
    assert set(convert.state_dict_to_flax(model)) == set(tse["flat"])
    assert set(EnhTSETask.example_batch(cfg)) == {
        "speech_mix", "speech_mix_lengths", "enroll_ref1", "speech_ref1"}
    ex = ExtractSpeech(path, tmp_path / "seed.npz", device="cpu")
    assert ex.device.type == "cpu" and not ex.model.training
    b = tse["batch"]
    est = ex(b["speech_mix"], b["enroll_ref1"])
    assert est.shape == (2, 1024) and est.dtype == np.float32
    one = ex(b["speech_mix"][0], b["enroll_ref1"][0])
    assert rel(one[0], tse["est"][0]) <= 1e-5
    assert rel(est[0], tse["est"][0]) <= 1e-5


def test_enh_tse_train_on_the_cpu_repeats_itself(tse, tmp_path):
    path = _config(tmp_path, tse["flat"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            enh_tse_train.main(["--config", str(path)])
    runs = []
    for name in ("a", "b"):
        _, trainer = enh_tse_train.main([
            "--config", str(path), "--device", "cpu",
            "--output_dir", str(tmp_path / name)])
        assert len(trainer.step_stats) == 2
        assert all(np.isfinite(s["loss"]) and not s["skipped"]
                   for s in trainer.step_stats)
        runs.append(load_checkpoint(tmp_path / name / "checkpoint")[0])
    assert set(runs[0]) == set(tse["flat"])
    assert all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])
    assert any(not np.array_equal(runs[0][k], tse["flat"][k])
               for k in runs[0])
