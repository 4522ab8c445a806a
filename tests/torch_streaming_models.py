"""Shared by the port's streaming tests: small streaming configurations,
weights that fill the JAX package's parameter tree from a numpy seed, a
writer of a model dir laid out as the committed assets are, and a context
in which JAX compiles its references without XLA's optimisations."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
from flax.traverse_util import flatten_dict, unflatten_dict

from espnet_tpu_torch.utils.config import dump_yaml

TOKENS = ["<blank>", "a", "b", "c", "d", "<space>", "<sos/eos>"]
FRONT = {"n_fft": 128, "hop_length": 64, "n_mels": 20, "fs": 8000}
ENC = {"output_size": 32, "attention_heads": 2, "linear_units": 48,
       "num_blocks": 2, "chunk_size": 4, "left_chunks": 2, "cnn_kernel": 5}
HYBRID = {"token_type": "char", "frontend_conf": FRONT,
          "normalize": "global_mvn", "encoder": "streaming_conformer",
          "encoder_conf": ENC, "decoder": "transformer",
          "decoder_conf": {"attention_heads": 2, "linear_units": 48,
                           "num_blocks": 1},
          "model_conf": {"ctc_weight": 0.3}}
TRANSDUCER = {"token_type": "char", "frontend_conf": FRONT,
              "normalize": "global_mvn", "encoder": "streaming_conformer",
              "encoder_conf": ENC, "decoder": "rnn",
              "decoder_conf": {"hidden_size": 32},
              "joint_conf": {"joint_space_size": 32},
              "model_conf": {"aux_ctc_weight": 0.3}}


@contextlib.contextmanager
def xla_unoptimized():
    """JAX's references compiled with most of XLA's optimisations off:
    they run once, at small shapes, where compiling is most of their time
    (the enhancement trainer's four JAX runs: 38 s -> 25 s)."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", before)


def flax_params(module, *args, seed=0, **kwargs):
    """The JAX module's parameter tree (``jax.eval_shape`` of its init,
    which compiles nothing) filled from a numpy seed at init scale:
    kernels ~ N(0, 1 / fan-in), LayerNorm scales 1 + N(0, 0.05^2),
    embeddings N(0, 1), the rest N(0, 0.05^2). -> the flat dict and the
    tree."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args,
                            **kwargs)
    rng = np.random.RandomState(seed)
    flat = {}
    for key, leaf in sorted(flatten_dict(shapes, sep="/").items()):
        shape, name = leaf.shape, key.rsplit("/", 1)[-1]
        x = np.asarray(rng.randn(*shape))   # 0-d leaves too
        if name == "kernel":
            x = x / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.05 * x
        elif name != "embedding":
            x = 0.05 * x
        flat[key] = x.astype(np.float32)
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    return flat, tree


def save_model(d, cfg, task):
    """``cfg``'s model with ``flax_params`` weights, written to ``d`` as
    the assets are: config.yaml, tokens.txt, feats_stats.npz (made-up
    GlobalMVN statistics) and params_f16.npz. -> d."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "tokens.txt").write_text("\n".join(TOKENS) + "\n")
    rng = np.random.RandomState(5)
    n_mels = cfg["frontend_conf"]["n_mels"]
    mean, var = rng.uniform(-8, -2, n_mels), rng.uniform(2, 6, n_mels)
    np.savez(d / "feats_stats.npz", count=np.float64(1000), sum=mean * 1000,
             sum_square=(var + mean ** 2) * 1000)
    cfg = dict(cfg, token_list=str(d / "tokens.txt"),
               stats_file=str(d / "feats_stats.npz"))
    dump_yaml(cfg, d / "config.yaml")
    flat, _ = flax_params(task.build_model(cfg), **task.example_batch(cfg))
    np.savez_compressed(d / "params_f16.npz",
                        **{k: v.astype(np.float16) for k, v in flat.items()})
    return d


def noise(n, seed):
    return (0.1 * np.random.RandomState(seed).randn(n)).astype(np.float32)


def pushes(audio, size):
    """[(piece, is_final)] of ``size`` samples each."""
    return [(audio[i:i + size], i + size >= len(audio))
            for i in range(0, len(audio), size)]
