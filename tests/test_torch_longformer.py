"""The port's long-form slice against the JAX package, on the CPU: the
banded attention (K4's and K4b's plain versions, against both JAX routes:
the masked einsum and the Pallas splash kernel in interpret mode), the
Transformer encoder layer and encoder with and without a band, the
Longformer-encoder ASR model's loss and every gradient, its full-width
eval loss, the converter's round trip, the positional encoding past 2048
frames, and the batch-decode CLI's output files.

Inputs are made with numpy from a seed and fed to both packages. Both
compute in fp32, with sums in another order; each tolerance says why it
is what it is. Rows with no allowed key (padded rows further than the
window from every valid key) follow each route's own convention, so the
attention is compared on valid rows, as the encoders use it.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from jax.experimental.pallas.ops.tpu.splash_attention import \
    splash_attention_kernel as splash

from espnet_tpu.bin.asr_inference import inference as jax_inference
from espnet_tpu.nn import transformer as jax_transformer
from espnet_tpu.nn.embedding import PositionalEncoding as JaxPE
from espnet_tpu.ops.attention_kernels import (_splash_banded_kernel,
                                              banded_attention as jax_banded)
from espnet_tpu.tasks.asr import ASRTask as JaxASRTask
from espnet_tpu_torch import convert
from espnet_tpu_torch.bin.asr_inference import inference
from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
from espnet_tpu_torch.nn import transformer
from espnet_tpu_torch.nn.embedding import PositionalEncoding
from espnet_tpu_torch.ops.banded_attention import (banded_attention,
                                                   banded_attention_bwd_plain,
                                                   banded_attention_plain,
                                                   banded_stats_plain)
from espnet_tpu_torch.tasks.asr import build_model, read_token_list
from espnet_tpu_torch.train.checkpoint import save_checkpoint
from espnet_tpu_torch.utils.config import dump_yaml, load_yaml
from tests.torch_streaming_models import flax_params, xla_unoptimized

FLAGSHIP = (Path(__file__).resolve().parents[1] / "assets"
            / "synth_asr_flagship")


@pytest.fixture(autouse=True, scope="module")
def jax_references_unoptimized():
    """The JAX references compile without XLA's optimisations: they run
    once, at small shapes, where compiling is most of their time."""
    with xla_unoptimized():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several workers side by side: one torch thread
    each, or torch's pool in every worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _perturbed(params, seed=0):
    """The flat flax dict of ``params`` moved off their init values, so
    that zero biases and unit scales take part; and the tree again."""
    rng = np.random.RandomState(seed)
    flat = {k: (np.asarray(v) + 0.05 * rng.randn(*np.shape(v))
                ).astype(np.float32)
            for k, v in flatten_dict(params, sep="/").items()}
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    return flat, tree


# ---- K4 and K4b: the banded attention ---------------------------------

def _splash_route(q, k, v, window, valid, sm_scale):
    """The JAX package's splash dispatch (attention_kernels.py:103-119)
    with the kernel in interpret mode: T and d padded to 128, segment 0
    for valid frames and 1 for padded ones."""
    B, H, T, d = q.shape
    Tp, dp = -(-T // 128) * 128, -(-d // 128) * 128
    pad = ((0, 0), (0, 0), (0, Tp - T), (0, dp - d))
    q, k, v = (jnp.pad(x, pad) for x in (q, k, v))
    kernel = _splash_banded_kernel(H, Tp, int(window), True)
    seg = jnp.where(jnp.pad(valid, ((0, 0), (0, Tp - T))), 0, 1)
    out = jax.vmap(lambda qq, kk, vv, s: kernel(
        qq * sm_scale, kk, vv,
        segment_ids=splash.SegmentIds(q=s, kv=s)))(q, k, v, seg)
    return out[:, :, :T, :d]


# (B, H, T, d) = (2, 2, 200, 64): T not a multiple of 128 and d padded
# for splash; the second utterance keeps 150 frames, so at W = 0 and 3
# its padded tail has rows with no allowed key
BANDED_T, BANDED_LENS = 200, (200, 150)


def _banded_case(seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(2, 2, BANDED_T, 64).astype(np.float32)
               for _ in range(3))
    valid = np.arange(BANDED_T)[None] < np.asarray(BANDED_LENS)[:, None]
    dout = rng.randn(2, 2, BANDED_T, 64).astype(np.float32)
    dout *= valid[:, None, :, None]      # no gradient into padded rows
    return q, k, v, valid, dout


@pytest.mark.parametrize("window", [0, 3, 64, 256])
def test_banded_attention_matches_both_jax_routes(window, record_property):
    q, k, v, valid, dout = _banded_case()
    s = 64 ** -0.5
    jq, jk, jv, jvalid = map(jnp.asarray, (q, k, v, valid))
    xla = lambda a, b, c: jax_banded(a, b, c, window, jvalid,  # noqa: E731
                                     sm_scale=s, force_xla=True)
    spl = lambda a, b, c: _splash_route(a, b, c, window,  # noqa: E731
                                        jvalid, s)
    ins = [_t(x).requires_grad_() for x in (q, k, v)]
    out = banded_attention(*ins, window, _t(valid), sm_scale=s)
    grads = torch.autograd.grad(out, ins, _t(dout))
    rows = np.broadcast_to(valid[:, None, :], (2, 2, BANDED_T))
    for name, route in (("xla", xla), ("splash", spl)):
        ref, vjp = jax.vjp(route, jq, jk, jv)
        ref_grads = vjp(jnp.asarray(dout))
        # fp32 sums over at most 2W + 1 keys of O(1) terms: ~1e-6
        err = float(np.abs(out.detach().numpy() - np.asarray(ref))[rows]
                    .max())
        assert err <= 1e-5, (name, err)
        record_property(f"max_abs_err:out_{name}", err)
        # the gradients of every input, padded rows too (no gradient
        # comes from them): sums over up to 2W + 1 terms, ~1e-6
        for gname, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
            gerr = float(np.abs(a.numpy() - np.asarray(b)).max())
            assert gerr <= 2e-5, (name, gname, gerr)
            record_property(f"max_abs_err:{gname}_{name}", gerr)


def test_banded_backward_plain_is_the_autograd_gradient(record_property):
    # the kernels' recompute-from-statistics arithmetic against torch's
    # autograd of the plain forward, with a gradient on every row
    q, k, v, valid, _ = _banded_case(1)
    dout = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    s, window = 64 ** -0.5, 3
    ins = [_t(x).requires_grad_() for x in (q, k, v)]
    out = banded_attention_plain(*ins, window, _t(valid), sm_scale=s)
    ref = torch.autograd.grad(out, ins, _t(dout))
    stats = banded_stats_plain(_t(q), _t(k), window, _t(valid), sm_scale=s)
    got = banded_attention_bwd_plain(_t(q), _t(k), _t(v), _t(valid),
                                     out.detach(), stats, _t(dout),
                                     window=window, sm_scale=s)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err = float((a - b).abs().max())
        assert err <= 2e-5, (name, err)
        record_property(f"max_abs_err:{name}", err)


def test_rows_with_no_allowed_key_give_zero_and_take_no_gradient():
    q, k, v, valid, _ = _banded_case(3)
    window = 3
    ins = [_t(x).requires_grad_() for x in (q, k, v)]
    out = banded_attention_plain(*ins, window, _t(valid), sm_scale=0.125)
    # rows 153.. of the second utterance are more than 3 frames from its
    # last valid key (149)
    empty = out[1, :, 153:]
    assert torch.count_nonzero(empty) == 0
    assert torch.count_nonzero(out[1, :, :153].detach()) > 0
    dout = torch.zeros_like(out)
    dout[1, :, 153:] = 1.0
    for g in torch.autograd.grad(out, ins, dout):
        assert torch.count_nonzero(g) == 0
    stats = banded_stats_plain(_t(q), _t(k), window, _t(valid))
    assert torch.equal(stats[1, :, 153:, 0], torch.zeros(2, 47))
    assert torch.isneginf(stats[1, :, 153:, 1]).all()
    assert torch.isfinite(stats[1, :, :153]).all()


# ---- the encoder --------------------------------------------------------

ENC = dict(output_size=64, attention_heads=4, linear_units=128,
           num_blocks=2)


def test_encoder_layer_matches_jax_on_valid_frames(record_property):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 300, 64).astype(np.float32)
    valid = np.arange(300)[None] < np.asarray([[300], [230]])
    band = np.abs(np.arange(300)[:, None] - np.arange(300)[None]) <= 8
    mask = valid[:, None, :] & band[None]
    jl = jax_transformer.TransformerEncoderLayer(4, 64, 128)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                     window=8, valid=jnp.asarray(valid))
    flat, params = _perturbed(params)
    ref = jl.apply(params, jnp.asarray(x), jnp.asarray(mask), window=8,
                   valid=jnp.asarray(valid))
    layer = convert.load_flax_params(
        transformer.TransformerEncoderLayer(4, 64, 128), flat).eval()
    with torch.no_grad():
        out = layer(_t(x), _t(mask), 8, _t(valid))
    err = float(np.abs(out.numpy() - np.asarray(ref))[valid].max())
    # one layer, O(1) residual stream, fp32 sums in another order
    assert err <= 1e-5, err
    record_property("max_abs_err:encoder_layer", err)


@pytest.mark.parametrize("window,normalize_before,input_layer", [
    (8, True, "conv2d"), (8, False, "linear"), (None, True, "linear"),
    (None, False, "conv2d")])
def test_encoder_matches_jax_on_valid_frames(window, normalize_before,
                                             input_layer, record_property):
    # conv2d: 1210 feature frames -> 301 encoder frames (T' ~ 300)
    frames = 1210 if input_layer == "conv2d" else 300
    rng = np.random.RandomState(5)
    feats = rng.randn(2, frames, 80).astype(np.float32)
    lens = np.asarray([frames, frames - 270], np.int32)
    conf = dict(ENC, input_layer=input_layer,
                normalize_before=normalize_before, attention_window=window)
    jenc = jax_transformer.TransformerEncoder(input_size=80, **conf)
    # init and apply compiled whole: faster than op-by-op dispatch
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(feats),
                                jnp.asarray(lens))
    flat, params = _perturbed(params)
    ref, ref_lens = jax.jit(jenc.apply)(params, jnp.asarray(feats),
                                        jnp.asarray(lens))
    enc = convert.load_flax_params(transformer.TransformerEncoder(80, **conf),
                                   flat).eval()
    with torch.no_grad():
        out, olens = enc(_t(feats), _t(lens).long())
    np.testing.assert_array_equal(olens.numpy(), np.asarray(ref_lens))
    valid = np.arange(out.shape[1])[None] < olens.numpy()[:, None]
    assert out.shape == ref.shape and valid[1].sum() < out.shape[1]
    err = float(np.abs(out.numpy() - np.asarray(ref))[valid].max())
    # two blocks, outputs O(1) (O(10) without the final LayerNorm), fp32
    assert err <= 1e-4 * max(1.0, float(np.abs(ref).max())), err
    record_property("max_abs_err:encoder", err)


def test_positional_encoding_takes_any_length(record_property):
    x = np.random.RandomState(6).randn(1, 2100, 256).astype(np.float32)
    ref = JaxPE(256).apply({}, jnp.asarray(x))
    pe = PositionalEncoding(256).eval()
    with torch.no_grad():
        out = pe(_t(x))
        # a later window of positions, after the table was built longer
        tail = pe(_t(x[:, :60]), offset=2040)
    err = float(np.abs(out.numpy() - np.asarray(ref)).max())
    assert err <= 1e-5, err
    record_property("max_abs_err:positional_encoding_2100", err)
    want = x[:, :60] * 16.0 + np.asarray(ref)[:, 2040:2100] - x[:, 2040:2100] \
        * 16.0
    np.testing.assert_allclose(tail.numpy(), want, atol=1e-4)


# ---- the Longformer-encoder ASR model -------------------------------------

def small_cfg(**model_conf):
    return {
        "token_list": read_token_list(FLAGSHIP / "tokens.txt"),
        "frontend": "default",
        "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
        "normalize": "global_mvn",
        "stats_file": str(FLAGSHIP / "feats_stats.npz"),
        "encoder": "longformer",
        "encoder_conf": dict(ENC, attention_window=8),
        "decoder": "transformer",
        "decoder_conf": {"attention_heads": 4, "linear_units": 128,
                         "num_blocks": 1},
        "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1, **model_conf},
    }


@pytest.fixture(scope="module")
def small():
    cfg = small_cfg()
    jmodel = JaxASRTask.build_model(cfg)
    flat, params = flax_params(jmodel, **JaxASRTask.example_batch(cfg))
    return cfg, jmodel, params, flat


def _batch(lens=(16000, 11000, 13000), text_lens=(12, 7, 10), seed=1):
    rng = np.random.RandomState(seed)
    speech = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        speech[i, :n] = 0.3 * rng.randn(n)
    text = rng.randint(1, 24, size=(len(lens), max(text_lens)))
    for i, n in enumerate(text_lens):
        text[i, n:] = 0
    return {"speech": speech, "speech_lengths": np.asarray(lens, np.int32),
            "text": text.astype(np.int32),
            "text_lengths": np.asarray(text_lens, np.int32)}


def _torch_batch(batch):
    return {k: _t(v).float() if v.dtype.kind == "f" else _t(v).long()
            for k, v in batch.items()}


def test_converter_round_trip_has_no_leftover_key(small):
    cfg, _, _, flat = small
    model = convert.load_flax_params(build_model(cfg), flat)
    back = convert.state_dict_to_flax(model)
    assert sorted(back) == sorted(flat)
    for name, value in flat.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    assert any("/layer1/self_attn/linear_q/" in k for k in back)
    with pytest.raises(KeyError):
        convert.load_flax_params(build_model(cfg), {
            **flat, "params/encoder_mod/layer0/extra/kernel": np.zeros((2, 2))})


def test_small_longformer_model_loss_and_every_gradient(small,
                                                        record_property):
    # T' = 30, 20 and 24 at W = 8: the band restricts, and the second
    # utterance's last rows have no allowed key
    cfg, jmodel, params, flat = small
    batch = _batch()

    def loss_fn(p):
        loss, stats, _ = jmodel.apply(
            p, **{k: jnp.asarray(v) for k, v in batch.items()},
            deterministic=True)
        return loss, stats

    (ref_loss, ref_stats), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    model = convert.load_flax_params(build_model(cfg), flat).eval()
    loss, stats, _ = model(**_torch_batch(batch))
    loss.backward()
    for key in ("loss", "loss_ctc", "loss_att", "acc"):
        # losses of O(10) through two blocks and the decoder in fp32
        np.testing.assert_allclose(stats[key].item(), float(ref_stats[key]),
                                   rtol=2e-6, atol=1e-6)
    grads = convert.state_dict_to_flax(model, grad=True)
    ref_grads = {k: np.asarray(v)
                 for k, v in flatten_dict(ref_grads, sep="/").items()}
    assert sorted(grads) == sorted(ref_grads)
    worst = 0.0
    for name, ref in ref_grads.items():
        # 1e-4 of each parameter's own gradient scale, and 1e-7 absolute
        # for the key biases, whose gradient is zero by the softmax's
        # shift invariance and so is fp32 noise in both
        scale = np.abs(ref).max()
        np.testing.assert_allclose(grads[name], ref, rtol=0,
                                   atol=1e-4 * scale + 1e-7, err_msg=name)
        if scale > 1e-6:
            worst = max(worst, float(np.abs(grads[name] - ref).max() / scale))
    record_property("max_rel_err:gradients", worst)


def slice_cfg():
    """The long-form slice's config: the flagship's, with the Longformer
    encoder at the flagship's widths and natural padding."""
    cfg = load_yaml(FLAGSHIP / "config.yaml")
    cfg.pop("collate_fixed_lengths")
    cfg.update(token_list=str(FLAGSHIP / "tokens.txt"),
               stats_file=str(FLAGSHIP / "feats_stats.npz"),
               encoder="longformer",
               encoder_conf={"output_size": 256, "attention_heads": 4,
                             "linear_units": 1024, "num_blocks": 6,
                             "attention_window": 64})
    return cfg


def test_slice_config_full_width_eval_loss(record_property):
    cfg = slice_cfg()
    jmodel = JaxASRTask.build_model(cfg)
    # the tree filled at init scale from a numpy seed (nothing compiled)
    flat, params = flax_params(jmodel, **JaxASRTask.example_batch(cfg),
                               seed=1)
    # 17 s and 13 s: T' = 531 and 406 frames, the band at 64 restricts
    batch = _batch(lens=(272000, 208000), text_lens=(40, 30), seed=2)
    ref_loss, ref_stats, _ = jax.jit(
        lambda p, b: jmodel.apply(p, **b, deterministic=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.load_flax_params(build_model(cfg), flat).eval()
    assert sum(p.numel() for p in model.parameters()) > 9_000_000
    with torch.no_grad():
        loss, stats, _ = model(**_torch_batch(batch))
    # 6 blocks and 3 decoder layers at d=256 in fp32: about 1e-4 of it
    for key in ("loss", "loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(float(stats[key]), float(ref_stats[key]),
                                   rtol=1e-4)
    record_property("slice_loss", float(loss))
    record_property("slice_loss_rel_diff",
                    abs(float(loss) / float(ref_loss) - 1))


# ---- the batch-decode CLI -----------------------------------------------

def test_inference_writes_the_jax_packages_files(tmp_path, small):
    # a tiny Longformer model saved as the trainer saves it, both
    # packages' inference() over 3 utterances in batches of 2 (the second
    # padded), greedy CTC
    cfg, _, _, flat = small
    model = convert.load_flax_params(build_model(cfg), flat)
    save_checkpoint(tmp_path / "ckpt", model)
    cfg = dict(cfg, token_list=str(FLAGSHIP / "tokens.txt"))
    dump_yaml(cfg, tmp_path / "config.yaml")
    SynthSpeechCorpus().materialize(tmp_path / "data", n_train=0, n_valid=0,
                                    n_test=3)
    kw = dict(data_path_and_name_and_type=[
        f"{tmp_path}/data/test/wav.scp,speech,sound"],
        asr_train_config=str(tmp_path / "config.yaml"),
        asr_model_file=str(tmp_path / "ckpt"), batch_size=2, ctc_weight=1.0)
    jax_inference(output_dir=str(tmp_path / "jax"), **kw)
    inference(output_dir=str(tmp_path / "port"), device="cpu", **kw)
    for name in ("text", "token", "token_int", "score"):
        ours = (tmp_path / "port" / "1best_recog" / name).read_text()
        ref = (tmp_path / "jax" / "1best_recog" / name).read_text()
        assert ours == ref, name
        assert len(ours.splitlines()) == 3
    stats = (tmp_path / "port" / "decode_stats.jsonl").read_text()
    assert [line.count('"n_utts"') for line in stats.splitlines()] == [1, 1]


def test_attention_dropout_in_training_takes_the_masked_route(monkeypatch):
    # the JAX package's dispatch: the band goes to the banded op unless
    # attention dropout acts (training, rate > 0); then the softmax is
    # written out under the mask, which holds the band
    from espnet_tpu_torch.nn import attention as nn_attention
    calls = []

    def counting(*args, **kw):
        calls.append(args[3])
        return banded_attention(*args, **kw)

    monkeypatch.setattr(nn_attention, "banded_attention", counting)
    mha = nn_attention.MultiHeadedAttention(4, 64, dropout_rate=0.5)
    x = _t(np.random.RandomState(7).randn(2, 30, 64).astype(np.float32))
    valid = torch.arange(30)[None] < torch.tensor([[30], [20]])
    band = (torch.arange(30)[:, None] - torch.arange(30)[None]).abs() <= 4
    mask = valid[:, None, :] & band[None]
    with torch.no_grad():
        ref = mha.eval()(x, x, x, mask, 4, valid)
        assert calls == [4]
        torch.manual_seed(0)
        dropped = mha.train()(x, x, x, mask, 4, valid)
        assert calls == [4] and not torch.allclose(dropped, ref)
        # with the dropout itself taken out, the masked route computes
        # the banded function on valid rows
        monkeypatch.setattr(nn_attention.F, "dropout", lambda a, p: a)
        kept = mha.train()(x, x, x, mask, 4, valid)
        torch.testing.assert_close(kept[valid], ref[valid], atol=1e-5,
                                   rtol=0)
        mha.dropout_rate = 0.0
        mha.train()(x, x, x, mask, 4, valid)
        assert calls == [4, 4]


def test_concatenated_data_dir_joins_consecutive_utterances(tmp_path):
    from espnet_tpu_torch.data.fileio import SoundScpReader
    from espnet_tpu_torch.data.synth_speech import concat_data_dir
    SynthSpeechCorpus().materialize(tmp_path / "data", n_train=5, n_valid=0,
                                    n_test=0)
    src = SoundScpReader(tmp_path / "data" / "train" / "wav.scp")
    waves = [src[k][1] for k in src.keys()]
    texts = (tmp_path / "data" / "train" / "text").read_text().splitlines()
    need = len(waves[0]) + len(waves[1])
    recs = concat_data_dir(tmp_path / "data" / "train", tmp_path / "long",
                           min_samples=need)
    # the first two make one recording; the next must reach `need` too
    n2 = 2 if len(waves[2]) + len(waves[3]) >= need else 3
    assert recs[0][1] == need and len(recs) >= 1
    out = SoundScpReader(tmp_path / "long" / "wav.scp")
    assert list(out.keys()) == [uid for uid, _, _ in recs]
    np.testing.assert_array_equal(out[recs[0][0]][1],
                                  np.concatenate(waves[:2]))
    assert recs[0][2] == " ".join(t.split(" ", 1)[1] for t in texts[:2])
    if len(recs) > 1:
        np.testing.assert_array_equal(out[recs[1][0]][1],
                                      np.concatenate(waves[2:2 + n2]))
    assert sum(n for _, n, _ in recs) <= sum(map(len, waves))


def test_entry_point_trains_the_longformer_with_natural_padding(tmp_path):
    from espnet_tpu_torch.bin import asr_train
    SynthSpeechCorpus().materialize(tmp_path / "data", n_train=5, n_valid=2,
                                    n_test=0)
    data = {split: [f"{tmp_path}/data/{split}/wav.scp,speech,sound",
                    f"{tmp_path}/data/{split}/text,text,text"]
            for split in ("train", "valid")}
    cfg = dict(small_cfg(), token_list=str(FLAGSHIP / "tokens.txt"),
               output_dir=str(tmp_path / "exp"), max_epoch=1,
               batch_type="sorted", batch_size=3, log_interval=1,
               optim="adam", optim_conf={"lr": 0.002}, specaug="specaug",
               specaug_conf={"num_time_mask": 1,
                             "time_mask_width_range": [0, 10]},
               train_data_path_and_name_and_type=data["train"],
               valid_data_path_and_name_and_type=data["valid"])
    dump_yaml(cfg, tmp_path / "train.yaml")
    _, trainer = asr_train.main(["--config", str(tmp_path / "train.yaml"),
                                 "--device", "cpu"])
    assert len(trainer.step_stats) == 2        # 5 utterances, batch 3
    for stats in trainer.step_stats:
        assert stats["skipped"] == 0.0 and np.isfinite(stats["loss"])
    assert np.isfinite(trainer.reporter.stats[1]["valid"]["loss"])


def test_one_hot_embedding_is_the_lookup_and_its_gradient():
    # the decoders' table lookup as a product (deterministic on the card)
    from espnet_tpu_torch.nn.embedding import OneHotEmbedding
    table = OneHotEmbedding(25, 16)
    ref = torch.nn.Embedding(25, 16)
    ref.weight.data.copy_(table.weight.data)
    ids = torch.from_numpy(np.random.RandomState(8).randint(0, 25, (4, 930)))
    g = torch.from_numpy(np.random.RandomState(9).randn(4, 930, 16)
                         .astype(np.float32))
    out, want = table(ids), ref(ids)
    assert torch.equal(out, want)
    (out * g).sum().backward()
    (want * g).sum().backward()
    torch.testing.assert_close(table.weight.grad, ref.weight.grad,
                               atol=1e-4, rtol=1e-5)
