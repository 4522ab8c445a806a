"""The port's streaming CTC decoders against the JAX package, on the
CPU: ``Speech2TextStreaming`` in greedy mode and in block-synchronous
hybrid beam mode, and ``StreamingSessionPool``, on a small hybrid model
(d = 32, 2 blocks, chunk 4, 2 left chunks, kernel 5, GlobalMVN) saved as
the committed assets are.

Audio is noise from a numpy seed, pushed in pieces of whole hops (so that
the JAX package's eager frontend meets few buffer shapes) with a shorter
final piece. The ids must be equal.
"""

import numpy as np
import pytest
import torch

from espnet_tpu.bin import asr_inference_streaming as jax_streaming_bin
from espnet_tpu.tasks.asr import ASRTask as JaxASRTask
from espnet_tpu_torch.bin import asr_inference_streaming
from tests.torch_streaming_models import (HYBRID, noise, pushes, save_model,
                                          xla_unoptimized)


@pytest.fixture(autouse=True, scope="module")
def jax_references_unoptimized():
    """The JAX references compile without XLA's optimisations: they run
    once, at small shapes, where compiling is most of their time."""
    with xla_unoptimized():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker: the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    return save_model(tmp_path_factory.mktemp("hybrid"), HYBRID, JaxASRTask)


def _stream(s2t, audio, size):
    for piece, final in pushes(audio, size):
        res = s2t(piece, is_final=final)
    return res


def test_ctc_sessions_match_jax(hybrid):
    # greedy and beam sessions on the same pushes; the ids of every
    # result. Beam: decode_interval 2, so a partial search runs on the
    # second push (2 chunks) and the final one on the last
    audio = noise(4500, 3)
    kw = dict(asr_train_config=hybrid / "config.yaml", asr_model_file=hybrid)
    for mode in ({"search_type": "greedy"},
                 {"search_type": "beam", "beam_size": 4, "ctc_weight": 0.3,
                  "decode_interval": 2}):
        ref = jax_streaming_bin.Speech2TextStreaming(**kw, **mode)
        ours = asr_inference_streaming.Speech2TextStreaming(
            **kw, **mode, device="cpu")
        for piece, final in pushes(audio, 1536):
            a, b = ours(piece, is_final=final), ref(piece, is_final=final)
            assert [r[2] for r in a] == [r[2] for r in b], mode
        assert a and a[0][2], mode


def _pool_round(pool, feeds):
    """One piece to each session of ``feeds`` ({sid: (piece, final)}),
    then one drain: the sessions' windows share the batched steps.
    -> {sid: ids}; a final piece closes its session, as ``push`` does."""
    for sid, (piece, final) in feeds.items():
        pool._fes[sid].push(np.asarray(piece, np.float32), is_final=final)
        pool._final[sid] = final
    pool._drain()
    out = {sid: list(pool._hyps[sid]) for sid in feeds}
    for sid, (_, final) in feeds.items():
        if final:
            pool.close(sid)
    return out


def test_session_pool_matches_jax_and_single_sessions(hybrid):
    # three sessions that start at other rounds; each round gives a piece
    # to every open session and drains once, so that rows at different
    # offsets share a step; a finished session's slot is taken by the
    # next one, whose last pieces go through push
    kw = dict(asr_train_config=hybrid / "config.yaml", asr_model_file=hybrid)
    ours_s2t = asr_inference_streaming.Speech2TextStreaming(**kw,
                                                            device="cpu")
    ref_s2t = jax_streaming_bin.Speech2TextStreaming(**kw)
    audios = [noise(n, 10 + i) for i, n in enumerate((4200, 3000, 2600))]
    single = [_stream(ours_s2t, a, 1408)[0][2] for a in audios]
    rows = []
    step = ours_s2t.encoder_step

    def counted_step(feats, state):
        rows.append(int((feats != 0).any(axis=(1, 2)).sum()))
        return step(feats, state)

    ours_s2t.encoder_step = counted_step
    outs = {}
    for s2t, pool_cls in ((ours_s2t, asr_inference_streaming
                           .StreamingSessionPool),
                          (ref_s2t, jax_streaming_bin.StreamingSessionPool)):
        pool = pool_cls(s2t, max_sessions=2)
        plan = {0: pushes(audios[0], 1408), 1: pushes(audios[1], 1536)}
        sids = {0: pool.open()}
        got = {}
        for r in range(4):
            if r == 1:
                sids[1] = pool.open()
            if r == 3:
                sids[2] = pool.open()
                plan[2] = pushes(audios[2], 1280)
            feeds = {sids[u]: plan[u].pop(0) for u in sorted(sids)
                     if plan.get(u)}
            ids = _pool_round(pool, feeds)
            for u in sorted(sids):
                if u in plan and not plan[u] and u not in got:
                    got[u] = ids[sids[u]]
        while plan[2]:
            got[2] = pool.push(sids[2], *plan[2].pop(0))[2]
        outs[pool_cls.__module__.split(".")[0]] = got
    assert max(rows) == 2
    assert outs["espnet_tpu_torch"] == outs["espnet_tpu"]
    assert [outs["espnet_tpu_torch"][u] for u in range(3)] == single
    assert all(single)


def test_ctc_session_needs_a_card_or_the_cpu(monkeypatch, hybrid):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        asr_inference_streaming.Speech2TextStreaming(hybrid / "config.yaml",
                                                     hybrid)
