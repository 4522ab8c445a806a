"""The port's clustering separators against the JAX package, on the CPU:
``kmeans_tf_bins``, DPCL trained with ``loss_type: dpcl`` (the affinity
loss) and separated through k-means, DAN on both paths (ideal attractors
from the references in training, k-means attractors at inference) and
DPCL-E2E (soft k-means, then a BLSTM), at the JAX package's own small
configurations (tests/test_enh.py); and the conv encoder's refusal of
complex and clustering separators.

Inputs and weights are made with numpy from a seed and fed to both
packages. Estimates and masks within 1e-5 of their largest entry, the
loss within 1e-4 relative and each gradient within 1e-4 of its scale
(``tests/torch_enh_models.py:grad_errors``); k-means labels equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from espnet_tpu.models.enh import separators as jax_separators
from espnet_tpu.models.enh.model import EnhancementModel as JaxEnhancement
from espnet_tpu_torch.models.enh import separators
from espnet_tpu_torch.models.enh.model import EnhancementModel
from tests.torch_enh_models import (grad_errors, jax_outputs, leaves,
                                    models, port_outputs, rel, t)
from tests.torch_streaming_models import xla_unoptimized


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


def test_kmeans_and_the_affinity_loss_match_jax():
    # random bin embeddings (no clear clusters: many close calls) at two
    # and three clusters, and two well-separated blobs: the labels equal
    # JAX's, the centers within 1e-5 of their largest entry; dpcl_loss
    # within 1e-5 relative, and 0 for an embedding that is the ideal
    # assignment itself
    rng = np.random.RandomState(0)
    emb = np.tanh(rng.randn(2, 300, 6)).astype(np.float32)
    blobs = np.concatenate([rng.randn(1, 50, 3) * 0.05 + [2.0, 0, 0],
                            rng.randn(1, 50, 3) * 0.05 - [2.0, 0, 0]],
                           1).astype(np.float32)
    mags = [np.abs(rng.randn(2, 9, 7)).astype(np.float32) for _ in range(2)]
    lemb = np.tanh(rng.randn(2, 9, 7, 5)).astype(np.float32)

    def jax_side(e, b, le, m1, m2):
        return (jax_separators.kmeans_tf_bins(e, 2),
                jax_separators.kmeans_tf_bins(e, 3),
                jax_separators.kmeans_tf_bins(b, 2, n_iter=8),
                jax_separators.dpcl_loss(le, [m1, m2]))

    want = jax.jit(jax_side)(*map(jnp.asarray, (emb, blobs, lemb, *mags)))
    got = (separators.kmeans_tf_bins(t(emb), 2),
           separators.kmeans_tf_bins(t(emb), 3),
           separators.kmeans_tf_bins(t(blobs), 2, n_iter=8))
    for (lab, cen), (wlab, wcen) in zip(got, want[:3]):
        assert np.array_equal(lab.numpy(), wlab)
        assert rel(cen.numpy(), wcen) <= 1e-5
    lab = got[2][0].numpy()[0]
    assert len(set(lab[:50])) == 1 and len(set(lab[50:])) == 1
    assert lab[0] != lab[-1]
    loss = separators.dpcl_loss(t(lemb), [t(m) for m in mags])
    assert rel(loss.numpy(), want[3]) <= 1e-5
    ideal = (mags[0] >= mags[1]).astype(np.float32)
    perfect = torch.stack([t(ideal), 1 - t(ideal)], dim=-1)
    assert separators.dpcl_loss(perfect, [t(m) for m in mags]).abs().max() \
        <= 1e-6


# the JAX package's own small configurations (tests/test_enh.py), and
# the model's loss type
CASES = {
    "dpcl": ({"layers": 1, "unit": 12, "emb_D": 6}, "dpcl"),
    "dan": ({"layers": 1, "unit": 12, "emb_D": 6}, "si_snr"),
    "dpcl_e2e": ({"layers": 1, "unit": 12, "emb_D": 6, "n_iter": 3},
                 "si_snr"),
}


@pytest.mark.parametrize("sep", list(CASES))
def test_clustering_separators_match_jax(sep, record_property):
    # the model's own loss (DPCL's affinity loss, DAN's PIT loss through
    # the references' ideal attractors, DPCL-E2E's PIT loss) and every
    # gradient; then the estimates and masks of a separation without the
    # references (k-means: DPCL's binary masks equal, labels equal)
    conf, loss_type = CASES[sep]
    jmod, tree, flat, model, batch = models(sep, conf, loss_type=loss_type)
    want_ests, want_masks, want_loss, want_grads = jax_outputs(
        jmod, tree, batch, one_forward=False)
    ests, masks, loss, stats, _, grads = port_outputs(model, batch,
                                                      refs_in_forward=False)
    assert set(grads) == set(want_grads) == set(flat)
    errs = [rel(g.numpy(), w) for g, w in zip(ests, want_ests)]
    mask_errs = [rel(g, w) for g, w in zip(leaves(masks),
                                           leaves(want_masks))]
    grad_err = max(grad_errors(grads, want_grads).values())
    loss_err = abs(loss.item() - want_loss) / abs(want_loss)
    record_property(f"rel_err:{sep}", [max(errs), max(mask_errs), loss_err,
                                       grad_err])
    assert len(ests) == 2 and len(mask_errs) == 2
    assert max(errs) <= 1e-5 and max(mask_errs) <= 1e-5
    assert loss_err <= 1e-4 and grad_err <= 1e-4
    if sep == "dpcl":
        assert set(stats) == {"loss"}
        # k-means labels equal: the binary masks are the same bits
        assert all(np.array_equal(g, w) for g, w in zip(
            leaves(masks), leaves(want_masks)))
        assert np.array_equal(sum(leaves(masks)), np.ones_like(
            leaves(masks)[0]))


@pytest.mark.parametrize("sep,conf", [
    ("tfgridnet", {"num_blocks": 1, "emb_dim": 8, "hidden": 12}),
    ("dccrn", {"enc_channels": (4, 8), "hidden": 12}),
    ("dpcl", {"layers": 1, "unit": 12, "emb_D": 6}),
    ("dan", {"layers": 1, "unit": 12, "emb_D": 6}),
])
def test_conv_encoder_refuses_complex_and_clustering_separators(sep, conf):
    # the learned basis masks a real representation: the port refuses a
    # complex-input, non-mask or reference-needing separator there, as
    # the JAX model does at its setup
    kw = dict(num_spk=2, encoder="conv", conv_channels=16, conv_kernel=8,
              conv_stride=4, separator=sep, separator_conf=conf)
    with pytest.raises(ValueError, match="real-mask separator"):
        EnhancementModel(**kw)
    x = jnp.zeros((1, 64))
    with pytest.raises(ValueError, match="real-mask separator"):
        jax.eval_shape(JaxEnhancement(**kw).init, jax.random.PRNGKey(0), x,
                       jnp.asarray([64]), x, x)
