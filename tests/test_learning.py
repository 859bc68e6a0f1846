"""Semantic sanity: the dRAM training objective must actually learn.

The reference's QA is operational (SURVEY.md §4); here we verify the whole
training system end-to-end on a synthetic task where the ground truth is
constructible: volumes contain low-HU "lesions" inside the lung whose
volume fraction determines the CLE score through the real ratio map.  After
a few optimization steps the interval-regression loss must drop
substantially and predictions must move toward the targets.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bodyct_dram_emph_subtype.data.datasets import CLE_RATIO_MAP
from bodyct_dram_emph_subtype.models import get_model_by_name
from bodyct_dram_emph_subtype.parallel.mesh import MeshSpec, get_mesh, shard_batch
from bodyct_dram_emph_subtype.train import (
    TrainState,
    make_optimizer,
    make_reg_train_step,
)


def _synthetic_batch(rng, b=6, shape=(16, 24, 32)):
    imgs = np.full((b, *shape), -0.5, np.float32)
    lungs = np.ones((b, *shape), np.float32)
    ems = np.zeros((b, *shape), np.float32)
    labels = []
    n_vox = np.prod(shape)
    for i in range(b):
        score = i % 6
        lo, hi = CLE_RATIO_MAP[score]
        frac = (lo + min(hi, 0.5)) / 2.0
        n_lesion = int(frac * n_vox)
        flat = rng.permutation(n_vox)[:n_lesion]
        em = np.zeros(n_vox, np.float32)
        em[flat] = 1.0
        em = em.reshape(shape)
        imgs[i][em > 0] = -2.0      # lesions look darker
        ems[i] = em
        labels.append(score)
    return {
        "image": imgs,
        "lung_mask": lungs,
        "em_mask": ems,
        "cls_label": np.asarray(labels, np.int32),
        "pse_label": np.asarray(labels, np.int32) % 3,
    }


@pytest.mark.slow
def test_dram_objective_learns(rng):
    model = get_model_by_name("med3ddramtiny")
    tx = make_optimizer()
    mesh = get_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    step = make_reg_train_step(model, tx, num_data_shards=1, augment=False)

    batch = _synthetic_batch(rng)
    x0 = jnp.zeros((1, 16, 24, 32, 1), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), x0, x0, train=False)
    state = TrainState.create(dict(variables), tx)
    device_batch = shard_batch(mesh, batch)
    args = (jnp.asarray(3e-4), jnp.ones(6, jnp.float32) / 6,
            jnp.ones(3, jnp.float32) / 3)

    losses = []
    for i in range(30):
        state, metrics, preds = step(state, device_batch, *args,
                                     jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    early = np.mean(losses[:3])
    late = np.mean(losses[-3:])
    assert late < 0.5 * early, f"loss did not learn: {early} -> {late}"
