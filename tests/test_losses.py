"""Loss parity vs torch oracles implementing the reference formulas."""
import numpy as np
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from bodyct_dram_emph_subtype.data import CLE_RATIO_MAP, PSE_RATIO_MAP
from bodyct_dram_emph_subtype.losses import (
    generate_regression_labels,
    interval_regression_loss,
    masked_balanced_bce,
    ratio_to_label_batch,
    segmentation_losses,
    weighted_cross_entropy,
)

BETA, GAMMA = 0.7338, 0.2578


def test_weighted_cross_entropy_matches_torch(rng):
    logits = rng.randn(8, 6).astype(np.float32)
    labels = rng.randint(0, 6, 8)
    w = rng.rand(6).astype(np.float32) + 0.1
    want = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           weight=torch.from_numpy(w)).item()
    got = float(weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                       jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_regression_labels_with_score0_correction():
    labels = jnp.asarray([0, 1, 3, 5])
    bands = np.asarray(generate_regression_labels(labels, CLE_RATIO_MAP))
    np.testing.assert_allclose(bands[0], [0.0, 0.0])          # score-0 band
    np.testing.assert_allclose(bands[1], [0.01, 0.05], atol=1e-6)
    np.testing.assert_allclose(bands[2], [0.1, 0.2], atol=1e-6)
    np.testing.assert_allclose(bands[3], [0.3, 1.0001], atol=1e-6)


def test_interval_regression_loss_matches_reference_math(rng):
    outs = rng.rand(5).astype(np.float32) * 0.4
    bands = np.sort(rng.rand(5, 2).astype(np.float32) * 0.4, axis=1)
    w = rng.rand(5).astype(np.float32)
    # torch oracle: the exact expression at models.py:512-521
    t_out, t_band, t_w = map(torch.from_numpy, (outs, bands, w))
    nd = torch.cat([t_out.unsqueeze(1), t_band], dim=1)
    nd = BETA * nd ** GAMMA
    K = (0.5 * (nd[:, 2] - nd[:, 1])) ** 2
    unhinged = (nd[:, 0] - (nd[:, 2] + nd[:, 1]) / 2.0) ** 2 - K
    want = (10.0 * F.leaky_relu(unhinged, negative_slope=0.0) * t_w).sum().item()
    got = float(interval_regression_loss(jnp.asarray(outs), jnp.asarray(bands),
                                         jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_masked_bce_matches_reference_math(rng):
    y = (rng.rand(2, 4, 6, 8, 1) > 0.7).astype(np.float32)
    p = rng.rand(2, 4, 6, 8, 1).astype(np.float32)
    m = (rng.rand(2, 4, 6, 8, 1) > 0.3).astype(np.float32)
    ty, tp, tm = map(torch.from_numpy, (y, p, m))
    alpha = (1.0 - ty.sum() / ty.shape[0]).clamp(0.3, 0.7)
    pt = tp * ty + (1.0 - tp) * (1.0 - ty)
    w = alpha * ty + (1.0 - alpha) * (1.0 - ty)
    ptc = pt.clamp(1e-6, 1 - 1e-6)
    nll = -1.0 * (0.85 * torch.log(ptc) * w * tm
                  + torch.log(ptc) * w * (1.0 - tm))
    want = (nll.sum() / w.sum()).item()
    got = float(masked_balanced_bce(jnp.asarray(y), jnp.asarray(p),
                                    jnp.asarray(m), smoothness=0.85))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_segmentation_losses_mutex_dice(rng):
    cle = rng.rand(2, 4, 6, 8, 1).astype(np.float32)
    pse = rng.rand(2, 4, 6, 8, 1).astype(np.float32)
    ems = (rng.rand(2, 4, 6, 8, 1) > 0.8).astype(np.float32)
    lungs = np.ones_like(cle)
    mul, seg = segmentation_losses(*map(jnp.asarray, (cle, pse, ems, lungs)))
    inter = (cle * pse).sum()
    want_dice = (2 * inter + 1e-7) / (cle.sum() + pse.sum() + 1e-7)
    np.testing.assert_allclose(float(mul), want_dice, rtol=1e-5)
    assert float(seg) > 0


def test_ratio_to_label_matches_reference_lookup():
    def ref_lookup(ratio, mapping):
        inv = {v: k for k, v in mapping.items()}
        return [inv[k] for k in inv if k[0] <= ratio < k[1]][0]

    for mapping in (CLE_RATIO_MAP, PSE_RATIO_MAP):
        ratios = [0.0, 0.005, 0.01, 0.049999, 0.05, 0.15, 0.25, 0.35, 0.9999]
        want = [ref_lookup(r, mapping) for r in ratios]
        got = np.asarray(ratio_to_label_batch(jnp.asarray(ratios, jnp.float32),
                                              mapping))
        np.testing.assert_array_equal(got, want)
