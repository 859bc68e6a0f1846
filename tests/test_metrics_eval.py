"""Evaluation metrics vs sklearn oracles."""
import numpy as np
from sklearn.metrics import cohen_kappa_score, f1_score

from bodyct_dram_emph_subtype.utils.metrics_eval import (
    accuracy,
    classification_report,
    macro_f1,
    weighted_kappa,
)


def test_metrics_match_sklearn(rng):
    y_true = rng.randint(0, 6, 200)
    y_pred = np.where(rng.rand(200) < 0.6, y_true, rng.randint(0, 6, 200))
    assert accuracy(y_true, y_pred) == (y_true == y_pred).mean()
    np.testing.assert_allclose(
        macro_f1(y_true, y_pred, 6),
        f1_score(y_true, y_pred, average="macro", labels=range(6)),
        rtol=1e-9)
    np.testing.assert_allclose(
        weighted_kappa(y_true, y_pred, 6, "linear"),
        cohen_kappa_score(y_true, y_pred, weights="linear",
                          labels=list(range(6))),
        rtol=1e-9)
    np.testing.assert_allclose(
        weighted_kappa(y_true, y_pred, 6, "quadratic"),
        cohen_kappa_score(y_true, y_pred, weights="quadratic",
                          labels=list(range(6))),
        rtol=1e-9)


def test_report_keys():
    rep = classification_report([0, 1, 2], [0, 1, 1], 3, prefix="x_")
    assert set(rep) == {"x_acc", "x_f1", "x_kappa_linear"}
    assert rep["x_acc"] == 2 / 3
