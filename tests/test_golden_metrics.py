"""Golden-metric training regression: a seed-fixed mini-run whose losses and
eval metrics are pinned to stored goldens, so numerics changes from perf work
(packed convs, layout/fusion changes, remat policies) are caught immediately.

Regenerate after an *intentional* numerics change:

    python tests/test_golden_metrics.py --regen

which rewrites ``tests/goldens/train_goldens.json``.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

GOLDEN_PATH = Path(__file__).parent / "goldens" / "train_goldens.json"
ATOL = 1e-3


def _run():
    import jax
    import jax.numpy as jnp

    from bodyct_dram_emph_subtype.models import get_model_by_name
    from bodyct_dram_emph_subtype.parallel.mesh import (
        MeshSpec, get_mesh, shard_batch)
    from bodyct_dram_emph_subtype.train import (
        TrainState, make_optimizer, make_reg_train_step)
    from bodyct_dram_emph_subtype.train.steps import make_eval_step
    from bodyct_dram_emph_subtype.utils.metrics_eval import (
        classification_report)
    from tests.test_learning import _synthetic_batch

    rng = np.random.RandomState(42)
    model = get_model_by_name("med3ddramtiny")
    tx = make_optimizer()
    mesh = get_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    step = make_reg_train_step(model, tx, num_data_shards=1, augment=True)
    eval_step = make_eval_step(model, "reg")

    batch = _synthetic_batch(rng)
    x0 = jnp.zeros((1, 16, 24, 32, 1), jnp.float32)
    variables = model.init(jax.random.PRNGKey(7), x0, x0, train=False)
    state = TrainState.create(dict(variables), tx)
    device_batch = shard_batch(mesh, batch)
    args = (jnp.asarray(1e-3), jnp.ones(6, jnp.float32) / 6,
            jnp.ones(3, jnp.float32) / 3)

    losses = {}
    for i in range(4):
        state, metrics, _ = step(state, device_batch, *args,
                                 jax.random.PRNGKey(100 + i))
        for k, v in metrics.items():
            losses.setdefault(k, []).append(round(float(v), 6))

    res = eval_step(state, device_batch)
    report = classification_report(np.asarray(res["cle_labels"]),
                                   np.asarray(res["pred_cle_labels"]), 6,
                                   prefix="cle_")
    report.update(classification_report(np.asarray(res["pse_labels"]),
                                        np.asarray(res["pred_pse_labels"]), 3,
                                        prefix="pse_"))
    return {"losses": losses,
            "eval": {k: round(float(v), 6) for k, v in report.items()}}


@pytest.mark.slow
def test_golden_training_metrics():
    assert GOLDEN_PATH.exists(), (
        f"goldens missing — run `python {__file__} --regen`")
    want = json.loads(GOLDEN_PATH.read_text())
    got = _run()
    for k, vals in want["losses"].items():
        np.testing.assert_allclose(
            got["losses"][k], vals, atol=ATOL,
            err_msg=f"train metric {k!r} drifted (regen goldens only for "
                    f"intentional numerics changes)")
    for k, v in want["eval"].items():
        np.testing.assert_allclose(
            got["eval"][k], v, atol=ATOL,
            err_msg=f"eval metric {k!r} drifted")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        sys.path.insert(0, str(Path(__file__).parent.parent))
        import os
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
        GOLDEN_PATH.parent.mkdir(parents=True, exist_ok=True)
        GOLDEN_PATH.write_text(json.dumps(_run(), indent=1))
        print(f"wrote {GOLDEN_PATH}")
    else:
        print(__doc__)
