"""Model goldens: the variable tree of every registered architecture, and
the eval / train-mode outputs and ``batch_stats`` updates of four of them
with weights filled deterministically by path.

The goldens pin the checkpoint layout (``params``/``batch_stats`` paths
and shapes are what ``best.ckpt`` import, ``.npz`` weights and the torch
converter address) and the numerics of the forward.  Regenerate with
``python tests/test_model_goldens.py --record`` only for a deliberate
change of the model.
"""
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bodyct_dram_emph_subtype.models import get_model_by_name
from bodyct_dram_emph_subtype.models.registry import _FACTORIES

GOLDENS = Path(__file__).parent / "goldens" / "model_goldens.json"
INPUT = (1, 16, 32, 32, 1)
OUTPUT_ARCHS = ("med3ddramtiny", "med3dtiny", "med3ddram18", "med3d18")
N_SAMPLES = 24  # sampled values per array


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _unflatten(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _init_shapes(model):
    x = jax.ShapeDtypeStruct(INPUT, jnp.float32)
    if isinstance(getattr(model, "n_classes", None), int):  # plain ResNet
        fn = lambda k, x: model.init(k, x, train=False)  # noqa: E731
    else:
        fn = lambda k, x: model.init(k, x, x, train=False)  # noqa: E731
    return jax.eval_shape(fn, jax.random.PRNGKey(0), x)


def tree_golden(model):
    return {p: list(v.shape) for p, v in _paths(_init_shapes(model))}


def fill_variables(shapes):
    """Deterministic weights by path: the same path always gets the same
    values, independent of the order in which a model declares them."""
    flat = {}
    for path, shape in sorted(shapes.items()):
        rng = np.random.default_rng(zlib.crc32(path.encode()))
        leaf = path.rsplit("/", 1)[-1]
        n = rng.standard_normal(shape).astype(np.float32)
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = n * np.float32(np.sqrt(2.0 / fan_in))
        elif leaf == "scale":
            v = 1.0 + 0.1 * n
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:  # bias, mean
            v = 0.1 * n
        flat[path] = jnp.asarray(v, jnp.float32)
    return _unflatten(flat)


def _inputs():
    rng = np.random.default_rng(1234)
    x = rng.standard_normal(INPUT).astype(np.float32)
    lungs = (rng.random(INPUT) > 0.3).astype(np.float32)
    return jnp.asarray(x), jnp.asarray(lungs)


def summarize(a, key):
    a = np.asarray(a, np.float64).ravel()
    idx = np.random.default_rng(zlib.crc32(key.encode())).choice(
        a.size, min(N_SAMPLES, a.size), replace=False)
    return {"n": int(a.size), "sum": float(a.sum()),
            "abs_sum": float(np.abs(a).sum()),
            "idx": idx.tolist(), "val": a[idx].tolist()}


def output_golden(arch):
    model = get_model_by_name(arch)
    variables = fill_variables(tree_golden(model))
    x, lungs = _inputs()
    out = {}
    with jax.default_matmul_precision("highest"):
        dense, heads = model.apply(variables, x, lungs, train=False)
        (dense_t, heads_t), mutated = model.apply(
            variables, x, lungs, train=True, mutable=["batch_stats"])
    for mode, (d, h) in (("eval", (dense, heads)),
                         ("train", (dense_t, heads_t))):
        for i, a in enumerate(d):
            out[f"{mode}/dense{i}"] = summarize(a, f"{mode}/dense{i}")
        for i, a in enumerate(h):
            out[f"{mode}/head{i}"] = summarize(a, f"{mode}/head{i}")
    for p, a in _paths(mutated["batch_stats"]):
        out[f"batch_stats/{p}"] = summarize(a, f"batch_stats/{p}")
    return out


def init_golden(arch):
    """Summaries of ``model.init`` with a fixed key: initial weights are
    drawn per parameter path from the root key, so a checkpoint-free
    training run starts from the same point on every version."""
    model = get_model_by_name(arch)
    x, lungs = _inputs()
    variables = model.init(jax.random.PRNGKey(0), x, lungs, train=False)
    return {f"{c}/{p}": summarize(a, f"init/{c}/{p}")
            for c in ("params", "batch_stats")
            for p, a in _paths(variables[c])}


def _load():
    return json.loads(GOLDENS.read_text())


@pytest.mark.parametrize("factory", sorted(_FACTORIES))
def test_variable_tree_matches_golden(factory):
    want = _load()["trees"][factory]
    got = tree_golden(get_model_by_name(factory))
    assert sorted(got) == sorted(want)
    for path, shape in want.items():
        assert got[path] == shape, path


def _check(got, want):
    assert got["n"] == want["n"]
    # float32 on the CPU: the same graph, sums reassociated at most
    np.testing.assert_allclose(got["val"], want["val"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["sum"], want["sum"], rtol=2e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["abs_sum"], want["abs_sum"], rtol=2e-4,
                               atol=1e-3)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("arch", OUTPUT_ARCHS)
def test_outputs_match_golden(arch, mode):
    want = _load()["outputs"][arch]
    got = output_golden(arch)
    keys = [k for k in want if k.startswith(mode + "/")
            or (mode == "train" and k.startswith("batch_stats/"))]
    assert keys
    assert sorted(k for k in got if k in keys) == sorted(keys)
    for k in keys:
        assert got[k]["idx"] == want[k]["idx"], k
        _check(got[k], want[k])


def test_init_matches_golden():
    want = _load()["init"]["med3ddramtiny"]
    got = init_golden("med3ddramtiny")
    assert sorted(got) == sorted(want)
    for k in want:
        _check(got[k], want[k])


if __name__ == "__main__" and "--record" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    data = {"input": list(INPUT),
            "trees": {f: tree_golden(get_model_by_name(f))
                      for f in sorted(_FACTORIES)},
            "outputs": {a: output_golden(a) for a in OUTPUT_ARCHS},
            "init": {a: init_golden(a) for a in ("med3ddramtiny",)}}
    GOLDENS.write_text(json.dumps(data, indent=0, sort_keys=True) + "\n")
    print("wrote", GOLDENS)
