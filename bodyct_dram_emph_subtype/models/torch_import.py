"""Greedy torch-checkpoint import into the model zoo.

Gives parity with the reference's partial-checkpoint loading
(``load_state_dict_greedy``, ``utils.py:226-249``) plus the torch→JAX
name/layout mapping needed to load ``paper.ckpt``/``best.ckpt`` weights into
our NDHWC modules:

- Lightning prefixes ``model.`` are stripped (``models.py:408``);
- conv weights transpose OIDHW → DHWIO;
- ``bnX.weight/bias/running_mean/running_var`` map to the BatchNorm
  ``scale/bias`` params and ``mean/var`` batch stats;
- unknown / shape-mismatched entries are skipped with a warning, missing
  entries reported — greedy semantics, not strict.

``torch`` is only needed to unpickle ``.ckpt``/``.pth`` files; converted
numpy state dicts work without it.
"""
from __future__ import annotations

import logging
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_BN_ATTR = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"),
            "running_var": ("batch_stats", "var")}


def torch_key_to_flax_path(key: str) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """Map a reference state-dict key to (collection, variable path).

    Returns None for keys that have no counterpart
    (``num_batches_tracked``).
    """
    key = key.removeprefix("model.")
    if key.endswith("num_batches_tracked"):
        return None
    parts = key.split(".")

    def bn_leaf(attr, *prefix):
        coll, leaf = _BN_ATTR[attr]
        return coll, (*prefix, "bn", leaf)

    # stem ------------------------------------------------------------------
    if parts[0] == "conv1":
        return "params", ("trunk", "conv1", _conv_leaf(parts[1]))
    if parts[0] == "bn1":
        return bn_leaf(parts[1], "trunk", "bn1")
    # encoder layers --------------------------------------------------------
    m = re.fullmatch(r"layer(\d)", parts[0])
    if m:
        block = f"layer{m.group(1)}_{parts[1]}"
        sub = parts[2]
        if sub.startswith("conv"):
            return "params", ("trunk", block, sub, _conv_leaf(parts[3]))
        if sub.startswith("bn"):
            return bn_leaf(parts[3], "trunk", block, sub)
        if sub == "downsample":
            # shortcut type B: downsample.0 = 1x1x1 conv, downsample.1 = BN
            # (``med3d.py:250-260``) → ``downsample_b`` (scope 'downsample')
            if parts[3] == "0":
                return "params", ("trunk", block, "downsample", "conv",
                                  _conv_leaf(parts[4]))
            if parts[3] == "1":
                return bn_leaf(parts[4], "trunk", block, "downsample", "norm")
            return None
    # decoder ---------------------------------------------------------------
    m = re.fullmatch(r"us([12])", parts[0])
    if m:
        # usX.conv_blocks.<i>.<j>... : j=0 conv, j=1 bn
        idx, j = parts[2], parts[3]
        if len(parts) >= 5 and parts[1] == "conv_blocks":
            if j == "0":
                return "params", ("decoder", f"us{m.group(1)}", f"conv{idx}",
                                  _conv_leaf(parts[4]))
            if j == "1":
                return bn_leaf(parts[4], "decoder", f"us{m.group(1)}",
                               f"norm{idx}")
        return None
    if parts[0] == "us3":
        if parts[1] == "0":
            return "params", ("decoder", "us3_conv", _conv_leaf(parts[2]))
        if parts[1] == "1":
            return bn_leaf(parts[2], "decoder", "us3_bn")
    # heads -----------------------------------------------------------------
    if parts[0] == "fcs":
        return "params", (f"fc{parts[1]}", _conv_leaf(parts[2]))
    if parts[0] == "fc":
        return "params", ("fc", _conv_leaf(parts[1]))
    return None


def _conv_leaf(attr: str) -> str:
    return {"weight": "kernel", "bias": "bias"}[attr]


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    try:  # torch tensor without importing torch at module scope
        return v.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(v)


def convert_state_dict(state_dict: Mapping[str, Any], variables: Dict[str, Any]
                       ) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Greedily merge a torch state dict into ``variables``
    (= {'params': ..., 'batch_stats': ...}); returns (new_variables, report).
    """
    import jax

    flat = {"params": _flatten(variables.get("params", {})),
            "batch_stats": _flatten(variables.get("batch_stats", {}))}
    report = {"loaded": 0, "shape_mismatch": 0, "unexpected": 0, "missing": 0}
    hit = set()
    for key, value in state_dict.items():
        mapped = torch_key_to_flax_path(key)
        if mapped is None:
            continue
        coll, path = mapped
        if path not in flat[coll]:
            logger.warning("[torch_import] unexpected entry: %s", key)
            report["unexpected"] += 1
            continue
        arr = _to_numpy(value)
        if arr.ndim == 5:  # conv OIDHW → DHWIO
            arr = arr.transpose(2, 3, 4, 1, 0)
        target = flat[coll][path]
        if tuple(arr.shape) != tuple(target.shape):
            logger.warning("[torch_import] shape mismatch: %s %s vs %s",
                           key, arr.shape, target.shape)
            report["shape_mismatch"] += 1
            continue
        flat[coll][path] = arr.astype(np.asarray(target).dtype)
        hit.add((coll, path))
        report["loaded"] += 1
    for coll in ("params", "batch_stats"):
        for path in flat[coll]:
            if (coll, path) not in hit:
                logger.warning("[torch_import] missing entry: %s/%s", coll,
                               "/".join(path))
                report["missing"] += 1
    out = dict(variables)
    out["params"] = _unflatten(flat["params"])
    if "batch_stats" in variables:
        out["batch_stats"] = _unflatten(flat["batch_stats"])
    out = jax.tree.map(lambda x: x, out)  # re-materialize container types
    return out, report


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a torch ``.ckpt``/``.pth`` state dict — torch-free by default
    (first-party zip-serialization reader), falling back to ``torch.load``
    only for formats the reader doesn't cover (legacy torch<1.6 files)."""
    try:
        from ..data.torch_pickle import load_state_dict
        return load_state_dict(path)
    except (ValueError, KeyError, NotImplementedError) as exc:
        logger.info("first-party reader failed (%s); trying torch", exc)
        import torch

        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and "state_dict" in ckpt:
            ckpt = ckpt["state_dict"]
        return {k: _to_numpy(v) for k, v in ckpt.items()}


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: Dict[Tuple[str, ...], Any]):
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out
