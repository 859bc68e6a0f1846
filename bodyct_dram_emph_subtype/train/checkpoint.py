"""Checkpointing: every-epoch saves, auto-resume, greedy reload.

Parity targets:
- ``ModelCheckpoint(save_top_k=-1, every_n_epochs=1)`` → a
  :class:`CheckpointManager` that keeps every epoch (``train.py:92-99``);
- auto-resume from the newest checkpoint (``train.py:77-91``);
- ``--reload_only_weights`` greedy weights-only restore tolerating missing /
  mismatched entries (``utils.py:226-249``), including torch ``.ckpt``/
  ``.pth`` files via the torch-import converter.

An epoch is one ``epoch_<n>.npz`` holding the leaves of
``{"state": train_state, "extras": {...}}`` keyed by their tree paths.  It
is written to a temporary file and renamed into place, so a checkpoint is
either whole or absent.
"""
from __future__ import annotations

import logging
import os
import re
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np

from ..models.torch_import import convert_state_dict, load_torch_checkpoint

logger = logging.getLogger(__name__)

_EPOCH_FILE = re.compile(r"epoch_(\d+)\.npz")


def _default_extras() -> Dict[str, Any]:
    # a uniform on-disk tree, so restores never need structure-dependent
    # templates
    return {"cle_class_weights": np.zeros(6), "pse_class_weights": np.zeros(3)}


def _flat(tree) -> Dict[str, Any]:
    return {jax.tree_util.keystr(path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


class CheckpointManager:
    """Save ``{state, extras}`` per epoch under ``directory``; keep every
    epoch."""

    def __init__(self, directory):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, epoch: int) -> Path:
        return self.directory / f"epoch_{int(epoch)}.npz"

    def save(self, epoch: int, state, extras: Optional[Dict[str, Any]] = None):
        payload = {"state": jax.device_get(state),
                   "extras": extras if extras is not None
                   else _default_extras()}
        arrays = {k: np.asarray(v) for k, v in _flat(payload).items()}
        fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(epoch))
        except BaseException:
            Path(tmp).unlink(missing_ok=True)
            raise

    def epochs(self):
        return sorted(int(m.group(1)) for m in
                      map(_EPOCH_FILE.fullmatch,
                          os.listdir(self.directory)) if m)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, state_template, epoch: Optional[int] = None,
                extras_template: Optional[Dict[str, Any]] = None
                ) -> Tuple[Any, Dict[str, Any], int]:
        """Read ``epoch`` (default: the newest) into the structure of the
        templates.  Leaves whose template is a ``jax.Array`` come back on
        that template's devices and sharding."""
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        template = {"state": state_template,
                    "extras": extras_template if extras_template is not None
                    else _default_extras()}
        paths, treedef = jax.tree_util.tree_flatten_with_path(template)
        with np.load(self._path(epoch)) as z:
            leaves = []
            for path, like in paths:
                value = z[jax.tree_util.keystr(path)]
                if value.shape != np.shape(like):
                    raise ValueError(
                        f"checkpoint leaf {jax.tree_util.keystr(path)} has "
                        f"shape {value.shape}, expected {np.shape(like)}")
                value = value.astype(like.dtype if hasattr(like, "dtype")
                                     else np.asarray(like).dtype)
                if isinstance(like, jax.Array):
                    value = jax.device_put(value, like.sharding)
                leaves.append(value)
        restored = jax.tree_util.tree_unflatten(treedef, leaves)
        return restored["state"], restored["extras"], int(epoch)


def greedy_restore_variables(variables: Dict[str, Any], ckpt_path: str
                             ) -> Dict[str, Any]:
    """Weights-only greedy reload from a torch ``.ckpt``/``.pth`` or an
    ``.npz`` of flat arrays; name+shape matching, mismatches skipped with
    warnings (reference ``load_state_dict_greedy``, ``utils.py:226-249``)."""
    path = Path(ckpt_path)
    if path.suffix in (".ckpt", ".pth", ".pt"):
        state_dict = load_torch_checkpoint(str(path))
    elif path.suffix == ".npz":
        with np.load(path) as z:
            state_dict = {k: z[k] for k in z.files}
    else:
        raise ValueError(f"unsupported weights file: {path}")
    new_vars, report = convert_state_dict(state_dict, dict(variables))
    logger.info("[greedy_restore] %s", report)
    return new_vars
