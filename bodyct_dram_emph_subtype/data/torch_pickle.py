"""Torch-free reader for torch ``.pth``/``.ckpt`` files (zip serialization).

The reference ships torch-pickled artifacts everywhere: cached training
volumes (``{uid}.pth``, ``dataset.py:148``) and Lightning checkpoints
(``best.ckpt``/``paper.ckpt``).  This module reads them with only the
standard library + numpy, so neither the deployment image nor the
training stack needs a torch wheel.

Format (torch >= 1.6 zipfile serialization):
- ``<name>/data.pkl``      — a pickle whose tensors are persistent-id
  references ``('storage', <StorageType>, key, location, numel)``;
- ``<name>/data/<key>``    — raw little-endian storage bytes;
- ``torch._utils._rebuild_tensor_v2(storage, offset, size, stride, ...)``
  reconstructs views — mapped here onto numpy strided views.

bfloat16 storages load via ml_dtypes (shipped with JAX).
"""
from __future__ import annotations

import io
import pickle
import zipfile
from pathlib import Path
from typing import Any, Dict

import numpy as np

try:
    import ml_dtypes
    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BFLOAT16 = None

_STORAGE_DTYPES = {
    "FloatStorage": np.dtype("<f4"), "DoubleStorage": np.dtype("<f8"),
    "HalfStorage": np.dtype("<f2"), "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"), "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("<i1"), "ByteStorage": np.dtype("<u1"),
    "BoolStorage": np.dtype("bool"),
    "ComplexFloatStorage": np.dtype("<c8"),
    "ComplexDoubleStorage": np.dtype("<c16"),
}


class _StorageType:
    def __init__(self, name: str):
        self.name = name

    @property
    def dtype(self) -> np.dtype:
        if self.name == "BFloat16Storage":
            if _BFLOAT16 is None:
                raise NotImplementedError("bfloat16 needs ml_dtypes")
            return _BFLOAT16
        return _STORAGE_DTYPES[self.name]


def _rebuild_tensor_v2(storage: np.ndarray, storage_offset, size, stride,
                       requires_grad=False, backward_hooks=None,
                       metadata=None) -> np.ndarray:
    flat = storage[storage_offset:]
    if not size:
        return flat[:1].reshape(()).copy()
    itemsize = flat.dtype.itemsize
    byte_strides = tuple(s * itemsize for s in stride)
    view = np.lib.stride_tricks.as_strided(flat, shape=tuple(size),
                                           strides=byte_strides)
    return np.ascontiguousarray(view)


def _rebuild_tensor(storage, storage_offset, size, stride):
    return _rebuild_tensor_v2(storage, storage_offset, size, stride)


class _Unpickler(pickle.Unpickler):
    """Maps torch classes onto numpy equivalents, resolves storages."""

    def __init__(self, file, archive: zipfile.ZipFile, prefix: str):
        super().__init__(file)
        self._archive = archive
        self._prefix = prefix

    def find_class(self, module: str, name: str):
        if module == "torch._utils" and name in ("_rebuild_tensor_v2",
                                                 "_rebuild_tensor"):
            return {"_rebuild_tensor_v2": _rebuild_tensor_v2,
                    "_rebuild_tensor": _rebuild_tensor}[name]
        if module == "torch" and name.endswith("Storage"):
            return _StorageType(name)
        if module == "torch.serialization" and name == "_get_layout":
            return lambda *_: None
        if (module, name) == ("torch._utils", "_rebuild_parameter"):
            return lambda data, requires_grad=True, hooks=None: data
        if (module, name) == ("collections", "OrderedDict"):
            import collections
            return collections.OrderedDict
        if module.startswith("torch"):
            # container/dtype stubs: good enough for state dicts + metadata
            return _TorchStub(f"{module}.{name}")
        return super().find_class(module, name)

    def persistent_load(self, pid):
        kind, storage_type, key, location, numel = pid
        assert kind == "storage", f"unknown persistent id {kind!r}"
        dtype = storage_type.dtype
        name = f"{self._prefix}/data/{key}"
        raw = self._archive.read(name)
        return np.frombuffer(raw, dtype=dtype, count=int(numel)).copy()


class _TorchStub:
    """Placeholder for torch classes irrelevant to weight extraction
    (dtypes, size objects, Lightning metadata)."""

    def __init__(self, qualname: str, *args, **kwargs):
        self.qualname = qualname
        self.args = args

    def __call__(self, *args, **kwargs):
        return _TorchStub(self.qualname, *args)

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return f"<torch stub {self.qualname}>"


def load_torch_file(path) -> Any:
    """Load a torch zip-serialized file; tensors come back as numpy arrays."""
    path = Path(path)
    with zipfile.ZipFile(path) as zf:
        pkl_names = [n for n in zf.namelist() if n.endswith("/data.pkl")]
        if not pkl_names:
            raise ValueError(f"{path} is not a torch zip-serialized file "
                             "(legacy torch<1.6 format is unsupported)")
        prefix = pkl_names[0][:-len("/data.pkl")]
        with zf.open(pkl_names[0]) as f:
            unpickler = _Unpickler(io.BytesIO(f.read()), zf, prefix)
            return unpickler.load()


def load_state_dict(path) -> Dict[str, np.ndarray]:
    """Load and flatten a checkpoint to {name: array}, unwrapping Lightning's
    ``{'state_dict': ...}`` envelope (``test.py:69-71``)."""
    obj = load_torch_file(path)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, np.ndarray)}
