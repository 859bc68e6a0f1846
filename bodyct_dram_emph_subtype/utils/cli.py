"""Small CLI helpers shared by the entry points."""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Tuple


REPO_ROOT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``$JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads
    the variable itself).  Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache``: the directory is part of the cache key, so it
    must not move between runs."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    path = str(REPO_ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def parse_size(value) -> Tuple[int, ...]:
    """Parse a size triple from CLI text: '(128,224,288)', '128,224,288',
    or '128 224 288'.  (The reference declares ``type=tuple`` which only
    works for the default value, ``train.py:30``.)"""
    if isinstance(value, (tuple, list)):
        return tuple(int(v) for v in value)
    nums = re.findall(r"-?\d+", str(value))
    if not nums:
        raise ValueError(f"cannot parse size from {value!r}")
    return tuple(int(n) for n in nums)


def parse_mesh(value):
    """Parse a mesh layout string like ``data=2,spatial=2,model=2`` into a
    :class:`~bodyct_dram_emph_subtype.parallel.mesh.MeshSpec`.

    Beyond-reference capability made user-reachable: the reference only
    ever data-parallelises (``--ngpus``, DDP); here the same CLI can also
    shard the volume's H axis ('spatial', XLA halo-exchanged convs) and the
    conv channels ('model', tensor parallelism)."""
    from ..parallel.mesh import MeshSpec

    if value is None or isinstance(value, MeshSpec):
        return value
    axes = {"data": 1, "spatial": 1, "model": 1}
    for part in str(value).split(","):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"(data|spatial|model)\s*=\s*(\d+)", part)
        if not m:
            raise ValueError(
                f"cannot parse mesh axis {part!r} (expected e.g. "
                f"'data=2,spatial=2,model=2')")
        axes[m.group(1)] = int(m.group(2))
    return MeshSpec(**axes)
