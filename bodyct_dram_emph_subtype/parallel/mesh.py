"""Device-mesh and sharding utilities — the distributed backbone.

The reference's distributed story is single-node DDP data parallelism over
gloo/nccl (``train.py:70``, ``test.py:60``) with SyncBatchNorm and an
explicit ``cat_all_gather`` for epoch metrics (``utils.py:66-80``).

Replacement (single-controller GSPMD):
- a ``jax.sharding.Mesh`` over ('data', 'spatial');
- the global batch is sharded over 'data' → gradient psums are inserted by
  XLA (DDP allreduce equivalent);
- activations can additionally be sharded over 'spatial' along H — XLA
  inserts halo exchanges for the 3-D convs, which is how a single volume
  scales past one card's memory (the reference has no analog);
- BatchNorm reduces over the sharded batch dim → cross-replica stats ==
  ``sync_batchnorm=True`` for free;
- epoch metrics: arrays come out of jit globally; across *processes* use
  ``multihost_utils.process_allgather`` (the ``cat_all_gather`` analog).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Mesh layout: ``data`` replicas x ``spatial`` shards (volume H axis)
    x ``model`` shards (conv channel axis, tensor parallelism)."""
    data: int = 1
    spatial: int = 1
    model: int = 1

    @property
    def size(self):
        return self.data * self.spatial * self.model


def get_mesh(spec: Optional[MeshSpec] = None,
             devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ('data', 'spatial', 'model') mesh.  Defaults to all devices
    on the data axis — plain DP, the reference's only strategy."""
    devices = list(devices if devices is not None else jax.devices())
    if spec is None:
        spec = MeshSpec(data=len(devices))
    if spec.size != len(devices):
        raise ValueError(f"mesh {spec} needs {spec.size} devices, "
                         f"got {len(devices)}")
    arr = np.asarray(devices).reshape(spec.data, spec.spatial, spec.model)
    return Mesh(arr, ("data", "spatial", "model"))


def shard_params_tp(mesh: Mesh, tree):
    """Tensor-parallel parameter placement: conv kernels (and their
    channel-wise affine/bias/stats companions) shard the output-channel dim
    over 'model'; everything else replicates.  Under GSPMD jit, activations
    become channel-sharded after each conv and XLA inserts the collectives
    (this is the scaling-book recipe: annotate, let the compiler do the
    comms)."""
    n_model = mesh.shape["model"]

    def place(x):
        shape = np.shape(x)
        if n_model > 1 and len(shape) >= 1 and shape[-1] % n_model == 0 \
                and shape[-1] >= n_model:
            spec = [None] * (len(shape) - 1) + ["model"]
            return jax.device_put(x, NamedSharding(mesh, P(*spec)))
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree.map(place, tree)


def batch_sharding(mesh: Mesh, spatial_axis: Optional[int] = 2
                   ) -> NamedSharding:
    """Sharding for (B, D, H, W[, C]) batches: B over 'data', H over
    'spatial' (when the mesh has a spatial extent).  Trailing axes in the
    PartitionSpec are implicitly replicated, so the same spec serves rank-4
    and rank-5 values."""
    if mesh.shape["spatial"] > 1 and spatial_axis is not None:
        spec = [None] * (spatial_axis + 1)
        spec[0] = "data"
        spec[spatial_axis] = "spatial"
        return NamedSharding(mesh, P(*spec))
    return NamedSharding(mesh, P("data"))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def process_local_data(x) -> np.ndarray:
    """Per-process slice of a batch-sharded global array — the inverse of
    :func:`shard_batch` for jit outputs (predictions, per-sample metrics).

    Multi-process jax.Arrays are not fully addressable, so ``np.asarray``
    would raise; instead the unique batch rows owned by this process's
    devices are concatenated in global order.  Assumes sharding only over
    axis 0 (replicated across 'spatial'/'model' — true for the per-sample
    outputs the train/eval steps emit).  Single-process: the whole array.
    """
    if jax.process_count() == 1:
        return np.asarray(x)
    parts = {}
    for shard in x.addressable_shards:
        index = shard.index
        start = (index[0].start or 0) if index else 0
        if start not in parts:
            parts[start] = np.asarray(shard.data)
    return np.concatenate([parts[s] for s in sorted(parts)], axis=0)


def shard_batch(mesh: Mesh, batch_tree):
    """Device-put a host batch with batch-dim sharding (leaves with a batch
    dim) — the host→device transfer of the input pipeline.

    Single-process: a plain ``device_put`` onto the mesh-wide sharding.
    Multi-process (``jax.distributed``): each process holds only its own
    sub-batch, so leaves go through
    ``jax.make_array_from_process_local_data`` — the per-process shards
    assemble into one global jax.Array (the DDP input contract,
    reference ``train.py:70,103``).  The local batch must then be
    ``global_batch / process_count`` (see ``SubtypeTrainer._loader``).
    """
    sharding_nd = batch_sharding(mesh)
    sharding_1d = NamedSharding(mesh, P("data"))
    multiprocess = jax.process_count() > 1

    def fit(sharding, shape):
        """Drop mesh axes that don't divide their dim (JAX rejects uneven
        shardings at device_put/jit boundaries): the leaf is then simply
        replicated along that axis — correct, just less parallel.  Warns
        once per (axis, dim) so a silent perf cliff is visible."""
        spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
        changed = False
        for d, name in enumerate(spec):
            if name is None:
                continue
            extent = mesh.shape[name]
            if extent > 1 and shape[d] % extent != 0:
                logger.warning(
                    "dim %d (size %d) not divisible by mesh axis %r (=%d); "
                    "replicating that dim instead", d, shape[d], name, extent)
                spec[d] = None
                changed = True
        if not changed:
            return sharding
        while spec and spec[-1] is None:
            spec.pop()
        return NamedSharding(mesh, P(*spec))

    def put(x):
        x = np.asarray(x)
        sharding = sharding_nd if x.ndim >= 4 else sharding_1d
        if multiprocess:
            # batch axis spans processes; all other axes are process-local
            # (get_mesh enumerates devices data-major, so each data row's
            # spatial x model block lives inside one process).  Divisibility
            # is judged on the GLOBAL shape — the local sub-batch is
            # 1/process_count of the batch dim by construction.
            global_shape = (x.shape[0] * jax.process_count(),) + x.shape[1:]
            sharding = fit(sharding, global_shape)
            return jax.make_array_from_process_local_data(sharding, x,
                                                          global_shape)
        sharding = fit(sharding, x.shape)
        return jax.device_put(x, sharding)

    return jax.tree.map(put, batch_tree)
