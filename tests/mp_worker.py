"""Worker for the 2-process multi-host tests (spawned by
``test_multiprocess.py``; not collected by pytest).

Each process gets 2 virtual CPU devices (4 global), initializes
``jax.distributed`` against a localhost coordinator, then exercises the
multi-process data path end-to-end:

- ``shard_batch`` assembling per-process sub-batches into one global array
  (``jax.make_array_from_process_local_data``);
- one dRAM train step over the 4-device 'data' mesh (gradient psums across
  processes);
- ``process_local_data`` round-trip of the per-sample outputs;
- the ``process_allgather`` epoch-end branch (``train/loop.py::_epoch_end``).
"""
import os
import sys

PID = int(sys.argv[1])
NPROC = int(sys.argv[2])
PORT = sys.argv[3]
TMPDIR = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
# The collective timeout must cover per-process COMPILE skew: the Gloo
# rendezvous default of ~30 s fails when one process reaches its first
# collective minutes before the other (cold compile cache).
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_collective_timeout_seconds=600")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{PORT}",
                           num_processes=NPROC, process_id=PID)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bodyct_dram_emph_subtype.models.resnet3d import ResNetSegReg  # noqa: E402
from bodyct_dram_emph_subtype.parallel.mesh import (  # noqa: E402
    MeshSpec, get_mesh, process_local_data, shard_batch)
from bodyct_dram_emph_subtype.train import (  # noqa: E402
    TrainState, make_optimizer, make_reg_train_step)

assert jax.process_count() == NPROC, jax.process_count()
assert jax.local_device_count() == 2
assert jax.device_count() == 2 * NPROC

GLOBAL_BATCH = 4
LOCAL_BATCH = GLOBAL_BATCH // NPROC
D, H, W = 16, 32, 32

mesh = get_mesh(MeshSpec(data=4))
# 1-block-per-layer dRAM model: every sharding-relevant structure of the
# full med3ddram18 (stem, shortcut downsamples, dilated layers, decoder,
# masked pool) at a fraction of the CPU compile time
model = ResNetSegReg(layers=(1, 1, 1, 1))

# deterministic per-process sub-batch: process p holds rows [p*LB, (p+1)*LB)
rng = np.random.RandomState(0)
full = {
    "image": rng.randn(GLOBAL_BATCH, D, H, W).astype(np.float32),
    "lung_mask": np.ones((GLOBAL_BATCH, D, H, W), np.float32),
    "em_mask": (rng.rand(GLOBAL_BATCH, D, H, W) > 0.8).astype(np.float32),
    "cls_label": rng.randint(0, 6, GLOBAL_BATCH).astype(np.int32),
    "pse_label": rng.randint(0, 3, GLOBAL_BATCH).astype(np.int32),
}
local = {k: v[PID * LOCAL_BATCH:(PID + 1) * LOCAL_BATCH] for k, v in
         full.items()}

device_batch = shard_batch(mesh, local)
assert device_batch["image"].shape == (GLOBAL_BATCH, D, H, W), \
    device_batch["image"].shape

# global-array contents must equal the concatenation of the sub-batches
lbl = process_local_data(device_batch["cls_label"])
np.testing.assert_array_equal(lbl, local["cls_label"])
# volume-shaped arrays too: the multi-process heatmap draw extracts the
# batch-sharded dense maps row-wise with process_local_data
# (train/loop.py::evaluate) — row i must be THIS process's local row i
np.testing.assert_array_equal(process_local_data(device_batch["image"]),
                              local["image"])

x = jnp.zeros((1, D, H, W, 1), jnp.float32)
variables = model.init(jax.random.PRNGKey(0), x, x, train=False)
tx = make_optimizer()
state = TrainState.create(dict(variables), tx)
train_step = make_reg_train_step(model, tx, num_data_shards=4)

step_args = (state, device_batch, jnp.asarray(1e-4),
             jnp.ones(6, jnp.float32) / 6, jnp.ones(3, jnp.float32) / 3,
             jax.random.PRNGKey(1))
# AOT-compile BEFORE the first collective execution, then align on the
# COORDINATION-SERVICE barrier (configurable timeout): per-process compile
# times skew by minutes on a cold cache, and every Gloo collective —
# including jax's own sync_global_devices — gives peers only ~30 s to
# reach its rendezvous (observed: GetKeyValue() DEADLINE_EXCEEDED).
compiled_step = train_step.lower(*step_args).compile()
from jax._src import distributed as _dist  # noqa: E402

_dist.global_state.client.wait_at_barrier("mp_worker_compiled",
                                          timeout_in_ms=600_000)
state, metrics, preds = compiled_step(*step_args)
loss = float(metrics["loss"])
assert np.isfinite(loss), loss

# per-sample outputs come back out as my local rows
local_preds = {k: process_local_data(v) for k, v in preds.items()}
for k, v in local_preds.items():
    assert v.shape[0] == LOCAL_BATCH, (k, v.shape)

# the epoch-end allgather branch (train/loop.py::_epoch_end)
from jax.experimental import multihost_utils  # noqa: E402

gathered = np.asarray(multihost_utils.process_allgather(
    local_preds["pred_cle_labels"])).reshape(-1)
assert gathered.shape == (GLOBAL_BATCH,), gathered.shape

# losses agree across processes (same global step)
all_losses = np.asarray(multihost_utils.process_allgather(
    np.asarray([loss], np.float32))).reshape(-1)
assert np.allclose(all_losses, all_losses[0]), all_losses

with open(os.path.join(TMPDIR, f"ok_{PID}"), "w") as f:
    f.write(f"{loss:.6f}")
print(f"MP-OK pid={PID} loss={loss:.4f}", flush=True)
