#!/usr/bin/env python
"""Model complexity probes — FLOPs / params / memory per architecture.

Replaces the reference's two probe scripts
(``compute_computation_complexity_proposed.py`` — a profiled training fit —
and ``compute_computation_complexity_resnet.py`` — ptflops MACs for MONAI
resnets) with the XLA-native equivalent:
``jit(...).lower().compile().cost_analysis()`` gives compiler-counted FLOPs
and bytes for the exact program that runs on the device.

Usage:
  python tools/compute_computation_complexity.py [--archs med3d,med3ddram50]
      [--target_size 128,224,288] [--batch 1] [--cpu]
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _resnet_macs_params(depth: int, ndim: int, in_shape,
                        n_classes: int = 400):
    """Analytic MACs/params of a standard torchvision-convention ResNet
    (the architecture family behind the reference's MONAI baselines,
    ``compute_computation_complexity_resnet.py:1-7``) at arbitrary spatial
    rank — conv7 stride-2 stem, maxpool3 stride-2, BasicBlock for 18/34 /
    Bottleneck for 50, type-B (1x1-conv) downsample shortcuts, global pool
    + FC.  Counts conv/FC multiply-accumulates only (the ptflops
    convention is MACs-dominated by the same terms; BN/ReLU add <1%)."""
    import math
    cfg = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
           50: ("bottleneck", (3, 4, 6, 3))}[depth]
    kind, blocks = cfg
    exp = 4 if kind == "bottleneck" else 1
    cin, *spatial = in_shape
    macs = params = 0

    def conv(cin, cout, k, stride, spatial):
        nonlocal macs, params
        out_sp = [math.ceil(s / stride) for s in spatial]
        n_out = 1
        for s in out_sp:
            n_out *= s
        macs += n_out * cout * cin * k ** ndim
        params += cout * cin * k ** ndim + 2 * cout   # + BN affine
        return out_sp

    spatial = conv(cin, 64, 7, 2, spatial)                    # stem
    spatial = [math.ceil(s / 2) for s in spatial]             # maxpool
    c = 64
    for i, nb in enumerate(blocks):
        planes = 64 * 2 ** i
        cout = planes * exp
        for b in range(nb):
            stride = 2 if (i > 0 and b == 0) else 1
            if kind == "basic":
                sp = conv(c, planes, 3, stride, spatial)
                sp = conv(planes, planes, 3, 1, sp)
            else:
                sp = conv(c, planes, 1, 1, spatial)
                sp = conv(planes, planes, 3, stride, sp)
                sp = conv(planes, cout, 1, 1, sp)
            if b == 0 and (stride != 1 or c != cout):
                conv(c, cout, 1, stride, spatial)             # shortcut B
            spatial, c = sp, cout
    macs += c * n_classes                                     # FC
    params += c * n_classes + n_classes
    return macs, params


def external_baseline_table():
    """The reference's MONAI-resnet comparison rows
    (``compute_computation_complexity_resnet.py:9-43``): resnet18/34/50 at
    (3, 224, 224[, 224]) in 2D and 3D, MACs + params."""
    rows = []
    for ndim, shape in ((3, (3, 224, 224, 224)), (2, (3, 224, 224))):
        for depth in (18, 34, 50):
            macs, params = _resnet_macs_params(depth, ndim, shape)
            rows.append({"arch": f"resnet{depth}_{ndim}d (baseline)",
                         "params_M": round(params / 1e6, 2),
                         "gmacs": round(macs / 1e9, 1),
                         "input": list(shape)})
    return rows


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--archs", default="med3d18,med3d,med3d50,"
                        "med3ddram18,med3ddram,med3ddram50")
    parser.add_argument("--target_size", default="128,224,288")
    parser.add_argument("--batch", default=1, type=int)
    parser.add_argument("--train", action="store_true",
                        help="probe the training step instead of inference")
    parser.add_argument("--compare", action="store_true",
                        help="append the reference-style external baseline "
                             "table (standard resnet18/34/50, 2D and 3D at "
                             "224, analytic MACs — the MONAI/ptflops rows of "
                             "compute_computation_complexity_resnet.py)")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()

    if args.cpu:
        import os
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from bodyct_dram_emph_subtype.models import get_model_by_name
    from bodyct_dram_emph_subtype.utils.cli import parse_size

    size = parse_size(args.target_size)
    shape = (args.batch, *size, 1)
    rows = []
    for arch in args.archs.split(","):
        model = get_model_by_name(arch)
        x = jnp.zeros(shape, jnp.float32)
        variables = jax.eval_shape(
            lambda k: model.init(k, x, x, train=False), jax.random.PRNGKey(0))
        n_params = sum(int(np.prod(l.shape)) for l in
                       jax.tree.leaves(variables["params"]))

        if args.train:
            # probe the full training step (fwd+bwd+update), the analog of
            # the reference's profiled-fit probe
            # (compute_computation_complexity_proposed.py)
            from bodyct_dram_emph_subtype.train import (
                TrainState, make_optimizer, make_reg_train_step,
                make_cls_train_step)
            tx = make_optimizer()
            state = jax.eval_shape(
                lambda v: TrainState.create(dict(v), tx), variables)
            make = (make_reg_train_step if "reg" in type(model).__name__.lower()
                    else make_cls_train_step)
            step = make(model, tx, 1)
            batch = {"image": jnp.zeros((args.batch, *size), jnp.float32),
                     "lung_mask": jnp.ones((args.batch, *size), jnp.float32),
                     "em_mask": jnp.zeros((args.batch, *size), jnp.float32),
                     "cls_label": jnp.zeros((args.batch,), jnp.int32),
                     "pse_label": jnp.zeros((args.batch,), jnp.int32)}
            lowered = step.lower(state, batch, jnp.asarray(1e-4),
                                 jnp.ones(6), jnp.ones(3),
                                 jax.random.PRNGKey(0))
        else:
            def fwd(v, x, l):
                return model.apply(v, x, l, train=False)

            lowered = jax.jit(fwd).lower(variables, x, x)
        try:
            cost = lowered.compile().cost_analysis()
            flops = cost.get("flops", float("nan"))
            bytes_accessed = cost.get("bytes accessed", float("nan"))
        except Exception as exc:  # cost analysis is backend-dependent
            flops, bytes_accessed = float("nan"), float("nan")
        rows.append({"arch": arch, "params_M": round(n_params / 1e6, 2),
                     "gflops": round(flops / 1e9, 1),
                     "gmacs": round(flops / 2e9, 1),
                     "gbytes_accessed": round(bytes_accessed / 1e9, 2),
                     "input": list(shape)})
        print(json.dumps(rows[-1]))
    if args.compare:
        for row in external_baseline_table():
            rows.append(row)
            print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
