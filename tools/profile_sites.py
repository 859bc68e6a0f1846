#!/usr/bin/env python
"""Device time per model stage from a ``jax.profiler`` trace, with each
stage's share of the card's roofline.

    python tools/profile_sites.py --out profile_out   # on the GPU

Traces the ``med3ddram`` bf16 eval forward (B=4, 128×224×288) and one bf16
train step (B=4, remat "all", augmentation on), then attributes every
device kernel to the model stage whose ``jax.named_scope`` (stem, layer1..4,
us1..us3, heads) its HLO op carries, and prints one JSON line per program:
steady time, device busy time per stage, and for the stages that hand-
written kernels once served, the least time the card could take (FLOPs over
peak or bytes over bandwidth, whichever bounds) over the measured time.
"""
from __future__ import annotations

import argparse
import glob
import json
import re
import subprocess
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                                   "bytes_per_s": 3.35e12}}
SCOPES = ("stem", "maxpool", "layer1", "layer2", "layer3", "layer4", "us1",
          "us2", "us3", "heads", "masked_pool")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_HEADER = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")


_SCOPE = re.compile(r"(?<![\w])(" + "|".join(SCOPES) + r")(?![\w])")


def _scope_of(op_name: str):
    """The innermost stage in an op name such as
    ``jit(step)/transpose(jvp(layer2))/jvp(layer2)/checkpoint/add``."""
    found = _SCOPE.findall(op_name)
    return found[-1] if found else None


def op_scopes(hlo_text: str) -> dict:
    """HLO instruction name → model stage, from the op metadata of a
    compiled module's text.  A fusion carries no metadata of its own; it
    takes the stage most of its fused computation's instructions carry."""
    comp_votes = defaultdict(Counter)
    instrs = []                  # (name, own scope, called computation)
    comp = None
    for line in hlo_text.splitlines():
        header = _HEADER.match(line)
        if header and " = " not in line:
            comp = header.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        op = _OP_NAME.search(line)
        scope = _scope_of(op.group(1)) if op else None
        if scope:
            comp_votes[comp][scope] += 1
        calls = _CALLS.search(line)
        instrs.append((m.group(1), scope, calls.group(1) if calls else None))
    out = {}
    for name, scope, called in instrs:
        if scope is None and called in comp_votes:
            scope = comp_votes[called].most_common(1)[0][0]
        out[name] = scope or "other"
    return out


def device_time_by_scope(xplane: str, scopes: dict, plane_prefix: str,
                         module: str) -> dict:
    """Device time (µs) per stage of the HLO module ``module``, from the
    events with an ``hlo_op`` on planes named ``plane_prefix...``.  Where a
    plane has an "XLA Ops" line (one event per HLO op) only that line
    counts, so kernels are not counted twice.  ``busy_us`` is the union of
    the counted intervals."""
    import jax
    per_line = defaultdict(list)
    data = jax.profiler.ProfileData.from_file(xplane)
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if "hlo_op" not in stats or module not in str(
                        stats.get("hlo_module", "")):
                    continue
                per_line[line.name].append(
                    (ev.start_ns, ev.end_ns, str(stats["hlo_op"])))
    lines = ["XLA Ops"] if "XLA Ops" in per_line else list(per_line)
    events = [e for name in lines for e in per_line[name]]
    totals = defaultdict(float)
    for s, e, op in events:
        totals[scopes.get(op, "other")] += (e - s) / 1e3
    busy, end = 0.0, -1.0
    for s, e, _ in sorted(events):
        if e > end:
            busy += e - max(s, end)
            end = e
    totals["busy_us"] = busy / 1e3
    totals["lines"] = sorted(per_line)
    return dict(totals)


def site_costs(batch: int, size=(128, 224, 288), blocks1: int = 3):
    """(FLOPs, bytes) each site needs, from its shapes (bf16 activations,
    unfused: every conv reads its input and weights and writes its
    output)."""
    d, h, w = (s // 2 for s in size)            # stem / decoder resolution
    half = batch * d * h * w
    quarter = half // 8                         # after the stem max-pool

    def conv(n_out, cin, cout, k=3):
        flops = 2.0 * n_out * cout * cin * k ** 3
        return flops, 2.0 * (n_out * cin + n_out * cout + k ** 3 * cin * cout)

    def add(*costs):
        return tuple(sum(c[i] for c in costs) for i in range(2))

    return {
        "stem_maxpool": (27.0 * quarter * 64, 2.0 * (half + quarter) * 64),
        "layer1": add(*[conv(quarter, 64, 64)] * (2 * blocks1)),
        "us2_convs": add(conv(half, 128, 64), conv(half, 64, 64)),
        "us3_conv": conv(half, 64, 32),
        # two f32 sigmoid maps and the f32 lung mask read once
        "masked_reduction": (4.0 * half, 4.0 * 3 * half),
    }


def profile(out: Path, batch: int = 4, size=(128, 224, 288),
            plane_prefix: str = "/device:GPU", arch: str = "med3ddram"):
    """Compile, time (median of 5) and trace (2 calls) the eval forward and
    one train step; device time per stage per call."""
    import jax
    import jax.numpy as jnp

    from bodyct_dram_emph_subtype.models import get_model_by_name
    from bodyct_dram_emph_subtype.train import (TrainState, make_optimizer,
                                                make_reg_train_step)

    shape = (batch, *size)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(shape, np.float32))[..., None]
    lungs = jnp.ones(shape + (1,), jnp.float32)
    fwd_model = get_model_by_name(arch, dtype=jnp.bfloat16)
    xs = jnp.zeros((1, 16, 32, 32, 1), jnp.float32)
    variables = jax.jit(lambda k: fwd_model.init(k, xs, xs, train=False))(
        jax.random.PRNGKey(0))

    fwd = jax.jit(lambda v, x, l: fwd_model.apply(v, x, l, train=False))
    train_model = get_model_by_name(arch, dtype=jnp.bfloat16, remat="all")
    tx = make_optimizer()
    step = make_reg_train_step(train_model, tx, 1, donate=True)
    batch_in = {"image": x[..., 0], "lung_mask": lungs[..., 0],
                "em_mask": (x[..., 0] < -1.0).astype(jnp.float32),
                "cls_label": jnp.arange(batch, dtype=jnp.int32) % 6,
                "pse_label": jnp.arange(batch, dtype=jnp.int32) % 3}
    sargs = (jnp.float32(1e-4), jnp.ones(6) / 6, jnp.ones(3) / 3,
             jax.random.PRNGKey(1))
    state = TrainState.create(dict(variables), tx)

    reports = {}
    for name, jitted, args in (
            ("eval_forward", fwd, (variables, x, lungs)),
            ("train_step", step, (state, batch_in, *sargs))):
        t0 = time.perf_counter()
        compiled = jitted.lower(*args).compile()
        t_compile = time.perf_counter() - t0
        box = list(args)

        def run():
            res = compiled(*box)
            if name == "train_step":        # the step donates its state
                box[0] = res[0]
            return res

        jax.block_until_ready(run())
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            times.append((time.perf_counter() - t0) * 1e3)
        with jax.profiler.trace(str(out / name)):
            for _ in range(2):
                res = run()
            jax.block_until_ready(res)
        xplane = glob.glob(str(out / name / "**" / "*.xplane.pb"),
                           recursive=True)[0]
        hlo = compiled.as_text()
        module = re.search(r"HloModule\s+([\w.\-]+)", hlo).group(1)
        by_scope = device_time_by_scope(xplane, op_scopes(hlo), plane_prefix,
                                        module)
        lines = by_scope.pop("lines")
        reports[name] = {
            "compile_s": round(t_compile, 2),
            "steady_ms": [round(t, 3) for t in times],
            "median_ms": round(float(np.median(times)), 3),
            "device_us_per_call": {k: round(v / 2, 1)
                                   for k, v in sorted(by_scope.items())},
            "trace_lines": lines,
            "temp_bytes": compiled.memory_analysis().temp_size_in_bytes,
        }
    stats = jax.devices()[0].memory_stats() or {}
    reports["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return reports


def roofline(reports, kind: str, batch: int, size):
    """Least possible time / measured device time for each former kernel
    site of the eval forward."""
    peak = PEAKS[kind]
    dev = reports["eval_forward"]["device_us_per_call"]
    measured = {"stem_maxpool": dev.get("maxpool"),
                "layer1": dev.get("layer1"),
                "us2_convs": dev.get("us2"), "us3_conv": dev.get("us3"),
                "masked_reduction": dev.get("masked_pool")}
    out = {}
    for site, (flops, nbytes) in site_costs(batch, size).items():
        t_flops = flops / peak["bf16_flops"] * 1e6
        t_bytes = nbytes / peak["bytes_per_s"] * 1e6
        out[site] = {"flops": flops, "bytes": nbytes,
                     "bound": "compute" if t_flops > t_bytes else "memory",
                     "roofline_us": round(max(t_flops, t_bytes), 1),
                     "measured_us": measured[site]}
        if measured[site]:
            out[site]["roofline_share"] = round(
                max(t_flops, t_bytes) / measured[site], 3)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="profile_out")
    p.add_argument("--batch", type=int, default=4)
    args = p.parse_args()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("profile_sites: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from bodyct_dram_emph_subtype.utils.cli import enable_compile_cache
    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    size = (128, 224, 288)
    reports = profile(Path(args.out), args.batch, size)
    reports["sites"] = roofline(reports, dev.device_kind, args.batch, size)
    reports["card"] = card
    reports["device_kind"] = dev.device_kind
    print(json.dumps(reports))
    return 0


if __name__ == "__main__":
    sys.exit(main())
