"""Model zoo tests: shapes, registry, param-count parity, and — when the
reference checkout is present — full forward parity against the torch model
with converted weights."""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bodyct_dram_emph_subtype.models import (
    ResNetSegCls,
    ResNetSegReg,
    get_model_by_name,
)
from bodyct_dram_emph_subtype.models.torch_import import convert_state_dict

REFERENCE = Path("/root/reference")

INPUT = (1, 32, 48, 64, 1)  # small but downsample-compatible (div by 8)


def _init(model, with_lungs=True):
    x = jnp.zeros(INPUT, jnp.float32)
    lungs = jnp.ones(INPUT, jnp.float32) if with_lungs else None
    variables = model.init(jax.random.PRNGKey(0), x, lungs, train=False)
    return variables, x, lungs


def test_segcls_shapes():
    model = get_model_by_name("med3d18")
    variables, x, lungs = _init(model)
    dense, cls = model.apply(variables, x, lungs, train=False)
    assert dense[0].shape == (1, 16, 24, 32, 6)
    assert dense[1].shape == (1, 16, 24, 32, 3)
    assert cls[0].shape == (1, 6) and cls[1].shape == (1, 3)


def test_segreg_shapes_and_range():
    model = get_model_by_name("med3ddram18")
    variables, x, lungs = _init(model)
    dense, reg = model.apply(variables, x, lungs, train=False)
    assert dense[0].shape == (1, 16, 24, 32, 1)
    assert reg[0].shape == (1,) and reg[1].shape == (1,)
    assert 0.0 <= float(reg[0][0]) <= 1.0
    d = np.asarray(dense[0])
    assert (d >= 0).all() and (d <= 1).all()  # sigmoid maps


def test_registry_all_archs_construct():
    for name in ["med3d", "med3d18", "med3d50", "med3ddram", "med3ddram18",
                 "med3ddram50", "med3dtiny", "med3ddramtiny"]:
        model = get_model_by_name(name)
        assert isinstance(model, (ResNetSegCls, ResNetSegReg))
    for tiny in ("med3dtiny", "med3ddramtiny"):
        assert tuple(get_model_by_name(tiny).layers) == (1, 1, 1, 1)
    with pytest.raises(KeyError):
        get_model_by_name("nope")


def test_registry_warns_on_unknown_target(tmp_path, caplog):
    """A typo'd ``_target_`` in a user yaml must warn, not silently fall
    through to a different builtin model."""
    import logging

    (tmp_path / "med3dtiny.yaml").write_text("_target_: med3d.resnet34segregg\n")
    with caplog.at_level(logging.WARNING,
                         logger="bodyct_dram_emph_subtype.models.registry"):
        model = get_model_by_name("med3dtiny", conf_dir=str(tmp_path))
    assert any("unknown _target_" in r.message for r in caplog.records)
    # the builtin fallback still resolves the arch name
    assert tuple(model.layers) == (1, 1, 1, 1)


def test_train_mode_updates_batch_stats():
    model = get_model_by_name("med3ddram18")
    variables, x, lungs = _init(model)
    (dense, reg), mutated = model.apply(
        variables, x + 1.0, lungs, train=True, mutable=["batch_stats"])
    before = variables["batch_stats"]["trunk"]["bn1"]["bn"]["mean"]
    after = mutated["batch_stats"]["trunk"]["bn1"]["bn"]["mean"]
    assert not np.allclose(np.asarray(before), np.asarray(after))


def _param_count(tree):
    return sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(tree))


@pytest.mark.skipif(not REFERENCE.exists(), reason="reference not mounted")
@pytest.mark.parametrize("arch,factory", [
    ("med3ddram18", "resnet18segreg"),
    ("med3d18", "resnet18segcls"),
    ("med3ddram", "resnet34segreg"),
    ("med3ddram50", "resnet50segreg"),
])
def test_param_count_parity_with_reference(arch, factory):
    sys.path.insert(0, str(REFERENCE))
    try:
        import med3d as ref_med3d
        torch_model = getattr(ref_med3d, factory)()
        want = sum(p.numel() for p in torch_model.parameters())
    finally:
        sys.path.pop(0)
    model = get_model_by_name(arch)
    variables, _, _ = _init(model)
    got = _param_count(variables["params"])
    assert got == want


@pytest.mark.skipif(not REFERENCE.exists(), reason="reference not mounted")
@pytest.mark.parametrize("arch,factory", [("med3ddram18", "resnet18segreg"),
                                          ("med3d18", "resnet18segcls"),
                                          ("med3ddram50", "resnet50segreg")])
def test_forward_parity_with_reference(rng, arch, factory):
    """Convert random torch weights into the model and compare full
    forward passes (eval mode) on the same input."""
    import torch

    sys.path.insert(0, str(REFERENCE))
    try:
        import med3d as ref_med3d
        torch_model = getattr(ref_med3d, factory)().eval()
    finally:
        sys.path.pop(0)

    model = get_model_by_name(arch)
    variables, _, _ = _init(model)
    variables, report = convert_state_dict(torch_model.state_dict(),
                                           dict(variables))
    assert report["missing"] == 0 and report["shape_mismatch"] == 0

    x = rng.randn(*INPUT).astype(np.float32)
    lungs = (rng.rand(*INPUT) > 0.3).astype(np.float32)
    with torch.no_grad():
        tx = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
        tl = torch.from_numpy(np.moveaxis(lungs, -1, 1).copy())
        want_dense, want_heads = torch_model(tx, tl)

    with jax.default_matmul_precision("highest"):
        got_dense, got_heads = model.apply(variables, jnp.asarray(x),
                                           jnp.asarray(lungs), train=False)
    for gd, wd in zip(got_dense, want_dense):
        wd = np.moveaxis(wd.numpy(), 1, -1)
        np.testing.assert_allclose(np.asarray(gd), wd, rtol=1e-3, atol=2e-4)
    for gh, wh in zip(got_heads, want_heads):
        np.testing.assert_allclose(np.asarray(gh), wh.numpy(), rtol=1e-3,
                                   atol=2e-4)


@pytest.mark.skipif(not REFERENCE.exists(), reason="reference not mounted")
def test_shortcut_b_forward_parity(rng):
    """Shortcut type 'B' (conv+BN residual branch, ``med3d.py:250-260``):
    param-count + forward parity against the torch model built with
    ``shortcut_type='B'``."""
    import torch

    sys.path.insert(0, str(REFERENCE))
    try:
        import med3d as ref_med3d
        torch_model = ref_med3d.resnet18segreg(shortcut_type="B").eval()
    finally:
        sys.path.pop(0)

    model = get_model_by_name("med3ddram18", shortcut_type="B")
    variables, _, _ = _init(model)
    want_n = sum(p.numel() for p in torch_model.parameters())
    got_n = _param_count(variables["params"])
    assert got_n == want_n

    variables, report = convert_state_dict(torch_model.state_dict(),
                                           dict(variables))
    assert report["missing"] == 0 and report["shape_mismatch"] == 0
    assert report["unexpected"] == 0

    x = rng.randn(*INPUT).astype(np.float32)
    lungs = (rng.rand(*INPUT) > 0.3).astype(np.float32)
    with torch.no_grad():
        tx = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
        tl = torch.from_numpy(np.moveaxis(lungs, -1, 1).copy())
        want_dense, want_heads = torch_model(tx, tl)
    with jax.default_matmul_precision("highest"):
        got_dense, got_heads = model.apply(variables, jnp.asarray(x),
                                           jnp.asarray(lungs), train=False)
    for gd, wd in zip(got_dense, want_dense):
        wd = np.moveaxis(wd.numpy(), 1, -1)
        np.testing.assert_allclose(np.asarray(gd), wd, rtol=1e-3, atol=2e-4)
    for gh, wh in zip(got_heads, want_heads):
        np.testing.assert_allclose(np.asarray(gh), wh.numpy(), rtol=1e-3,
                                   atol=2e-4)


@pytest.mark.skipif(not REFERENCE.exists(), reason="reference not mounted")
@pytest.mark.parametrize("method", ["ln", "lnna", "in", "bnt", "bntna"])
def test_norm_wrapper_variants_oracle(rng, method):
    """NormWrapper 'ln'/'lnna'/'in'/'bnt'/'bntna' vs the reference
    ``normal_wrapper`` (``med3d.py:10-28``) on the same activations."""
    import torch

    from bodyct_dram_emph_subtype.models.blocks import NormWrapper

    sys.path.insert(0, str(REFERENCE))
    try:
        import med3d as ref_med3d
        tmod = ref_med3d.normal_wrapper(method, 8).eval()
    finally:
        sys.path.pop(0)

    x = rng.randn(2, 6, 10, 12, 8).astype(np.float32)
    with torch.no_grad():
        want = tmod(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    want = np.moveaxis(want.numpy(), 1, -1)

    mod = NormWrapper(method)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    # affine GroupNorm variants init scale=1/bias=0 in both frameworks, so
    # fresh-init comparison is meaningful; 'bnt'/'bntna' always use batch
    # stats (track_running_stats=False), so eval == normalize-by-batch.
    got, _ = mod.apply(variables, jnp.asarray(x), False,
                       mutable=["batch_stats"])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_predict_step_batch_lung_norm_modes(rng):
    """Strict-parity predict mode: ``batch_lung_norm=True`` reproduces the
    reference's whole-batch normalization (``models.py:440-441``); the
    default per-sample mode relates to it by the volume ratio, and the two
    agree exactly at batch 1."""
    from bodyct_dram_emph_subtype.train import TrainState, make_optimizer
    from bodyct_dram_emph_subtype.train.steps import make_predict_step

    model = get_model_by_name("med3ddram18")
    shape = (2, 16, 24, 32)
    x = rng.randn(*shape).astype(np.float32)
    lungs = np.zeros(shape, np.float32)
    lungs[0, 2:14, 4:20, 4:28] = 1.0   # sample volumes differ
    lungs[1, 4:10, 6:16, 8:20] = 1.0
    ess = (rng.rand(*shape) > 0.5).astype(np.float32) * lungs

    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x)[..., None],
                           jnp.asarray(lungs)[..., None], train=False)
    state = TrainState.create(dict(variables), make_optimizer())

    per_sample = make_predict_step(model)(state, x, lungs, ess)
    batch_norm = make_predict_step(model, batch_lung_norm=True)(
        state, x, lungs, ess)

    vol = lungs.reshape(2, -1).sum(1)
    for key in ("cle_precentages", "pse_precentages"):
        got = np.asarray(batch_norm[key])
        want = np.asarray(per_sample[key]) * vol / vol.sum()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert not np.allclose(got, np.asarray(per_sample[key]))

    # batch 1: the two modes coincide
    one = make_predict_step(model)(state, x[:1], lungs[:1], ess[:1])
    one_b = make_predict_step(model, batch_lung_norm=True)(
        state, x[:1], lungs[:1], ess[:1])
    np.testing.assert_allclose(np.asarray(one["cle_precentages"]),
                               np.asarray(one_b["cle_precentages"]),
                               rtol=1e-6)


def _direct_stem(x, k):
    return jax.lax.conv_general_dilated(
        x, k, (2, 2, 2), [(3, 3)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


def test_s2d_stem_conv_matches_direct(rng):
    """Space-to-depth stem conv == direct k7 s2 conv (same kernel), and the
    odd-dims fallback is exact."""
    from bodyct_dram_emph_subtype.models.blocks import stem_conv_s2d

    k = jnp.asarray(rng.randn(7, 7, 7, 1, 6).astype(np.float32) * 0.05)
    x = jnp.asarray(rng.randn(2, 16, 20, 24, 1).astype(np.float32))
    np.testing.assert_allclose(np.asarray(stem_conv_s2d(x, k)),
                               np.asarray(_direct_stem(x, k)),
                               rtol=1e-4, atol=1e-5)
    x_odd = jnp.asarray(rng.randn(1, 15, 20, 24, 1).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(stem_conv_s2d(x_odd, k)),
                                  np.asarray(_direct_stem(x_odd, k)))


def test_s2d_stem_factor_variants_match_direct(rng):
    """Every s2d block-factor variant of the stem conv (Cin 8/32/64 forms)
    computes the exact same k7 s2 conv, and non-divisible dims fall back
    to the classic (2,2,2) mapping."""
    from bodyct_dram_emph_subtype.models.blocks import stem_conv_s2d

    k = jnp.asarray(rng.randn(7, 7, 7, 1, 6).astype(np.float32) * 0.05)
    x = jnp.asarray(rng.randn(1, 8, 16, 16, 1).astype(np.float32))
    ref = _direct_stem(x, k)
    for f in [(2, 4, 4), (4, 4, 4), (2, 2, 8), (4, 4, 2)]:
        np.testing.assert_allclose(np.asarray(stem_conv_s2d(x, k, f)),
                                   np.asarray(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=str(f))
    # dims not divisible by the factors: exact classic fallback
    x2 = jnp.asarray(rng.randn(1, 6, 10, 10, 1).astype(np.float32))
    np.testing.assert_allclose(np.asarray(stem_conv_s2d(x2, k, (4, 4, 4))),
                               np.asarray(_direct_stem(x2, k)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dilation", [2, 4])
@pytest.mark.parametrize("shape", [(8, 16, 8), (7, 10, 9)],
                         ids=["divisible", "non-divisible"])
def test_s2b_dilated_conv_matches_rhs_dilation(rng, dilation, shape):
    """Space-to-batch dilated conv == ``lax`` ``rhs_dilation`` with torch's
    ``padding=dilation``, including extents the dilation does not divide
    (zero-pad then crop)."""
    from bodyct_dram_emph_subtype.models.blocks import dilated_conv3d

    x = jnp.asarray(rng.randn(2, *shape, 3).astype(np.float32))
    k = jnp.asarray(rng.randn(3, 3, 3, 3, 5).astype(np.float32))
    want = jax.lax.conv_general_dilated(
        x, k, (1, 1, 1), [(dilation, dilation)] * 3,
        rhs_dilation=(dilation,) * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    with jax.default_matmul_precision("highest"):
        got = dilated_conv3d(x, k, dilation)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.slow
@pytest.mark.parametrize("scopes", ["all", "layer1,layer2,decoder", "none"])
def test_selective_remat_is_numerics_neutral(scopes):
    """``remat`` scope selection (selective activation checkpointing) must
    not change the forward values and may perturb gradients only at float-
    reassociation level — it trades memory for backward recompute, nothing
    else."""
    ref = get_model_by_name("med3ddramtiny", remat=False)
    mod = get_model_by_name("med3ddramtiny", remat=scopes)
    x = jnp.asarray(np.random.RandomState(0).randn(*INPUT), jnp.float32)
    lungs = jnp.ones(INPUT, jnp.float32)
    v = ref.init(jax.random.PRNGKey(0), x, lungs, train=False)

    def loss(model, v):
        (dense, regs), _ = model.apply(v, x, lungs, train=True,
                                       mutable=["batch_stats"])
        return sum(jnp.sum(m.astype(jnp.float32) ** 2) for m in dense) + \
            sum(jnp.sum(q ** 2) for q in regs)

    l_ref, g_ref = jax.value_and_grad(lambda p: loss(ref, p))(v)
    l_mod, g_mod = jax.value_and_grad(lambda p: loss(mod, p))(v)
    np.testing.assert_allclose(float(l_mod), float(l_ref), rtol=1e-6)
    # Per-element grads are NOT bit-stable under remat: the recomputed
    # activations differ from the saved ones at reassociation level, which
    # flips ReLU masks for near-zero voxels (random-init activations sit
    # at the boundary).  What must hold is global agreement: same loss,
    # same gradient direction and magnitude.
    a = np.concatenate([np.asarray(t).ravel()
                        for t in jax.tree.leaves(g_ref)])
    b = np.concatenate([np.asarray(t).ravel()
                        for t in jax.tree.leaves(g_mod)])
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.999, cos
    np.testing.assert_allclose(np.linalg.norm(b), np.linalg.norm(a),
                               rtol=5e-3)
