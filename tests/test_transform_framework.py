"""Transform-framework protocol tests: gating, freeze_param, dispatch."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bodyct_dram_emph_subtype.transforms import (
    BaseTransform,
    BoxMaskOut,
    Compose,
    Flip,
    GaussianAdditive,
    ImageOnlyTransform,
    IntensityWindow,
    ToDevice,
    ToHost,
)


class _MarkImage(ImageOnlyTransform):
    def __init__(self, p=0.5, always_apply=False):
        super().__init__(p, always_apply)

    def apply_to_image(self, data):
        return data + 1


def _data():
    return {"image": np.zeros((4, 4), np.float32),
            "lung_mask": np.zeros((4, 4), np.float32),
            "uid": "x", "cls_label": 3}


def test_key_semantic_dispatch():
    out = _MarkImage(always_apply=True)(_data())
    assert (out["image"] == 1).all()          # 'image' key transformed
    assert (out["lung_mask"] == 0).all()      # ImageOnly skips masks
    assert out["uid"] == "x" and out["cls_label"] == 3  # non-arrays pass


def test_probability_gate_statistics():
    t = _MarkImage(p=0.5)
    applied = 0
    for i in range(200):
        out = t(_data(), key=jax.random.PRNGKey(i))
        applied += int(out["image"].max() > 0)
    assert 60 < applied < 140  # ~Binomial(200, .5)


def test_always_apply_overrides_p():
    t = _MarkImage(p=0.0, always_apply=True)
    out = t(_data(), key=jax.random.PRNGKey(0))
    assert (np.asarray(out["image"]) == 1).all()


def test_freeze_param_reuses_cached_params(rng):
    t = Flip(1.0, True, dim=(1, 3))
    data = {"image": rng.randn(4, 6, 8).astype(np.float32)}
    out1 = t(dict(data), key=jax.random.PRNGKey(0))
    combs = list(t.params["combs"])
    t.freeze_param = True
    out2 = t(dict(data), key=jax.random.PRNGKey(99))  # key must be ignored
    assert list(t.params["combs"]) == combs
    np.testing.assert_array_equal(np.asarray(out1["image"]),
                                  np.asarray(out2["image"]))


def test_compose_splits_keys_deterministically(rng):
    data = {"image": rng.randn(6, 8, 10).astype(np.float32)}
    chain = Compose([GaussianAdditive(p=1.0),
                     BoxMaskOut(1.0, True, n_masks=(1, 4))])
    a = chain(dict(data), key=jax.random.PRNGKey(5))
    b = chain(dict(data), key=jax.random.PRNGKey(5))
    np.testing.assert_array_equal(np.asarray(a["image"]),
                                  np.asarray(b["image"]))
    c = chain(dict(data), key=jax.random.PRNGKey(6))
    assert not np.allclose(np.asarray(a["image"]), np.asarray(c["image"]))


def test_to_device_to_host_roundtrip(rng):
    data = {"image": rng.randn(3, 3).astype(np.float32), "uid": "u"}
    dev = ToDevice()(data)
    assert isinstance(dev["image"], jax.Array)
    host = ToHost()(dev)
    assert isinstance(host["image"], np.ndarray)
    np.testing.assert_array_equal(host["image"], data["image"])
    assert host["uid"] == "u"


def test_repr_serialization():
    t = IntensityWindow(from_span=(-1150, -300), to_span=(0, 1))
    s = repr(t)
    assert "IntensityWindow" in s and "from_span" in s


def test_validator_errors():
    with pytest.raises(ValueError):
        BaseTransform.check_range((5, 1), "bad")
    with pytest.raises(ValueError):
        BaseTransform.check_positive_range((-1, 2), "bad")
