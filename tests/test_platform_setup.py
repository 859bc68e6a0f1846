"""Platform setup of the entry points: the compile-cache helper, the
GPU requirement of ``chip_smoke.py``/``bench.py``, and a main path that
imports without flax and orbax."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import jax

from bodyct_dram_emph_subtype.utils import cli

REPO = Path(__file__).resolve().parents[1]


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set",
                                                          "env-unset"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cli.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; the helper sets nothing
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = cli.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_exit_nonzero_without_gpu(script):
    res = subprocess.run([sys.executable, str(REPO / script)], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert "needs an NVIDIA GPU" in res.stderr
    assert res.stdout.strip() == ""


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Copied without the rest of the repo, the script fails and prints no
    result (the GPU check or the package import stops it)."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = _env(PYTHONPATH="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]


def test_main_path_imports_without_flax_or_orbax():
    code = """
import sys
sys.modules["flax"] = None
sys.modules["orbax"] = None
sys.modules["orbax.checkpoint"] = None
import processor, train, chip_smoke  # noqa: F401
import jax, jax.numpy as jnp
from bodyct_dram_emph_subtype.models import get_model_by_name
from bodyct_dram_emph_subtype.train import TrainState, make_optimizer
from bodyct_dram_emph_subtype.train.checkpoint import CheckpointManager
model = get_model_by_name("med3ddramtiny")
x = jnp.zeros((1, 16, 32, 32, 1), jnp.float32)
v = model.init(jax.random.PRNGKey(0), x, x, train=False)
dense, regs = model.apply(v, x, x, train=False)
TrainState.create(v, make_optimizer())
print("ok", dense[0].shape, float(regs[0][0]))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok (1, 8, 16, 16, 1)")
