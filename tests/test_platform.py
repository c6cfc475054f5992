"""The program's platform layer: what the main path imports, the compile
cache's location, simulator-kernel choice, optional figures, and the
bring-up script's contract (``chip_smoke.py``)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _python(code_or_args, cwd=ROOT, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_import_without_flax_orbax_matplotlib():
    """The package imports where only JAX, optax, numpy and scipy exist."""
    code = (
        "import sys\n"
        "for m in ('flax', 'orbax', 'orbax.checkpoint', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import sbi_for_diffusion_models_tpu as s\n"
        "from sbi_for_diffusion_models_tpu.analysis import can_plot\n"
        "assert not can_plot('x')\n"
        "print('imported', s.__version__)\n"
    )
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout
    assert "matplotlib not available; skipped x" in r.stdout


def test_compile_cache_uses_env_dir_when_set(monkeypatch, tmp_path):
    from sbi_for_diffusion_models_tpu.utils.cache import enable_persistent_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env_cache"))
    assert enable_persistent_cache() == str(tmp_path / "env_cache")
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads it itself


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    from sbi_for_diffusion_models_tpu.utils.cache import (
        DEFAULT_CACHE_DIR,
        enable_persistent_cache,
    )

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = enable_persistent_cache()
        assert d == str(ROOT / ".jax_cache") == str(DEFAULT_CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == d
        assert enable_persistent_cache() == d  # fixed, not per process
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_resolve_sim_kernel():
    from sbi_for_diffusion_models_tpu.models.rt_choice_model import resolve_sim_kernel

    assert resolve_sim_kernel("auto") == "scan"  # CPU: the Triton route needs a GPU
    assert resolve_sim_kernel("pallas") == "pallas"
    with pytest.raises(ValueError, match="unknown SIM_KERNEL"):
        resolve_sim_kernel("mosaic")


def test_chip_smoke_result_line():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev(), Dev(), Dev(), Dev()])
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4},
    }


def test_chip_smoke_accuracy_rule():
    """Phase (d)'s rule: floors where the float32 reference is exact, else
    4x its worst row error and 2x its median gradient error."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))

    assert chip_smoke.tolerances(0.0, 0.0) == {"value": 1e-4, "grad_median": 1e-5}
    assert chip_smoke.tolerances(1e-3, 2e-5) == {"value": 4e-3, "grad_median": 4e-5}
    assert chip_smoke.value_err(np.array([101.0, -2.0]), np.array([100.0, -1.0])) == 1.0
    errs = chip_smoke.grad_errs(np.array([[3.0, 4.0], [0.0, 0.0]]),
                                np.array([[3.0, 0.0], [0.0, 0.0]]))
    np.testing.assert_allclose(errs, [4.0 / 3.0, 0.0])


def test_chip_smoke_control_swaps_dense_precision():
    """Phase (d)'s control traces the MNLE's Dense layers at the algorithm it
    is given, and restores HIGHEST after."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from sbi_for_diffusion_models_tpu.nets import mnle_net
    from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLE, MNLEConfig

    est = MNLE(cfg=MNLEConfig(hidden_features=8, num_transforms=1, num_bins=4),
               params=None, cond_mean=0.0, cond_std=1.0, x_mean=0.0, x_std=1.0)
    params = est._net.init(jax.random.key(0))
    x, c = np.zeros((3, 2), np.float32), np.full((3, 85), 0.5, np.float32)
    trace = lambda: str(jax.make_jaxpr(est.log_prob_fn)(params, x, c))
    control = jax.lax.DotAlgorithmPreset.TF32_TF32_F32
    assert "TF32" not in trace() and "HIGHEST" in trace()
    with chip_smoke.dense_precision(control):
        assert "TF32" in trace() and "HIGHEST" not in trace()
    assert mnle_net._PRECISION == jax.lax.Precision.HIGHEST
    tol = chip_smoke.tolerances(1e-3, 2e-5)
    assert chip_smoke.within({"value": 4e-3, "grad_median": 4e-5, "grad_max": 1.0}, tol)
    assert not chip_smoke.within({"value": 1e-3, "grad_median": 5e-5, "grad_max": 0.0}, tol)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Off the GPU, and alone in a directory without the program, the script
    exits non-zero and prints no result."""
    r = _python(["chip_smoke.py"])
    assert r.returncode != 0 and '"ok"' not in r.stdout
    assert "no GPU found" in r.stderr
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _python(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
