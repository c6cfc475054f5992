"""Metrics/profiling utilities: JSONL logging, timing, NaN guards, SBC plots."""

import json

import jax.numpy as jnp

from sbi_for_diffusion_models_tpu.utils.metrics import MetricsLogger, timed


def test_metrics_logger_writes_jsonl(tmp_path):
    path = tmp_path / "m.jsonl"
    log = MetricsLogger(path)
    log.log("sim", "steps_per_s", 1e9, batch=4)
    log.log("train", "loss", 0.5)
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert len(lines) == 2
    assert lines[0]["stage"] == "sim" and lines[0]["batch"] == 4
    assert lines[1]["name"] == "loss" and "ts" in lines[1]


def test_metrics_logger_stdout_fallback(capsys):
    MetricsLogger(None).log("a", "b", 1)
    assert "a/b = 1" in capsys.readouterr().out


def test_timed_waits_for_result():
    out, dt = timed(lambda: jnp.arange(10).sum())
    assert dt >= 0.0
    assert out.is_ready() and int(out) == 45


def test_nan_guard_raises_on_nan():
    import jax
    import pytest

    from sbi_for_diffusion_models_tpu.utils.debug import assert_finite, nan_guard

    # jax_debug_nans only instruments newly-compiled executables; an earlier
    # test may have cached this computation without the check.
    jax.clear_caches()
    with pytest.raises(FloatingPointError):
        with nan_guard():
            jnp.log(jnp.array([-1.0])).block_until_ready()

    # Clean computation passes.
    with nan_guard():
        assert float(jnp.log(jnp.array([2.0]))[0]) > 0

    assert_finite("ok", jnp.ones(3))
    with pytest.raises(FloatingPointError, match="non-finite"):
        assert_finite("bad", jnp.array([1.0, float("nan")]))


def test_sbc_ecdf_plot(tmp_path):
    import numpy as np

    from sbi_for_diffusion_models_tpu.analysis import sbc_ecdf_plot

    rng = np.random.default_rng(0)
    ranks = rng.integers(0, 601, size=(48, 5))
    out = sbc_ecdf_plot(ranks, 600, tmp_path / "ecdf.png")
    assert out.exists() and out.stat().st_size > 0
