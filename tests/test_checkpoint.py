"""Training checkpoint/resume: round-trip, fingerprint guard, train resume."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLEConfig, build_mnle
from sbi_for_diffusion_models_tpu.run_config import RUN_CONFIG_PARAMS
from sbi_for_diffusion_models_tpu.utils.checkpoint import (
    config_fingerprint,
    latest_step,
    restore_train_state,
    save_train_state,
)


def _state():
    est = build_mnle(
        jax.random.key(0),
        MNLEConfig(condition_dim=4, hidden_features=8, num_transforms=2, num_bins=4),
    )
    tx = optax.adam(1e-3)
    return est.params, tx.init(est.params)


def test_roundtrip(tmp_path):
    params, opt_state = _state()
    key = jax.random.key(42)
    save_train_state(tmp_path / "ckpt", 3, params, opt_state, key, cfg=RUN_CONFIG_PARAMS)
    assert latest_step(tmp_path / "ckpt") == 3
    abstract = {
        "params": params,
        "opt_state": opt_state,
        "key": jax.random.key_data(key),
        "meta": {"step": np.asarray(0, np.int64)},
    }
    restored = restore_train_state(tmp_path / "ckpt", abstract, cfg=RUN_CONFIG_PARAMS)
    assert int(restored["meta"]["step"]) == 3
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(restored["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.random.key_data(restored["key"]).tolist() == jax.random.key_data(key).tolist()


def test_missing_returns_none(tmp_path):
    assert restore_train_state(tmp_path / "nope", {}) is None
    assert latest_step(tmp_path / "nope") is None


def test_fingerprint_guard(tmp_path):
    params, opt_state = _state()
    save_train_state(
        tmp_path / "ckpt", 0, params, opt_state, jax.random.key(0),
        cfg=RUN_CONFIG_PARAMS,
    )
    other = RUN_CONFIG_PARAMS.replace(TRAIN_LEARNING_RATE=99.0)
    assert config_fingerprint(other) != config_fingerprint(RUN_CONFIG_PARAMS)
    abstract = {
        "params": params,
        "opt_state": opt_state,
        "key": jax.random.key_data(jax.random.key(0)),
        "meta": {"step": np.asarray(0, np.int64)},
    }
    with pytest.raises(ValueError, match="different"):
        restore_train_state(tmp_path / "ckpt", abstract, cfg=other)


def test_train_mnle_resumes_from_npz_checkpoint(tmp_path, capsys):
    """train_mnle writes a tree-path .npz checkpoint per epoch; a rerun with
    the same config resumes after the last saved epoch with its params."""
    from sbi_for_diffusion_models_tpu.mnle import train_mnle

    key = jax.random.key(3)
    z = jax.random.normal(key, (400, 4))
    x = jnp.stack(
        [jnp.exp(0.3 * jax.random.normal(jax.random.fold_in(key, 1), (400,))),
         jax.random.randint(jax.random.fold_in(key, 2), (400,), 0, 3).astype(jnp.float32)],
        -1,
    )
    cfg = RUN_CONFIG_PARAMS.replace(
        MNLE_HIDDEN_FEATURES=8, MNLE_NUM_TRANSFORMS=1, MNLE_NUM_BINS=4,
        TRAIN_BATCH_SIZE=100, TRAIN_MAX_EPOCHS=2,
    )
    ck = tmp_path / "train_ckpt"
    kw = dict(checkpoint_dir=str(ck), checkpoint_every=1)
    train_mnle(cfg, None, z, x, verbose=False, **kw)
    assert latest_step(ck) == 1
    assert sorted(p.name for p in ck.glob("step_*.npz")) == [
        "step_00000000.npz", "step_00000001.npz"]
    saved = np.load(ck / "step_00000001.npz")
    capsys.readouterr()
    est = train_mnle(cfg, None, z, x, verbose=True, **kw)
    assert "resumed from epoch 1" in capsys.readouterr().out
    for kp, leaf in jax.tree_util.tree_flatten_with_path(est.params)[0]:
        np.testing.assert_array_equal(
            np.asarray(leaf), saved["['params']" + jax.tree_util.keystr(kp)]
        )
