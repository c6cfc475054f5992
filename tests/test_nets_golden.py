"""The plain-JAX estimators against the committed models.

``tests/fixtures/golden_logprob.npz`` holds log-prob values and theta
gradients of every committed model in ``artifacts/models/`` on 16 fixed
(x, condition) rows, computed with the estimator's earlier Flax
implementation. The parameter trees keep that implementation's paths, so
the saved files load unchanged and evaluate to the same numbers.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sbi_for_diffusion_models_tpu.mnle import load_model
from sbi_for_diffusion_models_tpu.nets.mnle_net import MNLEConfig, build_mnle

ROOT = Path(__file__).resolve().parents[1]
MODELS = sorted(p.stem for p in (ROOT / "artifacts" / "models").glob("*.npz"))
GOLDEN = np.load(ROOT / "tests" / "fixtures" / "golden_logprob.npz")


@pytest.fixture(autouse=True)
def _model_dir(monkeypatch):
    monkeypatch.setenv("MODEL_DIR", str(ROOT / "artifacts" / "models"))


def test_every_committed_model_has_golden_values():
    assert MODELS and all(f"{m}:lp" in GOLDEN.files for m in MODELS)


@pytest.mark.parametrize("model", MODELS)
def test_golden_logprob_and_grad(model):
    est = load_model(model + ".npz")
    x, cond = jnp.asarray(GOLDEN["x"]), jnp.asarray(GOLDEN["cond"])
    # Computed as the fixture was: values op by op, gradients jitted. (XLA's
    # CPU fusions use other exp/log approximations than single ops, which
    # moves the sharpest rows by up to ~1e-2, so the modes must not mix.)
    lp = np.asarray(est.log_prob(x, cond))
    np.testing.assert_allclose(lp, GOLDEN[f"{model}:lp"], rtol=1e-6, atol=1e-5)

    def row(th, xi, si):
        return est.log_prob_fn(est.params, xi, jnp.concatenate([th, si]))

    g = np.asarray(jax.jit(jax.vmap(jax.grad(row)))(cond[:, :5], x, cond[:, 5:]))
    want = GOLDEN[f"{model}:grad"]
    # Relative to the row's gradient scale: rows near the onset barrier
    # carry gradients of O(100) whose float32 sums reorder between runs.
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1.0)
    np.testing.assert_array_less(np.abs(g - want) / scale, 1e-4)


@pytest.mark.parametrize("model", MODELS)
def test_init_tree_matches_committed_keys(model):
    """A fresh init has exactly the committed file's tree paths and shapes."""
    data = np.load(ROOT / "artifacts" / "models" / f"{model}.npz")
    meta = json.loads(str(data["__meta__"]))
    est = build_mnle(jax.random.key(0), MNLEConfig(**meta["mnle_config"]))
    init = {
        "param:" + jax.tree_util.keystr(kp): np.shape(v)
        for kp, v in jax.tree_util.tree_flatten_with_path(est.params)[0]
    }
    saved = {k: data[k].shape for k in data.files if k.startswith("param:")}
    assert init == saved
    # Flax defaults: zero biases, LeCun-normal kernels (the affine head's
    # kernel starts at zero by design).
    for kp, v in jax.tree_util.tree_flatten_with_path(est.params)[0]:
        path = jax.tree_util.keystr(kp)
        v = np.asarray(v)
        if path.endswith("['bias']") or "affine_head" in path:
            assert not v.any(), path
        else:
            assert abs(v.std() * np.sqrt(v.shape[0]) - 1.0) < 0.25, path


def test_vmapped_chain_grads_match_per_chain_loop():
    """NUTS vmaps value_and_grad over chains; on the XLA path the vmapped
    result must equal a per-chain loop."""
    est = load_model("mnle_10m_shifted_logt_affine.npz")
    T, C = 50, 16
    key = jax.random.key(4)
    x = jnp.stack(
        [0.6 + jnp.exp(0.3 * jax.random.normal(jax.random.fold_in(key, 0), (T,))),
         jax.random.randint(jax.random.fold_in(key, 1), (T,), 0, 3).astype(jnp.float32)],
        -1,
    )
    pulses = jnp.where(jax.random.uniform(jax.random.fold_in(key, 2), (T, 80)) < 0.75, 1.0, -1.0)
    ths = jnp.asarray(GOLDEN["cond"][:C, :5]).at[:, 4].set(0.2)

    def pot(th):
        c = jnp.concatenate([jnp.broadcast_to(th, (T, 5)), pulses], -1)
        return jnp.sum(est.log_prob_fn(est.params, x, c))

    vg = jax.value_and_grad(pot)
    v_b, g_b = jax.jit(jax.vmap(vg))(ths)
    one = jax.jit(vg)
    for i in range(C):
        v_i, g_i = one(ths[i])
        np.testing.assert_allclose(float(v_b[i]), float(v_i), rtol=1e-5, atol=1e-4)
        # float32 sums over 50 trials reorder under vmap: compare against the
        # row's gradient scale (entries reach O(1000) near the onset barrier,
        # summed from per-trial terms that partly cancel).
        g_i = np.asarray(g_i)
        scale = max(np.abs(g_i).max(), 1.0)
        assert np.abs(np.asarray(g_b[i]) - g_i).max() / scale < 1e-3, i
