"""Multi-dimensional conditional neural spline flow (coupling NSF).

Owns the generic density-estimation capability behind the reference
notebooks' SNPE / SNLE experiments (reference: src/notebooks/ryans_test.ipynb
cells 0-2 — ``SNPE(prior)`` / ``SNLE(prior)`` with sbi's default NSF density
estimators): a d-dimensional rational-quadratic-spline coupling flow with
context conditioning, usable as either a posterior estimator q(theta | x) or
a likelihood estimator q(x | theta).

Design: alternating-mask coupling layers (Durkan et al. 2019). Each layer
splits dims by a binary mask; the conditioner MLP maps
[masked dims, context] -> spline params for the transformed dims. For d == 1
every layer conditions on the context alone (matching the MNLE flow). All
math reuses nets/spline.py and is pure-function (jit/vmap/grad-safe).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .layers import dense, dense_init
from .spline import num_spline_params, rq_spline_forward, rq_spline_inverse

__all__ = ["NSFConfig", "CouplingNSF", "FlowEstimator", "build_flow", "fit_flow"]

_LOG_SQRT_2PI = 0.5 * np.log(2.0 * np.pi)


@dataclass(frozen=True)
class NSFConfig:
    dim: int
    context_dim: int
    hidden_features: int = 64
    num_transforms: int = 5
    num_bins: int = 16
    tail_bound: float = 5.0


class CouplingNSF:
    """Stack of RQ-spline coupling transforms with alternating masks, as pure
    functions of an explicit parameter tree (built by :meth:`init`; the
    conditioner of layer t is ``conditioner_t/layers_{0,2,4}``)."""

    def __init__(self, cfg: NSFConfig):
        self.cfg = cfg
        d = cfg.dim
        masks = []
        for t in range(cfg.num_transforms):
            if d == 1:
                mask = np.zeros(1, bool)  # transform the single dim each layer
            else:
                mask = np.arange(d) % 2 == t % 2  # True = pass-through half
            masks.append(mask)
        self._masks = [jnp.asarray(m) for m in masks]

    def init(self, key: jax.Array) -> dict:
        cfg = self.cfg
        H = cfg.hidden_features
        widths = [cfg.dim + cfg.context_dim, H, H, cfg.dim * num_spline_params(cfg.num_bins)]
        params = {}
        for t in range(cfg.num_transforms):
            name = f"conditioner_{t}"
            params[name] = {
                f"layers_{2 * i}": dense_init(
                    key, (name, f"layers_{2 * i}"), widths[i], widths[i + 1]
                )
                for i in range(3)
            }
        return params

    def _params_for(self, params, t, z, context):
        """Spline params for layer t given pass-through dims + context."""
        cfg = self.cfg
        mask = self._masks[t]
        h = jnp.concatenate([jnp.where(mask, z, 0.0), context], axis=-1)
        p = params[f"conditioner_{t}"]
        h = jax.nn.relu(dense(p["layers_0"], h))
        h = jax.nn.relu(dense(p["layers_2"], h))
        raw = dense(p["layers_4"], h)
        return raw.reshape(raw.shape[:-1] + (cfg.dim, num_spline_params(cfg.num_bins)))

    def log_prob(self, params, theta, context):
        """log q(theta | context); theta (..., d), context (..., c)."""
        cfg = self.cfg
        z = theta
        log_det = jnp.zeros(theta.shape[:-1])
        for t in range(cfg.num_transforms):
            mask = self._masks[t]
            sp = self._params_for(params, t, z, context)
            z_new, ld = rq_spline_forward(
                z, sp, num_bins=cfg.num_bins, tail_bound=cfg.tail_bound
            )
            z = jnp.where(mask, z, z_new)
            log_det = log_det + jnp.sum(jnp.where(mask, 0.0, ld), axis=-1)
        base = jnp.sum(-_LOG_SQRT_2PI - 0.5 * z**2, axis=-1)
        return base + log_det

    def sample(self, params, key, context):
        """One draw per context row; context (..., c) -> (..., d)."""
        cfg = self.cfg
        z = jax.random.normal(key, context.shape[:-1] + (cfg.dim,))
        for t in reversed(range(cfg.num_transforms)):
            mask = self._masks[t]
            # pass-through dims of z are final
            sp = self._params_for(params, t, z, context)
            z_new, _ = rq_spline_inverse(
                z, sp, num_bins=cfg.num_bins, tail_bound=cfg.tail_bound
            )
            z = jnp.where(mask, z, z_new)
        return z


@dataclass
class FlowEstimator:
    """Trained conditional flow with z-scoring baked into log_prob/sample."""

    cfg: NSFConfig
    params: Any
    y_mean: jnp.ndarray  # stats of the modeled variable
    y_std: jnp.ndarray
    c_mean: jnp.ndarray  # stats of the context
    c_std: jnp.ndarray
    _net: CouplingNSF = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_net", CouplingNSF(self.cfg))

    def log_prob_fn(self, params, y, context):
        u = (y - self.y_mean) / self.y_std
        c = (context - self.c_mean) / self.c_std
        lp = self._net.log_prob(params, u, c)
        return lp - jnp.sum(jnp.log(self.y_std))

    def log_prob(self, y, context):
        return self.log_prob_fn(self.params, jnp.asarray(y), jnp.asarray(context))

    def sample(self, key, context):
        c = (jnp.asarray(context) - self.c_mean) / self.c_std
        u = self._net.sample(self.params, key, c)
        return u * self.y_std + self.y_mean


def build_flow(key, cfg: NSFConfig, **stats) -> FlowEstimator:
    params = jax.jit(CouplingNSF(cfg).init)(key)
    return FlowEstimator(
        cfg=cfg,
        params=params,
        y_mean=jnp.asarray(stats.get("y_mean", jnp.zeros(cfg.dim)), jnp.float32),
        y_std=jnp.asarray(stats.get("y_std", jnp.ones(cfg.dim)), jnp.float32),
        c_mean=jnp.asarray(
            stats.get("c_mean", jnp.zeros(cfg.context_dim)), jnp.float32
        ),
        c_std=jnp.asarray(stats.get("c_std", jnp.ones(cfg.context_dim)), jnp.float32),
    )


def fit_flow(
    estimator: FlowEstimator,
    y,
    context,
    *,
    learning_rate: float = 5e-4,
    batch_size: int = 1024,
    max_epochs: int = 300,
    patience: int = 20,
    validation_fraction: float = 0.1,
    seed=0,
    verbose: bool = False,
) -> FlowEstimator:
    """Max-likelihood training with validation early stopping (shared by the
    SNPE and SNLE trainers; same loop shape as train_mnle)."""
    import optax

    from ..utils.rng import as_key

    y = jnp.asarray(y, jnp.float32)
    context = jnp.asarray(context, jnp.float32)
    n = y.shape[0]
    key = as_key(seed)

    n_val = max(int(n * validation_fraction), 1) if n > 10 else 0
    perm = jax.random.permutation(jax.random.fold_in(key, 0), n)
    val_idx, tr_idx = perm[:n_val], perm[n_val:]
    y_tr, c_tr = y[tr_idx], context[tr_idx]
    y_val, c_val = y[val_idx], context[val_idx]
    n_tr = int(y_tr.shape[0])
    batch_size = min(batch_size, n_tr)
    n_batches = max(n_tr // batch_size, 1)

    def loss_fn(params, yb, cb):
        return -jnp.mean(estimator.log_prob_fn(params, yb, cb))

    tx = optax.adam(learning_rate)
    opt_state = tx.init(estimator.params)

    @jax.jit
    def epoch_step(params, opt_state, perm_idx, y_tr, c_tr):
        def body(carry, idx):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn)(
                params, jnp.take(y_tr, idx, axis=0), jnp.take(c_tr, idx, axis=0)
            )
            updates, opt_state = tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), loss

        batches = perm_idx[: n_batches * batch_size].reshape(n_batches, batch_size)
        (params, opt_state), losses = jax.lax.scan(body, (params, opt_state), batches)
        return params, opt_state, jnp.mean(losses)

    @jax.jit
    def val_loss(params, y_val, c_val):
        return loss_fn(params, y_val, c_val) if n_val > 0 else jnp.float32(0.0)

    params, best_params, best_val, since = estimator.params, estimator.params, np.inf, 0
    for epoch in range(max_epochs):
        perm_idx = jax.random.permutation(jax.random.fold_in(key, 1 + epoch), n_tr)
        params, opt_state, tr_loss = epoch_step(params, opt_state, perm_idx, y_tr, c_tr)
        vl = float(val_loss(params, y_val, c_val)) if n_val > 0 else float(tr_loss)
        if vl < best_val - 1e-5:
            best_val, best_params, since = vl, params, 0
        else:
            since += 1
        if verbose and epoch % 20 == 0:
            print(f"[fit_flow] epoch {epoch}: train={float(tr_loss):.4f} val={vl:.4f}")
        if since >= patience:
            break

    return FlowEstimator(
        cfg=estimator.cfg,
        params=best_params,
        y_mean=estimator.y_mean,
        y_std=estimator.y_std,
        c_mean=estimator.c_mean,
        c_std=estimator.c_std,
    )
