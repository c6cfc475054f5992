"""Dense layers and MLPs as explicit parameter trees and pure functions.

A layer is ``{"kernel": (n_in, n_out), "bias": (n_out,)}`` and an MLP is
``{"Dense_0": layer, ..., "Dense_{depth}": layer}``: the tree paths of the
Flax modules the estimators were first written with, so every saved model
loads unchanged. Kernels start LeCun-normal and biases at zero (Flax's
defaults), and each kernel is drawn from the key Flax derived for that
module path, so a seeded init reproduces the earlier parameters too.
"""

from __future__ import annotations

import hashlib

import jax
import jax.numpy as jnp

__all__ = ["param_key", "dense_init", "dense", "mlp_init", "mlp"]

_lecun_normal = jax.nn.initializers.lecun_normal()


def param_key(root: jax.Array, path: tuple[str, ...]) -> jax.Array:
    """Key of the first parameter drawn at ``path``: the SHA-1 of the path
    names and the scope's draw counter (1), folded into ``root``."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update((1).to_bytes(1, "big"))
    return jax.random.fold_in(root, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


def dense_init(root, path, n_in: int, n_out: int, *, zero_kernel: bool = False):
    if zero_kernel:
        kernel = jnp.zeros((n_in, n_out), jnp.float32)
    else:
        kernel = _lecun_normal(param_key(root, path), (n_in, n_out), jnp.float32)
    return {"kernel": kernel, "bias": jnp.zeros((n_out,), jnp.float32)}


def dense(p, x, precision=None):
    y = jax.lax.dot_general(
        x, p["kernel"], (((x.ndim - 1,), (0,)), ((), ())), precision=precision
    )
    return y + p["bias"]


def mlp_init(root, path, n_in: int, hidden: int, n_out: int, depth: int):
    widths = [n_in] + [hidden] * depth + [n_out]
    return {
        f"Dense_{i}": dense_init(root, path + (f"Dense_{i}",), widths[i], widths[i + 1])
        for i in range(depth + 1)
    }


def mlp(p, x, precision=None):
    """ReLU between layers, none after the last."""
    n = len(p)
    for i in range(n - 1):
        x = jax.nn.relu(dense(p[f"Dense_{i}"], x, precision))
    return dense(p[f"Dense_{n - 1}"], x, precision)
