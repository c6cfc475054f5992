"""Rational-quadratic spline transforms (Durkan et al. 2019, NSF).

The reference's MNLE delegates its conditional flow over (log-)RT to
``pyknos``/``nflows`` neural-spline-flow internals via
``likelihood_nn(model="mnle", num_transforms=10, num_bins=24, ...)``
(reference: src/sbi_for_diffusion_models/mnle.py:31-39). This module owns that
math as pure JAX functions: elementwise monotone RQ splines with linear tails,
fully vectorized so they vmap/jit over batches, trials, and MCMC chains.

Shapes: all functions are written for the *last axis* being the event axis and
broadcast over leading axes. Parameters are unconstrained network outputs; the
constraining (softmax bins, softplus derivatives) happens in here so the
conditioner stays a plain linear head.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "num_circular_spline_params",
    "num_spline_params",
    "rq_spline_circular",
    "rq_spline_forward",
    "rq_spline_inverse",
]

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def num_spline_params(num_bins: int) -> int:
    """Unconstrained params per transformed scalar: widths K + heights K +
    internal derivatives (K - 1)."""
    return 3 * num_bins - 1


def _prepare_knots(params: jnp.ndarray, num_bins: int, tail_bound: float):
    """Split + constrain raw params into knot positions and derivatives.

    params: (..., 3K-1) raw network output.
    Returns (x_knots, y_knots, derivs) with shapes (..., K+1), (..., K+1),
    (..., K+1); boundary derivatives pinned to 1 for linear tails.
    """
    K = num_bins
    w_raw = params[..., :K]
    h_raw = params[..., K : 2 * K]
    d_raw = params[..., 2 * K :]

    min_w = DEFAULT_MIN_BIN_WIDTH
    min_h = DEFAULT_MIN_BIN_HEIGHT
    min_d = DEFAULT_MIN_DERIVATIVE

    widths = jax.nn.softmax(w_raw, axis=-1)
    widths = min_w + (1.0 - min_w * K) * widths
    heights = jax.nn.softmax(h_raw, axis=-1)
    heights = min_h + (1.0 - min_h * K) * heights

    total = 2.0 * tail_bound
    cum_w = jnp.cumsum(widths, axis=-1) * total
    cum_h = jnp.cumsum(heights, axis=-1) * total
    zeros = jnp.zeros_like(cum_w[..., :1])
    x_knots = jnp.concatenate([zeros, cum_w], axis=-1) - tail_bound
    y_knots = jnp.concatenate([zeros, cum_h], axis=-1) - tail_bound
    # Pin the exact endpoints (cumsum rounding can drift the last knot).
    x_knots = x_knots.at[..., -1].set(tail_bound)
    y_knots = y_knots.at[..., -1].set(tail_bound)

    d_inner = min_d + jax.nn.softplus(d_raw)
    ones = jnp.ones_like(d_inner[..., :1])
    derivs = jnp.concatenate([ones, d_inner, ones], axis=-1)
    return x_knots, y_knots, derivs


def _searchsorted(knots: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Index k of the bin containing x: knots[k] <= x < knots[k+1].

    knots: (..., K+1); x: (...,). Vectorized comparison-sum (K is small, 24).
    """
    return jnp.clip(
        jnp.sum(x[..., None] >= knots[..., 1:], axis=-1),
        0,
        knots.shape[-1] - 2,
    )


def _take_gather(arr, idx):
    """Per-row knot lookup via gather."""
    return jnp.take_along_axis(arr, idx[..., None], axis=-1)[..., 0]


def rq_spline_forward(
    x: jnp.ndarray,
    params: jnp.ndarray,
    *,
    num_bins: int,
    tail_bound: float,
):
    """Forward RQ spline y = f(x) with linear tails.

    x: (...,) scalar per element; params: (..., 3K-1).
    Returns (y, log_det) each shaped like x. Outside [-B, B] the transform is
    the identity with zero log-det (linear tails).
    """
    return _rq_spline(x, params, num_bins=num_bins, tail_bound=tail_bound,
                      inverse=False)


def rq_spline_inverse(
    y: jnp.ndarray,
    params: jnp.ndarray,
    *,
    num_bins: int,
    tail_bound: float,
):
    """Inverse RQ spline x = f^{-1}(y); log_det is of the *inverse* map."""
    return _rq_spline(y, params, num_bins=num_bins, tail_bound=tail_bound,
                      inverse=True)


def _rq_spline(inputs, params, *, num_bins, tail_bound, inverse):
    x_knots, y_knots, derivs = _prepare_knots(params, num_bins, tail_bound)
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    # Clamp inputs for the in-spline math; tail values pass through identity.
    z = jnp.clip(inputs, -tail_bound, tail_bound)

    k = _searchsorted(y_knots if inverse else x_knots, z)
    x_k = _take_gather(x_knots, k)
    x_k1 = _take_gather(x_knots, k + 1)
    y_k = _take_gather(y_knots, k)
    y_k1 = _take_gather(y_knots, k + 1)
    d_k = _take_gather(derivs, k)
    d_k1 = _take_gather(derivs, k + 1)

    w = x_k1 - x_k
    h = y_k1 - y_k
    s = h / w  # bin slope

    if not inverse:
        xi = (z - x_k) / w
        xi1m = 1.0 - xi
        num = h * (s * xi**2 + d_k * xi * xi1m)
        den = s + (d_k1 + d_k - 2.0 * s) * xi * xi1m
        y = y_k + num / den
        deriv_num = s**2 * (d_k1 * xi**2 + 2.0 * s * xi * xi1m + d_k * xi1m**2)
        log_det = jnp.log(deriv_num) - 2.0 * jnp.log(den)
        out = jnp.where(inside, y, inputs)
        log_det = jnp.where(inside, log_det, 0.0)
        return out, log_det
    else:
        # Solve the quadratic for xi given y (Durkan et al. eq. 6-8).
        dy = z - y_k
        a = h * (s - d_k) + dy * (d_k1 + d_k - 2.0 * s)
        b = h * d_k - dy * (d_k1 + d_k - 2.0 * s)
        c = -s * dy
        disc = b**2 - 4.0 * a * c
        disc = jnp.maximum(disc, 0.0)
        xi = 2.0 * c / (-b - jnp.sqrt(disc))
        xi = jnp.clip(xi, 0.0, 1.0)
        x = x_k + xi * w
        xi1m = 1.0 - xi
        den = s + (d_k1 + d_k - 2.0 * s) * xi * xi1m
        deriv_num = s**2 * (d_k1 * xi**2 + 2.0 * s * xi * xi1m + d_k * xi1m**2)
        # log |dx/dy| = -(log |dy/dx|)
        log_det = 2.0 * jnp.log(den) - jnp.log(deriv_num)
        out = jnp.where(inside, x, inputs)
        log_det = jnp.where(inside, log_det, 0.0)
        return out, log_det


# ---------------------------------------------------------------------------
# Circular RQ spline on [0, 1) (phase variables)
# ---------------------------------------------------------------------------
# Monotone RQ spline f: [0,1] -> [0,1] with f(0)=0, f(1)=1 and PERIODIC
# derivative (d_0 = d_K from one shared parameter), composed with a learned
# rotation, so the induced density on the circle is continuous across the
# wrap point and an atom can sit anywhere in [0,1) — including at the wrap —
# without splitting across unbounded tails (Rezende et al. 2020, "Normalizing
# Flows on Tori and Spheres"-style construction). Used by the absolute-grid
# pulse RT representation (nets/mnle_net.MNLEConfig.rt_rep), where the
# within-slot phase is a circular variable.


def num_circular_spline_params(num_bins: int) -> int:
    """K widths + K heights + K derivatives (wrap-shared) + 1 rotation."""
    return 3 * num_bins + 1


def _prepare_circular_knots(params: jnp.ndarray, num_bins: int):
    K = num_bins
    w_raw = params[..., :K]
    h_raw = params[..., K : 2 * K]
    d_raw = params[..., 2 * K : 3 * K]
    rot_raw = params[..., 3 * K]

    min_w = DEFAULT_MIN_BIN_WIDTH
    min_h = DEFAULT_MIN_BIN_HEIGHT
    min_d = DEFAULT_MIN_DERIVATIVE

    widths = min_w + (1.0 - min_w * K) * jax.nn.softmax(w_raw, axis=-1)
    heights = min_h + (1.0 - min_h * K) * jax.nn.softmax(h_raw, axis=-1)
    cum_w = jnp.cumsum(widths, axis=-1)
    cum_h = jnp.cumsum(heights, axis=-1)
    zeros = jnp.zeros_like(cum_w[..., :1])
    x_knots = jnp.concatenate([zeros, cum_w], axis=-1)
    y_knots = jnp.concatenate([zeros, cum_h], axis=-1)
    x_knots = x_knots.at[..., -1].set(1.0)
    y_knots = y_knots.at[..., -1].set(1.0)

    d_inner = min_d + jax.nn.softplus(d_raw)  # (..., K): d_0 .. d_{K-1}
    derivs = jnp.concatenate([d_inner, d_inner[..., :1]], axis=-1)  # d_K = d_0
    rot = jax.nn.sigmoid(rot_raw)
    return x_knots, y_knots, derivs, rot


def rq_spline_circular(
    phi: jnp.ndarray,
    params: jnp.ndarray,
    *,
    num_bins: int,
    inverse: bool = False,
):
    """Circular RQ spline on [0,1): phi -> (out, log_det).

    Forward (normalizing): out = f(frac(phi - rot)). Inverse (generative):
    out = frac(f^{-1}(phi) + rot). Rotation is measure-preserving; the
    spline itself has f(0)=0, f(1)=1 with matching endpoint derivatives, so
    the density is continuous across the wrap point.
    """
    x_knots, y_knots, derivs, rot = _prepare_circular_knots(params, num_bins)

    if inverse:
        z = jnp.clip(phi, 0.0, 1.0 - 1e-6)
    else:
        z = (phi - rot) % 1.0
        z = jnp.clip(z, 0.0, 1.0 - 1e-6)

    k = _searchsorted(y_knots if inverse else x_knots, z)
    x_k, x_k1 = _take_gather(x_knots, k), _take_gather(x_knots, k + 1)
    y_k, y_k1 = _take_gather(y_knots, k), _take_gather(y_knots, k + 1)
    d_k, d_k1 = _take_gather(derivs, k), _take_gather(derivs, k + 1)

    w = x_k1 - x_k
    h = y_k1 - y_k
    s = h / w

    if not inverse:
        xi = jnp.clip((z - x_k) / w, 0.0, 1.0)
        xi1m = 1.0 - xi
        num = h * (s * xi**2 + d_k * xi * xi1m)
        den = s + (d_k1 + d_k - 2.0 * s) * xi * xi1m
        out = y_k + num / den
        deriv_num = s**2 * (d_k1 * xi**2 + 2.0 * s * xi * xi1m + d_k * xi1m**2)
        log_det = jnp.log(deriv_num) - 2.0 * jnp.log(den)
        return out, log_det
    else:
        dy = z - y_k
        a = h * (s - d_k) + dy * (d_k1 + d_k - 2.0 * s)
        b = h * d_k - dy * (d_k1 + d_k - 2.0 * s)
        c = -s * dy
        disc = jnp.maximum(b**2 - 4.0 * a * c, 0.0)
        xi = jnp.clip(2.0 * c / (-b - jnp.sqrt(disc)), 0.0, 1.0)
        x = x_k + xi * w
        xi1m = 1.0 - xi
        den = s + (d_k1 + d_k - 2.0 * s) * xi * xi1m
        deriv_num = s**2 * (d_k1 * xi**2 + 2.0 * s * xi * xi1m + d_k * xi1m**2)
        log_det = 2.0 * jnp.log(den) - jnp.log(deriv_num)
        return (x + rot) % 1.0, log_det
