"""Mixed Neural Likelihood Estimator (MNLE) in plain JAX.

Owns the behavior the reference delegates to ``sbi``'s
``likelihood_nn(model="mnle", ...)`` builder and ``MixedDensityEstimator``
(reference: src/sbi_for_diffusion_models/mnle.py:31-39, used for log_prob at
potentials.py:113):

* a **categorical head** p(choice | z) — MLP over the (z-scored) condition;
* a **conditional normalizing flow** p(log rt | z, onehot(choice)) — a stack of
  elementwise rational-quadratic-spline transforms (num_transforms=10,
  num_bins=24, hidden=128 by default, matching the reference hyperparameters)
  with a standard-normal base;
* **input transforms** baked into log_prob: optional log on the continuous
  column (``log_transform_x``, reference run_config.py:24-25) and independent
  z-scoring of both condition and continuous x, with the exact change-of-
  variables corrections.

Everything is a pure function of (params, inputs): ``MNLE.log_prob`` jits,
vmaps over trials/thetas/chains, and differentiates cleanly for NUTS.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .layers import dense, dense_init, mlp, mlp_init
from .spline import (
    num_circular_spline_params,
    num_spline_params,
    rq_spline_circular,
    rq_spline_forward,
    rq_spline_inverse,
)

__all__ = ["MNLEConfig", "MNLENet", "MNLE", "build_mnle"]

_LOG_SQRT_2PI = 0.5 * np.log(2.0 * np.pi)


@dataclass(frozen=True)
class MNLEConfig:
    """Architecture hyperparameters (defaults = reference mnle.py:36-38)."""

    condition_dim: int = 85
    num_categories: int = 3
    hidden_features: int = 128
    num_transforms: int = 10
    num_bins: int = 24
    tail_bound: float = 5.0
    log_transform_x: bool = True
    z_score_theta: bool = True
    z_score_x: bool = True
    # Depth of the conditioner MLPs (sbi's are 2 layers deep).
    trunk_depth: int = 2
    # Pulse summary embedding: when pulse_dim > 0 and embed_dim > 0, the
    # trailing ``pulse_dim`` block of the condition is compressed through a
    # learned MLP (together with leak-decayed evidence summaries computed
    # from the trial's own lambda = theta[lam_index]) before reaching the
    # heads. 0/0 reproduces the reference's flat 85-dim conditioning
    # (reference mnle.py:31-39).
    pulse_dim: int = 0
    embed_dim: int = 0
    embed_depth: int = 2
    lam_index: int = 1
    # "replace": the raw pulse block is swapped for [embedding, features]
    # (compresses 80 -> embed_dim + 6; lossy). "append": the raw block is
    # kept and [embedding?, features] are appended (strictly more
    # informative; use embed_dim=0 to append the physics features alone).
    embed_mode: str = "replace"
    # Censored-RT likelihood: trials whose choice equals ``censored_category``
    # have a (near-)deterministic RT — the simulator pins them to the window
    # end ~ T_MAX (reference rt_choice_model.py:208-218) — so their RT is a
    # point mass the continuous flow can only smooth into a z-dependent
    # distortion of the potential. With ``censor_rt=True`` those trials
    # contribute only the (correct) censoring probability P(choice | z), the
    # textbook censored-data likelihood; the flow trains and evaluates on
    # non-censored trials only. False reproduces the reference estimator's
    # smoothing behavior.
    censor_rt: bool = False
    censored_category: int = 2
    # RT representation.
    #
    # "log" (reference-style): the flow models z-scored log RT.
    #
    # "pulse" (physics-informed, an extension): evidence arrives only at
    # discrete pulse times, so boundary crossings cluster tightly at pulse
    # arrivals — empirically >90% of non-censored RT mass lies within the
    # first 10% of a pulse interval even at prior-median drift. The RT
    # distribution is near-ATOMIC on the grid rt = t_nd + (k + phi) * Delta
    # (t_nd read off the trial's own theta), which a smooth spline flow over
    # log RT can only blur — the dominant estimator bias found by
    # high-power SBC. This representation factors it exactly:
    #     p(rt | z, choice) = P(k | z, choice)              (slot head)
    #                       * p(phi | z, choice, k)          (flow, smooth)
    # with k = floor((rt - t_nd)/Delta) a categorical over num_pulse_slots
    # and phi in (0,1) the within-interval phase, flowed through a logit so
    # the density is exactly normalized on (0,1). Requires censor_rt=True
    # (the censored atom is handled by the choice head).
    #
    # "shifted_log" models the DECISION TIME directly: t = log(rt - t_nd),
    # with t_nd read from the condition (theta[tnd_index]). The hard response
    # onset rt = t_nd — the feature that identifies t_nd from data — is built
    # into the representation instead of being learned: the density is
    # exactly zero (a steep finite barrier, for sane NUTS gradients) for
    # rt <= t_nd, and the flow learns the decision-time shape, which is far
    # more stationary across theta than the shifted RT density. Motivated by
    # the measured onset-leak bias of the "log" rep at 10M budget
    # (artifacts/calibration_censor10m_pt6_96: tau mean rank 147/600 — the
    # smoothed onset leaks density below t_nd, so matching the observed
    # min-RT pushes the t_nd posterior up). This is the standard shifted
    # response-time construction in the DDM literature; no reference
    # counterpart (the reference flows over log rt, mnle.py:31-39). Requires
    # censor_rt=True.
    rt_rep: str = "log"
    # Condition dims to log-transform before z-scoring (conditioning only —
    # x is untouched, so no density correction). Motivation: the prior puts
    # LogNormal tails on lam/v/B (pipeline.build_prior_theta), so raw
    # z-scoring parks the tail (v up to ~26 = +12 sigma) in the trunk's
    # saturation zone and the learned likelihood flattens there — the
    # measured SBC shrinkage corr(v_true, v_rank) = +0.2..0.4 shared by
    # EVERY raw-conditioned model (artifacts/calibration_*_96). Log-scaling
    # those dims makes the conditioner resolve multiplicative structure.
    log_condition_dims: tuple = ()
    num_pulse_slots: int = 80
    pulse_interval: float = 0.1
    euler_dt: float = 5e-4
    tnd_index: int = 4
    # Left-tail sharpening (rt_rep "log"/"shifted_log"): a FIXED monotone
    # pre-transform phi(t) = t - exp(-k (t - c)) / k applied to the
    # standardized flow coordinate before the spline stack, with
    # log|phi'| = log1p(exp(-k (t - c))). Motivation (round-4): diffusion
    # first-passage density decays DOUBLY exponentially as dt -> 0
    # (p(dt) ~ dt^{-3/2} exp(-c/dt)), but the flow's Gaussian base decays
    # only like exp(-t^2/2) in log-decision-time space — the structural
    # near-onset overdensity that lets the sampler trade t_nd upward while
    # still "explaining" the smallest RTs (the measured one-sided tau SBC
    # bias that survives the exact-onset shifted_log rep,
    # artifacts/calibration_shifted10m_slice_96). phi leaves the data bulk
    # (t > c) untouched where the spline can reshape freely, and pushes
    # t < c doubly-exponentially into the base's tail — a region the
    # linear-tail spline CANNOT undo, so the learned density inherits the
    # correct super-Gaussian left decay at any budget. k = 0 disables
    # (default; all previously saved models load unchanged).
    tail_sharp_k: float = 0.0
    # None is a TRAINING-TIME sentinel (mnle.train_mnle resolves it to just
    # below the training data's left edge in standardized units before the
    # network is built); a built estimator always carries a concrete float.
    tail_sharp_c: float | None = -3.5
    # Conditional location-scale layer (rt_rep "log"/"shifted_log"): a
    # trunk-predicted affine z = (t - mu(c, choice)) * exp(-ls(c, choice))
    # applied BEFORE the spline chain (normalizing direction), exact
    # log-det = -ls. Motivation (round-4, onset_density_check_sharp12):
    # for conditions whose simulator decision-time distribution is nearly
    # deterministic (97-99.9% of mass inside one 0.25 s bin), the learned
    # conditional density is over-smoothed in BOTH directions — the spline
    # chain alone must synthesize extreme derivatives from the globally
    # z-scored coordinate to sharpen, and MLE undersharpens. With the
    # hard one-sided support constraint (tau < min_i rt_i) the symmetric
    # over-smoothing becomes the measured one-sided tau rank bias. The
    # affine factorizes per-condition location/scale out of the splines
    # (the standard NSF affine+spline interleaving, cf. sbi's default
    # density estimators, reference mnle.py:31-39), so each condition is
    # modeled at unit scale and sharpening costs one easy -ls log-det
    # term. False = off (default; saved models load unchanged).
    cond_affine: bool = False
    # Grid anchor for rt_rep="pulse".
    #
    # "tnd": slots anchored at the trial's own t_nd — the atom sits at a
    # fixed small phase, but k(theta) jumps at slot boundaries as t_nd
    # varies, making the POTENTIAL discontinuous in theta (NUTS divergence
    # storms observed).
    #
    # "absolute": slots anchored at 0 — k = floor(rt/Delta) and the phase
    # phi = frac(rt/Delta) are theta-independent, so the potential is smooth
    # in theta; the atom's phase location (= frac(t_nd/Delta) + jitter) is
    # predicted by the conditioner, and the phase flow is a chain of
    # CIRCULAR RQ splines (uniform base) so the peak can sit anywhere on
    # the circle, including the wrap point.
    grid_anchor: str = "absolute"

    def __post_init__(self):
        # JSON round-trips tuples as lists; keep the config hashable.
        object.__setattr__(
            self, "log_condition_dims", tuple(self.log_condition_dims)
        )


def transform_condition(cfg: "MNLEConfig", condition):
    """Log-transform ``cfg.log_condition_dims`` of the condition (before
    z-scoring). Pure conditioning reparameterization: the modeled x is
    untouched, so no Jacobian correction; gradients w.r.t. theta flow
    through the log (and are better scaled on multiplicative parameters)."""
    if not cfg.log_condition_dims:
        return condition
    idx = jnp.asarray(cfg.log_condition_dims, jnp.int32)
    vals = jnp.log(jnp.maximum(condition[..., idx], 1e-37))
    return condition.at[..., idx].set(vals)


def shifted_rt_transform(cfg: "MNLEConfig", rt, condition):
    """(rt_rep="shifted_log") rt -> t = log(rt - t_nd), with
    t_nd = condition[..., cfg.tnd_index].

    Returns ``(t, log_det, barrier)``: the transformed coordinate, the
    change-of-variables term |d t / d rt| = 1/(rt - t_nd) in log space
    (= -t), and a gentle linear barrier (0 on the support rt > t_nd,
    slope -50 per second of violation below it).

    Below-onset suppression is dominated by the clamped log itself, not
    the barrier: dt <= floor gives t = log(1e-6) ~ -13.8, which after
    z-scoring sits ~10+ sigmas into the flow's Gaussian tail — roughly
    -70 log-density units PER VIOLATING TRIAL (exp(-70) ~ 4e-31, zero for
    MH purposes). The barrier only restores a gradient on the clamp's
    plateau so NUTS is guided back into the support. An earlier steep
    variant (slope 1e4) triggered divergence storms on datasets whose
    posterior mass piles against the onset wall (hundreds of divergences
    per SBC group); the leapfrog energy-error scale of this version is
    ~50 * step, well under the divergence threshold.
    """
    tau = condition[..., cfg.tnd_index]
    dt = rt - tau
    floor = jnp.float32(1e-6)
    t = jnp.log(jnp.maximum(dt, floor))
    barrier = -50.0 * jax.nn.relu(floor - dt)
    return t, -t, barrier


def tail_sharp_transform(cfg: "MNLEConfig", t):
    """phi(t) = t - exp(-k (t - c)) / k on the standardized flow coordinate
    (see MNLEConfig.tail_sharp_k). Returns (phi(t), log|phi'(t)|). The
    exponent is clamped at 30 (exp(30) ~ 1e13) so far-below-onset proposals
    produce a finite, astronomically negative log-density with finite
    gradients instead of inf/NaN (the tau-slice/grid-hop moves evaluate
    there)."""
    k = cfg.tail_sharp_k
    e = jnp.exp(jnp.minimum(-k * (t - cfg.tail_sharp_c), 30.0))
    return t - e / k, jnp.log1p(e)


def tail_sharp_inverse(cfg: "MNLEConfig", y):
    """Inverse of :func:`tail_sharp_transform` by Newton iteration (phi is
    smooth, strictly increasing, concave; phi' >= 1 keeps steps bounded).
    Sampling-path only — log_prob never needs it."""
    k = cfg.tail_sharp_k
    c = cfg.tail_sharp_c
    # Branch-aware init: identity region above c, asymptotic
    # y ~ -exp(-k (t - c)) / k below it.
    t = jnp.where(y > c, y, c - jnp.log1p(k * jnp.maximum(c - y, 0.0)) / k)

    def step(t, _):
        e = jnp.exp(jnp.minimum(-k * (t - c), 30.0))
        return t - (t - e / k - y) / (1.0 + e), None

    t, _ = jax.lax.scan(step, t, None, length=30)
    return t


def pulse_grid_split(cfg: "MNLEConfig", rt, t_nd):
    if cfg.grid_anchor == "absolute":
        delta = cfg.pulse_interval
        # NO barrier here: a theta-dependent hard truncation without
        # renormalization would bias the likelihood (the removed mass varies
        # with t_nd). The absolute rep instead lets the conditioner learn
        # near-zero mass below t_nd; the tnd-anchored rep encodes the
        # constraint structurally (its grid starts at t_nd).
        barrier = jnp.zeros_like(rt)
        u = jnp.clip(rt, cfg.euler_dt, None) / delta
        k = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, cfg.num_pulse_slots - 1)
        phi = jnp.clip(u - k.astype(u.dtype), 1e-6, 1.0 - 1e-6)
        # s IS the phase (the circular flow consumes it directly);
        # |d phi / d rt| = 1/delta.
        ds = jnp.broadcast_to(-jnp.log(delta), phi.shape)
        return k, phi, phi, ds, barrier
    return _pulse_grid_split_tnd(cfg, rt, t_nd)


def _pulse_grid_split_tnd(cfg: "MNLEConfig", rt, t_nd):
    """rt -> (k, phi, s, log|ds/drt|, barrier) for the "pulse" RT rep.

    k = floor((rt - t_nd)/Delta) clipped to [0, K-1]; phi in (0,1) is the
    within-interval phase; s = logit(phi) (bijective (0,1) -> R, so the flow
    density is exactly normalized on the interval). ``barrier`` is a smooth
    quadratic penalty active only where rt <= t_nd + dt — the region the
    simulator cannot reach (rt = t_nd + hit_step*dt with hit_step >= 1,
    reference rt_choice_model.py:218), which the log-RT rep could only
    penalize through learned density mass.
    """
    delta = cfg.pulse_interval
    dtt = rt - t_nd
    behind = jax.nn.relu(cfg.euler_dt - dtt)
    barrier = -((behind / delta) ** 2) * 1e4
    u = jnp.clip(dtt, cfg.euler_dt, None) / delta
    k = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, cfg.num_pulse_slots - 1)
    phi = jnp.clip(u - k.astype(u.dtype), 1e-6, 1.0 - 1e-6)
    s = jnp.log(phi) - jnp.log1p(-phi)
    # |d s / d rt| = 1 / (phi (1 - phi) delta)
    ds = -jnp.log(phi) - jnp.log1p(-phi) - jnp.log(delta)
    return k, phi, s, ds, barrier


def pulse_grid_join(cfg: "MNLEConfig", k, s, t_nd):
    """Inverse of :func:`pulse_grid_split` for sampling: (k, s) -> rt."""
    if cfg.grid_anchor == "absolute":
        phi = jnp.clip(s, 1e-6, 1.0 - 1e-6)
        return (k.astype(s.dtype) + phi) * cfg.pulse_interval
    phi = jnp.clip(jax.nn.sigmoid(s), 1e-6, 1.0 - 1e-6)
    return t_nd + (k.astype(s.dtype) + phi) * cfg.pulse_interval


def _slot_features(cfg: "MNLEConfig", k, t_nd, dtype):
    """Flow-head conditioning for the pulse rep: normalized slot index,
    plus (absolute anchor) sin/cos of t_nd's grid phase — the atom's
    expected phase location, handed to the conditioner so the circular flow
    only has to learn the residual jitter shape, not the phase-tracking
    itself."""
    k_norm = ((k.astype(dtype) + 0.5) / cfg.num_pulse_slots)[..., None]
    if cfg.grid_anchor != "absolute":
        return k_norm
    tp = (t_nd / cfg.pulse_interval) % 1.0
    ang = 2.0 * jnp.pi * tp
    return jnp.concatenate(
        [k_norm, jnp.sin(ang)[..., None], jnp.cos(ang)[..., None]], axis=-1
    )


# Horizon times (seconds) for the leak-decayed pulse-evidence summaries.
_FEATURE_HORIZONS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)


def pulse_physics_features(c_raw, theta_dim: int, pulse_dim: int, lam_index: int):
    """Leak-decayed pulse-evidence summaries, one per horizon time.

    The accumulator's deterministic pulse contribution at time T is
    v * sum_p s_p * exp(-lambda (T - t_p)) (reference rt_choice_model.py:
    186-192); with lambda read off the trial's own theta these sums are exact
    sufficient-statistics-style features of the 80-dim stimulus. Each is
    normalized by the sqrt of its weight power so random +-1 sequences give
    unit variance (z-scored by construction).
    """
    from ..constants import PULSE_INTERVAL

    lam = jnp.abs(c_raw[..., lam_index])
    s = c_raw[..., theta_dim : theta_dim + pulse_dim]
    t_p = jnp.arange(pulse_dim, dtype=jnp.float32) * PULSE_INTERVAL
    feats = []
    for T in _FEATURE_HORIZONS:
        w = jnp.where(t_p < T, jnp.exp(-lam[..., None] * (T - t_p)), 0.0)
        F = jnp.sum(w * s, axis=-1)
        denom = jnp.sqrt(jnp.sum(w * w, axis=-1) + 1e-6)
        feats.append(F / denom)
    return jnp.stack(feats, axis=-1)


# All MNLE matmuls run at HIGHEST precision. On the GPU the float32 default
# may use TF32 tensor-core passes (about three decimal digits), which compound
# through the 10-transform spline stack into O(0.1-1) log-prob jitter —
# enough to perturb NUTS trajectories and high-power SBC. HIGHEST keeps true
# float32 products; the layers are small (hidden=128), so the cost is minor.
_PRECISION = jax.lax.Precision.HIGHEST


def _dense(p, x):
    return dense(p, x, _PRECISION)


def _mlp(p, x):
    return mlp(p, x, _PRECISION)


class MNLENet:
    """Raw network as pure functions of an explicit parameter tree (built by
    :meth:`init`). Operates on already-standardized inputs: ``u`` = z-scored
    (log-)rt scalar, ``c`` = z-scored condition vector."""

    def __init__(self, cfg: MNLEConfig):
        self.cfg = cfg

    def _uses_embed(self):
        cfg = self.cfg
        return cfg.embed_dim > 0 and cfg.pulse_dim > 0

    def context_dim(self) -> int:
        """Width of :meth:`make_context`'s output."""
        cfg = self.cfg
        append = cfg.embed_mode == "append"
        if cfg.pulse_dim <= 0 or not (self._uses_embed() or append):
            return cfg.condition_dim
        k = cfg.condition_dim - cfg.pulse_dim
        width = (cfg.condition_dim if append else k) + len(_FEATURE_HORIZONS)
        return width + (cfg.embed_dim if self._uses_embed() else 0)

    def init(self, key: jax.Array) -> dict:
        """Parameter tree with the module paths of the original Flax
        estimator (``cat_net/Dense_i``, ``flow_trunk/...``, ``spline_head_i``,
        ``affine_head``, ``pulse_embed``, ``pulse_slot_head``)."""
        cfg = self.cfg
        H = cfg.hidden_features
        ctx = self.context_dim()
        params = {
            "cat_net": mlp_init(
                key, ("cat_net",), ctx, H, cfg.num_categories, cfg.trunk_depth
            ),
            # Shared context trunk for the flow + one spline-parameter head
            # per transform (pyknos-NSF style conditioners, fused: one trunk
            # matmul feeds all 10 heads).
            "flow_trunk": mlp_init(
                key, ("flow_trunk",), ctx + cfg.num_categories, H, H,
                cfg.trunk_depth,
            ),
        }
        head_in = H
        if cfg.rt_rep == "pulse":
            head_in += 3 if cfg.grid_anchor == "absolute" else 1
        circular = cfg.rt_rep == "pulse" and cfg.grid_anchor == "absolute"
        head_params = (
            num_circular_spline_params(cfg.num_bins)
            if circular
            else num_spline_params(cfg.num_bins)
        )
        for i in range(cfg.num_transforms):
            name = f"spline_head_{i}"
            params[name] = dense_init(key, (name,), head_in, head_params)
        if cfg.cond_affine and cfg.rt_rep != "pulse":
            # (mu, log_sigma) of the conditional location-scale layer
            # (MNLEConfig.cond_affine). Zero-init (kernel AND bias) makes the
            # layer exactly the identity at init, so training starts from
            # the plain spline-chain density and learns the conditional
            # shift/scale as a perturbation.
            params["affine_head"] = dense_init(
                key, ("affine_head",), H, 2, zero_kernel=True
            )
        if self._uses_embed():
            params["pulse_embed"] = mlp_init(
                key, ("pulse_embed",), cfg.pulse_dim + len(_FEATURE_HORIZONS),
                H, cfg.embed_dim, cfg.embed_depth,
            )
        if cfg.rt_rep == "pulse":
            # Pulse-slot head: P(k | ctx, choice) over the RT grid.
            params["pulse_slot_head"] = dense_init(
                key, ("pulse_slot_head",), H, cfg.num_pulse_slots
            )
        return params

    def make_context(self, params, c_std, c_raw):
        """Head input: z-scored condition, optionally augmented with the
        pulse summary block ("replace": raw pulses swapped for [embedding,
        physics features]; "append": raw pulses kept, [embedding?, features]
        appended)."""
        cfg = self.cfg
        use_embed = self._uses_embed()
        append = cfg.embed_mode == "append"
        if cfg.pulse_dim <= 0 or not (use_embed or append):
            return c_std
        k = cfg.condition_dim - cfg.pulse_dim
        feats = pulse_physics_features(c_raw, k, cfg.pulse_dim, cfg.lam_index)
        parts = [c_std] if append else [c_std[..., :k]]
        if use_embed:
            parts.append(
                _mlp(
                    params["pulse_embed"],
                    jnp.concatenate([c_std[..., k:], feats], -1),
                )
            )
        parts.append(feats)
        return jnp.concatenate(parts, axis=-1)

    def choice_logits(self, params, c):
        """(..., context_dim) -> (..., num_categories) log-probabilities."""
        return jax.nn.log_softmax(_mlp(params["cat_net"], c), axis=-1)

    def _trunk_emb(self, params, c, choice_onehot):
        ctx = jnp.concatenate([c, choice_onehot], axis=-1)
        return jax.nn.relu(_mlp(params["flow_trunk"], ctx))

    def slot_logits(self, params, c, choice_onehot):
        """(pulse rep) (..., ctx), (..., C) -> (..., K) log P(k | c, choice)."""
        emb = self._trunk_emb(params, c, choice_onehot)
        return jax.nn.log_softmax(_dense(params["pulse_slot_head"], emb), axis=-1)

    def _flow_params(self, params, c, choice_onehot, k_feat=None):
        emb = self._trunk_emb(params, c, choice_onehot)
        affine = None
        if self.cfg.cond_affine and self.cfg.rt_rep != "pulse":
            a = _dense(params["affine_head"], emb)
            # log_sigma clipped so an extreme conditioner output cannot
            # produce inf/zero scales under MCMC's off-support probes.
            affine = (a[..., 0], jnp.clip(a[..., 1], -7.0, 7.0))
        if k_feat is not None:
            # Pulse rep: the phase flow is conditioned on the slot index
            # (normalized scalar) — phase shape drifts with slot (later slots
            # are closer to leak equilibrium, broader phases).
            emb = jnp.concatenate([emb, k_feat], axis=-1)
        heads = [
            _dense(params[f"spline_head_{i}"], emb)
            for i in range(self.cfg.num_transforms)
        ]
        return heads, affine

    def flow_log_prob(self, params, u, c, choice_onehot, k_feat=None):
        """log p(u | c, choice) for scalar u (shape (...,))."""
        heads, affine = self._flow_params(params, c, choice_onehot, k_feat)
        log_det = jnp.zeros_like(u)
        z = u
        if self.cfg.rt_rep == "pulse" and self.cfg.grid_anchor == "absolute":
            # Circular phase flow: uniform base on [0,1), periodic-continuous
            # density — the atom's phase can live anywhere on the circle.
            for p in heads:
                z, ld = rq_spline_circular(z, p, num_bins=self.cfg.num_bins)
                log_det = log_det + ld
            return log_det  # log uniform(z) = 0
        if affine is not None:
            mu, ls = affine
            z = (z - mu) * jnp.exp(-ls)
            log_det = log_det - ls
        for p in heads:  # normalizing direction: data -> base
            z, ld = rq_spline_forward(
                z, p, num_bins=self.cfg.num_bins, tail_bound=self.cfg.tail_bound
            )
            log_det = log_det + ld
        base = -_LOG_SQRT_2PI - 0.5 * z**2
        return base + log_det

    def flow_sample(self, params, key, c, choice_onehot, k_feat=None):
        """Draw u ~ p(u | c, choice); c/choice_onehot shaped (..., d)."""
        heads, affine = self._flow_params(params, c, choice_onehot, k_feat)
        if self.cfg.rt_rep == "pulse" and self.cfg.grid_anchor == "absolute":
            z = jax.random.uniform(key, c.shape[:-1])
            for p in reversed(heads):
                z, _ = rq_spline_circular(
                    z, p, num_bins=self.cfg.num_bins, inverse=True
                )
            return z
        z = jax.random.normal(key, c.shape[:-1])
        for p in reversed(heads):  # generative direction: base -> data
            z, _ = rq_spline_inverse(
                z, p, num_bins=self.cfg.num_bins, tail_bound=self.cfg.tail_bound
            )
        if affine is not None:
            mu, ls = affine
            z = z * jnp.exp(ls) + mu
        return z


@dataclass
class MNLE:
    """Trained estimator: params + standardization stats + pure methods.

    ``log_prob(x, condition)`` follows the sbi x-convention the reference packs
    (reference rt_choice_model.py:332-343): x[..., 0] = rt (raw seconds, or
    log-rt if the pipeline logged manually), x[..., 1] = choice in {0,1,2}.
    ``condition[..., :]`` = z = [theta(5), pulse_sides(P)].
    """

    cfg: MNLEConfig
    params: Any
    cond_mean: jnp.ndarray
    cond_std: jnp.ndarray
    x_mean: jnp.ndarray  # scalar, stats of the (log-)rt column
    x_std: jnp.ndarray
    # Training provenance (simulation budget, epochs, losses) — persisted by
    # save_model so downstream artifacts (e.g. calibration summaries) record
    # the true budget instead of a CLI default.
    train_meta: dict | None = None
    _net: MNLENet = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_net", MNLENet(self.cfg))

    # -- pure functional core (safe to close over under jit) ---------------
    def log_prob_fn(self, params, x, condition):
        """log p(x | condition), broadcasting over leading axes.

        x: (..., 2); condition: (..., condition_dim). Returns (...,).
        """
        cfg = self.cfg
        rt = x[..., 0]
        choice = x[..., 1].astype(jnp.int32)

        c = transform_condition(cfg, condition)
        if cfg.z_score_theta:
            c = (c - self.cond_mean) / self.cond_std

        onehot = jax.nn.one_hot(choice, cfg.num_categories)
        ctx = self._net.make_context(params, c, condition)
        logits = self._net.choice_logits(params, ctx)
        cat_lp = jnp.take_along_axis(logits, choice[..., None], axis=-1)[..., 0]

        if cfg.rt_rep == "pulse":
            # rt = t_nd + (k + phi) * Delta: slot head carves the atomic
            # structure, the flow models the smooth within-interval phase.
            t_nd = condition[..., cfg.tnd_index]
            k, _, s, ds, barrier = pulse_grid_split(cfg, rt, t_nd)
            t, log_det = s, ds
            if cfg.z_score_x and cfg.grid_anchor != "absolute":
                t = (t - self.x_mean) / self.x_std
                log_det = log_det - jnp.log(self.x_std)
            slot_all = self._net.slot_logits(params, ctx, onehot)
            slot_lp = jnp.take_along_axis(slot_all, k[..., None], axis=-1)[..., 0]
            k_feat = _slot_features(cfg, k, t_nd, t.dtype)
            flow_lp = self._net.flow_log_prob(params, t, ctx, onehot, k_feat)
            rt_term = slot_lp + flow_lp + log_det + barrier
            not_censored = (choice != cfg.censored_category).astype(rt_term.dtype)
            return cat_lp + not_censored * rt_term

        log_det = jnp.zeros_like(rt)
        barrier = jnp.zeros_like(rt)
        t = rt
        if cfg.rt_rep == "shifted_log":
            t, ld, barrier = shifted_rt_transform(cfg, rt, condition)
            log_det = log_det + ld
        elif cfg.log_transform_x:
            t_safe = jnp.maximum(t, 1e-37)
            log_det = log_det - jnp.log(t_safe)  # |d log(rt)/d rt| = 1/rt
            t = jnp.log(t_safe)
        if cfg.z_score_x:
            t = (t - self.x_mean) / self.x_std
            log_det = log_det - jnp.log(self.x_std)
        if cfg.tail_sharp_k > 0:
            t, ld_s = tail_sharp_transform(cfg, t)
            log_det = log_det + ld_s

        flow_lp = self._net.flow_log_prob(params, t, ctx, onehot)
        if cfg.censor_rt:
            # Censored trials: P(choice | z) only (their RT is deterministic;
            # see MNLEConfig.censor_rt). Also stops flow gradients from the
            # point-mass rows during training, since the training loss is
            # -mean(log_prob).
            not_censored = (choice != cfg.censored_category).astype(flow_lp.dtype)
            return cat_lp + not_censored * (flow_lp + log_det + barrier)
        return cat_lp + flow_lp + log_det + barrier

    def log_prob(self, x, condition):
        return self.log_prob_fn(self.params, jnp.asarray(x), jnp.asarray(condition))

    def sample_fn(self, params, key, condition):
        """One (rt, choice) draw per condition row; condition: (..., d)."""
        cfg = self.cfg
        c = transform_condition(cfg, condition)
        if cfg.z_score_theta:
            c = (c - self.cond_mean) / self.cond_std
        k_cat, k_flow = jax.random.split(key)
        ctx = self._net.make_context(params, c, condition)
        logits = self._net.choice_logits(params, ctx)
        choice = jax.random.categorical(k_cat, logits, axis=-1)
        onehot = jax.nn.one_hot(choice, cfg.num_categories)
        if cfg.rt_rep == "pulse":
            k_slot, k_phi = jax.random.split(k_flow)
            slot_all = self._net.slot_logits(params, ctx, onehot)
            k = jax.random.categorical(k_slot, slot_all, axis=-1)
            k_feat = _slot_features(
                cfg, k, condition[..., cfg.tnd_index], jnp.float32
            )
            u = self._net.flow_sample(params, k_phi, ctx, onehot, k_feat)
            if cfg.z_score_x and cfg.grid_anchor != "absolute":
                u = u * self.x_std + self.x_mean
            t = pulse_grid_join(cfg, k, u, condition[..., cfg.tnd_index])
        else:
            u = self._net.flow_sample(params, k_flow, ctx, onehot)
            t = u
            if cfg.tail_sharp_k > 0:
                t = tail_sharp_inverse(cfg, t)
            if cfg.z_score_x:
                t = t * self.x_std + self.x_mean
            if cfg.rt_rep == "shifted_log":
                t = condition[..., cfg.tnd_index] + jnp.exp(t)
            elif cfg.log_transform_x:
                t = jnp.exp(t)
        if cfg.censor_rt:
            from ..constants import T_MAX

            t = jnp.where(choice == cfg.censored_category, jnp.float32(T_MAX), t)
        return jnp.stack([t, choice.astype(jnp.float32)], axis=-1)

    def sample(self, key, condition):
        return self.sample_fn(self.params, key, jnp.asarray(condition))


def build_mnle(
    key: jax.Array,
    cfg: MNLEConfig,
    *,
    cond_mean=None,
    cond_std=None,
    x_mean=0.0,
    x_std=1.0,
) -> MNLE:
    """Initialize an untrained MNLE with given standardization stats."""
    if cfg.rt_rep in ("pulse", "shifted_log") and not cfg.censor_rt:
        raise ValueError(
            f"rt_rep={cfg.rt_rep!r} requires censor_rt=True: the censored "
            "atom is handled by the choice head, not the RT flow"
        )
    if cfg.rt_rep not in ("log", "pulse", "shifted_log"):
        raise ValueError(f"unknown rt_rep {cfg.rt_rep!r}")
    # jit the init: one traced program instead of dozens of eager draws.
    params = jax.jit(MNLENet(cfg).init)(key)
    if cond_mean is None:
        cond_mean = jnp.zeros((cfg.condition_dim,), jnp.float32)
    if cond_std is None:
        cond_std = jnp.ones((cfg.condition_dim,), jnp.float32)
    return MNLE(
        cfg=cfg,
        params=params,
        cond_mean=jnp.asarray(cond_mean, jnp.float32),
        cond_std=jnp.asarray(cond_std, jnp.float32),
        x_mean=jnp.asarray(x_mean, jnp.float32),
        x_std=jnp.asarray(x_std, jnp.float32),
    )
