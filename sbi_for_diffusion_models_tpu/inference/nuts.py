"""No-U-Turn Sampler: iterative multinomial NUTS, pure JAX, vmapped chains.

Owns the capability the reference delegates to Pyro's NUTS via
``MCMCPosterior(..., method="nuts_pyro")`` (reference:
src/sbi_for_diffusion_models/mnle.py:77-93): multinomial NUTS (Betancourt
2017) with Stan-style warmup — dual-averaging step-size adaptation and
windowed diagonal mass-matrix estimation.

Design notes
------------
* The doubling loop and subtree builds are ``lax.while_loop``s — no recursion,
  no Python control flow; a single compiled program serves every draw.
* Within-subtree U-turn checks use the checkpoint-stack scheme (as in
  numpyro's iterative algorithm): even leaves store (momentum, prefix
  momentum-sum) into a ``(max_depth, D)`` stack slot indexed by
  ``popcount(n >> 1)``; odd leaves with ``t`` trailing one-bits check the
  ``t`` aligned segments that end there.
* Everything is written single-chain and ``vmap``ed by the caller — extra
  chains ride the same launches, so run many (the reference hardwires 2).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "run_nuts",
    "nuts_step",
    "find_reasonable_step_size",
    "ReplicaExchange",
    "geometric_ladder",
]

_MAX_DELTA_ENERGY = 1000.0  # divergence threshold (Stan's default)


# ---------------------------------------------------------------------------
# Hamiltonian pieces
# ---------------------------------------------------------------------------
def _kinetic(p, inv_mass):
    return 0.5 * jnp.sum(p * p * inv_mass)


def _leapfrog(vg_fn, u, p, g, eps, inv_mass):
    """One leapfrog step; g = grad logp(u). Returns (u', p', logp', g')."""
    p_half = p + 0.5 * eps * g
    u_new = u + eps * inv_mass * p_half
    logp_new, g_new = vg_fn(u_new)
    p_new = p_half + 0.5 * eps * g_new
    return u_new, p_new, logp_new, g_new


def _popcount(n):
    """Number of set bits of a non-negative int32 (max_depth <= 31)."""

    def body(state):
        n, c = state
        return n >> 1, c + (n & 1)

    _, c = lax.while_loop(lambda s: s[0] > 0, body, (n, jnp.int32(0)))
    return c


def _trailing_ones(n):
    def body(state):
        n, c = state
        return n >> 1, c + 1

    _, c = lax.while_loop(lambda s: (s[0] & 1) == 1, body, (n, jnp.int32(0)))
    return c


def _is_turning(v_left, v_right, rho):
    """Generalized U-turn criterion with velocities v = inv_mass * p."""
    return (jnp.dot(v_left, rho) <= 0.0) | (jnp.dot(v_right, rho) <= 0.0)


# ---------------------------------------------------------------------------
# Subtree construction (iterative, fixed-size checkpoint stack)
# ---------------------------------------------------------------------------
class _Subtree(NamedTuple):
    leaf_idx: jnp.ndarray
    u: jnp.ndarray  # current (time-ordered) edge state
    p: jnp.ndarray
    g: jnp.ndarray
    logp: jnp.ndarray
    rho: jnp.ndarray  # momentum sum over leaves built so far
    prop_u: jnp.ndarray  # multinomial proposal within the subtree
    prop_logp: jnp.ndarray
    log_w: jnp.ndarray  # logsumexp of leaf weights (relative to H0)
    sum_accept: jnp.ndarray
    turning: jnp.ndarray
    diverging: jnp.ndarray
    r_ckpts: jnp.ndarray  # (max_depth+1, D) momentum checkpoints
    rsum_ckpts: jnp.ndarray  # (max_depth+1, D) prefix momentum-sums


def _build_subtree(
    key, u, p, g, logp, depth, direction, eps, inv_mass, H0, max_depth, vg_fn
):
    """Build 2**depth leaves by repeated leapfrog from (u, p) in `direction`.

    Returns a _Subtree whose (u, p, g, logp) is the far edge reached, plus the
    subtree's multinomial proposal, weight, momentum sum, and flags.
    """
    D = u.shape[0]
    num_leaves = jnp.int32(1) << depth
    signed_eps = eps * direction.astype(eps.dtype)

    init = _Subtree(
        leaf_idx=jnp.int32(0),
        u=u,
        p=p,
        g=g,
        logp=logp,
        rho=jnp.zeros_like(p),
        prop_u=u,
        prop_logp=logp,
        log_w=-jnp.inf,
        sum_accept=jnp.float32(0.0),
        turning=jnp.bool_(False),
        diverging=jnp.bool_(False),
        r_ckpts=jnp.zeros((max_depth + 1, D), u.dtype),
        rsum_ckpts=jnp.zeros((max_depth + 1, D), u.dtype),
    )

    def cond(st: _Subtree):
        return (st.leaf_idx < num_leaves) & (~st.turning) & (~st.diverging)

    def body(st: _Subtree):
        n = st.leaf_idx
        u_new, p_new, logp_new, g_new = _leapfrog(
            vg_fn, st.u, st.p, st.g, signed_eps, inv_mass
        )
        energy = -logp_new + _kinetic(p_new, inv_mass)
        delta = energy - H0
        delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
        diverging = delta > _MAX_DELTA_ENERGY
        leaf_log_w = -delta
        accept = jnp.minimum(1.0, jnp.exp(-delta))

        # Progressive multinomial sampling within the subtree.
        new_log_w = jnp.logaddexp(st.log_w, leaf_log_w)
        take_new = jnp.log(
            jax.random.uniform(jax.random.fold_in(key, n))
        ) < (leaf_log_w - new_log_w)
        prop_u = jnp.where(take_new, u_new, st.prop_u)
        prop_logp = jnp.where(take_new, logp_new, st.prop_logp)

        rho_before = st.rho
        rho_after = rho_before + p_new

        # Checkpoint store (even leaves) ---------------------------------
        is_even = (n & 1) == 0
        slot = _popcount(n >> 1)
        r_ckpts = jnp.where(
            is_even, st.r_ckpts.at[slot].set(p_new), st.r_ckpts
        )
        rsum_ckpts = jnp.where(
            is_even, st.rsum_ckpts.at[slot].set(rho_before), st.rsum_ckpts
        )

        # U-turn checks for aligned segments ending at odd leaf n --------
        t_ones = _trailing_ones(n)
        idx_max = _popcount(n >> 1)
        idx_min = idx_max - t_ones + 1

        def check_turn(carry):
            i, turning = carry
            p_left = r_ckpts[i]
            rho_seg = rho_after - rsum_ckpts[i]
            turning = turning | _is_turning(
                p_left * inv_mass, p_new * inv_mass, rho_seg
            )
            return i + 1, turning

        def check_cond(carry):
            i, turning = carry
            return (i <= idx_max) & (~turning)

        _, seg_turning = lax.while_loop(
            check_cond, check_turn, (idx_min, jnp.bool_(False))
        )
        turning = jnp.where((n & 1) == 1, seg_turning, False)

        return _Subtree(
            leaf_idx=n + 1,
            u=u_new,
            p=p_new,
            g=g_new,
            logp=logp_new,
            rho=rho_after,
            prop_u=prop_u,
            prop_logp=prop_logp,
            log_w=new_log_w,
            sum_accept=st.sum_accept + accept,
            turning=turning,
            diverging=diverging,
            r_ckpts=r_ckpts,
            rsum_ckpts=rsum_ckpts,
        )

    return lax.while_loop(cond, body, init)


# ---------------------------------------------------------------------------
# One NUTS transition
# ---------------------------------------------------------------------------
class _Tree(NamedTuple):
    u_left: jnp.ndarray
    p_left: jnp.ndarray
    g_left: jnp.ndarray
    logp_left: jnp.ndarray
    u_right: jnp.ndarray
    p_right: jnp.ndarray
    g_right: jnp.ndarray
    logp_right: jnp.ndarray
    rho: jnp.ndarray
    prop_u: jnp.ndarray
    prop_logp: jnp.ndarray
    log_w: jnp.ndarray
    depth: jnp.ndarray
    turning: jnp.ndarray
    diverging: jnp.ndarray
    sum_accept: jnp.ndarray
    num_steps: jnp.ndarray


def nuts_step(key, u, logp, g, *, vg_fn, eps, inv_mass, max_depth=10):
    """One NUTS draw from position u. Returns (u', logp', g', info dict)."""
    k_mom, k_tree = jax.random.split(key)
    p0 = jax.random.normal(k_mom, u.shape, u.dtype) / jnp.sqrt(inv_mass)
    H0 = -logp + _kinetic(p0, inv_mass)

    init = _Tree(
        u_left=u,
        p_left=p0,
        g_left=g,
        logp_left=logp,
        u_right=u,
        p_right=p0,
        g_right=g,
        logp_right=logp,
        rho=p0,
        prop_u=u,
        prop_logp=logp,
        log_w=jnp.float32(0.0),
        depth=jnp.int32(0),
        turning=jnp.bool_(False),
        diverging=jnp.bool_(False),
        sum_accept=jnp.float32(0.0),
        num_steps=jnp.int32(0),
    )

    def cond(tr: _Tree):
        return (tr.depth < max_depth) & (~tr.turning) & (~tr.diverging)

    def body(tr: _Tree):
        k_depth = jax.random.fold_in(k_tree, tr.depth)
        k_dir, k_sub, k_accept = jax.random.split(k_depth, 3)
        go_right = jax.random.bernoulli(k_dir)
        direction = jnp.where(go_right, 1, -1).astype(jnp.int32)

        edge_u = jnp.where(go_right, tr.u_right, tr.u_left)
        edge_p = jnp.where(go_right, tr.p_right, tr.p_left)
        edge_g = jnp.where(go_right, tr.g_right, tr.g_left)
        edge_logp = jnp.where(go_right, tr.logp_right, tr.logp_left)

        sub = _build_subtree(
            k_sub,
            edge_u,
            edge_p,
            edge_g,
            edge_logp,
            tr.depth,
            direction,
            eps,
            inv_mass,
            H0,
            max_depth,
            vg_fn,
        )
        bad = sub.turning | sub.diverging

        # Merge (only when the subtree is valid): biased progressive
        # sampling across subtrees (Stan / numpyro behavior).
        take_new = (~bad) & (
            jnp.log(jax.random.uniform(k_accept)) < (sub.log_w - tr.log_w)
        )
        prop_u = jnp.where(take_new, sub.prop_u, tr.prop_u)
        prop_logp = jnp.where(take_new, sub.prop_logp, tr.prop_logp)
        log_w = jnp.where(bad, tr.log_w, jnp.logaddexp(tr.log_w, sub.log_w))

        u_left = jnp.where(go_right | bad, tr.u_left, sub.u)
        p_left = jnp.where(go_right | bad, tr.p_left, sub.p)
        g_left = jnp.where(go_right | bad, tr.g_left, sub.g)
        logp_left = jnp.where(go_right | bad, tr.logp_left, sub.logp)
        u_right = jnp.where(go_right & ~bad, sub.u, tr.u_right)
        p_right = jnp.where(go_right & ~bad, sub.p, tr.p_right)
        g_right = jnp.where(go_right & ~bad, sub.g, tr.g_right)
        logp_right = jnp.where(go_right & ~bad, sub.logp, tr.logp_right)

        rho = jnp.where(bad, tr.rho, tr.rho + sub.rho)
        full_turn = _is_turning(p_left * inv_mass, p_right * inv_mass, rho)
        turning = bad | full_turn

        return _Tree(
            u_left=u_left,
            p_left=p_left,
            g_left=g_left,
            logp_left=logp_left,
            u_right=u_right,
            p_right=p_right,
            g_right=g_right,
            logp_right=logp_right,
            rho=rho,
            prop_u=prop_u,
            prop_logp=prop_logp,
            log_w=log_w,
            depth=tr.depth + 1,
            turning=turning,
            diverging=tr.diverging | sub.diverging,
            sum_accept=tr.sum_accept + sub.sum_accept,
            num_steps=tr.num_steps + sub.leaf_idx,
        )

    tree = lax.while_loop(cond, body, init)
    _, g_new = vg_fn(tree.prop_u)  # cache gradient for the next step
    accept_prob = tree.sum_accept / jnp.maximum(
        tree.num_steps.astype(jnp.float32), 1.0
    )
    info = {
        "accept_prob": accept_prob,
        "num_steps": tree.num_steps,
        "diverging": tree.diverging,
        "depth": tree.depth,
    }
    return tree.prop_u, tree.prop_logp, g_new, info


# ---------------------------------------------------------------------------
# Step-size initialization and dual averaging
# ---------------------------------------------------------------------------
def find_reasonable_step_size(key, vg_fn, u, inv_mass, eps0=1.0):
    """Double/halve eps until the one-step accept prob crosses 0.5
    (Hoffman & Gelman 2014, Algorithm 4)."""
    logp, g = vg_fn(u)
    p0 = jax.random.normal(key, u.shape, u.dtype) / jnp.sqrt(inv_mass)
    H0 = -logp + _kinetic(p0, inv_mass)

    def delta_h(eps):
        u1, p1, logp1, _ = _leapfrog(vg_fn, u, p0, g, eps, inv_mass)
        H1 = -logp1 + _kinetic(p1, inv_mass)
        d = H0 - H1
        return jnp.where(jnp.isnan(d), -jnp.inf, d)

    d0 = delta_h(jnp.float32(eps0))
    direction = jnp.where(d0 > jnp.log(0.5), 1.0, -1.0)

    def cond(state):
        eps, it = state
        d = delta_h(eps)
        keep = jnp.where(direction > 0, d > jnp.log(0.5), d < jnp.log(0.5))
        return keep & (it < 64) & (eps > 1e-10) & (eps < 1e7)

    def body(state):
        eps, it = state
        return eps * jnp.where(direction > 0, 2.0, 0.5), it + 1

    eps, _ = lax.while_loop(cond, body, (jnp.float32(eps0), jnp.int32(0)))
    return eps


class _DAState(NamedTuple):
    log_eps: jnp.ndarray
    log_eps_avg: jnp.ndarray
    h_avg: jnp.ndarray
    mu: jnp.ndarray
    count: jnp.ndarray


def _da_init(eps):
    return _DAState(
        log_eps=jnp.log(eps),
        log_eps_avg=jnp.log(eps),
        h_avg=jnp.float32(0.0),
        mu=jnp.log(10.0 * eps),
        count=jnp.float32(0.0),
    )


def _da_update(state: _DAState, accept_prob, target):
    t0, gamma, kappa = 10.0, 0.05, 0.75
    m = state.count + 1.0
    eta_h = 1.0 / (m + t0)
    h_avg = (1.0 - eta_h) * state.h_avg + eta_h * (target - accept_prob)
    log_eps = state.mu - jnp.sqrt(m) / gamma * h_avg
    eta = m**-kappa
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return _DAState(log_eps, log_eps_avg, h_avg, state.mu, m)


# ---------------------------------------------------------------------------
# Welford variance accumulation (mass adaptation)
# ---------------------------------------------------------------------------
class _Welford(NamedTuple):
    mean: jnp.ndarray
    m2: jnp.ndarray
    count: jnp.ndarray


def _welford_init(dim, dtype=jnp.float32):
    return _Welford(
        jnp.zeros((dim,), dtype), jnp.zeros((dim,), dtype), jnp.float32(0.0)
    )


def _welford_update(w: _Welford, x):
    n = w.count + 1.0
    delta = x - w.mean
    mean = w.mean + delta / n
    m2 = w.m2 + delta * (x - mean)
    return _Welford(mean, m2, n)


def _welford_var(w: _Welford):
    """Regularized variance estimate (Stan's shrinkage toward 1e-3)."""
    n = jnp.maximum(w.count - 1.0, 1.0)
    var = w.m2 / n
    c = w.count
    return (c / (c + 5.0)) * var + 1e-3 * (5.0 / (c + 5.0))


# ---------------------------------------------------------------------------
# Warmup schedule (Stan-style fast / window / fast phases)
# ---------------------------------------------------------------------------
def _warmup_schedule(num_warmup: int):
    """Returns list of (length, is_window, update_mass_at_end)."""
    if num_warmup <= 20:
        return [(num_warmup, False, False)] if num_warmup > 0 else []
    init = max(int(0.15 * num_warmup), 10)
    term = max(int(0.10 * num_warmup), 10)
    middle = num_warmup - init - term
    if middle < 20:
        return [(num_warmup, False, False)]
    phases = [(init, False, False)]
    size = max(middle // 4, 10) if middle >= 40 else middle
    pos = 0
    while pos < middle:
        w = min(size, middle - pos)
        if middle - (pos + w) < 10:  # absorb tail into the last window
            w = middle - pos
        phases.append((w, True, True))
        pos += w
        size *= 2
    phases.append((term, False, False))
    return phases


# ---------------------------------------------------------------------------
# Replica exchange (parallel tempering)
# ---------------------------------------------------------------------------
def geometric_ladder(n_replicas: int, beta_min: float) -> np.ndarray:
    """Geometric inverse-temperature ladder 1 = b_0 > b_1 > ... > b_{R-1} =
    ``beta_min``. The cold rung (the target posterior) is ALWAYS index 0."""
    R = int(n_replicas)
    if R < 2:
        return np.ones((max(R, 1),), np.float32)
    return np.asarray(
        beta_min ** (np.arange(R) / (R - 1)), np.float32
    )


@dataclass(frozen=True)
class ReplicaExchange:
    """Replica-exchange (parallel tempering) spec for ``run_nuts``.

    The pulse-DDM posterior is rugged and multimodal across (a0, v, B, t_nd)
    (BENCH_NOTES "real root cause": split-R-hat up to ~365 with zero
    divergences) — trajectory samplers cannot cross between basins, which is
    the failure mode behind the reference's sole correctness oracle (SBC rank
    uniformity, reference mnle.py:132-237) at high power. Parallel tempering
    runs ``n_replicas`` chains per cold chain on a ladder of inverse
    temperatures ``betas`` applied to the LIKELIHOOD term only (the prior
    stays untempered, so every rung is a proper distribution), and exchanges
    states between adjacent rungs with the exact Metropolis ratio — hot rungs
    traverse between basins, swaps transport those states down to beta = 1.

    Contract with ``run_nuts``:
      * the chain axis is grouped as ``C = M * n_replicas`` with replicas
        CONTIGUOUS and the cold rung (beta = 1) FIRST in each group;
      * ``betas`` has shape (C,) aligned with ``init_u`` rows (the caller
        usually also threads beta through ``data`` so ``logp_fn`` computes
        the tempered target ``base(u) + beta * ll(u)``);
      * ``ll_fn(u[, data_i])`` returns the UNTEMPERED likelihood part
        ``ll(u)`` — exactly the term beta multiplies in ``logp_fn``. Swap
        acceptance between rungs i, j is
        ``min(1, exp((beta_i - beta_j) * (ll_j - ll_i)))``; everything
        beta does not multiply cancels.

    Swaps use the deterministic even-odd (DEO) scheme (Okabe et al. 2001;
    Syed et al. 2021 non-reversible PT): sweep s pairs rungs (0,1),(2,3),...
    when s is even and (1,2),(3,4),... when odd, which moves states across
    the full ladder in O(R) sweeps instead of O(R^2) for random pairing.
    """

    n_replicas: int
    betas: jnp.ndarray  # (C,) inverse temperature per chain row
    ll_fn: Callable  # ll_fn(u) or ll_fn(u, data_i) -> scalar untempered ll
    swap_every: int = 1  # DEO sweep every k transitions


def _exchange_sweep(ex: ReplicaExchange, key, sweep_idx, u, data):
    """One DEO swap sweep. u: (C, D) positions. Returns the permutation
    ``perm`` (C,) of chain rows such that ``u_new = u[perm]``.

    Only the POSITION moves between rungs; per-rung adaptation state (step
    size, mass matrix) stays with its temperature, which is the standard PT
    scheme (each rung's kernel stays tuned to its own tempered geometry).
    """
    C = u.shape[0]
    R = int(ex.n_replicas)
    M = C // R
    if data is None:
        ll = jax.vmap(ex.ll_fn)(u)
    else:
        ll = jax.vmap(ex.ll_fn)(u, data)
    llg = ll.reshape(M, R)
    bg = ex.betas.reshape(M, R)

    r = jnp.arange(R)
    parity = sweep_idx % 2
    partner = jnp.where((r - parity) % 2 == 0, r + 1, r - 1)
    in_range = (partner >= 0) & (partner < R)
    partner_safe = jnp.clip(partner, 0, R - 1)

    ll_p = llg[:, partner_safe]  # (M, R)
    b_p = bg[:, partner_safe]
    # Symmetric in (r, partner): both sides compute the same ratio.
    log_accept = (bg - b_p) * (ll_p - llg)
    # One uniform per PAIR: key both members by the pair's lower rung index.
    pair_id = jnp.minimum(r, partner_safe)
    uni = jax.random.uniform(key, (M, R))  # indexed by pair_id -> shared
    uni_pair = uni[:, pair_id]
    accept = in_range[None, :] & (jnp.log(uni_pair) < log_accept)
    perm_within = jnp.where(accept, partner_safe[None, :], r[None, :])
    perm = (jnp.arange(M)[:, None] * R + perm_within).reshape(-1)
    return perm, jnp.mean(accept.astype(jnp.float32))


# ---------------------------------------------------------------------------
# Full driver: warmup + sampling, vmapped over chains
# ---------------------------------------------------------------------------
class _ChainState(NamedTuple):
    """Full per-chain sampler state, carried across segment launches."""

    u: jnp.ndarray
    logp: jnp.ndarray
    g: jnp.ndarray
    da: _DAState
    w: _Welford
    inv_mass: jnp.ndarray
    eps_final: jnp.ndarray  # frozen step size used in sampling mode


def run_nuts(
    key: jax.Array,
    logp_fn: Callable[..., jnp.ndarray],
    init_u: jnp.ndarray,
    *,
    num_warmup: int,
    num_samples: int,
    max_depth: int = 10,
    target_accept: float = 0.8,
    thin: int = 1,
    data=None,
    segment_length: int = 50,
    checkpoint_dir: str | None = None,
    mode_hop=None,
    exchange: Optional[ReplicaExchange] = None,
) -> Tuple[jnp.ndarray, dict]:
    """Run NUTS: warmup with step-size + diagonal-mass adaptation, then
    sampling. ``init_u``: (num_chains, D). Returns
    (samples (num_chains, num_samples, D), info dict).

    ``data``: optional pytree with leading axis num_chains giving each chain
    its own conditioning data — then ``logp_fn(u, data_i)`` is called with the
    chain's slice. This is how SBC runs all datasets x chains in ONE compiled
    program (the reference loops datasets serially, reference mnle.py:183).

    Execution is split into fixed-length segment launches (``segment_length``
    transitions each) of ONE compiled segment function that carries the full
    sampler state: identical per-segment shapes mean a single compile, and no
    single device execution runs unboundedly long. Warmup flags
    (welford-collect / window-end) are per-step scan inputs, so warmup and
    sampling share the segment function; samples produced during warmup
    segments are discarded.

    Resume (the reference loses everything on a crash, reference
    mnle.py:179-216): with ``checkpoint_dir`` the sampler state is pulled to
    the host after every segment and written to disk, and a fresh process
    resumes at the first incomplete segment (segment keys are derived
    deterministically from ``key``). A runtime error propagates.

    ``mode_hop``: optional Metropolis move ``hop(key, u, logp, g, vg_fn) ->
    (u, logp, g)`` run after every NUTS transition — the escape hatch for
    KNOWN multimodal structure that trajectory-based samplers cannot cross
    (e.g. the pulse-grid posterior's near-periodic t_nd modes,
    inference/mcmc.make_grid_hop). Must preserve the target distribution
    (its own MH correction); adaptation statistics are taken after the hop.

    ``exchange``: optional :class:`ReplicaExchange` — runs a parallel-
    tempering swap sweep across the chain axis after every
    ``exchange.swap_every`` transitions (DEO pairing). The chain axis must be
    grouped as ``M * n_replicas`` contiguous replicas with the cold rung
    first; ``samples`` then contains every rung and the caller selects the
    beta = 1 rows. Composes with ``mode_hop`` (hop first, then swap).
    """
    num_chains, D = init_u.shape
    keys = jax.random.split(key, num_chains)
    key_ex = jax.random.fold_in(key, 0x45584348)  # exchange-sweep stream
    L = max(int(segment_length), 1)
    if exchange is not None:
        if num_chains % int(exchange.n_replicas) != 0:
            raise ValueError(
                f"num_chains={num_chains} not divisible by "
                f"n_replicas={exchange.n_replicas}"
            )
        if exchange.betas.shape != (num_chains,):
            raise ValueError(
                f"exchange.betas must be ({num_chains},), got "
                f"{exchange.betas.shape}"
            )

    # Per-step warmup flags from the Stan-style schedule.
    W = num_warmup
    collect_flags = np.zeros((max(W, 1),), np.bool_)
    update_flags = np.zeros((max(W, 1),), np.bool_)
    pos = 0
    for length, is_window, update_mass in _warmup_schedule(W):
        collect_flags[pos : pos + length] = is_window
        pos += length
        if update_mass:
            update_flags[pos - 1] = True

    def init_chain(chain_key, u0, data_i) -> _ChainState:
        if data is None:
            vg_fn = jax.value_and_grad(logp_fn)
        else:
            vg_fn = jax.value_and_grad(lambda u: logp_fn(u, data_i))
        inv_mass = jnp.ones((D,), u0.dtype)
        eps0 = find_reasonable_step_size(chain_key, vg_fn, u0, inv_mass)
        logp0, g0 = vg_fn(u0)
        return _ChainState(
            u=u0, logp=logp0, g=g0, da=_da_init(eps0),
            w=_welford_init(D, u0.dtype), inv_mass=inv_mass,
            eps_final=eps0,
        )

    def _vg(data_i):
        if data is None:
            return jax.value_and_grad(logp_fn)
        return jax.value_and_grad(lambda u: logp_fn(u, data_i))

    def chain_step(k, st: _ChainState, data_i, warm, collect, update):
        """One transition (x thin) + adaptation for a single chain."""
        vg_fn = _vg(data_i)
        eps = jnp.where(warm, jnp.exp(st.da.log_eps), st.eps_final)

        def one(carry, kk):
            u, logp, g = carry
            u, logp, g, info = nuts_step(
                kk, u, logp, g, vg_fn=vg_fn, eps=eps,
                inv_mass=st.inv_mass, max_depth=max_depth,
            )
            return (u, logp, g), info

        (u, logp, g), infos = lax.scan(
            one, (st.u, st.logp, st.g), jax.random.split(k, thin)
        )
        info = jax.tree.map(lambda a: a[-1], infos)
        if mode_hop is not None:
            u, logp, g = mode_hop(
                jax.random.fold_in(k, 0x9E37), u, logp, g, vg_fn
            )

        da_new = _da_update(st.da, info["accept_prob"], target_accept)
        da = jax.tree.map(
            lambda a, b: jnp.where(warm, a, b), da_new, st.da
        )
        w_new = _welford_update(st.w, u)
        w = jax.tree.map(
            lambda a, b: jnp.where(warm & collect, a, b), w_new, st.w
        )

        def window_end(args):
            da, w, _ = args
            # New mass matrix from the window variance; reset welford and
            # re-center dual averaging (Stan behavior at window ends).
            return (
                _da_init(jnp.exp(da.log_eps_avg)),
                _welford_init(D, u.dtype),
                _welford_var(w),
            )

        da, w, inv_mass = lax.cond(
            warm & update, window_end, lambda a: a, (da, w, st.inv_mass)
        )
        eps_final = jnp.exp(da.log_eps_avg)
        new_st = _ChainState(
            u=u, logp=logp, g=g, da=da, w=w,
            inv_mass=inv_mass, eps_final=eps_final,
        )
        return new_st, (u, info)

    in_data_axis = None if data is None else 0

    def segment_all(keys, st_b: _ChainState, data_b, step_keys_t, ex_keys,
                    flags, t0):
        """L transitions for ALL chains: scan over steps of a vmapped
        transition, so cross-chain moves (replica-exchange swaps) can run
        between transitions. step_keys_t: (L, num_chains) keys; flags:
        (warm, collect, update) each (L,); t0: global transition index of
        the segment start (drives DEO sweep parity).
        """

        def step(carry, xs):
            st_b, t = carry
            ks, ek, warm, collect, update = xs
            st_b, (u_out, info_out) = jax.vmap(
                chain_step, in_axes=(0, 0, in_data_axis, None, None, None)
            )(ks, st_b, data_b, warm, collect, update)
            if exchange is not None:
                swap_every = max(int(exchange.swap_every), 1)

                def apply_swap(st_b):
                    perm, acc = _exchange_sweep(
                        exchange, ek, t // swap_every, st_b.u, data_b
                    )
                    u_new = st_b.u[perm]
                    logp_new, g_new = jax.vmap(
                        lambda u, d: _vg(d)(u), in_axes=(0, in_data_axis)
                    )(u_new, data_b)
                    return st_b._replace(u=u_new, logp=logp_new, g=g_new), acc

                st_b, acc = lax.cond(
                    (t % swap_every) == 0,
                    apply_swap,
                    lambda s: (s, jnp.float32(-1.0)),  # -1 = no sweep this step
                    st_b,
                )
                info_out = dict(
                    info_out, swap_accept=jnp.full((st_b.u.shape[0],), acc)
                )
            return (st_b, t + 1), (u_out, info_out)

        (st_b, _), (u_seg, info_seg) = lax.scan(
            step, (st_b, t0), (step_keys_t, ex_keys) + flags
        )
        # (L, C, ...) -> (C, L, ...) to keep the driver's layout unchanged.
        u_seg = jnp.swapaxes(u_seg, 0, 1)
        info_seg = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), info_seg)
        return st_b, (u_seg, info_seg)

    init_fn = jax.jit(jax.vmap(init_chain, in_axes=(0, 0, in_data_axis)))
    seg_fn = jax.jit(segment_all)

    state = init_fn(jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys), init_u, data)

    total = W + num_samples
    n_segments = -(-total // L)
    warm_flags_all = np.zeros((n_segments * L,), np.bool_)
    warm_flags_all[:W] = True
    collect_all = np.zeros((n_segments * L,), np.bool_)
    collect_all[:W] = collect_flags[:W]
    update_all = np.zeros((n_segments * L,), np.bool_)
    update_all[:W] = update_flags[:W]

    keys_host = np.asarray(jax.random.key_data(keys))

    # Full run fingerprint: a stale checkpoint whose (chains, D) happen to
    # match but whose segment length, warmup, draw budget, thinning, or key
    # differ would otherwise be silently spliced into the returned samples.
    import hashlib as _hashlib

    ex_tag = (
        "none"
        if exchange is None
        else f"R={exchange.n_replicas}/every={exchange.swap_every}/"
        + _hashlib.sha256(np.asarray(exchange.betas).tobytes()).hexdigest()[:8]
    )
    run_fingerprint = _hashlib.sha256(
        keys_host.tobytes()
        + f"L={L}/W={W}/S={num_samples}/thin={thin}/depth={max_depth}"
          f"/hop={mode_hop is not None}/ex={ex_tag}".encode()
    ).hexdigest()[:16]

    ckpt_file = None
    start_segment = 0
    samples_host = []
    infos_host = []
    if checkpoint_dir is not None:
        from pathlib import Path

        ckpt_dir = Path(checkpoint_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        ckpt_file = ckpt_dir / "nuts_segments.npz"
        if ckpt_file.exists():
            blob = np.load(ckpt_file, allow_pickle=False)
            stale_reason = None
            if blob["samples"].shape[0] != num_chains or blob["samples"].shape[2] != D:
                stale_reason = (
                    f"chains/dim {blob['samples'].shape[0]}x{blob['samples'].shape[2]}"
                    f" != {num_chains}x{D}"
                )
            elif "run_fingerprint" not in blob or str(blob["run_fingerprint"]) != run_fingerprint:
                stale_reason = "run fingerprint mismatch (key/L/warmup/samples/thin)"
            if stale_reason is not None:
                # Stale checkpoint from a different run: ignore, start fresh.
                print(
                    f"[run_nuts] ignoring stale checkpoint {ckpt_file} "
                    f"({stale_reason})"
                )
                blob = None
            if blob is not None:
                start_segment = int(blob["next_segment"])
            if blob is not None and start_segment > 0:
                samples_host = [blob["samples"]]
                infos_host = [
                    {
                        k: blob[k]
                        for k in (
                            "accept_prob",
                            "num_steps",
                            "diverging",
                            "swap_accept",
                        )
                        if k in blob
                    }
                ]
                state_leaves, state_def = jax.tree.flatten(state)
                state = jax.tree.unflatten(
                    state_def,
                    [jnp.asarray(blob[f"state_{i}"]) for i in range(len(state_leaves))],
                )
                print(
                    f"[run_nuts] resumed at segment {start_segment}/{n_segments}"
                )

    def _dispatch(s, keys, state):
        lo = s * L
        flags = (
            jnp.asarray(warm_flags_all[lo : lo + L]),
            jnp.asarray(collect_all[lo : lo + L]),
            jnp.asarray(update_all[lo : lo + L]),
        )
        seg_keys = jax.vmap(
            lambda k: jax.random.split(jax.random.fold_in(k, 1000 + s), L)
        )(keys)
        seg_keys_t = jnp.swapaxes(seg_keys, 0, 1)  # (L, C)
        ex_keys = jax.random.split(jax.random.fold_in(key_ex, s), L)
        state_new, (u_seg, info_seg) = seg_fn(
            keys, state, data, seg_keys_t, ex_keys, flags, jnp.int32(lo)
        )
        return state_new, u_seg, info_seg

    def _save_ckpt(next_segment, state_np):
        info_blobs = {
            k: np.concatenate([i[k] for i in infos_host], axis=1)
            for k in infos_host[0]
        }
        np.savez(
            ckpt_file,
            run_fingerprint=np.asarray(run_fingerprint),
            next_segment=np.asarray(next_segment),
            samples=np.concatenate(samples_host, axis=1),
            **info_blobs,
            **{f"state_{i}": leaf for i, leaf in enumerate(jax.tree.leaves(state_np))},
        )

    # Depth-1 pipelining: segment s+1 is dispatched BEFORE segment s's
    # outputs are pulled, so the host transfer overlaps device compute, and
    # each segment's samples + stats (+ state, when checkpointing) come back
    # in ONE device_get.
    pending = None  # (seg_idx, state_dev, u_dev, info_dev)
    for s in range(start_segment, n_segments + 1):
        new_pending = None
        if s < n_segments:
            state, u_seg, info_seg = _dispatch(s, keys, state)
            new_pending = (s, state, u_seg, info_seg)
        if pending is not None:
            seg_idx, state_dev, u_dev, info_dev = pending
            if ckpt_file is not None:
                u_np, info_np, state_np = jax.device_get((u_dev, info_dev, state_dev))
            else:
                u_np, info_np = jax.device_get((u_dev, info_dev))
            samples_host.append(u_np)
            infos_host.append(info_np)
            if ckpt_file is not None:
                _save_ckpt(seg_idx + 1, state_np)
        pending = new_pending

    all_u = np.concatenate(samples_host, axis=1)  # (C, n_segments*L, D)
    samples = jnp.asarray(all_u[:, W : W + num_samples])
    all_info = {
        k: np.concatenate([i[k] for i in infos_host], axis=1)[
            :, W : W + num_samples
        ]
        for k in ("accept_prob", "num_steps", "diverging")
    }
    info = {
        "accept_prob": jnp.asarray(all_info["accept_prob"]),
        "num_steps": jnp.asarray(all_info["num_steps"]),
        "diverging": jnp.asarray(all_info["diverging"]),
        "step_size": state.eps_final,
        "inv_mass": state.inv_mass,
    }
    if exchange is not None and "swap_accept" in infos_host[0]:
        # Mean DEO sweep acceptance over the WHOLE run (warmup included;
        # rows are identical across chains, -1 marks steps with no sweep).
        sa = np.concatenate(
            [i["swap_accept"] for i in infos_host], axis=1
        )[0]
        info["swap_accept"] = float(sa[sa >= 0].mean()) if (sa >= 0).any() else 0.0
    return samples, info
