"""Pulse-DDM Euler-Maruyama as a fused Pallas kernel (Triton route, GPU).

The XLA scan kernel (``ddm_scan.py``) writes a ``(chunk, N)`` noise block to
device memory on every pulse interval and runs the time loop as a sequence
of small per-step kernels. Here one GPU thread owns one trial: its state
``(a, hit_step, choice)`` stays in registers for the whole 16,000-step
recurrence, one ``lax.while_loop`` per block walks the pulse intervals and
exits as soon as every trial of the block is absorbed, and the only device
memory traffic is one read of (theta, stimulus) and one write of (rt, choice).

Noise comes from a counter-based generator inside the kernel: threefry-2x32
(the 20-round hash ``jax.random`` uses; 32-bit add, rotate and xor only)
keyed by two words drawn from the caller's key, counting
(global trial index, step pair). Each hash gives one Box-Muller pair, i.e.
the normals of two consecutive steps, so the stream does not depend on the
block size or on how many chunks a block skipped.

Semantics match the reference math exactly (reference:
src/sbi_for_diffusion_models/models/rt_choice_model.py:131-221): leak +
diffusion step, pulse kick on the first step of every pulse interval,
absorbing bounds {0, B} with first-hit step ``t+1``, per-trial decision
window from ``t_nd``, censoring to choice 2, RT clamping. The random stream
differs from the scan kernel's, so parity with it is distributional, and
exact with ``mu_sensory=0``.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..constants import DT_CHOICE, T_MAX
from .ddm_scan import sanitize_theta

__all__ = ["ddm_rt_choice_pallas", "threefry2x32", "box_muller", "BLOCK_TRIALS"]

BLOCK_TRIALS = 128  # trials per program: one per thread at 4 warps

_TWO_PI = 2.0 * math.pi
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return (x << jnp.uint32(r)) | jax.lax.shift_right_logical(x, jnp.uint32(32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), written with
    uint32 add / shift / or / xor only so it lowers inside a Triton kernel.
    Bit-identical to ``jax.random``'s ``threefry2x32_p`` for the same
    (key, counter) words."""
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(_THREEFRY_PARITY))
    x0 = c0 + ks[0]
    x1 = c1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def box_muller(b0, b1):
    """Two independent standard normals from two uint32 words: the top 24
    bits of each become uniforms (the first bounded away from 0), which
    share one log and one sqrt."""
    u1 = jax.lax.shift_right_logical(b0, jnp.uint32(8)).astype(jnp.float32)
    u2 = jax.lax.shift_right_logical(b1, jnp.uint32(8)).astype(jnp.float32)
    u1 = u1 * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    u2 = u2 * (1.0 / (1 << 24))
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    ang = _TWO_PI * u2
    return r * jnp.cos(ang), r * jnp.sin(ang)


def _kernel(
    key_ref,  # (2,) uint32 generator key
    theta_ref,  # (8, BLOCK) f32 rows: a_init, lam, v, B, t_nd, pad
    n_steps_ref,  # (BLOCK,) int32 per-trial decision window
    s_ref,  # (P, BLOCK) f32 pulse sides, pulse-major
    rt_ref,  # (BLOCK,) f32
    choice_ref,  # (BLOCK,) f32
    *,
    block: int,
    n_chunks: int,
    steps_per_pulse: int,
    dt: float,
    t_max: float,
    sigma: float,
    collapse_rate: float,
):
    k0 = key_ref[0]
    k1 = key_ref[1]
    a_init = theta_ref[0, :]
    lam = theta_ref[1, :]
    v = theta_ref[2, :]
    B = theta_ref[3, :]
    t_nd = theta_ref[4, :]
    n_steps = n_steps_ref[...]
    trial = (
        pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    ).astype(jnp.uint32)

    dtf = jnp.float32(dt)
    sig_sqrt_dt = jnp.float32(sigma * math.sqrt(dt))
    half = steps_per_pulse // 2

    def one_step(t, kick, eps, st):
        a, hit_step, choice = st
        active = (hit_step == 0) & (t < n_steps)
        # Leak + diffusion, unmasked as in the reference (post-hit values are
        # never read back). reference rt_choice_model.py:186-187.
        a = a + (-lam * a) * dtf + eps * sig_sqrt_dt
        if kick is not None:
            a = jnp.where(active, a + kick, a)
        if collapse_rate > 0.0:
            tt = t.astype(jnp.float32) * dtf
            # The rate is negated in Python: the Triton lowering cannot
            # negate a constant operand.
            f = 0.5 + 0.5 * jnp.exp(jnp.float32(-collapse_rate) * tt)
            upper = B * f
            lower = B * (1.0 - f)
        else:
            upper = B
            lower = 0.0
        hit_up = active & (a >= upper)
        hit_lo = active & (a <= lower)
        hit_step = jnp.where(hit_up | hit_lo, t + 1, hit_step)
        choice = jnp.where(hit_up, 1, jnp.where(hit_lo, 0, choice))
        return a, hit_step, choice

    def step_pair(t, kick, st):
        pair = jnp.full((block,), t // 2, jnp.int32).astype(jnp.uint32)
        e0, e1 = box_muller(*threefry2x32(k0, k1, trial, pair))
        st = one_step(t, kick, e0, st)
        return one_step(t + 1, None, e1, st)

    def chunk_cond(state):
        c, _, hit_step, _ = state
        active = (hit_step == 0) & (c * steps_per_pulse < n_steps)
        return (c < n_chunks) & (jnp.max(active.astype(jnp.int32)) > 0)

    def chunk_body(state):
        c, a, hit_step, choice = state
        t0 = c * steps_per_pulse
        # The pulse-kick step is the first of the chunk; the remaining pairs
        # are pulse-free.
        st = step_pair(t0, v * s_ref[c, :], (a, hit_step, choice))
        st = jax.lax.fori_loop(
            1, half, lambda j, st: step_pair(t0 + 2 * j, None, st), st
        )
        return (c + 1,) + st

    zeros = jnp.zeros((block,), jnp.int32)
    _, _, hit_step, choice = jax.lax.while_loop(
        chunk_cond, chunk_body, (jnp.int32(0), a_init, zeros, zeros)
    )

    # Censoring + RT (reference rt_choice_model.py:206-218).
    hit = hit_step > 0
    hit_step = jnp.where(hit, hit_step, n_steps)
    rt_ref[...] = jnp.clip(t_nd + hit_step.astype(jnp.float32) * dtf, 1e-6, t_max)
    choice_ref[...] = jnp.where(hit, choice, 2).astype(jnp.float32)


@partial(
    jax.jit,
    static_argnames=(
        "mu_sensory",
        "collapse_rate",
        "dt",
        "t_max",
        "steps_per_pulse",
        "n_max",
        "block_trials",
        "interpret",
    ),
)
def ddm_rt_choice_pallas(
    theta: jnp.ndarray,
    pulse_sides: jnp.ndarray,
    key: jax.Array,
    *,
    mu_sensory: float = 1.0,
    collapse_rate: float = 0.0,
    dt: float = float(DT_CHOICE),
    t_max: float = float(T_MAX),
    steps_per_pulse: int = 200,
    n_max: int | None = None,
    block_trials: int = BLOCK_TRIALS,
    interpret: bool = False,
) -> jnp.ndarray:
    """Drop-in twin of ``ddm_rt_choice_scan`` for the GPU.

    theta: (N, 5); pulse_sides: (N, P) with P >= n_max/steps_per_pulse;
    returns (N, 2) float32 [rt, choice], choice in {0, 1, 2}. ``block_trials``
    (a power of two) trials share one program of ``block_trials // 32`` warps
    (at least one), so each thread owns one trial.
    """
    if n_max is None:
        n_max = int(t_max / dt)
    if n_max % steps_per_pulse != 0:
        raise ValueError(
            f"n_max={n_max} must be divisible by steps_per_pulse={steps_per_pulse}"
        )
    if steps_per_pulse % 2 != 0:
        raise ValueError(
            f"steps_per_pulse={steps_per_pulse} must be even (the kernel "
            "consumes Box-Muller normal pairs, two steps per draw)"
        )
    if block_trials & (block_trials - 1):
        raise ValueError(f"block_trials={block_trials} must be a power of two")
    n_chunks = n_max // steps_per_pulse

    theta = jnp.asarray(theta, jnp.float32)
    s = jnp.asarray(pulse_sides, jnp.float32)
    N = theta.shape[0]
    if s.shape[1] < n_chunks:
        raise ValueError(f"pulse_sides has P={s.shape[1]} < n_chunks={n_chunks}")

    # Parameter sanitation and the per-trial window stay in XLA, shared with
    # the scan kernel, so both see bit-identical inputs.
    a0_frac, lam, v, B, t_nd = sanitize_theta(theta)
    n_steps = jnp.clip(jnp.floor((t_max - t_nd) / dt).astype(jnp.int32), 0, n_max)
    zero = jnp.zeros_like(lam)
    rows = jnp.stack([a0_frac * B, lam, v, B, t_nd, zero, zero, zero])

    pad = (-N) % block_trials
    rows = jnp.pad(rows, ((0, 0), (0, pad)), mode="edge")
    n_steps = jnp.pad(n_steps, (0, pad), mode="edge")
    s_t = jnp.pad(s[:, :n_chunks].T, ((0, 0), (0, pad)), mode="edge")
    Np = N + pad
    key_words = jax.random.bits(key, (2,), jnp.uint32)

    kernel = partial(
        _kernel,
        block=block_trials,
        n_chunks=n_chunks,
        steps_per_pulse=steps_per_pulse,
        dt=float(dt),
        t_max=float(t_max),
        sigma=float(mu_sensory),
        collapse_rate=float(collapse_rate),
    )
    col = pl.BlockSpec((block_trials,), lambda i: (i,))
    rt, choice = pl.pallas_call(
        kernel,
        grid=(Np // block_trials,),
        in_specs=[
            pl.BlockSpec((2,), lambda i: (0,)),
            pl.BlockSpec((8, block_trials), lambda i: (0, i)),
            col,
            pl.BlockSpec((n_chunks, block_trials), lambda i: (0, i)),
        ],
        out_specs=[col, col],
        out_shape=[jax.ShapeDtypeStruct((Np,), jnp.float32)] * 2,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(1, block_trials // 32), num_stages=1
        ),
        interpret=interpret,
        name="ddm_rt_choice",
    )(key_words, rows, n_steps, s_t)
    return jnp.stack([rt[:N], choice[:N]], axis=-1)
