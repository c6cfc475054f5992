"""Explicit jax.random key-threading helpers.

The reference mixes numpy Generators and torch global seeds
(reference: rt_choice_model_pipeline.py:49-50, mnle.py:161-162,188-189). The
framework replaces that with one key-splitting discipline: every
stochastic entry point takes a key (or an int seed that is promoted to a key),
and derived streams are obtained with ``fold_in`` so they are reproducible and
independent of batching/device count.
"""

from __future__ import annotations

from typing import Union

import jax
import numpy as np

KeyLike = Union[int, np.integer, jax.Array, np.random.Generator, None]


def as_key(seed: KeyLike) -> jax.Array:
    """Promote an int seed / numpy Generator / existing key to a jax PRNG key.

    Accepting ``np.random.Generator`` keeps reference call sites that pass
    ``rng=np.random.default_rng(seed)`` working: we draw one 63-bit integer
    from the generator and use it as the seed.
    """
    if seed is None:
        return jax.random.key(np.random.randint(0, 2**31 - 1))
    if isinstance(seed, np.random.Generator):
        return jax.random.key(int(seed.integers(0, 2**63 - 1)))
    if isinstance(seed, (int, np.integer)):
        return jax.random.key(int(seed))
    # Already a key (new-style typed key or legacy uint32[2]).
    return seed


def stream(key: jax.Array, *tags: int) -> jax.Array:
    """Derive an independent named stream from a key by folding in tags."""
    for t in tags:
        key = jax.random.fold_in(key, t)
    return key
