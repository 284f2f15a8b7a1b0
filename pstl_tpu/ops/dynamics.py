"""Unicycle-with-acceleration dynamics and differentiable rollout.

Parity target: ``nusc_train.py:29-60`` (``dynamics``, ``generate_trajs``,
``get_neighbor_trajs``).  The reference unrolls an explicit-Euler loop in
Python; here the rollout is a single ``lax.scan`` over the time axis, fully
differentiable and fused by XLA, with arbitrary leading batch dims.

State s = (x, y, theta, v); control u = (omega, a); dt seconds per step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def dynamics(s: Array, u: Array) -> Array:
    """Continuous-time derivative. s: (..., 4), u: (..., 2) -> (..., 4)."""
    x, y, th, v = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    w, a = u[..., 0], u[..., 1]
    return jnp.stack([v * jnp.cos(th), v * jnp.sin(th), w, a], axis=-1)


def rollout_scan(s0: Array, us: Array, dt: float) -> Array:
    """Explicit-Euler rollout as a sequential ``lax.scan`` (reference
    formulation, used as the oracle for the parallel version below)."""
    us_t = jnp.moveaxis(us, -2, 0)            # (T, ..., 2)

    def step(s, u):
        s_next = s + dynamics(s, u) * dt
        return s_next, s_next

    _, traj = jax.lax.scan(step, s0, us_t)    # (T, ..., 4)
    traj = jnp.moveaxis(traj, 0, -2)          # (..., T, 4)
    return jnp.concatenate([s0[..., None, :], traj], axis=-2)


def rollout(s0: Array, us: Array, dt: float) -> Array:
    """Explicit-Euler rollout — closed form via prefix sums.

    The Euler recurrence is associative in (theta, v): theta_t / v_t are
    exclusive prefix sums of the controls, and x_t / y_t are prefix sums of
    v_t * cos/sin(theta_t).  Two ``cumsum`` passes replace the reference's
    sequential loop (nusc_train.py:39-49) — bit-identical numerics, but the
    whole rollout (and its VJP) is parallel across the time axis, which
    removes ~40 sequential scan iterations per rollout from the guidance
    inner loop and the sampler.

    s0: (..., 4); us: (..., T, 2).  Returns (..., T+1, 4) incl. s0.
    """
    w, a = us[..., 0], us[..., 1]
    th0 = s0[..., 2:3]
    v0 = s0[..., 3:4]
    # state-BEFORE-update sequences: theta_t = th0 + dt*sum_{i<t} w_i
    th = th0 + dt * jnp.cumsum(w, axis=-1)           # theta_{1..T}
    v = v0 + dt * jnp.cumsum(a, axis=-1)             # v_{1..T}
    th_full = jnp.concatenate([th0, th], axis=-1)    # theta_{0..T}
    v_full = jnp.concatenate([v0, v], axis=-1)
    # x_{t+1} = x0 + dt * sum_{i<=t} v_i cos(theta_i)
    dx = v_full[..., :-1] * jnp.cos(th_full[..., :-1]) * dt
    dy = v_full[..., :-1] * jnp.sin(th_full[..., :-1]) * dt
    x = s0[..., 0:1] + jnp.cumsum(dx, axis=-1)
    y = s0[..., 1:2] + jnp.cumsum(dy, axis=-1)
    tail = jnp.stack([x, y, th, v], axis=-1)         # states 1..T
    return jnp.concatenate([s0[..., None, :], tail], axis=-2)


# Alias matching the reference's name for discoverability.
generate_trajs = rollout


def neighbor_rollout(neighbors: Array, nt: int, dt: float,
                     full: bool = False) -> Array:
    """Constant-velocity neighbor prediction (nusc_train.py:51-60).

    neighbors: (..., k, 7) rows (valid, x, y, th, v, L, W).
    Returns (..., k, nt, 5) of (valid, x, y, th, v), or (..., k, nt, 7) with
    (L, W) appended when full=True.
    """
    zeros = jnp.zeros(neighbors.shape[:-1] + (nt - 1, 2),
                      dtype=neighbors.dtype)
    trajs = rollout(neighbors[..., 1:5], zeros, dt)     # (..., k, nt, 4)
    valid = jnp.broadcast_to(neighbors[..., None, 0:1],
                             trajs.shape[:-1] + (1,))
    if full:
        lw = jnp.broadcast_to(neighbors[..., None, 5:7],
                              trajs.shape[:-1] + (2,))
        return jnp.concatenate([valid, trajs, lw], axis=-1)
    return jnp.concatenate([valid, trajs], axis=-1)
