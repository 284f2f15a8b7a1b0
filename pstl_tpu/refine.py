"""Test-time gradient refinement & the backup safety controller.

Parity targets:
- ``--refinement``: 50-iter Adam over softmax convex-combination weights of
  cached denoise steps, applied only to STL-violating candidates
  (nusc_train.py:1034-1071, nusc_sim.py:560-626)
- ``--raw_refinement``: short Adam on a raw control residual for violating
  candidates (nusc_sim.py:627-666)
- backup controller ``solve_bak``: 500-iter Adam on a 2-step control residual
  restoring neighbor clearance (nusc_sim.py:686-708, 757-781)

All three are jitted ``lax.scan``s of Adam steps — one compiled program each.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import optax

from pstl_tpu import specs
from pstl_tpu.config import Config
from pstl_tpu.ops import dynamics as dyn
from pstl_tpu.ops import geometry as geom

Array = jax.Array

# denoise-step index sets per K (nusc_train.py:1053-1056)
K_D_LIST = {
    2: [0], 3: [80, 95], 4: [80, 90, 95], 6: [0, 50, 80, 90, 95],
    8: [0, 50, 80, 85, 90, 95, 98], 10: [0, 50, 80, 85, 90, 95, 96, 97, 98],
    20: [0, 10, 30, 50, 60, 70, 75, 80, 85, 90, 91, 92, 93, 94, 95, 96, 97,
         98, 99],
}


def convex_refinement(nn_controls: Array, all_steps: Array,
                      states_flat: Array, score_rows, valid: Array,
                      cfg: Config, K: int = 8,
                      n_iters: int = 50, lr: float = 0.3,
                      stl_thres: float = 0.0005) -> Array:
    """Optimize softmax weights lambda over {current controls} U {selected
    cached denoise steps}; replace only violating candidates."""
    N = nn_controls.shape[0]
    idx = K_D_LIST[K]
    cands = jnp.stack([jax.lax.stop_gradient(nn_controls)]
                      + [jax.lax.stop_gradient(all_steps[i]) for i in idx],
                      axis=-1)                      # (N, nt, 2, K)

    def score(u):
        trajs = dyn.rollout(states_flat, u, cfg.dt)
        return score_rows(trajs[:, :-1])

    s0 = score(nn_controls)
    violated = ((s0 <= 0) & (valid > 0)).astype(nn_controls.dtype)
    violated = violated[:, None, None]

    def combine(lamdas):
        ratios = jax.nn.softmax(lamdas, axis=-1)   # (N, K)
        # elementwise fp32 weighted sum: a matrix product could run in a
        # reduced precision on the GPU
        mix = jnp.sum(cands * ratios[:, None, None, :], axis=-1)
        return (jax.lax.stop_gradient(nn_controls) * (1 - violated)
                + violated * mix)

    def loss_fn(lamdas):
        u = combine(lamdas)
        s = score(u)
        return specs.mask_mean(jax.nn.relu(stl_thres - s), valid)

    opt = optax.adam(lr)
    grad_fn = jax.grad(loss_fn)

    def step(carry, _):
        lam, st = carry
        g = grad_fn(lam)
        upd, st = opt.update(g, st, lam)
        return (optax.apply_updates(lam, upd), st), None

    lam0 = jnp.ones((N, len(idx) + 1))
    (lam, _), _ = jax.lax.scan(step, (lam0, opt.init(lam0)), None,
                               length=n_iters)
    return jax.lax.stop_gradient(combine(lam))


def raw_refinement(nn_controls: Array, states_flat: Array,
                   score_rows, valid: Array, cfg: Config,
                   n_iters: int = 5, lr: float = 3e-2,
                   stl_thres: float = 0.0005) -> Array:
    """Adam on a raw control residual for violating candidates
    (nusc_sim.py:627-666)."""

    def score(u):
        trajs = dyn.rollout(states_flat, u, cfg.dt)
        return score_rows(trajs[:, :-1])

    base = jax.lax.stop_gradient(nn_controls)
    s0 = score(base)
    violated = ((s0 <= 0) & (valid > 0)).astype(base.dtype)[:, None, None]

    def loss_fn(res):
        u = base + violated * res
        s = score(u)
        return specs.mask_mean(jax.nn.relu(stl_thres - s), valid)

    opt = optax.adam(lr)
    grad_fn = jax.grad(loss_fn)

    def step(carry, _):
        res, st = carry
        g = grad_fn(res)
        upd, st = opt.update(g, st, res)
        return (optax.apply_updates(res, upd), st), None

    r0 = jnp.zeros_like(base)
    (res, _), _ = jax.lax.scan(step, (r0, opt.init(r0)), None,
                               length=n_iters)
    return jax.lax.stop_gradient(base + violated * res)


def solve_backup(ego_traj: Array, ego_ctrls: Array, nei_traj: Array,
                 cfg: Config, n_iters: int = 500, lr: float = 1e-2,
                 d_safe: float = 0.1) -> Array:
    """Backup safety controller (``solve_bak``, nusc_sim.py:757-781):
    optimize a (2, 2) control residual so the next 2 steps keep anchor-disc
    clearance above d_safe, with an L2 residual penalty.

    ego_traj: (1, >=3, >=4) planned states; ego_ctrls: (1, >=2, 2);
    nei_traj: (1, >=3, >=7) neighbor rows (valid, x, y, th, v, L, W).
    Returns the residual (2, 2).
    """
    base_u = jax.lax.stop_gradient(ego_ctrls[:, 0:2])
    s0 = jax.lax.stop_gradient(ego_traj[:, 0, 0:4])

    def loss_fn(u_res):
        new_traj = dyn.rollout(s0, base_u + u_res[None], cfg.dt)  # (1,3,4)
        clear = geom.car_clearance(
            new_traj[:, 1:3, :3], cfg.ego_L, cfg.ego_W,
            nei_traj[:, 1:3, 1:4], nei_traj[:, 1:3, 5], nei_traj[:, 1:3, 6],
            cfg.refined_nL, cfg.refined_nW)
        loss_d = jnp.mean(jax.nn.relu(d_safe * 1.01 - clear))
        return loss_d + jnp.mean(jnp.square(u_res))

    opt = optax.adam(lr)
    grad_fn = jax.grad(loss_fn)

    def step(carry, _):
        u, st = carry
        g = grad_fn(u)
        upd, st = opt.update(g, st, u)
        return (optax.apply_updates(u, upd), st), None

    u0 = jnp.zeros((2, 2))
    (u, _), _ = jax.lax.scan(step, (u0, opt.init(u0)), None, length=n_iters)
    return jax.lax.stop_gradient(u)
