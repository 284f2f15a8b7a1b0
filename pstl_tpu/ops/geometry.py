"""Differentiable geometry kernels.

Parity targets:
- signed point-to-polyline distance & heading distance
  (``nusc_api.py:685-813``, efficient branch)
- anchor-disc car-car clearance (``utils.py:465-526``) and its batched
  masked wrapper (``nusc_train.py:142-148``)
- oriented bounding-box corners (``utils.py:443-462``)

All kernels are pure jnp, broadcast over arbitrary leading batch dims, and
are evaluated in float32 (they feed the stiff tau=100 STL robustness).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

Array = jax.Array


# ---------------------------------------------------------------------------
# point-to-polyline signed distance
# ---------------------------------------------------------------------------

def segment_argmin(points: Array, lanes: Array) -> Array:
    """Index of the segment minimizing d(p, w_i) + d(p, w_{i+1}) for each
    point: (n, T, >=2) points, (n, n_segs, >=2) waypoints -> (n, T)."""
    pd = jnp.linalg.norm(points[..., None, :2] - lanes[..., None, :, :2],
                         axis=-1)                            # (n, T, n_segs)
    return jnp.argmin(pd[..., :-1] + pd[..., 1:], axis=-1)


def take_rows(table: Array, idx: Array) -> Array:
    """``out[..., t, :] = table[..., idx[..., t], :]``: rows of a
    (..., S, d) table picked by an in-range (..., T) index (leading dims
    broadcast)."""
    return jnp.take_along_axis(table, idx[..., None], axis=-2,
                               mode="promise_in_bounds")


def point_to_polyline(points: Array, lanes: Array, clip: bool = False,
                      with_angle: bool = False, inline: bool = False):
    """Signed distance from trajectory points to a lane centerline.

    points: (n, T, 2) or (n, T, 3) with heading when with_angle.
    lanes:  (n, n_segs, 3) waypoints (x, y, heading).

    Selects the segment minimizing d(p, w_i) + d(p, w_{i+1}), then returns the
    signed triangle-area distance to that segment (left of travel positive).
    ``inline=True`` replaces the projection with the endpoint distance when
    the point lies beyond the first/last segment (nusc_api.py:716-724).
    Returns dist (n, T) [and angle_dist (n, T) = 1 - cos(dtheta)].
    """
    points = points.astype(jnp.float32)
    lanes = lanes.astype(jnp.float32)
    n_segs = lanes.shape[-2]

    min_idx = segment_argmin(points, lanes)                      # (n, T)
    # segment endpoints by gather: exact, whatever precision the device
    # gives float32 matrix products
    p2 = take_rows(lanes[..., :-1, :], min_idx)                  # (n, T, 3)
    p3 = take_rows(lanes[..., 1:, :], min_idx)

    x1, y1 = points[..., 0], points[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    x3, y3 = p3[..., 0], p3[..., 1]

    area = x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)
    bottom_l = jnp.linalg.norm((p2 - p3)[..., :2], axis=-1)
    l2_dist = jnp.sqrt(jnp.clip((x1 - x2) ** 2 + (y1 - y2) ** 2, 1e-3))
    normal_case = (bottom_l != 0).astype(jnp.float32)
    dist_to_lane = (normal_case * area / jnp.clip(bottom_l, 1e-7)
                    + (1 - normal_case) * l2_dist)

    if inline:
        l2_dist1 = jnp.sqrt(jnp.clip((x1 - x3) ** 2 + (y1 - y3) ** 2, 1e-3))
        behind = ((x1 - x2) * (x3 - x2) + (y1 - y2) * (y3 - y2)) <= 0
        ahead = ((x1 - x3) * (x2 - x3) + (y1 - y3) * (y2 - y3)) <= 0
        behind_all = (min_idx == 0) & behind
        ahead_all = (min_idx == n_segs - 2) & ahead
        normal = ~(behind_all | ahead_all)
        sign = jnp.sign(dist_to_lane)
        dist = (normal * dist_to_lane + behind_all * l2_dist * sign
                + ahead_all * l2_dist1 * sign)
    else:
        dist = dist_to_lane

    if clip:
        dist = jnp.clip(dist, -5.0, 5.0)

    if with_angle:
        angle_dist = 1.0 - jnp.cos(p2[..., 2] - points[..., 2])
        return dist, angle_dist
    return dist


# ---------------------------------------------------------------------------
# anchor-disc car clearance
# ---------------------------------------------------------------------------

def anchor_points(x: Array, y: Array, th: Array, L: Array, W: Array,
                  num_L: int, num_W: int):
    """Cover an oriented box with num_L x num_W discs (utils.py:465-497).

    x, y, th, L, W broadcast together to shape (...,).
    Returns centers (..., num_L*num_W, 2) and radius r (...,).
    """
    r = jnp.minimum(jnp.maximum(L / num_L / 2.0, W / num_W / 2.0), W / 2.0)
    alpha = jnp.linspace(0.0, 1.0, num_L)
    beta = jnp.linspace(0.0, 1.0, num_W)
    # local-frame centers spanning the box interior minus the radius
    xs = ((-L / 2 + r)[..., None] * (1 - alpha) + (L / 2 - r)[..., None] * alpha)
    ys = ((-W / 2 + r)[..., None] * (1 - beta) + (W / 2 - r)[..., None] * beta)
    xs = jnp.broadcast_to(xs[..., :, None], xs.shape + (num_W,))
    ys = jnp.broadcast_to(ys[..., None, :], ys.shape[:-1] + (num_L, num_W))
    xs = xs.reshape(xs.shape[:-2] + (num_L * num_W,))
    ys = ys.reshape(ys.shape[:-2] + (num_L * num_W,))
    c, s = jnp.cos(th)[..., None], jnp.sin(th)[..., None]
    gx = xs * c - ys * s + x[..., None]
    gy = xs * s + ys * c + y[..., None]
    return jnp.stack([gx, gy], axis=-1), r


def car_clearance(xyth_a: Array, L_a, W_a, xyth_b: Array, L_b, W_b,
                  num_L: int = 4, num_W: int = 1, full: bool = False):
    """Min disc-to-disc clearance between two oriented boxes.

    xyth_*: (..., 3); L/W broadcastable to (...,). Leading dims of a and b
    must broadcast (the caller places ego at (..., 1, T) vs (..., K, T)).
    Returns clearance (...,); with full=True also the raw min center distance
    and the radius sum (utils.py:499-510).
    """
    ones = jnp.ones_like(xyth_a[..., 0])
    xys1, r1 = anchor_points(xyth_a[..., 0], xyth_a[..., 1], xyth_a[..., 2],
                             L_a * ones, W_a * ones, num_L, num_W)
    onesb = jnp.ones_like(xyth_b[..., 0])
    xys2, r2 = anchor_points(xyth_b[..., 0], xyth_b[..., 1], xyth_b[..., 2],
                             L_b * onesb, W_b * onesb, num_L, num_W)
    diff = xys1[..., :, None, :] - xys2[..., None, :, :]    # (..., k, k, 2)
    d = jnp.linalg.norm(diff, axis=-1)
    min_dist = jnp.min(d, axis=(-2, -1))
    clearance = min_dist - r1 - r2
    if full:
        return clearance, min_dist, r1 + r2
    return clearance


def min_neighbor_distance(ego_traj: Array, nei_traj: Array, nei_valid: Array,
                          ego_L: float, ego_W: float, num_L: int = 4,
                          num_W: int = 1, full: bool = False):
    """Masked min clearance to any neighbor per timestep.

    Parity: ``compute_shortest_dist_refined`` (nusc_train.py:142-148) —
    clearance clipped to [-5, 20], invalid neighbors replaced by 100, min
    over the K axis.

    ego_traj: (n, T, >=3); nei_traj: (n, K, T, >=6) with (x,y,th,...,L,W);
    nei_valid: (n, K, T).
    Returns min_d (n, T); with full=True also masked min-center-dist (n,K,T)
    and radius sums (n,K,T) for the TrafficSim collision loss
    (nusc_train.py:416-421).
    """
    res = car_clearance(ego_traj[..., None, :, :3], ego_L, ego_W,
                        nei_traj[..., :3], nei_traj[..., -2], nei_traj[..., -1],
                        num_L, num_W, full=full)
    if full:
        car_dist, min_dist, r_sum = res
    else:
        car_dist = res
    masked = (jnp.clip(car_dist, -5.0, 20.0) * nei_valid
              + (1 - nei_valid) * 100.0)
    min_d = jnp.min(masked, axis=-2)
    if full:
        masked_center = min_dist * nei_valid + (1 - nei_valid) * 100.0
        return min_d, masked_center, r_sum
    return min_d


# ---------------------------------------------------------------------------
# fused ego-clearance with precomputed neighbor discs (guidance hot path)
# ---------------------------------------------------------------------------
#
# The autodiff of ``min_neighbor_distance`` materializes the
# (n, K, T, nL, nL) pairwise tensors in HBM twice (forward residuals + the
# min-reduce VJP masks); XLA's cost model shows the guidance inner loop is
# HBM-bound ~4:1 on exactly these.  This path (a) precomputes the neighbor
# disc centers ONCE per planning call (they are constants of the guidance
# problem), (b) reduces min-over-pairs on SQUARED distances so the sqrt
# happens after the reduce (valid since the disc radii are per-car constants,
# so min commutes), and (c) wraps the whole thing in a recompute-based
# ``custom_vjp`` so no pairwise tensor ever becomes a residual — forward and
# backward are each one produce+reduce fusion.
#
# Semantics match ``min_neighbor_distance`` with num_W == 1 (the reference
# default, nusc_train.py:1667): r = min(max(L/(2 nL), W/2), W/2) == W/2.
# Gradient tie-handling on the clip boundary uses a strict-interior gate
# (measure-zero difference from jnp.clip's VJP).

from typing import NamedTuple


class NeighborDiscs(NamedTuple):
    """Constant per-plan neighbor anchor-disc geometry.

    nx, ny: (n, K, T, nL) disc centers; r: (n, K, T) disc radius;
    valid: (n, K, T) mask.
    """
    nx: Array
    ny: Array
    r: Array
    valid: Array


def precompute_neighbor_discs(nei_traj: Array, nei_valid: Array,
                              num_L: int) -> NeighborDiscs:
    """nei_traj: (n, K, T, >=6) rows (x, y, th, ..., L, W)."""
    nx0, ny0, nth = nei_traj[..., 0], nei_traj[..., 1], nei_traj[..., 2]
    Ln, Wn = nei_traj[..., -2], nei_traj[..., -1]
    r = Wn / 2.0
    alpha = jnp.linspace(0.0, 1.0, num_L)
    ax = ((-Ln / 2 + r)[..., None] * (1 - alpha)
          + (Ln / 2 - r)[..., None] * alpha)                # (n, K, T, nL)
    nx = nx0[..., None] + ax * jnp.cos(nth)[..., None]
    ny = ny0[..., None] + ax * jnp.sin(nth)[..., None]
    return NeighborDiscs(nx, ny, r, nei_valid)


def _ego_axes(ego_L: float, ego_W: float, num_L: int):
    re = ego_W / 2.0
    return re, jnp.linspace(-ego_L / 2 + re, ego_L / 2 - re, num_L)


def _clearance_fwd_math(ego_xyth, discs: NeighborDiscs, ego_L, ego_W, num_L):
    """ego_xyth: (bs, R, T, 3) — R candidates per scene sharing the scene's
    discs (bs, K, T, nL).  Returns (bs, R, T)."""
    re, axe = _ego_axes(ego_L, ego_W, num_L)
    x, y, th = ego_xyth[..., 0], ego_xyth[..., 1], ego_xyth[..., 2]
    ex = x[..., None] + axe * jnp.cos(th)[..., None]      # (bs, R, T, nLe)
    ey = y[..., None] + axe * jnp.sin(th)[..., None]
    dx = (ex[:, :, None, :, :, None]                       # (bs,R,1,T,nLe,1)
          - discs.nx[:, None, :, :, None, :])              # (bs,1,K,T,1,nLn)
    dy = ey[:, :, None, :, :, None] - discs.ny[:, None, :, :, None, :]
    d2 = jnp.min(dx * dx + dy * dy, axis=(-2, -1))         # (bs, R, K, T)
    per = jnp.sqrt(d2 + 1e-12) - re - discs.r[:, None]
    valid = discs.valid[:, None]
    masked = jnp.clip(per, -5.0, 20.0) * valid + (1.0 - valid) * 100.0
    return jnp.min(masked, axis=-2)                        # (bs, R, T)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def min_clearance_tiled(ego_xyth: Array, discs: NeighborDiscs, ego_L: float,
                        ego_W: float, num_L: int = 4) -> Array:
    """Masked min clearance of R candidate rollouts per scene against the
    scene's precomputed neighbor discs.

    ego_xyth: (bs, R, T, >=3); discs fields (bs, K, T, ...).  Returns
    (bs, R, T).  Differentiable w.r.t. ego only (neighbors are playback
    constants — matches the guidance problem and every training loss, where
    neighbor tensors carry no gradient).  Keeping the discs at per-SCENE
    shape instead of tiling them to bs*R rows is the point: the guidance
    inner loop streams 2 MB of constants instead of ~400 MB.
    """
    return _clearance_fwd_math(ego_xyth[..., :3], discs, ego_L, ego_W, num_L)


def _min_clearance_tiled_fwd(ego_xyth, discs, ego_L, ego_W, num_L):
    out = _clearance_fwd_math(ego_xyth[..., :3], discs, ego_L, ego_W, num_L)
    return out, (ego_xyth, discs)


def _min_clearance_tiled_bwd(ego_L, ego_W, num_L, res, g):
    ego_xyth, discs = res
    re, axe = _ego_axes(ego_L, ego_W, num_L)
    x, y, th = ego_xyth[..., 0], ego_xyth[..., 1], ego_xyth[..., 2]
    cth, sth = jnp.cos(th), jnp.sin(th)
    ex = x[..., None] + axe * cth[..., None]               # (bs, R, T, nLe)
    ey = y[..., None] + axe * sth[..., None]
    dx = ex[:, :, None, :, :, None] - discs.nx[:, None, :, :, None, :]
    dy = ey[:, :, None, :, :, None] - discs.ny[:, None, :, :, None, :]
    d2p = dx * dx + dy * dy                          # (bs,R,K,T,nLe,nLn)
    d2 = jnp.min(d2p, axis=(-2, -1))
    dist = jnp.sqrt(d2 + 1e-12)
    per = dist - re - discs.r[:, None]
    valid = discs.valid[:, None]
    masked = jnp.clip(per, -5.0, 20.0) * valid + (1.0 - valid) * 100.0
    out = jnp.min(masked, axis=-2, keepdims=True)          # (bs, R, 1, T)
    # route through the K-min with tie splitting (matches jnp.min VJP)
    eqK = (masked == out).astype(g.dtype)
    wK = eqK / jnp.maximum(jnp.sum(eqK, axis=-2, keepdims=True), 1.0)
    gate = ((per > -5.0) & (per < 20.0)).astype(g.dtype) * valid
    gK = g[:, :, None] * wK * gate                         # (bs, R, K, T)
    # pair-min tie splitting, then d sqrt = 0.5 / dist, d d2 = 2*dx -> dx/dist
    eqP = (d2p == d2[..., None, None]).astype(g.dtype)
    wP = eqP / jnp.maximum(jnp.sum(eqP, axis=(-2, -1), keepdims=True), 1.0)
    coef = (gK / dist)[..., None, None] * wP         # (bs,R,K,T,nLe,nLn)
    g_ex = jnp.sum(coef * dx, axis=(-4, -1))               # (bs, R, T, nLe)
    g_ey = jnp.sum(coef * dy, axis=(-4, -1))
    gx = jnp.sum(g_ex, axis=-1)
    gy = jnp.sum(g_ey, axis=-1)
    gth = jnp.sum(g_ex * (-axe * sth[..., None])
                  + g_ey * (axe * cth[..., None]), axis=-1)
    g_ego = jnp.stack([gx, gy, gth], axis=-1)
    if ego_xyth.shape[-1] > 3:
        g_ego = jnp.concatenate(
            [g_ego, jnp.zeros(ego_xyth.shape[:-1]
                              + (ego_xyth.shape[-1] - 3,), g_ego.dtype)],
            axis=-1)
    zero_discs = jax.tree_util.tree_map(jnp.zeros_like, discs)
    return g_ego, zero_discs


min_clearance_tiled.defvjp(_min_clearance_tiled_fwd, _min_clearance_tiled_bwd)


def min_clearance_pre(ego_xyth: Array, discs: NeighborDiscs, ego_L: float,
                      ego_W: float, num_L: int = 4) -> Array:
    """Per-row variant: ego_xyth (n, T, >=3) against per-row discs
    (n, K, T, ...).  Returns (n, T).  Thin wrapper over the tiled kernel
    with R = 1."""
    return min_clearance_tiled(ego_xyth[:, None], discs, ego_L, ego_W,
                               num_L)[:, 0]


def bbox_corners(x, y, theta, L, W) -> Array:
    """Oriented box corners (4, 2) per element (utils.py:443-462)."""
    lx = jnp.stack([L / 2, L / 2, -L / 2, -L / 2], axis=-1)
    ly = jnp.stack([W / 2, -W / 2, -W / 2, W / 2], axis=-1)
    c, s = jnp.cos(theta)[..., None], jnp.sin(theta)[..., None]
    gx = lx * c - ly * s + x[..., None]
    gy = lx * s + ly * c + y[..., None]
    return jnp.stack([gx, gy], axis=-1)
