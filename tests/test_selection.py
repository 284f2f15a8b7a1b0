"""Selection gathers of the lane and clearance terms: exact, and free of
default-precision float32 matrix products (which a GPU may run in TF32)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pstl_tpu import specs
from pstl_tpu.config import Config
from pstl_tpu.ops import geometry as geom
from tests.test_specs import make_batch

OFFSET = 1e3        # map coordinates 1 km from the origin


def _setup(coarse_pair, offset=OFFSET):
    cfg = Config(diffusion=True, guidance=True, n_randoms=4, n_neighbors=3,
                 clearance_coarse_pair=coarse_pair).finalize()
    bs = 2
    batch = make_batch(cfg, bs=bs, seed=1)
    shift = jnp.asarray([offset, offset, 0.0])
    for k in ("currlane_wpts", "leftlane_wpts", "rightlane_wpts"):
        batch[k] = batch[k] + shift
    batch["ego_traj"] = batch["ego_traj"].at[..., :2].add(offset)
    nei = np.asarray(batch["neighbor_trajs_aug"]).copy()
    rng = np.random.RandomState(2)
    nei[:, 1, :, 0] = 1.0                      # a second, nearby neighbor
    nei[:, 1, :, 1:3] = rng.randn(bs, cfg.nt, 2) * 3 + [8.0, 1.0]
    nei[:, 1, :, 5:7] = [4.5, 1.9]
    nei[:, :, :, 1:3] += offset
    batch["neighbor_trajs_aug"] = jnp.asarray(nei)
    batch["neighbors"] = batch["neighbor_trajs_aug"][:, :, 0, :]
    stlp = specs.calibrate_stlp(batch, batch["ego_traj"][..., :4], cfg)
    dense = specs.densify_batch(batch, stlp, cfg, key=jax.random.PRNGKey(0))
    states = batch["ego_traj"][:, 0, :4]
    fused = specs.make_guidance_loss(batch, dense, cfg, states,
                                     dense["valids_dense"].reshape(-1))
    n = bs * cfg.n_randoms * 3
    mu = jnp.asarray(rng.randn(n, cfg.nt * 2) * 0.5, jnp.float32)
    return cfg, batch, fused, fused._to_cand_minor(mu)


def _default_f32_dots(fn, *args):
    """dot_general ops of ``fn``'s StableHLO that take float32 operands at
    the default precision."""
    text = jax.jit(fn).lower(*args).as_text()
    return [ln for ln in text.splitlines()
            if "dot_general" in ln and re.search(r"tensor<[0-9x]*xf32>", ln)
            and "HIGHEST" not in ln]


def test_detector_finds_default_precision_einsum():
    a = jnp.ones((4, 3))
    assert _default_f32_dots(lambda x: jnp.einsum("ij,jk->ik", x, x.T), a)
    assert not _default_f32_dots(lambda x: jnp.einsum(
        "ij,jk->ik", x, x.T, precision=jax.lax.Precision.HIGHEST), a)


@pytest.mark.parametrize("what", ["point_to_polyline", "freeze_cm",
                                  "clear_select"])
def test_no_default_precision_f32_dot(what):
    _, batch, fused, muT = _setup(coarse_pair=True)
    if what == "point_to_polyline":
        fn = lambda p, l: geom.point_to_polyline(p, l, with_angle=True)
        args = (batch["ego_traj"][..., :3], batch["currlane_wpts"])
    elif what == "freeze_cm":
        fn, args = fused.freeze_cm, (muT,)
    else:
        def fn(m):
            x_s, y_s, _, _, cth, sth = fused._rollout(m)
            return fused._clear_select(x_s, y_s, cth, sth)
        args = (muT,)
    assert _default_f32_dots(fn, *args) == []


@pytest.mark.parametrize("coarse_pair", [False, True])
def test_selections_match_numpy_gather(coarse_pair):
    """At map coordinates 1 km out: the device picks the nearest segment /
    disc pair, and the gathered endpoints, disc offsets and disc centers
    are exactly the host's numpy gather with the same indices."""
    _, _, fused, muT = _setup(coarse_pair)
    x_s, y_s, _, _, cth, sth = fused._rollout(muT)
    mi = fused._lane_argmin(x_s, y_s)
    lsel = jax.device_get(fused._lane_gather(mi))
    ie, inn = fused._clear_pair(x_s, y_s, cth, sth)
    csel = jax.device_get(fused._clear_gather(ie, inn))
    mi, ie, inn = (np.asarray(v) for v in (mi, ie, inn))
    # the device's segment is the host's float64 nearest segment
    lx, ly = (np.asarray(v, np.float64) for v in (fused.lxr, fused.lyr))
    xs, ys = (np.asarray(v, np.float64) for v in (x_s, y_s))
    pd = np.hypot(xs[:, :, None] - lx[:, None], ys[:, :, None] - ly[:, None])
    segc = pd[:, :, :-1] + pd[:, :, 1:]
    picked = np.take_along_axis(segc, mi[:, :, None], axis=2)[:, :, 0]
    assert (picked <= segc.min(axis=2) + 1e-4).all()
    pay = np.asarray(fused.lane_payload_g)
    want = np.take_along_axis(pay[:, :, None], mi[:, None, :, None],
                              axis=3)[:, :, :, 0]
    for c, k in enumerate(("x2", "y2", "th2", "x3", "y3")):
        np.testing.assert_array_equal(lsel[k], want[:, c])
    np.testing.assert_array_equal(lsel["first"], mi == 0)
    np.testing.assert_array_equal(csel["axe"], np.asarray(fused.axe)[ie])
    for k in ("nx", "ny"):
        np.testing.assert_array_equal(
            csel[k], np.take_along_axis(np.asarray(getattr(fused, k)), inn,
                                        axis=3))


def test_polyline_endpoints_match_numpy_gather():
    """``point_to_polyline``'s segment endpoints at map coordinates 1 km
    out are exactly the host's gather, and its distances match a float64
    recomputation on them."""
    _, batch, _, _ = _setup(coarse_pair=False)
    rng = np.random.RandomState(4)
    pts = batch["ego_traj"][..., :3] + jnp.asarray(
        rng.randn(*batch["ego_traj"].shape[:2], 3) * [1.0, 2.0, 0.1],
        jnp.float32)
    lanes = batch["leftlane_wpts"]
    idx = np.asarray(geom.segment_argmin(pts, lanes))
    p2 = np.asarray(geom.take_rows(lanes[..., :-1, :], jnp.asarray(idx)))
    want = np.take_along_axis(np.asarray(lanes)[..., :-1, :],
                              idx[..., None], axis=-2)
    np.testing.assert_array_equal(p2, want)
    d = np.asarray(geom.point_to_polyline(pts, lanes))
    p3 = np.take_along_axis(np.asarray(lanes, np.float64)[..., 1:, :],
                            idx[..., None], axis=-2)
    p, q = np.asarray(pts, np.float64), want.astype(np.float64)
    area = (p[..., 0] * (q[..., 1] - p3[..., 1])
            + q[..., 0] * (p3[..., 1] - p[..., 1])
            + p3[..., 0] * (p[..., 1] - q[..., 1]))
    d_ref = area / np.hypot(q[..., 0] - p3[..., 0], q[..., 1] - p3[..., 1])
    # float32 cancellation at |coords| ~ 1e3 bounds the agreement
    np.testing.assert_allclose(d, d_ref, atol=2e-3)
