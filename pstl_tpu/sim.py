"""Device-resident closed-loop replanning simulator.

Parity target: ``nusc_sim.py`` (``NuScenesSim`` env :25-354 + driver main
:356-755).  The reference re-enters the Python NuScenes devkit every sim step
for map/neighbor queries; here every scene is pre-extracted into fixed-shape
tensors (see ``data/synthetic.py`` scene_* outputs) so the WHOLE episode —
planner (full DDPM reverse pass + guidance + multi-cands + RefineNet), ego
Euler step, neighbor playback, lane re-windowing around the *simulated* pose,
collision and out-of-lane checks, and metric accumulation — is one jitted
``lax.scan`` vmapped over a batch of scenes.  This is the surface behind the
north-star benchmark (closed-loop agent-steps/sec/chip).

Deviations from the reference (documented):
- the current lane is re-windowed on device from the dense centerline, and
  left/right lanes come from the pre-extracted per-t lane tensors (TRUE map
  geometry, selected by nearest GT pose to the simulated pose) when the
  cache carries them — the reference re-queries the devkit per step
  (nusc_sim.py:145-147); legacy caches fall back to +-3.5 m offsets;
- out-of-lane uses the analytic drivable corridor |lateral offset| <= width
  over the valid lanes instead of the rasterized ``drivable_area`` layer;
- episodes run a fixed max length with done-masking (XLA-friendly) instead
  of early python exit.

The aggressive closed-loop stlp override mirrors nusc_sim.py:444-472; mode
restriction to lane-keep + argmax robustness mirrors nusc_sim.py:677-683.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pstl_tpu import diffusion, specs
from pstl_tpu.config import Config
from pstl_tpu.models import Net
from pstl_tpu.models import net as models
from pstl_tpu.ops import dynamics as dyn
from pstl_tpu.ops import geometry as geom

Array = jax.Array

LANE_OFFSET = 3.5
D_SAFE = 0.1           # collision threshold (nusc_sim.py:113)
# analytic drivable half-width per valid lane; the reference checks the
# map's road-wide drivable_area layer, which extends beyond lane centers —
# 3.25 m covers a lane plus shoulder (and the aggressive stlp's dmin=-3 band)
CORRIDOR_HALF = 3.25

# fixed aggressive stlp override (nusc_sim.py:466-472)
AGGRESSIVE_STLP = np.array([1.0, 9.0, -3.0, 2.0, 0.1, 0.2], np.float32)
# --test_aggressive per-episode presets (nusc_sim.py:444-465)
TEST_AGGRESSIVE_STLPS = np.array([
    [0.0, 1.0, -1.0, 2.0, 2.0, 0.2],
    [0.0, 4.0, -1.0, 1.0, 1.0, 0.2],
    [0.0, 6.0, -1.0, 1.0, 0.2, 0.2],
], np.float32)


class SceneTensors(NamedTuple):
    """Per-scene pre-extracted tensors (stack for a batch).

    The optional per-t tensors carry TRUE side-lane geometry / validity /
    maneuver labels extracted along the GT corridor at every t (the
    reference re-queries the map around the simulated pose each step,
    nusc_sim.py:145-156; offline we select the stored entry whose GT pose
    is nearest the simulated pose).  When absent (legacy caches) the sim
    falls back to +-LANE_OFFSET side-lane fabrication, scene-start
    validity, and lateral-offset re-labeling.
    """
    ego_full: Array       # (L_full, 4) GT ego states (x, y, th, v)
    nei_full: Array       # (K, L_full, 7) neighbor tracks
    center_dense: Array   # (n_dense, 3) dense current-lane centerline
    lane_valids: Array    # (3,) [curr, left, right] validity
    length: Array         # () scene length (sim steps)
    drivable: Array       # (H, W) rasterized drivable-area mask
    drivable_origin: Array  # (2,) world coords of mask corner (x0, y0)
    drivable_res: Array   # () meters per cell
    lanes_t: Optional[Array] = None        # (Lt, 3, n_segs, 3) per-t lanes
    lane_valids_t: Optional[Array] = None  # (Lt, 3) per-t validity
    hl_t: Optional[Array] = None           # (Lt,) per-t keyframe labels


def rasterize_corridor(center_dense: np.ndarray, lane_valids: np.ndarray,
                       resolution: float = 0.5, margin: float = 12.0):
    """Drivable raster of the analytic lane corridor (synthetic scenes /
    legacy caches without an extracted drivable_area layer): a grid cell is
    drivable when within CORRIDOR_HALF of any valid lane's centerline.
    Returns (mask (H, W) bool, origin (2,), resolution)."""
    pts = center_dense[:, :2]
    lo = pts.min(axis=0) - (LANE_OFFSET + margin)
    hi = pts.max(axis=0) + (LANE_OFFSET + margin)
    H = int(np.ceil((hi[1] - lo[1]) / resolution))
    W = int(np.ceil((hi[0] - lo[0]) / resolution))
    gx = lo[0] + (np.arange(W) + 0.5) * resolution
    gy = lo[1] + (np.arange(H) + 0.5) * resolution
    offsets = [0.0] + [LANE_OFFSET * s for s, v in
                       (( +1.0, lane_valids[1]), (-1.0, lane_valids[2]))
                       if v > 0.5]
    nx = -np.sin(center_dense[:, 2])
    ny = np.cos(center_dense[:, 2])
    mask = np.zeros((H, W), bool)
    for i0 in range(0, H, 64):        # chunk rows to bound temp memory
        gyc = gy[i0:i0 + 64]
        dx = gx[None, :, None] - pts[None, None, :, 0]     # (1, W, n)
        dy = gyc[:, None, None] - pts[None, None, :, 1]    # (h, 1, n)
        d2 = dx * dx + dy * dy                             # (h, W, n)
        ok = np.zeros(d2.shape[:2], bool)
        for off in offsets:
            ox = pts[None, None, :, 0] + nx[None, None, :] * off
            oy = pts[None, None, :, 1] + ny[None, None, :] * off
            dd = (gx[None, :, None] - ox) ** 2 \
                + (gyc[:, None, None] - oy) ** 2
            ok |= np.min(dd, axis=-1) <= CORRIDOR_HALF ** 2
        mask[i0:i0 + 64] = ok
    return mask, lo.astype(np.float32), np.float32(resolution)


def scenes_from_dataset(data: Dict[str, np.ndarray]) -> SceneTensors:
    if "scene_drivable" in data:
        mask = np.asarray(data["scene_drivable"])
        origin = np.asarray(data["scene_drivable_origin"])
        res = np.asarray(data["scene_drivable_res"])
    else:
        # legacy/synthetic cache: rasterize the analytic corridor so the
        # out-of-lane check matches the reference's drivable_area raster
        # query (nusc_sim.py:190-211) instead of an analytic band
        masks, origins, ress = [], [], []
        for i in range(len(data["scene_center_dense"])):
            m, o, r = rasterize_corridor(
                np.asarray(data["scene_center_dense"][i]),
                np.asarray(data["scene_lane_valids"][i]))
            masks.append(m)
            origins.append(o)
            ress.append(r)
        Hm = max(m.shape[0] for m in masks)
        Wm = max(m.shape[1] for m in masks)
        mask = np.zeros((len(masks), Hm, Wm), bool)
        for i, m in enumerate(masks):
            mask[i, :m.shape[0], :m.shape[1]] = m
        origin = np.stack(origins)
        res = np.stack(ress)
    opt = {k: (jnp.asarray(data[f"scene_{k}"])
               if f"scene_{k}" in data else None)
           for k in ("lanes_t", "lane_valids_t", "hl_t")}
    return SceneTensors(
        ego_full=jnp.asarray(data["scene_ego_full"]),
        nei_full=jnp.asarray(data["scene_nei_full"]),
        center_dense=jnp.asarray(data["scene_center_dense"]),
        lane_valids=jnp.asarray(data["scene_lane_valids"]),
        length=jnp.asarray(data["scene_len"]),
        drivable=jnp.asarray(mask),
        drivable_origin=jnp.asarray(origin),
        drivable_res=jnp.asarray(res),
        **opt,
    )


# ---------------------------------------------------------------------------
# on-device observation extraction
# ---------------------------------------------------------------------------

def lane_window_device(center_dense: Array, pose_xy: Array,
                       n_segs: int) -> Array:
    """Re-window the dense centerline around a pose — the device replacement
    for the reference's per-step ``get_centerlines`` devkit call
    (nusc_sim.py:145-147)."""
    n_dense = center_dense.shape[0]
    d2 = jnp.sum((center_dense[:, :2] - pose_xy) ** 2, axis=-1)
    i0 = jnp.maximum(jnp.argmin(d2) - 2, 0)
    stride = jnp.maximum((n_dense - i0 - 1) // (n_segs * 2), 1)
    idx = jnp.clip(i0 + jnp.arange(n_segs) * stride, 0, n_dense - 1)
    return center_dense[idx]


def offset_lane_device(lane: Array, offset: float) -> Array:
    nx = -jnp.sin(lane[:, 2])
    ny = jnp.cos(lane[:, 2])
    return lane.at[:, 0].add(nx * offset).at[:, 1].add(ny * offset)


def observe(scene: SceneTensors, ego_state: Array, t: Array,
            cfg: Config) -> Dict[str, Array]:
    """Fixed-shape observation for ONE scene at sim time t (unbatched;
    callers vmap)."""
    nt, k = cfg.nt, cfg.n_neighbors
    nei_win = jax.lax.dynamic_slice_in_dim(scene.nei_full, t, nt, axis=1)
    curr = lane_window_device(scene.center_dense, ego_state[:2], cfg.n_segs)
    if scene.lanes_t is not None:
        # TRUE per-t side lanes extracted along the GT corridor: select the
        # entry whose GT pose is nearest the SIMULATED pose (offline
        # analogue of nusc_sim.py:145-147 -> nusc_api.py:493-525 re-query)
        Lt = scene.lanes_t.shape[0]
        d2g = jnp.sum((scene.ego_full[:Lt, :2] - ego_state[:2]) ** 2,
                      axis=-1)
        it = jnp.argmin(d2g)
        valids = (scene.lane_valids_t[it]
                  if scene.lane_valids_t is not None else scene.lane_valids)
        left = scene.lanes_t[it, 1] * valids[1]
        right = scene.lanes_t[it, 2] * valids[2]
    else:
        valids = scene.lane_valids
        left = offset_lane_device(curr, LANE_OFFSET) * valids[1]
        right = offset_lane_device(curr, -LANE_OFFSET) * valids[2]
    ego_traj = jnp.broadcast_to(ego_state, (nt, 4))
    ego_traj = jnp.concatenate(
        [ego_traj, jnp.full((nt, 1), cfg.ego_L), jnp.full((nt, 1), cfg.ego_W)],
        axis=-1)
    # per-step high-level re-labeling around the SIMULATED pose (the
    # reference re-queries get_high_level_behaviors each sim step,
    # nusc_sim.py:148-156): annotation-keyframe labels when the cache
    # carries them, else label by the current lateral offset from the
    # re-windowed centerline — keep inside +-half-lane, else the side the
    # ego has drifted to (subject to that lane existing)
    if scene.hl_t is not None and scene.lanes_t is not None:
        hl = scene.hl_t[it]
    else:
        d0 = geom.point_to_polyline(ego_state[None, None, :3],
                                    curr[None])[0, 0]
        hl = jnp.where(d0 > LANE_OFFSET / 2,
                       jnp.where(valids[1] > 0.5, 1.0, 0.0),
                       jnp.where(d0 < -LANE_OFFSET / 2,
                                 jnp.where(valids[2] > 0.5, 2.0, 0.0),
                                 0.0))
    return {
        "ego_traj": ego_traj,
        "neighbors": nei_win[:, 0],
        "neighbors_traj": nei_win,
        "neighbor_trajs_aug": nei_win,
        "currlane_wpts": curr,
        "leftlane_wpts": left,
        "rightlane_wpts": right,
        "curr_id": valids[0:1],
        "left_id": valids[1:2],
        "right_id": valids[2:3],
        "gt_high_level": hl[None],
    }


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def make_planner(cfg: Config, net: Net, params, formulas,
                 coeffs: diffusion.Coeffs,
                 stlp_override: Optional[np.ndarray] = None) -> Callable:
    """Returns plan(key, obs_batch) -> (u0 (bs, 2), info dict).

    Full reference planning pipeline (nusc_sim.py:409-683): densify with the
    aggressive stlp override (per-scene overrides via ``stlp_override``
    (bs, 6) for the --test_aggressive presets), DDPM reverse pass (guidance
    maximize=True), multi-cands + RefineNet + n_rolls re-rectification,
    lane-keep restriction, argmax robustness, first control extracted.
    """
    M = cfg.n_randoms
    override = jnp.asarray(stlp_override if stlp_override is not None
                           else AGGRESSIVE_STLP)

    def plan(key, obs):
        bs = obs["ego_traj"].shape[0]
        n = bs * M * 3
        k_dense, k_sample = jax.random.split(key)
        states = obs["ego_traj"][:, 0, :4]
        gt_stlp = jnp.broadcast_to(override.reshape(-1, 6)[-1], (bs, 6))
        if override.ndim == 2:
            stlp_dense = jnp.repeat(override[:, None, :], M * 3,
                                    axis=0).reshape(n, 1, 6)
        else:
            stlp_dense = jnp.broadcast_to(override, (n, 1, 6))
        dense = specs.densify_batch(obs, gt_stlp, cfg, key=k_dense,
                                    stlp_dense=stlp_dense)
        if cfg.use_init_hint:
            # the init-hint conditioned VAE (e3) expects a control-seed hint
            # per row; closed-loop has no trajopt sidecars, so feed the
            # dataset's random-seed distribution (nusc_dataset.py:215-218)
            k_dense, k_hint = jax.random.split(k_dense)
            kw, ka = jax.random.split(k_hint)
            hint = jnp.stack(
                [jax.random.uniform(kw, (n, cfg.nt), minval=-cfg.mul_w_max,
                                    maxval=cfg.mul_w_max) * 0.1,
                 jax.random.uniform(ka, (n, cfg.nt), minval=-cfg.mul_a_max,
                                    maxval=cfg.mul_a_max)], axis=-1)
            dense["params_init"] = hint
        highlevel = dense["highlevel_dense"]
        valid = dense["valids_dense"].reshape(-1)
        states_flat = jnp.broadcast_to(states[:, None, None],
                                       (bs, M, 3, 4)).reshape(n, 4)
        score_rows = specs.make_score_rows(obs, dense, cfg, formulas)

        def score_controls(u):
            trajs = dyn.rollout(states_flat, u, cfg.dt)
            s = score_rows(trajs[:, :-1])
            acc = specs.mask_mean((s > 0).astype(jnp.float32), valid)
            return s, acc, trajs

        if cfg.diffusion:
            ext0 = {"timestep": jnp.ones((n, 1)), "highlevel": highlevel,
                    "noise": jnp.zeros((n, cfg.nt * 2))}
            _, feature = net.apply(params, dense, ext0, get_feature=True)

            def apply_fn(e):
                return net.apply(params, dense, e, prev_feature=feature)

            fused = (specs.make_guidance_loss(obs, dense, cfg, states,
                                              valid)
                     if cfg.guidance else None)
            guidance_ctx = (diffusion.make_guidance_ctx(
                score_rows, valid, states_flat, fused_loss=fused)
                if cfg.guidance else None)
            cm_fn = (models.make_cm_eps_fn(params, dense, highlevel,
                                           feature, cfg)
                     if cfg.cm_sampler and fused is not None else None)
            nn_controls, all_steps = diffusion.sample(
                k_sample, apply_fn, dense, highlevel, feature, cfg, coeffs,
                n, guidance_ctx=guidance_ctx, maximize=True, cm_fn=cm_fn)
        elif cfg.vae:
            # VAE / TrafficSim closed-loop rows (nusc_sim.py model dispatch):
            # sample the prior latent directly
            z = jax.random.normal(k_sample, (n, cfg.vae_dim))
            nn_controls, _ = net.apply(params, dense,
                                       {"highlevel": highlevel}, sample=z,
                                       get_feature=False)
            feature = None
            all_steps = nn_controls[None]
        else:   # bc
            nn_controls = net.apply(params, dense, {"highlevel": highlevel})
            feature = None
            all_steps = nn_controls[None]

        if cfg.rect_head and not cfg.not_use_rect:
            if cfg.multi_cands is not None:
                nn_controls, prev_scores = diffusion.select_multi_cands(
                    all_steps, cfg.multi_cands, states_flat, score_rows, cfg)
            else:
                prev_scores, _, _ = score_controls(nn_controls)
            controls = net.apply(params, feature, highlevel,
                                 dense["stlp_dense"][:, 0], nn_controls,
                                 prev_scores, method=Net.rect)
            for _ in range(cfg.n_rolls or 0):
                s_re, _, _ = score_controls(controls)
                controls = net.apply(params, feature, highlevel,
                                     dense["stlp_dense"][:, 0], controls,
                                     s_re, method=Net.rect)
            if cfg.refinement or cfg.raw_refinement:
                from pstl_tpu import refine

                def do_refine(c):
                    if cfg.refinement:
                        return refine.convex_refinement(
                            c, all_steps, states_flat, score_rows, valid,
                            cfg, K=6)
                    return refine.raw_refinement(
                        c, states_flat, score_rows, valid, cfg)

                if cfg.lite_refine:
                    # --lite_refine (nusc_sim.py:554-557): skip the gradient
                    # repair when some lane-keep candidate already satisfies
                    # the spec (reference: scalar max, batch_size=1; here
                    # the max runs over the whole scene batch)
                    s_pre, _, _ = score_controls(controls)
                    keep_max = jnp.max(s_pre.reshape(bs, M, 3)[:, :, 0])
                    controls = jax.lax.cond(keep_max <= 0, do_refine,
                                            lambda c: c, controls)
                else:
                    controls = do_refine(controls)
        else:
            controls = nn_controls

        scores, acc, trajs = score_controls(controls)
        # lane-keep only + argmax robustness (nusc_sim.py:677-683)
        scores3 = scores.reshape(bs, M, 3)
        if cfg.forward_shield:
            # graded reversal penalty (see Config docstring): at low speeds
            # EVERY sampled candidate may dip below v=0 somewhere in the
            # horizon, so a uniform penalty would cancel out — penalizing by
            # reversal depth picks the least-reversing candidate and keeps
            # the executed speed recoverable
            min_v = jnp.min(trajs[..., 3], axis=-1).reshape(bs, M, 3)
            scores3 = scores3 - jnp.maximum(-min_v, 0.0) * 1e3
        keep_scores = jnp.where(
            jnp.arange(3)[None, None, :] == 0, scores3, -10000.0)
        flat = keep_scores.reshape(bs, M * 3)
        best = jnp.argmax(flat, axis=-1)
        u_all = controls.reshape(bs, M * 3, cfg.nt, 2)
        tr_all = trajs.reshape(bs, M * 3, cfg.nt + 1, 4)
        u_best = jnp.take_along_axis(
            u_all, best[:, None, None, None], axis=1)[:, 0]
        tr_best = jnp.take_along_axis(
            tr_all, best[:, None, None, None], axis=1)[:, 0]
        stl_acc = jnp.mean((keep_scores[:, :, 0] > 0).astype(jnp.float32),
                           axis=-1)
        info = {"controls": controls, "trajs": trajs, "scores": scores,
                "keep_scores": flat, "best": best,
                "plan_traj": tr_best, "stl_acc": stl_acc,
                "valids_dense": dense["valids_dense"]}
        return u_best[:, 0, :], info

    return plan


def _apply_backup(u0: Array, info: Dict[str, Array], obs: Dict[str, Array],
                  cfg: Config) -> Array:
    """Batched backup safety controller (nusc_sim.py:686-708): when the
    chosen plan's 2-step-ahead clearance to any predicted neighbor drops
    below D_SAFE, solve a control-residual optimization to restore it and
    apply the corrected first control.

    Reference semantics (nusc_sim.py:689-705): loop neighbors in slot
    order, repair against the FIRST valid neighbor whose clearance is
    unsafe, then break.  Batched equivalent: per-neighbor clearance test,
    ``argmax`` of the unsafe mask = first-True slot index.  The Adam
    budget comes from ``cfg.backup_niters`` (reference: 500,
    nusc_sim.py:762)."""
    from pstl_tpu import refine
    plan_traj = info["plan_traj"]                    # (bs, nt+1, 4)
    nei = obs["neighbor_trajs_aug"]                  # (bs, K, nt, 7)
    # chosen plan controls: recover first two from the plan states
    dth = (plan_traj[:, 1:3, 2] - plan_traj[:, 0:2, 2]) / cfg.dt
    dv = (plan_traj[:, 1:3, 3] - plan_traj[:, 0:2, 3]) / cfg.dt
    u01 = jnp.stack([dth, dv], axis=-1)              # (bs, 2, 2)

    clear = geom.car_clearance(
        plan_traj[:, None, 2, :3], cfg.ego_L, cfg.ego_W,
        nei[:, :, 2, 1:4], nei[:, :, 2, 5], nei[:, :, 2, 6],
        cfg.refined_nL, cfg.refined_nW)              # (bs, K)
    # per-neighbor unsafe test, exactly the reference's per-ni check:
    # valid slot AND clipped clearance below D_SAFE
    unsafe_k = (nei[:, :, 2, 0] > 0.5) & (jnp.clip(clear, -5, 20) < D_SAFE)
    unsafe = jnp.any(unsafe_k, axis=-1)              # (bs,)

    # first unsafe neighbor slot drives the residual (argmax of a bool
    # mask returns the first True; rows with no unsafe slot pick 0 but
    # their correction is discarded by the `unsafe` where below)
    j = jnp.argmax(unsafe_k, axis=-1)
    nei_sel = jnp.take_along_axis(
        nei, j[:, None, None, None], axis=1)[:, 0]   # (bs, nt, 7)
    u_res = jax.vmap(lambda pt, uu, nn: refine.solve_backup(
        pt[None, 0:3], uu[None], nn[None, 0:3], cfg,
        n_iters=cfg.backup_niters))(
        plan_traj, u01, nei_sel)                     # (bs, 2, 2)
    u_corr = u01[:, 0] + u_res[:, 0]
    return jnp.where(unsafe[:, None], u_corr, u0), unsafe


# ---------------------------------------------------------------------------
# environment step (batched)
# ---------------------------------------------------------------------------

def env_step(scene: SceneTensors, ego_state: Array, t: Array, u: Array,
             cfg: Config):
    """One Euler step + collision / out-of-lane checks for one scene
    (nusc_sim.py:108-227).  Unbatched; callers vmap."""
    new_state = ego_state + dyn.dynamics(ego_state, u) * cfg.dt
    if cfg.env_nonnegative_speed:
        new_state = new_state.at[3].set(jnp.maximum(new_state[3], 0.0))
    nei_next = jax.lax.dynamic_index_in_dim(scene.nei_full, t + 1, axis=1,
                                            keepdims=False)   # (K, 7)
    clear = geom.car_clearance(new_state[None, :3], cfg.ego_L, cfg.ego_W,
                               nei_next[:, 1:4], nei_next[:, 5],
                               nei_next[:, 6], cfg.refined_nL, cfg.refined_nW)
    clear = jnp.clip(clear, -5.0, 20.0) * nei_next[:, 0] \
        + (1 - nei_next[:, 0]) * 100.0
    collide = jnp.min(clear) < D_SAFE
    # rasterized drivable-area lookup (nusc_sim.py:190-211 parity: the
    # reference queries the map's drivable_area layer at the new pose)
    rel = (new_state[:2] - scene.drivable_origin) / scene.drivable_res
    j = jnp.floor(rel[0]).astype(jnp.int32)
    i = jnp.floor(rel[1]).astype(jnp.int32)
    H, W = scene.drivable.shape
    in_bounds = (i >= 0) & (i < H) & (j >= 0) & (j < W)
    cell = scene.drivable[jnp.clip(i, 0, H - 1), jnp.clip(j, 0, W - 1)]
    out_of_lane = ~(in_bounds & cell)
    done_t = t + 1 >= scene.length - 2
    return new_state, collide, out_of_lane, done_t


# ---------------------------------------------------------------------------
# episode runner
# ---------------------------------------------------------------------------

class Carry(NamedTuple):
    """Closed-loop episode state (batched over scenes)."""
    ego: Array          # (bs, 4)
    t: Array            # (bs,) int
    done: Array         # (bs,) bool
    collide: Array
    out_of_lane: Array
    progress: Array
    stl_acc_sum: Array
    steps: Array
    repairs: Array      # (bs,) backup-controller repairs fired
    key: Array


def _init_carry(scenes: SceneTensors, key: Array,
                t0: Optional[Array] = None) -> Carry:
    """t0: optional (bs,) per-scene episode start frame (the reference's
    curated [traj, ti] closed-loop protocol, nusc_dataset.py:38-72)."""
    bs = scenes.ego_full.shape[0]
    if t0 is None:
        t0 = jnp.zeros((bs,), jnp.int32)
    else:
        t0 = jnp.asarray(t0, jnp.int32)
    ego0 = jnp.take_along_axis(scenes.ego_full, t0[:, None, None],
                               axis=1)[:, 0]
    return Carry(
        ego=ego0,
        t=t0,
        done=jnp.zeros((bs,), bool),
        collide=jnp.zeros((bs,), bool),
        out_of_lane=jnp.zeros((bs,), bool),
        progress=jnp.zeros((bs,)),
        stl_acc_sum=jnp.zeros((bs,)),
        steps=jnp.zeros((bs,)),
        repairs=jnp.zeros((bs,)),
        key=key)


def _make_body(scenes: SceneTensors, cfg: Config, plan, with_info=False):
    """The shared (observe -> plan -> env step -> metric update) body."""

    def body(c: Carry):
        k, k_plan = jax.random.split(c.key)
        obs = jax.vmap(lambda s, e, t: observe(s, e, t, cfg),
                       in_axes=(0, 0, 0))(scenes, c.ego, c.t)
        u0, info = plan(k_plan, obs)
        if cfg.backup:
            u0, repaired = _apply_backup(u0, info, obs, cfg)
        else:
            repaired = jnp.zeros(u0.shape[:1], bool)
        new_ego, collide, ool, done_t = jax.vmap(
            lambda s, e, t, u: env_step(s, e, t, u, cfg),
            in_axes=(0, 0, 0, 0))(scenes, c.ego, c.t, u0)
        active = ~c.done
        carry = Carry(
            ego=jnp.where(active[:, None], new_ego, c.ego),
            t=jnp.where(active, c.t + 1, c.t),
            done=c.done | ((collide | ool | done_t) & active),
            collide=c.collide | (collide & active),
            out_of_lane=c.out_of_lane | (ool & active),
            progress=c.progress + active * c.ego[:, 3] * cfg.dt,
            stl_acc_sum=c.stl_acc_sum + active * info["stl_acc"],
            steps=c.steps + active,
            repairs=c.repairs + active * repaired,
            key=k)
        if with_info:
            return carry, info
        return carry

    return body


def run_closed_loop(key: Array, scenes: SceneTensors, cfg: Config, net: Net,
                    params, formulas, coeffs, max_steps: int,
                    measure_area: bool = False) -> Dict[str, Array]:
    """Batched episodes as one jitted scan (replanning at every step).

    scenes: stacked SceneTensors with leading batch dim bs.
    Returns per-scene metrics: collide, out_of_lane, traj_len, progress,
    stl_acc (mean over active steps), plus per-step diagnostics.
    """
    plan = make_planner(cfg, net, params, formulas, coeffs)
    body = _make_body(scenes, cfg, plan)
    c, _ = jax.lax.scan(lambda c, _: (body(c), None),
                        _init_carry(scenes, key), None, length=max_steps)
    return _carry_metrics(c)


def _carry_metrics(c):
    steps = jnp.maximum(c.steps, 1.0)
    return {
        "collide": c.collide.astype(jnp.float32),
        "out_of_lane": c.out_of_lane.astype(jnp.float32),
        "traj_len": c.steps,
        "progress": c.progress,
        "stl_acc": c.stl_acc_sum / steps,
        "agent_steps": jnp.sum(c.steps),
        "repairs": c.repairs,
    }


def make_closed_loop_step(scenes: SceneTensors, cfg: Config, net: Net,
                          params, formulas, coeffs, with_info: bool = False,
                          stlp_override=None, chunk: int = 1):
    """Host-driven variant: ONE jitted program per call, invoked from
    python.  ``chunk`` > 1 runs that many replanning steps per program as a
    ``lax.scan`` — the scan body compiles once, and host dispatch latency
    amortizes across the chunk.  with_info (per-step diagnostics for recording/rendering)
    forces chunk=1.  Returns (init_carry, step_fn)."""
    plan = make_planner(cfg, net, params, formulas, coeffs,
                        stlp_override=stlp_override)
    body = _make_body(scenes, cfg, plan, with_info=with_info)

    if with_info or chunk <= 1:
        step = jax.jit(body)
    else:
        @jax.jit
        def step(c: Carry):
            c, _ = jax.lax.scan(lambda c, _: (body(c), None), c, None,
                                length=chunk)
            return c

    def init_carry(key, t0=None):
        return _init_carry(scenes, key, t0=t0)

    return init_carry, step


def run_closed_loop_host(key: Array, scenes: SceneTensors, cfg: Config,
                         net: Net, params, formulas, coeffs,
                         max_steps: int, record: bool = False,
                         render_dir: Optional[str] = None,
                         stlp_override=None, chunk: int = 1,
                         t0=None) -> Dict[str, Array]:
    """Host-driven episode runner (same metrics as run_closed_loop).

    record=True additionally returns per-step ego history, plan trajectories
    and the per-step candidate-area diversity metric (Table-II "area",
    nusc_sim.py:714-735); render_dir writes closed-loop frames + GIFs.
    chunk > 1 (ignored when recording) runs that many steps per dispatch.
    """
    import numpy as np
    from pstl_tpu import metrics as met

    chunk = 1 if record else max(chunk, 1)
    init_carry, step = make_closed_loop_step(scenes, cfg, net, params,
                                             formulas, coeffs,
                                             with_info=record,
                                             stlp_override=stlp_override,
                                             chunk=chunk)
    import time as _time
    c = init_carry(key, t0=t0)
    bs = scenes.ego_full.shape[0]
    hist = {"ego": [np.asarray(c.ego)], "plan": [], "area": [],
            "step_s": []}
    for si in range(max(max_steps // chunk, 1)):
        _t0 = _time.time()
        if record:
            c, info = step(c)
            hist["ego"].append(np.asarray(c.ego))
            hist["plan"].append(np.asarray(info["plan_traj"]))
            M = cfg.n_randoms
            area = met.measure_extra_diversity(
                info["trajs"][:, :-1].reshape(bs, M, 3, cfg.nt * 4),
                info["scores"].reshape(bs, M, 3),
                info["valids_dense"].reshape(bs, M, 3), cfg.nt,
                info["controls"].reshape(bs, M, 3, cfg.nt * 2),
                -cfg.mul_w_max, cfg.mul_w_max, -cfg.mul_a_max,
                cfg.mul_a_max)["area"]
            hist["area"].append(float(area))
        else:
            c = step(c)
        jax.block_until_ready(c.ego)
        hist["step_s"].append(_time.time() - _t0)
        if bool(c.done.all()):
            break
    out = _carry_metrics(c)
    if record:
        out["history"] = hist
        out["area"] = (jnp.asarray(np.mean(hist["area"]))
                       if hist["area"] else jnp.asarray(0.0))
    if render_dir and record:
        from pstl_tpu import viz
        ego_hist = np.stack(hist["ego"], axis=1)         # (bs, S+1, 4)
        for i in range(min(bs, 4)):
            frames = []
            for t in range(1, ego_hist.shape[1]):
                path = f"{render_dir}/frame_s{i:02d}_t{t:03d}.png"
                viz.render_closed_loop_frame(
                    path, np.asarray(scenes.center_dense[i]),
                    np.asarray(scenes.lane_valids[i]), ego_hist[i, :t + 1],
                    np.asarray(scenes.nei_full[i, :, min(
                        t, scenes.nei_full.shape[2] - 1)]),
                    hist["plan"][t - 1][i] if t - 1 < len(hist["plan"])
                    else None,
                    ego_LW=(cfg.ego_L, cfg.ego_W),
                    drivable=np.asarray(scenes.drivable[i]),
                    drivable_origin=np.asarray(scenes.drivable_origin[i]),
                    drivable_res=float(scenes.drivable_res[i]))
                frames.append(path)
            viz.generate_gif(f"{render_dir}/episode_{i:02d}.gif", frames)
    return out
