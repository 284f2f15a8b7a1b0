"""Driving pSTL specifications over NuScenes-style scenes.

Parity targets in the reference:
- signal cache ``prep_stl_cache``            (nusc_train.py:74-93)
- maneuver formulas ``build_stl_cache``      (nusc_train.py:95-140)
- dense scoring ``compute_stl_dense``        (nusc_train.py:318-345)
- per-row selection ``get_stl_scores``       (nusc_train.py:150-151)
- STL-parameter calibration ``infer_gt_stlp``(nusc_train.py:210-251)
- flex parameter sampling ``generate_flex_pstl`` / ``get_dense_stlp``
                                             (nusc_train.py:657-722)
- batch densification ``augment_batch_data`` (nusc_train.py:724-754)
- masked mean ``mask_mean``                  (nusc_train.py:23-27)

The 6-dim pSTL parameter vector is
``stlp = (v_min, v_max, d_min, d_max, d_safe, th_max)`` indexed by the
``I_*`` constants (nusc_train.py:62-72).

Everything here is pure-functional: explicit PRNG keys, no global config;
batches are plain dicts of fixed-shape arrays, so every function can sit
inside ``jit`` / ``vmap`` / ``scan`` / ``grad``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp

from pstl_tpu.config import Config
from pstl_tpu.ops import geometry as geom
from pstl_tpu.ops import stl

Array = jax.Array

# the guidance-loss subsystem (CandMinorGuidanceLoss, its freeze/selection
# machinery, mask_mean and the stlp layout constants) lives in
# pstl_tpu/ops/guidance_loss.py; re-exported here so the public specs.* API is unchanged
from pstl_tpu.ops.guidance_loss import (  # noqa: F401
    I_DMAX, I_DMIN, I_DSAFE, I_THMAX, I_VAL, I_VMAX, I_VMIN,
    CandMinorGuidanceLoss, make_guidance_loss, mask_mean)

# high-level maneuver labels
HL_KEEP, HL_LEFT, HL_RIGHT, HL_OUTLIER = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# signal cache
# ---------------------------------------------------------------------------

def prep_signals(x: Dict[str, Array], cfg: Config,
                 with_collision: bool = False) -> Dict[str, Array]:
    """Precompute the lane-distance / neighbor-clearance signals the formulas
    consume (nusc_train.py:74-93).

    Expects in ``x``:
      ego_traj  (n, T, >=4)  rollout states (x, y, th, v)
      neighbors (n, K, T, 7) neighbor tracks (valid, x, y, th, v, L, W)
      currlane_wpts / leftlane_wpts / rightlane_wpts (n, n_segs, 3)
      stlp      (n, 1, 6) or (n, T, 6)
    Adds x2{curr,left,right}_d / _th (n, T), min_nei_d (n, T)
    [, min_centroid_d, radius_sum], and the norm_stl factors.
    """
    out = dict(x)
    pts = x["ego_traj"][..., 0:3]
    for key in ("curr", "left", "right"):
        d, th = geom.point_to_polyline(pts, x[f"{key}lane_wpts"],
                                       clip=cfg.clip_dist, with_angle=True,
                                       inline=cfg.inline)
        out[f"x2{key}_d"] = d
        out[f"x2{key}_th"] = th

    nei = x["neighbors"]
    need_full = with_collision or cfg.collision_loss is not None
    if "nei_discs" in x and not need_full and cfg.refined_nW == 1:
        # constant disc geometry hoisted by dense_signal_input: one fused
        # produce+reduce per evaluation, recompute-based VJP (no pairwise
        # tensors in HBM) — the guidance hot path
        out["min_nei_d"] = geom.min_clearance_pre(
            x["ego_traj"][..., 0:3], x["nei_discs"], cfg.ego_L, cfg.ego_W,
            cfg.refined_nL)
    else:
        res = geom.min_neighbor_distance(
            x["ego_traj"][..., 0:4], nei[..., 1:7], nei[..., I_VAL],
            ego_L=cfg.ego_L, ego_W=cfg.ego_W, num_L=cfg.refined_nL,
            num_W=cfg.refined_nW, full=need_full)
        if need_full:
            out["min_nei_d"], out["min_centroid_d"], out["radius_sum"] = res
        else:
            out["min_nei_d"] = res

    if cfg.norm_stl and "v_factor" not in x:
        stlp = x["stlp"]
        out["v_factor"] = jnp.clip(stlp[..., I_VMAX] - stlp[..., I_VMIN], 0.3)
        out["d_factor"] = jnp.clip((stlp[..., I_DMAX] - stlp[..., I_DMIN]) * 5,
                                   0.3)
        out["safe_factor"] = jnp.clip(stlp[..., I_DSAFE], 0.3)
    return out


# ---------------------------------------------------------------------------
# maneuver formulas
# ---------------------------------------------------------------------------

def build_formulas(cfg: Config) -> List[stl.ListAnd]:
    """The three maneuver specs [keep, left-change, right-change]
    (nusc_train.py:95-140).  Each is a ListAnd over Always/Eventually clauses
    on speed band, signed lane-offset band, heading alignment, and neighbor
    clearance."""
    nt = cfg.nt

    def P(i):
        return lambda x: x["stlp"][..., i]

    if cfg.norm_stl:
        vf = lambda x: x["v_factor"]
        df = lambda x: x["d_factor"]
        sf = lambda x: x["safe_factor"]
        keep_v_min = stl.Always(0, nt, stl.AP(
            lambda x: (x["ego_traj"][..., 3] - P(I_VMIN)(x)) / vf(x), "vmin"))
        keep_v_max = stl.Always(0, nt, stl.AP(
            lambda x: (-x["ego_traj"][..., 3] + P(I_VMAX)(x)) / vf(x), "vmax"))
        keep_d_min = stl.Always(0, nt, stl.AP(
            lambda x: (x["x2curr_d"] - P(I_DMIN)(x)) / df(x), "dmin"))
        keep_d_max = stl.Always(0, nt, stl.AP(
            lambda x: (-x["x2curr_d"] + P(I_DMAX)(x)) / df(x), "dmax"))

        def reach_d(side):
            return stl.Eventually(0, nt // 2, stl.Always(0, nt, stl.And(
                stl.AP(lambda x: (x[f"x2{side}_d"] - P(I_DMIN)(x)) / df(x)),
                stl.AP(lambda x: (-x[f"x2{side}_d"] + P(I_DMAX)(x)) / df(x)))))

        safe = stl.Always(0, nt, stl.AP(
            lambda x: (x["min_nei_d"] - P(I_DSAFE)(x)) / sf(x), "safe"))
    else:
        keep_v_min = stl.Always(0, nt, stl.AP(
            lambda x: x["ego_traj"][..., 3] - P(I_VMIN)(x), "vmin"))
        keep_v_max = stl.Always(0, nt, stl.AP(
            lambda x: -x["ego_traj"][..., 3] + P(I_VMAX)(x), "vmax"))
        keep_d_min = stl.Always(0, nt, stl.AP(
            lambda x: x["x2curr_d"] - P(I_DMIN)(x), "dmin"))
        keep_d_max = stl.Always(0, nt, stl.AP(
            lambda x: -x["x2curr_d"] + P(I_DMAX)(x), "dmax"))

        def reach_d(side):
            return stl.Eventually(0, nt // 2, stl.Always(0, nt, stl.And(
                stl.AP(lambda x: x[f"x2{side}_d"] - P(I_DMIN)(x)),
                stl.AP(lambda x: -x[f"x2{side}_d"] + P(I_DMAX)(x)))))

        safe = stl.Always(0, nt, stl.AP(
            lambda x: x["min_nei_d"] - P(I_DSAFE)(x), "safe"))

    # heading clauses are always normalized by th_max (nusc_train.py:132-134)
    keep_th_max = stl.Always(0, nt, stl.AP(
        lambda x: (P(I_THMAX)(x) - x["x2curr_th"]) / P(I_THMAX)(x), "thmax"))

    def reach_th(side):
        return stl.Eventually(0, nt // 2, stl.Always(0, nt, stl.AP(
            lambda x: (P(I_THMAX)(x) - x[f"x2{side}_th"]) / P(I_THMAX)(x))))

    stl_curr = stl.ListAnd([keep_v_min, keep_v_max, keep_d_min, keep_d_max,
                            keep_th_max, safe])
    stl_left = stl.ListAnd([keep_v_min, keep_v_max, reach_d("left"),
                            reach_th("left"), safe])
    stl_right = stl.ListAnd([keep_v_min, keep_v_max, reach_d("right"),
                             reach_th("right"), safe])
    return [stl_curr, stl_left, stl_right]


class ClauseBank:
    """Fused evaluator of the three maneuver formulas' robustness at t = 0.

    Numerically identical to evaluating ``build_formulas`` and taking
    ``trace[:, 0]`` (verified in tests), but each of the 10 unique clauses is
    computed once (the formulas share vmin/vmax/safe), and all Always(0, nt)
    clauses collapse to a single soft-min over the horizon / one reverse
    ``logcumsumexp`` — O(T) work per clause instead of the O(T^2) masked
    window reduce, and no duplicate evaluation across formulas.  This is the
    hot path of the guidance inner loop.
    """

    def __init__(self, cfg: Config):
        self.cfg = cfg
        # robustness accumulation dtype (cfg.robustness_dtype): fp32 default;
        # bf16 opt-in for scene-local coordinates
        self.dtype = jnp.bfloat16 if cfg.robustness_dtype == "bfloat16" \
            else jnp.float32

    def _alw0(self, g: Array, tau: float, hard: bool) -> Array:
        """Always(0, nt) robustness at t=0 = soft-min over the horizon."""
        return stl.soft_min(g, tau, axis=-1, hard=hard, dtype=self.dtype)

    def _ev_alw0(self, g: Array, tau: float, hard: bool) -> Array:
        """Eventually(0, nt//2, Always(0, nt, g)) at t=0: suffix soft-mins
        via reverse cumulative scan, soft-max over the first nt//2."""
        nt2 = self.cfg.nt // 2
        g = g.astype(self.dtype)
        if hard:
            suffix = stl.cumulative(jnp.minimum, g, axis=-1, reverse=True)
            return jnp.max(suffix[..., :nt2], axis=-1)
        suffix = -stl.logcumsumexp(-g * tau, axis=-1, reverse=True) / tau
        return stl.soft_max(suffix[..., :nt2], tau, axis=-1,
                            dtype=self.dtype)

    def clause_breakdown(self, x: Dict[str, Array], tau: float,
                         hard: bool = False) -> Dict[str, Array]:
        """Per-clause robustness at t=0 (the ListAnd ``full=True``
        diagnostic, stl_d_lib.py:101-112) keyed by clause name."""
        vals = self._clauses(x, tau, hard)
        names = ["alw_vmin", "alw_vmax", "alw_dmin", "alw_dmax", "alw_th",
                 "alw_safe", "reach_left_d", "reach_left_th",
                 "reach_right_d", "reach_right_th"]
        return dict(zip(names, vals))

    def _clauses(self, x, tau, hard):
        cfg = self.cfg
        v = x["ego_traj"][..., 3]
        stlp = x["stlp"]
        P = lambda i: stlp[..., i]
        if cfg.norm_stl:
            vf, df, sf = x["v_factor"], x["d_factor"], x["safe_factor"]
        else:
            vf = df = sf = 1.0
        pair = lambda a, b: stl.soft_min(jnp.stack([a, b], -1), tau,
                                         axis=-1, hard=hard,
                                         dtype=self.dtype)
        out = [
            self._alw0((v - P(I_VMIN)) / vf, tau, hard),
            self._alw0((-v + P(I_VMAX)) / vf, tau, hard),
            self._alw0((x["x2curr_d"] - P(I_DMIN)) / df, tau, hard),
            self._alw0((-x["x2curr_d"] + P(I_DMAX)) / df, tau, hard),
            self._alw0((P(I_THMAX) - x["x2curr_th"]) / P(I_THMAX), tau,
                       hard),
            self._alw0((x["min_nei_d"] - P(I_DSAFE)) / sf, tau, hard),
        ]
        for side in ("left", "right"):
            d = x[f"x2{side}_d"]
            g_d = pair((d - P(I_DMIN)) / df, (-d + P(I_DMAX)) / df)
            out.append(self._ev_alw0(g_d, tau, hard))
            g_th = (P(I_THMAX) - x[f"x2{side}_th"]) / P(I_THMAX)
            out.append(self._ev_alw0(g_th, tau, hard))
        return out

    def scores(self, x: Dict[str, Array], tau: float,
               hard: bool = False) -> List[Array]:
        (alw_vmin, alw_vmax, alw_dmin, alw_dmax, alw_th, alw_safe,
         left_d, left_th, right_d, right_th) = self._clauses(x, tau, hard)

        def conj(parts):
            return stl.soft_min(jnp.stack(parts, axis=-1), tau, axis=-1,
                                hard=hard, dtype=self.dtype)

        s_curr = conj([alw_vmin, alw_vmax, alw_dmin, alw_dmax, alw_th,
                       alw_safe])
        s_left = conj([alw_vmin, alw_vmax, left_d, left_th, alw_safe])
        s_right = conj([alw_vmin, alw_vmax, right_d, right_th, alw_safe])
        return [s_curr, s_left, s_right]


def build_scorer(cfg: Config) -> ClauseBank:
    """The production robustness scorer (fused clause bank)."""
    return ClauseBank(cfg)


class TiledScorer:
    """Fast robustness scorer for the canonical dense layout
    (bs x n_randoms x 3 maneuvers), numerically identical to evaluating the
    ClauseBank and selecting per-row (verified in tests/test_specs.py).

    Two structural savings over ClauseBank on pre-tiled signals, both exact:

    1. **Per-row formula selection before compute.**  A row whose maneuver is
       j only ever reads lane j's distance/heading signals (keep -> curr,
       left-change -> left, right-change -> right; nusc_train.py:95-140), so
       the lane geometry runs once per row instead of three times, and each
       row evaluates only its own formula's clauses (~5.3 instead of 10).
    2. **Per-scene constants stay per-scene.**  All R = n_randoms*3 candidate
       rows of a scene share its neighbors/lanes; scoring in (bs, R, ...)
       layout against (bs, K, T, nL) discs and (bs, S, 3) lanes removes the
       ~R x constant streaming that dominated the guidance profile.

    Built ONCE per planning/eval/train call from the per-scene batch;
    ``__call__(trajs)`` maps (N, T, >=4) rollout states (t = 0..T-1) to
    per-row robustness (N,).  The outlier class never appears in this layout
    (highlevel_dense tiles [0, 1, 2]); use ``compute_scores`` for batches
    carrying label-3 rows.
    """

    def __init__(self, batch: Dict[str, Array], stlp_dense: Array,
                 cfg: Config, n_randoms: Optional[int] = None):
        self.cfg = cfg
        M = n_randoms if n_randoms is not None else cfg.n_randoms
        self.R = M * 3
        nei = batch["neighbor_trajs_aug"]                   # (bs, K, T, 7)
        self.bs = nei.shape[0]
        self.discs = geom.precompute_neighbor_discs(
            nei[..., 1:7], nei[..., I_VAL], cfg.refined_nL)
        self.lanes = [batch["currlane_wpts"], batch["leftlane_wpts"],
                      batch["rightlane_wpts"]]              # 3 x (bs, S, 3)
        self.stlp = stlp_dense.reshape(self.bs, M, 3, 6)
        self.dtype = jnp.bfloat16 if cfg.robustness_dtype == "bfloat16" \
            else jnp.float32
        if cfg.norm_stl:
            s = self.stlp
            self.vf = jnp.clip(s[..., I_VMAX] - s[..., I_VMIN], 0.3)
            self.df = jnp.clip((s[..., I_DMAX] - s[..., I_DMIN]) * 5, 0.3)
            self.sf = jnp.clip(s[..., I_DSAFE], 0.3)
        else:
            self.vf = self.df = self.sf = 1.0

    def _alw(self, g, tau, hard):
        return stl.soft_min(g, tau, axis=-1, hard=hard, dtype=self.dtype)

    def _ev_alw(self, g, tau, hard):
        nt2 = self.cfg.nt // 2
        g = g.astype(self.dtype)
        if hard:
            suffix = stl.cumulative(jnp.minimum, g, axis=-1, reverse=True)
            return jnp.max(suffix[..., :nt2], axis=-1)
        suffix = -stl.logcumsumexp(-g * tau, axis=-1, reverse=True) / tau
        return stl.soft_max(suffix[..., :nt2], tau, axis=-1,
                            dtype=self.dtype)

    def __call__(self, trajs: Array, tau: Optional[float] = None,
                 hard: bool = False) -> Array:
        cfg = self.cfg
        if tau is None:
            tau = cfg.smoothing_factor
        bs, R, M = self.bs, self.R, self.R // 3
        ego = trajs.reshape(bs, M, 3, cfg.nt, trajs.shape[-1])
        stlp = self.stlp                                      # (bs, M, 3, 6)
        P = lambda i: stlp[..., i:i + 1]                      # (bs, M, 3, 1)

        # clauses shared by every formula: speed band + neighbor clearance
        v = ego[..., 3]                                       # (bs, M, 3, T)
        alw_vmin = self._alw((v - P(I_VMIN)) / _u(self.vf), tau, hard)
        alw_vmax = self._alw((-v + P(I_VMAX)) / _u(self.vf), tau, hard)
        mnd = geom.min_clearance_tiled(
            ego[..., :3].reshape(bs, R, cfg.nt, 3), self.discs, cfg.ego_L,
            cfg.ego_W, cfg.refined_nL).reshape(bs, M, 3, cfg.nt)
        alw_safe = self._alw((mnd - P(I_DSAFE)) / _u(self.sf), tau, hard)

        # per-maneuver lane clauses, ONE lane per row — all three maneuvers
        # in a single batched polyline call ((bs, 3, M, T) leading dims) so
        # each kernel is 3x larger instead of 3x more numerous
        ego_j = jnp.swapaxes(ego[..., :3], 1, 2)        # (bs, 3, M, T, 3)
        lanes_j = jnp.stack(self.lanes, axis=1)[:, :, None]  # (bs, 3, 1, S, 3)
        d_all, th_all = geom.point_to_polyline(
            ego_j, lanes_j, clip=cfg.clip_dist, with_angle=True,
            inline=cfg.inline)                           # (bs, 3, M, T)
        Pj = lambda i: jnp.swapaxes(stlp[..., i:i + 1], 1, 2)  # (bs,3,M,1)
        dfj = jnp.swapaxes(self.df, 1, 2)[..., None] \
            if hasattr(self.df, "ndim") else self.df     # (bs, 3, M, 1)

        g_dmin = (d_all - Pj(I_DMIN)) / dfj
        g_dmax = (-d_all + Pj(I_DMAX)) / dfj
        g_th = (Pj(I_THMAX) - th_all) / Pj(I_THMAX)

        # keep (j=0): Always on dmin/dmax/th over the curr lane
        alw_keep = self._alw(jnp.stack([g_dmin[:, 0], g_dmax[:, 0],
                                        g_th[:, 0]], axis=-2), tau, hard)
        s_keep = stl.soft_min(
            jnp.stack([alw_vmin[:, :, 0], alw_vmax[:, :, 0],
                       alw_keep[:, :, 0], alw_keep[:, :, 1],
                       alw_keep[:, :, 2],
                       alw_safe[:, :, 0]], -1),
            tau, axis=-1, hard=hard, dtype=self.dtype)

        # change (j=1,2): Eventually-Always of the d-band pair and the
        # heading clause over the side lanes — batched over j
        g_band = stl.soft_min(jnp.stack([g_dmin[:, 1:], g_dmax[:, 1:]], -1),
                              tau, axis=-1, hard=hard, dtype=self.dtype)
        ev_d = self._ev_alw(g_band, tau, hard)           # (bs, 2, M)
        ev_th = self._ev_alw(g_th[:, 1:], tau, hard)
        vmin_j = jnp.moveaxis(alw_vmin[:, :, 1:], -1, 1)  # (bs, 2, M)
        vmax_j = jnp.moveaxis(alw_vmax[:, :, 1:], -1, 1)
        safe_j = jnp.moveaxis(alw_safe[:, :, 1:], -1, 1)
        s_change = stl.soft_min(
            jnp.stack([vmin_j, vmax_j, ev_d, ev_th, safe_j], -1),
            tau, axis=-1, hard=hard, dtype=self.dtype)    # (bs, 2, M)

        scores = jnp.stack([s_keep, s_change[:, 0], s_change[:, 1]],
                           axis=-1)                       # (bs, M, 3)
        return scores.reshape(bs * R)                     # (N,)


# CandMinorGuidanceLoss + make_guidance_loss moved to
# pstl_tpu/ops/guidance_loss.py; re-exported above so
# specs.CandMinorGuidanceLoss / specs.make_guidance_loss keep working.


def make_score_rows(batch: Dict[str, Array], dense: Dict[str, Array],
                    cfg: Config, formulas=None,
                    n_randoms: Optional[int] = None):
    """Per-row robustness function for the canonical dense layout.

    Returns ``score_rows(ego_states (N, T, >=4)) -> (N,)``.  TiledScorer
    fast path by default; ``cfg.tiled_scorer=False`` falls back to the
    ClauseBank over pre-tiled signals (identical numerics, see
    tests/test_specs.py::TestTiledScorer).
    """
    if cfg.tiled_scorer:
        return TiledScorer(batch, dense["stlp_dense"], cfg, n_randoms)
    if formulas is None:
        formulas = build_scorer(cfg)
    signal_base = dense_signal_input(dense, cfg=cfg)
    hl = dense["highlevel_dense"]
    valid = dense["valids_dense"].reshape(-1)

    def score_rows(ego):
        sig = dict(signal_base)
        sig["ego_traj"] = ego
        _, s, _ = compute_scores(sig, formulas, hl, valid, cfg)
        return s

    return score_rows


def _u(f):
    """Unsqueeze a (bs, M, 3) norm factor to broadcast over T (scalars pass
    through)."""
    return f[..., None] if hasattr(f, "ndim") and f.ndim == 3 else f


def select_scores(scores_list: Sequence[Array], stl_idx: Array) -> Array:
    """Per-row formula selection incl. outlier class 3 -> +1
    (nusc_train.py:150-151, 322)."""
    out = jnp.zeros_like(scores_list[0])
    for i, s in enumerate(scores_list):
        out = out + s * (stl_idx == i)
    return out


def compute_scores(signals: Dict[str, Array], formulas, stl_idx: Array,
                   mask: Array, cfg: Config, tau: Optional[float] = None,
                   hard: bool = False, scene: bool = False,
                   tj_scores: Optional[Array] = None,
                   n_group: Optional[int] = None):
    """Evaluate all three formulas, select per-row, masked accuracy
    (nusc_train.py:318-345).

    signals: prepared (or raw, prep applied here if lane distances missing).
    stl_idx: (n,) or (n,1) high-level index per dense row.
    mask:    (n,) validity.
    Returns (scores_list, scores (n,), acc [, scene_acc]).
    """
    if tau is None:
        tau = cfg.smoothing_factor
    if "x2curr_d" not in signals:
        signals = prep_signals(signals, cfg)
    if isinstance(formulas, ClauseBank):
        scores_list = formulas.scores(signals, tau, hard)
    else:
        scores_list = [f(signals, tau, hard)[:, 0] for f in formulas]
    # outlier class: constant +1 (nusc_train.py:322)
    scores_list = scores_list + [jax.lax.stop_gradient(scores_list[-1]) * 0.0
                                 + 1.0]
    idx = stl_idx.reshape(-1)
    scores = select_scores(scores_list, idx)
    mask_flat = mask.reshape(-1)
    if cfg.oracle_filter and tj_scores is not None:
        tj = tj_scores.reshape(-1, cfg.n_randoms, 3)
        tj = jnp.max(tj, axis=1, keepdims=True)
        tj_val = jnp.broadcast_to((tj > 0).astype(scores.dtype),
                                  (tj.shape[0], cfg.n_randoms, 3)).reshape(-1)
        acc = mask_mean((scores > 0).astype(scores.dtype), mask_flat * tj_val)
    else:
        acc = mask_mean((scores > 0).astype(scores.dtype), mask_flat)
    if scene:
        g = n_group or cfg.n_randoms
        sc = scores.reshape(-1, g, 3)
        mc = mask.reshape(-1, g, 3)
        scene_acc = mask_mean((jnp.max(sc, axis=1) > 0).astype(scores.dtype),
                              mc[:, 0, :])
        return scores_list, scores, acc, scene_acc
    return scores_list, scores, acc


# ---------------------------------------------------------------------------
# STL parameter calibration
# ---------------------------------------------------------------------------

def calibrate_stlp(batch: Dict[str, Array], gt_trajs: Array,
                   cfg: Config) -> Array:
    """Infer per-scene ground-truth pSTL parameters from the GT trajectory
    (``infer_gt_stlp``, nusc_train.py:210-251).

    batch needs: neighbor_trajs_aug (n, K, T, 7), {curr,left,right}lane_wpts,
    gt_high_level (n, 1).  gt_trajs: (n, T, >=4).
    Returns stlp (n, 6).
    """
    DEFAULT_DMIN, DEFAULT_DMAX, DEFAULT_TH = -5.0, 5.0, 0.5
    nt = cfg.nt
    gt_vmin = jnp.min(gt_trajs[..., 3], axis=-1)
    gt_vmax = jnp.max(gt_trajs[..., 3], axis=-1)

    nei = batch["neighbor_trajs_aug"]
    nei_dist = geom.min_neighbor_distance(
        gt_trajs[..., 0:4], nei[..., 1:7], nei[..., 0],
        ego_L=cfg.ego_L, ego_W=cfg.ego_W, num_L=cfg.refined_nL,
        num_W=cfg.refined_nW)
    gt_d_safe = jnp.min(nei_dist, axis=-1)

    dists, angles = {}, {}
    for key in ("curr", "left", "right"):
        d, th = geom.point_to_polyline(gt_trajs[..., 0:3],
                                       batch[f"{key}lane_wpts"],
                                       clip=cfg.clip_dist, inline=cfg.inline,
                                       with_angle=True)
        dists[key], angles[key] = d, th

    hl = batch["gt_high_level"][:, 0]
    half = nt // 2 - 1
    dmin = {"curr": jnp.min(dists["curr"], -1),
            "left": jnp.min(dists["left"][:, half:], -1),
            "right": jnp.min(dists["right"][:, half:], -1)}
    dmax = {"curr": jnp.max(dists["curr"], -1),
            "left": jnp.max(dists["left"][:, half:], -1),
            "right": jnp.max(dists["right"][:, half:], -1)}
    thm = {"curr": jnp.max(angles["curr"], -1),
           "left": jnp.max(angles["left"][:, half:], -1),
           "right": jnp.max(angles["right"][:, half:], -1)}

    def pick(d, default):
        return (d["curr"] * (hl == 0) + d["left"] * (hl == 1)
                + d["right"] * (hl == 2) + default * (hl == 3))

    gt_dmin = pick(dmin, DEFAULT_DMIN)
    gt_dmax = pick(dmax, DEFAULT_DMAX)
    gt_th_max = pick(thm, DEFAULT_TH)

    if cfg.flex:
        return jnp.stack([jnp.clip(gt_vmin - 1, -0.3), gt_vmax + 1,
                          gt_dmin - 0.3, gt_dmax + 0.3,
                          jnp.clip(gt_d_safe - 0.1, 0), gt_th_max + 0.1],
                         axis=-1)
    return jnp.stack([gt_vmin - 0.1, gt_vmax + 0.1, gt_dmin - 0.1,
                      gt_dmax + 0.1, gt_d_safe - 0.1, gt_th_max + 0.05],
                     axis=-1)


# ---------------------------------------------------------------------------
# flex parameter sampling + dense batching
# ---------------------------------------------------------------------------

def _uniform(key, lo, hi, shape):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


def generate_flex_pstl(key: Array, stlp_mid: Array, the_high_level: int,
                       n_randoms: int) -> Array:
    """Randomized relaxation of calibrated params for off-label maneuvers
    (nusc_train.py:675-695).  stlp_mid: (bs, n_randoms, 6)."""
    bs = stlp_mid.shape[0]
    ks = jax.random.split(key, 6)

    def rep(v):
        return jnp.repeat(v, n_randoms, axis=1)

    vd0 = rep(_uniform(ks[0], 1.3, 3.0, (bs, 1)))
    vd1 = rep(_uniform(ks[1], 1.3, 3.0, (bs, 1)))
    new_vmin = jnp.clip(stlp_mid[:, :, 0] - vd0, -0.3)
    new_vmax = jnp.clip(stlp_mid[:, :, 1] + vd1, -0.3)
    if the_high_level == 0:
        lamb0 = rep(_uniform(ks[2], 0.0, 1.0, (bs, 1)))
        lamb1 = rep(_uniform(ks[3], 0.0, 1.0, (bs, 1)))
        new_dmin = (lamb0 * stlp_mid[:, :, 2]
                    + (1 - lamb0) * (stlp_mid[:, :, 2] - 2.5))
        new_dmax = (lamb1 * stlp_mid[:, :, 2]
                    + (1 - lamb1) * (stlp_mid[:, :, 2] + 2.5))
    else:
        new_dmin = rep(_uniform(ks[2], -2.5, -0.5, (bs, 1)))
        new_dmax = rep(_uniform(ks[3], 0.5, 2.5, (bs, 1)))
    lamb2 = rep(_uniform(ks[4], 0.0, 1.0, (bs, 1)))
    new_dsafe = jnp.clip(lamb2 * stlp_mid[:, :, 4]
                         + (1 - lamb2) * (stlp_mid[:, :, 4] - 1.5), 0)
    lamb3 = rep(_uniform(ks[5], 0.0, 1.0, (bs, 1)))
    new_thmax = (lamb3 * stlp_mid[:, :, 5]
                 + (1 - lamb3) * (stlp_mid[:, :, 5] + 0.3))
    return jnp.stack([new_vmin, new_vmax, new_dmin, new_dmax, new_dsafe,
                      new_thmax], axis=-1)


def get_dense_stlp(key: Array, gt_high_level: Array, the_stlp: Array,
                   cfg: Config, n_randoms: Optional[int] = None) -> Array:
    """Dense (bs*n_randoms*3, 1, 6) pSTL parameter tensor: ground-truth
    params on the labeled maneuver, flex/default params elsewhere
    (nusc_train.py:657-722)."""
    if n_randoms is None:
        n_randoms = cfg.n_randoms
    bs = the_stlp.shape[0]
    hl = gt_high_level.reshape(bs, 1, 1)
    stlp_mid = jnp.repeat(the_stlp[:, None, :], n_randoms, axis=1)

    if cfg.flex:
        k0, k1, k2 = jax.random.split(key, 3)
        d0 = generate_flex_pstl(k0, stlp_mid, 0, n_randoms)
        d1 = generate_flex_pstl(k1, stlp_mid, 1, n_randoms)
        d2 = generate_flex_pstl(k2, stlp_mid, 2, n_randoms)
        hlf = hl.astype(stlp_mid.dtype)
        in0 = (hlf * (3 - hlf) == 0).astype(stlp_mid.dtype)  # keep or outlier
        in1 = (hl == 1).astype(stlp_mid.dtype)
        in2 = (hl == 2).astype(stlp_mid.dtype)
        stlp_mul = jnp.stack([
            in0 * stlp_mid + (1 - in0) * d0,
            in1 * stlp_mid + (1 - in1) * d1,
            in2 * stlp_mid + (1 - in2) * d2,
        ], axis=-2)
    else:
        default = jnp.asarray([0.0, 20.0, -2.5, 2.5, 0.1, 0.5],
                              dtype=stlp_mid.dtype)
        default = jnp.broadcast_to(default, (bs, n_randoms, 6))
        ins = [(hl == i).astype(stlp_mid.dtype) for i in range(3)]
        stlp_mul = jnp.stack([m * stlp_mid + (1 - m) * default for m in ins],
                             axis=-2)
    return stlp_mul.reshape(bs * n_randoms * 3, 1, 6)


def dup(x: Array, m: int) -> Array:
    """(N, ...) -> (N*m, ...) tiling along a new candidate axis
    (nusc_train.py:20-21)."""
    return jnp.repeat(x[:, None], m, axis=1).reshape((-1,) + x.shape[1:])


def densify_batch(batch: Dict[str, Array], the_stlp: Array, cfg: Config,
                  key: Optional[Array] = None,
                  n_randoms: Optional[int] = None,
                  stlp_dense: Optional[Array] = None) -> Dict[str, Array]:
    """Expand a per-scene batch to the (bs * n_randoms * 3) dense layout
    (``augment_batch_data``, nusc_train.py:724-754)."""
    if n_randoms is None:
        n_randoms = cfg.n_randoms
    m = n_randoms * 3
    bs = batch["currlane_wpts"].shape[0]
    out = dict(batch)
    out["neighbors_dense"] = dup(batch["neighbor_trajs_aug"], m)
    for k in ("currlane_wpts", "leftlane_wpts", "rightlane_wpts"):
        out[f"{k}_dense"] = dup(batch[k], m)
    out["stlp"] = the_stlp[:, None, :]
    if stlp_dense is not None:
        out["stlp_dense"] = stlp_dense
    elif cfg.load_stlp and "pre_stlp" in batch:
        out["stlp_dense"] = batch["pre_stlp"].reshape(bs * m, 1, 6)
    else:
        assert key is not None, "densify_batch needs a PRNG key for flex stlp"
        out["stlp_dense"] = get_dense_stlp(key, batch["gt_high_level"],
                                           the_stlp, cfg, n_randoms)
    valids = jnp.concatenate([batch["curr_id"], batch["left_id"],
                              batch["right_id"]], axis=-1)       # (bs, 3)
    out["valids_dense"] = dup(valids, n_randoms).reshape(bs * n_randoms, 3)
    out["highlevel_dense"] = jnp.tile(
        jnp.asarray([0.0, 1.0, 2.0]).reshape(1, 3, 1),
        (bs * n_randoms, 1, 1)).reshape(bs * m, 1)
    return out


def dense_signal_input(batch: Dict[str, Array],
                       dense_trajs: Optional[Array] = None,
                       repeat_n: Optional[int] = None,
                       detach: bool = False,
                       cfg: Optional[Config] = None) -> Dict[str, Array]:
    """Assemble the signal dict consumed by the formulas from a densified
    batch (``pre_prepare_stl_cache``, nusc_train.py:258-285).

    With ``cfg`` given, also hoists everything that is CONSTANT across
    repeated evaluations on the same dense batch — neighbor anchor-disc
    geometry and the norm_stl factors — so the guidance inner loop and
    multi-candidate scoring do not recompute them per call.
    """
    out = {
        "neighbors": batch["neighbors_dense"],
        "currlane_wpts": batch["currlane_wpts_dense"],
        "leftlane_wpts": batch["leftlane_wpts_dense"],
        "rightlane_wpts": batch["rightlane_wpts_dense"],
        "stlp": batch["stlp_dense"],
        "dense_valids": batch["valids_dense"],
        "gt_high_level": batch["gt_high_level"],
    }
    if cfg is not None:
        if cfg.refined_nW == 1 and cfg.collision_loss is None:
            nei = out["neighbors"]
            out["nei_discs"] = geom.precompute_neighbor_discs(
                nei[..., 1:7], nei[..., I_VAL], cfg.refined_nL)
        if cfg.norm_stl:
            stlp = out["stlp"]
            out["v_factor"] = jnp.clip(stlp[..., I_VMAX] - stlp[..., I_VMIN],
                                       0.3)
            out["d_factor"] = jnp.clip(
                (stlp[..., I_DMAX] - stlp[..., I_DMIN]) * 5, 0.3)
            out["safe_factor"] = jnp.clip(stlp[..., I_DSAFE], 0.3)
    if detach:
        out = {k: jax.lax.stop_gradient(v) for k, v in out.items()}
    if repeat_n is not None:
        out = jax.tree_util.tree_map(
            lambda v: jnp.tile(v, (repeat_n,) + (1,) * (v.ndim - 1)), out)
    if dense_trajs is not None:
        out["ego_traj"] = dense_trajs
    return out
