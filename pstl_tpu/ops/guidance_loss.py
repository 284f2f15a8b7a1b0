"""Candidate-minor fused STL-guidance loss.

Split out of ``specs.py`` (it had grown into a god module, VERDICT r4):
this is the guidance-loss subsystem — the freeze/selection machinery and
the fused hinge loss that ``diffusion._guidance_step`` consumes.
``specs`` re-exports every public name here, so all call sites (``specs.CandMinorGuidanceLoss``,
``specs.make_guidance_loss``, ``specs.mask_mean``) are unchanged.

Reference parity anchors: the guidance inner loop (nusc_train.py:557-627),
masked mean (nusc_train.py:23-27), stlp layout (nusc_train.py:62-72).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from pstl_tpu.config import Config
from pstl_tpu.ops import geometry as geom
from pstl_tpu.ops import stl

Array = jax.Array

# stlp component indices (nusc_train.py:62-72).  Defined here (the leaf
# module) and re-exported by ``specs`` so the import graph stays acyclic.
I_VMIN, I_VMAX, I_DMIN, I_DMAX, I_DSAFE, I_THMAX = 0, 1, 2, 3, 4, 5
# neighbor row layout: (valid, x, y, th, v, L, W)
I_VAL = 0


def mask_mean(x: Array, mask: Array, axis=None) -> Array:
    """mean(x * mask) / clip(mean(mask), 1e-2) — nusc_train.py:23-27."""
    return (jnp.mean(x * mask, axis=axis)
            / jnp.clip(jnp.mean(mask, axis=axis), 1e-2))


class CandMinorGuidanceLoss:
    """Fused guidance hinge loss in candidate-minor layout.

    Same math as rollout -> TiledScorer -> mask_mean(relu(thres - scores))
    (loss values agree to fp tolerance; gradients differ only on
    nearest-segment argmin ties), but every hot tensor keeps the large
    candidate axis R = 3*M minor (lanes pd (bs,T,S,R), clearance pairs
    (bs,K,T,nLe,nLn,R)), the rollout/scorer/reduction chain is one
    function XLA fuses end-to-end, and with ``cfg.guidance_remat`` the
    backward pass recomputes instead of storing residuals.

    Candidate index is j-major (r = j*M + m): lane selection per row
    becomes static slicing at M boundaries.  ``__call__(mu, thres)`` takes
    the sampler's m-major mu (N, nt*2) and transposes at entry (245 KB,
    negligible).
    """

    def __init__(self, batch: Dict[str, Array], stlp_dense: Array,
                 states: Array, valid: Array, cfg: Config,
                 n_randoms: Optional[int] = None):
        self.cfg = cfg
        M = n_randoms if n_randoms is not None else cfg.n_randoms
        self.M = M
        R = M * 3
        self.R = R
        bs = batch["currlane_wpts"].shape[0]
        self.bs = bs
        # Scene-local recentering: every geometric quantity in this class
        # (lane distance, heading deviation, disc clearance) is a function
        # of coordinate DIFFERENCES, so shifting each scene's frame to the
        # ego start pose is exact.  It keeps |coords| ~ O(maneuver length)
        # instead of O(map), which is what makes cfg.geometry_dtype=
        # bfloat16 usable for the selection fields and frozen payloads
        # (bf16's 8-bit mantissa on raw NuScenes-scale coords would cost
        # ~4 m; recentered it costs ~0.1 m only on stored payloads).
        cx = states[:, 0][:, None, None]                      # (bs,1,1)
        cy = states[:, 1][:, None, None]
        lanes = jnp.stack([batch["currlane_wpts"], batch["leftlane_wpts"],
                           batch["rightlane_wpts"]], axis=1)  # (bs, 3, S, 3)
        lanes = lanes.at[..., 0].add(-states[:, 0][:, None, None])
        lanes = lanes.at[..., 1].add(-states[:, 1][:, None, None])
        lane_r = jnp.moveaxis(jnp.repeat(lanes, M, axis=1), 1, -1)
        self.lxr = lane_r[:, :, 0]                            # (bs, S, R)
        self.lyr = lane_r[:, :, 1]
        self.lthr = lane_r[:, :, 2]

        nei = batch["neighbor_trajs_aug"]                     # (bs, K, T, 7)
        self.nvalid = nei[..., 0]
        nx0, ny0, nth = (nei[..., 1] - cx, nei[..., 2] - cy,
                         nei[..., 3])
        Ln, Wn = nei[..., 5], nei[..., 6]
        self.rn = Wn / 2.0
        alpha = jnp.linspace(0.0, 1.0, cfg.refined_nL)
        axn = ((-Ln / 2 + self.rn)[..., None] * (1 - alpha)
               + (Ln / 2 - self.rn)[..., None] * alpha)       # (bs,K,T,nLn)
        self.nx = nx0[..., None] + axn * jnp.cos(nth)[..., None]
        self.ny = ny0[..., None] + axn * jnp.sin(nth)[..., None]
        self.re = cfg.ego_W / 2.0
        self.axe = jnp.linspace(-cfg.ego_L / 2 + self.re,
                                cfg.ego_L / 2 - self.re, cfg.refined_nL)

        stlp = stlp_dense.reshape(bs, M, 3, 6)
        self.stlp_r = jnp.transpose(stlp, (0, 3, 2, 1)).reshape(bs, 6, R)
        if cfg.norm_stl:
            s = self.stlp_r
            self.vf = jnp.clip(s[:, I_VMAX] - s[:, I_VMIN], 0.3)[:, None]
            self.df = jnp.clip((s[:, I_DMAX] - s[:, I_DMIN]) * 5,
                               0.3)[:, None]
            self.sf = jnp.clip(s[:, I_DSAFE], 0.3)[:, None]
        else:
            self.vf = self.df = self.sf = 1.0
        self.valid_r = valid.reshape(bs, M, 3).transpose(0, 2, 1
                                                         ).reshape(bs, R)
        # recentered frame: the rollout starts at the origin
        self.x0 = jnp.zeros_like(cx)
        self.y0 = jnp.zeros_like(cy)
        self.th0 = states[:, 2][:, None, None]
        self.v0 = states[:, 3][:, None, None]
        self.dtype = jnp.bfloat16 if cfg.robustness_dtype == "bfloat16" \
            else jnp.float32
        # geometry dtype: the (bs,T,S,R) / (bs,K,T,nLe,nLn,R) SELECTION
        # fields and the frozen per-(t,row) payloads — bandwidth, not
        # arithmetic (the Adam-iteration math stays fp32 either way)
        self.gdtype = jnp.bfloat16 if cfg.geometry_dtype == "bfloat16" \
            else jnp.float32
        self.lxr_g = self.lxr.astype(self.gdtype)
        self.lyr_g = self.lyr.astype(self.gdtype)
        # the 5 lane endpoint payloads, gathered together by
        # _lane_select; stored in geometry dtype
        self.lane_payload_g = jnp.stack(
            [self.lxr[:, :-1], self.lyr[:, :-1], self.lthr[:, :-1],
             self.lxr[:, 1:], self.lyr[:, 1:]],
            axis=1).astype(self.gdtype)                       # (bs,5,S-1,R)
        self.nx_g = self.nx.astype(self.gdtype)
        self.ny_g = self.ny.astype(self.gdtype)

    def _alw(self, g, tau, axis=1):
        g = g.astype(self.dtype)
        return -jax.scipy.special.logsumexp(-g * tau, axis=axis) / tau

    def _ev_alw(self, g, tau):
        nt2 = self.cfg.nt // 2
        g = g.astype(self.dtype)
        suffix = -stl.logcumsumexp(-g * tau, axis=1, reverse=True) / tau
        return jax.scipy.special.logsumexp(suffix[:, :nt2] * tau,
                                           axis=1) / tau

    def _rollout(self, muT: Array):
        """(bs,T,2,R) normalized controls -> ego states, candidate-minor."""
        cfg = self.cfg
        bs, R = self.bs, self.R
        w = muT[:, :, 0, :] * cfg.mul_w_max
        a = muT[:, :, 1, :] * cfg.mul_a_max
        th_in = self.th0 + cfg.dt * jnp.cumsum(w, axis=1)
        v_in = self.v0 + cfg.dt * jnp.cumsum(a, axis=1)
        th_s = jnp.concatenate(
            [jnp.broadcast_to(self.th0, (bs, 1, R)), th_in[:, :-1]], axis=1)
        v_s = jnp.concatenate(
            [jnp.broadcast_to(self.v0, (bs, 1, R)), v_in[:, :-1]], axis=1)
        cth, sth = jnp.cos(th_s), jnp.sin(th_s)
        zer = jnp.zeros((bs, 1, R))
        x_s = self.x0 + jnp.concatenate(
            [zer, jnp.cumsum(v_s * cth * cfg.dt, axis=1)[:, :-1]], axis=1)
        y_s = self.y0 + jnp.concatenate(
            [zer, jnp.cumsum(v_s * sth * cfg.dt, axis=1)[:, :-1]], axis=1)
        return x_s, y_s, th_s, v_s, cth, sth

    def _lane_argmin(self, x_s: Array, y_s: Array) -> Array:
        """Nearest-segment search, the (bs,T,S,R) hot part of the lane
        terms.  Returns the segment index per (t, row), (bs,T,R)."""
        gd = self.gdtype
        xg, yg = x_s.astype(gd), y_s.astype(gd)
        pdx = xg[:, :, None, :] - self.lxr_g[:, None]         # (bs,T,S,R)
        pdy = yg[:, :, None, :] - self.lyr_g[:, None]
        pd = jnp.sqrt(pdx * pdx + pdy * pdy)
        return jnp.argmin(pd[:, :, :-1] + pd[:, :, 1:], axis=2)

    def _lane_gather(self, mi: Array):
        """Per-(t,row) segment constants of the segments ``mi`` picks."""
        S = self.lxr.shape[1]
        # all 5 endpoint payloads in ONE gather along the segment axis
        x2, y2, th2, x3, y3 = jnp.moveaxis(jnp.take_along_axis(
            self.lane_payload_g[:, :, None], mi[:, None, :, None],
            axis=3, mode="promise_in_bounds")[:, :, :, 0], 1, 0)
        return dict(x2=x2, y2=y2, th2=th2, x3=x3, y3=y3,
                    first=(mi == 0), last=(mi == S - 2))

    def _lane_select(self, x_s: Array, y_s: Array):
        """Nearest-segment search + endpoint gather."""
        return self._lane_gather(self._lane_argmin(x_s, y_s))

    def _lane_terms(self, x_s, y_s, th_s, lsel):
        """Signed lane distance + heading deviation from frozen-or-fresh
        segment constants — (bs,T,R) elementwise only."""
        cfg = self.cfg
        f32 = jnp.float32
        x2, y2 = lsel["x2"].astype(f32), lsel["y2"].astype(f32)
        x3, y3 = lsel["x3"].astype(f32), lsel["y3"].astype(f32)
        area = x_s * (y2 - y3) + x2 * (y3 - y_s) + x3 * (y_s - y2)
        bottom = jnp.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
        l2d = jnp.sqrt(jnp.clip((x_s - x2) ** 2 + (y_s - y2) ** 2, 1e-3))
        normal = (bottom != 0).astype(jnp.float32)
        d_all = (normal * area / jnp.clip(bottom, 1e-7)
                 + (1 - normal) * l2d)
        if cfg.inline:
            l2d1 = jnp.sqrt(jnp.clip((x_s - x3) ** 2 + (y_s - y3) ** 2,
                                     1e-3))
            behind = ((x_s - x2) * (x3 - x2)
                      + (y_s - y2) * (y3 - y2)) <= 0
            ahead = ((x_s - x3) * (x2 - x3) + (y_s - y3) * (y2 - y3)) <= 0
            behind_all = lsel["first"] & behind
            ahead_all = lsel["last"] & ahead
            norm_c = ~(behind_all | ahead_all)
            sign = jnp.sign(d_all)
            d_all = (norm_c * d_all + behind_all * l2d * sign
                     + ahead_all * l2d1 * sign)
        if cfg.clip_dist:
            d_all = jnp.clip(d_all, -5.0, 5.0)
        th_all = 1.0 - jnp.cos(lsel["th2"].astype(f32) - th_s)
        return d_all, th_all

    def _clear_pair(self, x_s, y_s, cth, sth):
        """Nearest (ego-disc, neighbor-disc) pair per (k,t,row) — the
        (bs,K,T,nLe,nLn,R) hot part of the clearance.  Returns the ego-disc
        and neighbor-disc indices, (bs,K,T,R) each."""
        gd = self.gdtype
        xg, yg = x_s.astype(gd), y_s.astype(gd)
        cg, sg = cth.astype(gd), sth.astype(gd)
        axg = self.axe.astype(gd)
        exd = (xg[:, :, None, :]
               + axg[None, None, :, None] * cg[:, :, None, :])
        eyd = (yg[:, :, None, :]
               + axg[None, None, :, None] * sg[:, :, None, :])
        nLe = self.axe.shape[0]
        nLn = self.nx.shape[-1]
        bs, T, R = x_s.shape[0], x_s.shape[1], x_s.shape[2]
        K = self.nx.shape[1]
        if self.cfg.clearance_coarse_pair:
            # coarse-to-fine: nearest ego disc to the NEIGHBOR CENTER
            # first (nLe distances), then nearest neighbor disc to that
            # ego disc (nLn distances) — 2*nL instead of nL^2 pair
            # distances.  Can differ from the exact pair argmin when the
            # neighbor straddles the ego; the frozen-selection path is
            # already trust-region-stale, so this only perturbs WHICH
            # near-minimal pair is frozen (opt-in).
            ncx = jnp.mean(self.nx_g, axis=-1)                # (bs,K,T)
            ncy = jnp.mean(self.ny_g, axis=-1)
            de = ((exd[:, None] - ncx[..., None, None]) ** 2
                  + (eyd[:, None] - ncy[..., None, None]) ** 2)
            ie = jnp.argmin(de, axis=3)                       # (bs,K,T,R)
            take_e = lambda v: jnp.take_along_axis(
                v[:, None], ie[:, :, :, None], axis=3,
                mode="promise_in_bounds")[:, :, :, 0]         # (bs,K,T,R)
            ex_sel, ey_sel = take_e(exd), take_e(eyd)
            dn = ((ex_sel[..., None, :] - self.nx_g[..., None]) ** 2
                  + (ey_sel[..., None, :] - self.ny_g[..., None]) ** 2)
            inn = jnp.argmin(dn, axis=3)
        else:
            dxp = (exd[:, None, :, :, None, :]
                   - self.nx_g[:, :, :, None, :, None])
            dyp = (eyd[:, None, :, :, None, :]
                   - self.ny_g[:, :, :, None, :, None])
            d2p = dxp * dxp + dyp * dyp       # (bs,K,T,nLe,nLn,R)
            pi = jnp.argmin(d2p.reshape(bs, K, T, nLe * nLn, R),
                            axis=3)                           # (bs,K,T,R)
            # decompose the flat pair argmin into (ego-disc,
            # neighbor-disc) indices
            ie, inn = pi // nLn, pi % nLn
        return jax.lax.stop_gradient(ie), jax.lax.stop_gradient(inn)

    def _clear_gather(self, ie: Array, inn: Array):
        """The selected ego-disc offset and neighbor-disc center."""
        take_n = lambda v: jnp.take_along_axis(
            v, inn, axis=3, mode="promise_in_bounds")         # (bs,K,T,R)
        return dict(axe=jnp.take(self.axe.astype(self.gdtype), ie),
                    nx=take_n(self.nx_g), ny=take_n(self.ny_g))

    def _clear_select(self, x_s, y_s, cth, sth):
        """Nearest disc pair search + gather of its geometry."""
        return self._clear_gather(*self._clear_pair(x_s, y_s, cth, sth))

    def _clear_mnd(self, x_s, y_s, cth, sth, csel):
        """Min neighbor clearance signal (bs,T,R)."""
        if csel is None:
            # exact: full pairwise min (pairwise stays in-registers)
            exd = (x_s[:, :, None, :]
                   + self.axe[None, None, :, None] * cth[:, :, None, :])
            eyd = (y_s[:, :, None, :]
                   + self.axe[None, None, :, None] * sth[:, :, None, :])
            dxp = (exd[:, None, :, :, None, :]
                   - self.nx[:, :, :, None, :, None])
            dyp = (eyd[:, None, :, :, None, :]
                   - self.ny[:, :, :, None, :, None])
            d2 = jnp.min(dxp * dxp + dyp * dyp, axis=(3, 4))  # (bs,K,T,R)
        else:
            # frozen pair: (bs,K,T,R) elementwise only
            f32 = jnp.float32
            axe_f = csel["axe"].astype(f32)
            exd = x_s[:, None] + axe_f * cth[:, None]
            eyd = y_s[:, None] + axe_f * sth[:, None]
            d2 = ((exd - csel["nx"].astype(f32)) ** 2
                  + (eyd - csel["ny"].astype(f32)) ** 2)
        per = jnp.sqrt(d2 + 1e-12) - self.re - self.rn[..., None]
        vk = self.nvalid[..., None]
        masked = jnp.clip(per, -5.0, 20.0) * vk + (1.0 - vk) * 100.0
        return jnp.min(masked, axis=1)                        # (bs,T,R)

    def scores_r(self, muT: Array, tau: Optional[float] = None,
                 frozen=None) -> Array:
        """muT: (bs, T, 2, R) normalized controls, j-major.  Returns
        per-row robustness (bs, R).  ``frozen`` (from :meth:`freeze`)
        replaces the argmin searches with precomputed selections."""
        cfg = self.cfg
        if tau is None:
            tau = cfg.smoothing_factor
        bs, R, M, T = self.bs, self.R, self.M, cfg.nt
        x_s, y_s, th_s, v_s, cth, sth = self._rollout(muT)

        # lane distance/heading, per-row lane baked into lane_r
        lsel = frozen["lane"] if frozen is not None \
            else self._lane_select(x_s, y_s)
        d_all, th_all = self._lane_terms(x_s, y_s, th_s, lsel)

        # neighbor clearance
        mnd = self._clear_mnd(x_s, y_s, cth, sth,
                              frozen["clear"] if frozen is not None
                              else None)

        P = lambda i: self.stlp_r[:, i][:, None, :]           # (bs,1,R)
        Ps = lambda i, sl: self.stlp_r[:, i, sl][:, None, :]
        sub = (lambda f, sl: f[:, :, sl] if hasattr(f, "ndim") else f)
        alw_vmin = self._alw((v_s - P(I_VMIN)) / self.vf, tau)
        alw_vmax = self._alw((-v_s + P(I_VMAX)) / self.vf, tau)
        alw_safe = self._alw((mnd - P(I_DSAFE)) / self.sf, tau)

        if cfg.guidance_blend_scores:
            # candidate-sharding-friendly variant: compute the lane-KEEP
            # and lane-CHANGE scores for ALL R columns and blend with a
            # static is_keep mask (r < M, j-major) instead of slicing the
            # R axis at the non-shard-aligned M boundary — same values
            # column-for-column (equality-tested), ~1.6x redundant
            # reduction FLOPs, but no slice/pad halo exchanges when R is
            # sharded over a "cand" mesh axis
            sm = lambda rows: -jax.scipy.special.logsumexp(
                jnp.stack(rows, axis=1).astype(self.dtype) * (-tau),
                axis=1) / tau
            th_m = P(I_THMAX)
            alw_d1 = self._alw((d_all - P(I_DMIN)) / self.df, tau)
            alw_d2 = self._alw((-d_all + P(I_DMAX)) / self.df, tau)
            alw_th = self._alw((th_m - th_all) / th_m, tau)
            s_keep_all = sm([alw_vmin, alw_vmax, alw_d1, alw_d2, alw_th,
                             alw_safe])                       # (bs, R)
            band_all = sm([(d_all - P(I_DMIN)) / self.df,
                           (-d_all + P(I_DMAX)) / self.df])   # (bs,T,R)
            ev_d_all = self._ev_alw(band_all, tau)
            ev_th_all = self._ev_alw((th_m - th_all) / th_m, tau)
            s_change_all = sm([alw_vmin, alw_vmax, ev_d_all, ev_th_all,
                               alw_safe])                     # (bs, R)
            is_keep = (jnp.arange(R) < M).astype(jnp.float32)[None]
            return (is_keep * s_keep_all
                    + (1.0 - is_keep) * s_change_all).astype(jnp.float32)

        kM = slice(0, M)
        cM = slice(M, R)
        thk = Ps(I_THMAX, kM)
        g_keep = jnp.stack([
            (d_all[..., kM] - Ps(I_DMIN, kM)) / sub(self.df, kM),
            (-d_all[..., kM] + Ps(I_DMAX, kM)) / sub(self.df, kM),
            (thk - th_all[..., kM]) / thk,
        ], axis=1)                                            # (bs,3,T,M)
        alw_keep = self._alw(g_keep, tau, axis=2)             # (bs,3,M)
        s_keep = -jax.scipy.special.logsumexp(jnp.stack([
            -alw_vmin[:, kM], -alw_vmax[:, kM], -alw_keep[:, 0],
            -alw_keep[:, 1], -alw_keep[:, 2], -alw_safe[:, kM]],
            axis=1).astype(self.dtype) * tau, axis=1) / tau   # (bs, M)

        d_c = d_all[..., cM]
        dfc = sub(self.df, cM)
        band = -jax.scipy.special.logsumexp(jnp.stack([
            -(d_c - Ps(I_DMIN, cM)) / dfc,
            -(-d_c + Ps(I_DMAX, cM)) / dfc],
            axis=1).astype(self.dtype) * tau, axis=1) / tau   # (bs,T,2M)
        ev_d = self._ev_alw(band, tau)                        # (bs, 2M)
        thc = Ps(I_THMAX, cM)
        ev_th = self._ev_alw((thc - th_all[..., cM]) / thc, tau)
        s_change = -jax.scipy.special.logsumexp(jnp.stack([
            -alw_vmin[:, cM], -alw_vmax[:, cM], -ev_d, -ev_th,
            -alw_safe[:, cM]], axis=1).astype(self.dtype) * tau,
            axis=1) / tau                                     # (bs, 2M)
        return jnp.concatenate([s_keep, s_change],
                               axis=1).astype(jnp.float32)    # (bs, R)

    def _to_cand_minor(self, mu: Array) -> Array:
        """(N, nt*2) m-major sampler layout -> (bs, T, 2, R) j-major."""
        cfg = self.cfg
        muT = mu.reshape(self.bs, self.M, 3, cfg.nt, 2)
        return jnp.transpose(muT, (0, 3, 4, 2, 1)).reshape(
            self.bs, cfg.nt, 2, self.R)

    def _from_cand_minor(self, muT: Array) -> Array:
        """(bs, T, 2, R) j-major -> (N, nt*2) m-major (inverse of
        :meth:`_to_cand_minor`)."""
        cfg = self.cfg
        x = muT.reshape(self.bs, cfg.nt, 2, 3, self.M)
        return jnp.transpose(x, (0, 4, 3, 1, 2)).reshape(
            self.bs * self.M * 3, cfg.nt * 2)

    def freeze_cm(self, muT: Array) -> Dict[str, Dict[str, Array]]:
        """:meth:`freeze` on an already candidate-minor (bs,T,2,R) mu."""
        x_s, y_s, th_s, v_s, cth, sth = self._rollout(muT)
        return dict(lane=self._lane_select(x_s, y_s),
                    clear=self._clear_select(x_s, y_s, cth, sth))

    def freeze_zeros(self) -> Dict[str, Dict[str, Array]]:
        """Zero-filled pytree with :meth:`freeze_cm`'s exact structure —
        the initial scan carry for ``cfg.guidance_sel_every > 1`` (the
        first guided step always refreshes, so the zeros are never read)."""
        bs, T, R = self.bs, self.cfg.nt, self.R
        K = self.nx.shape[1]
        f = lambda: jnp.zeros((bs, T, R), self.gdtype)
        b = lambda: jnp.zeros((bs, T, R), bool)
        fk = lambda: jnp.zeros((bs, K, T, R), self.gdtype)
        return dict(lane=dict(x2=f(), y2=f(), th2=f(), x3=f(), y3=f(),
                              first=b(), last=b()),
                    clear=dict(axe=fk(), nx=fk(), ny=fk()))

    def loss_cm(self, muT: Array, thres: float,
                tau: Optional[float] = None, frozen=None) -> Array:
        """Hinge loss on candidate-minor (bs,T,2,R) controls — lets the
        guidance Adam loop stay in this layout so the m-major<->j-major
        transpose runs once per denoise step instead of inside every
        iteration's forward+backward."""
        scores = self.scores_r(muT, tau, frozen=frozen)
        return mask_mean(jax.nn.relu(thres - scores), self.valid_r)

    def freeze(self, mu: Array) -> Dict[str, Dict[str, Array]]:
        """:meth:`freeze_cm` from the sampler's m-major (N, nt*2) layout."""
        return self.freeze_cm(self._to_cand_minor(mu))

    def __call__(self, mu: Array, thres: float,
                 tau: Optional[float] = None, frozen=None) -> Array:
        """mu: (N, nt*2) normalized, m-major — the sampler's layout."""
        return self.loss_cm(self._to_cand_minor(mu), thres, tau,
                            frozen=frozen)


def make_guidance_loss(batch: Dict[str, Array], dense: Dict[str, Array],
                       cfg: Config, states: Array, valid: Array,
                       n_randoms: Optional[int] = None):
    """Build the candidate-minor fused guidance loss when enabled (None
    falls back to the rollout+score_rows loss in diffusion._guidance_step).
    """
    if not (cfg.guidance_fused_loss and cfg.tiled_scorer):
        return None
    return CandMinorGuidanceLoss(batch, dense["stlp_dense"], states, valid,
                                 cfg, n_randoms=n_randoms)

