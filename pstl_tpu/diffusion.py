"""DDPM core: schedule, forward prep, reverse sampler with fused STL guidance.

Parity targets:
- cosine beta schedule with the reference's nonstandard x0.2 scaling
  (``get_diffusion_coeffs``, nusc_train.py:528-537)
- forward noising ``diffusion_prep`` (nusc_train.py:539-555)
- reverse loop ``diffusion_rollout`` (nusc_train.py:557-645) including the
  CTG-style guidance inner optimizer (nusc_train.py:599-627) and its
  always-positive-offset clamp quirk (nusc_train.py:624-626, reproduced
  behind ``cfg.guidance_positive_offset_quirk``)
- control denormalization ``normalize_diff`` (nusc_train.py:647-655)
- multi-candidate argmax selection (nusc_train.py:993-1024, 1382-1400)

Design: the whole T-1-step reverse process is ONE ``lax.scan`` —
the policy-net forward, the posterior update, the guidance gradient ascent
(an inner ``fori_loop`` carrying Adam moments), and the noise injection all
live in the scan body, so XLA compiles the entire sampler into a single
device program.  The per-step guidance trigger schedule is precomputed on
host as a static boolean vector and threaded through scan's xs.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pstl_tpu import specs
from pstl_tpu.config import Config
from pstl_tpu.ops import dynamics as dyn
from pstl_tpu.parallel.mesh import constrain_candidates

Array = jax.Array


class Coeffs(NamedTuple):
    beta: Array
    alpha: Array
    alpha_hat: Array


def get_coeffs(cfg: Config) -> Coeffs:
    """Noise schedule (nusc_train.py:528-537).  cfg.cos is forced on by
    ``Config.finalize`` like the reference; the x0.2 beta scaling is
    intentional reference behavior."""
    T = cfg.diffusion_steps
    if cfg.cos:
        t = jnp.linspace(0.0, 1.0, T + 1)
        alpha_bar = jnp.cos((t + 0.008) / 1.008 * jnp.pi / 2) ** 2
        beta = jnp.clip(1 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999) * 0.2
    else:
        beta = jnp.linspace(cfg.beta_start, cfg.beta_end, T)
    alpha = 1.0 - beta
    return Coeffs(beta, alpha, jnp.cumprod(alpha))


def normalize_controls(controls: Array, cfg: Config) -> Array:
    """Physical controls -> normalized [-1,1]-ish diffusion space."""
    return jnp.stack([controls[..., 0] / cfg.mul_w_max,
                      controls[..., 1] / cfg.mul_a_max], axis=-1)


def denormalize_controls(x: Array, cfg: Config,
                         clip: Optional[bool] = None) -> Array:
    """Diffusion space -> physical controls (``normalize_diff``,
    nusc_train.py:647-655). x: (n, nt*2) or (n, nt, 2)."""
    if clip is None:
        clip = cfg.diffusion_clip
    x = x.reshape(x.shape[0], cfg.nt, 2)
    w = x[..., 0] * cfg.mul_w_max
    a = x[..., 1] * cfg.mul_a_max
    if clip:
        w = jnp.clip(w, -cfg.mul_w_max, cfg.mul_w_max)
        a = jnp.clip(a, -cfg.mul_a_max, cfg.mul_a_max)
    return jnp.stack([w, a], axis=-1)


def prep(key: Array, dense_controls: Array, cfg: Config, coeffs: Coeffs,
         n_randoms: Optional[int] = None, mono: bool = False):
    """Forward noising for training (``diffusion_prep``, nusc_train.py:539-555).

    dense_controls: (bs, M, 3, nt, 2) physical controls (or (bs, nt, 2) GT
    controls when mono).  Returns (noise (n, nt*2), t (n, 1), x_t (n, nt*2)).
    """
    if n_randoms is None:
        n_randoms = cfg.n_randoms
    if mono:
        bs = dense_controls.shape[0]
        n = bs * n_randoms
        cmd = jnp.broadcast_to(dense_controls[:, None],
                               (bs, n_randoms) + dense_controls.shape[1:])
        cmd = cmd.reshape(n, cfg.nt, 2)
    else:
        n = dense_controls.shape[0] * n_randoms * 3
        cmd = dense_controls.reshape(n, cfg.nt, 2)
    cmd = normalize_controls(cmd, cfg).reshape(n, cfg.nt * 2)
    k_noise, k_t = jax.random.split(key)
    noise = jax.random.normal(k_noise, (n, cfg.nt * 2))
    t = jax.random.randint(k_t, (n,), 1, cfg.diffusion_steps)
    sa = jnp.sqrt(coeffs.alpha_hat[t])[:, None]
    sb = jnp.sqrt(1 - coeffs.alpha_hat[t])[:, None]
    return noise, t[:, None], sa * cmd + sb * noise


def _trigger_schedule(cfg: Config) -> np.ndarray:
    """Static per-step guidance triggers for i = T-1 .. 1
    (nusc_train.py:589-598).  Entry j corresponds to scan step j,
    i.e. diffusion index i = T-1-j."""
    T = cfg.diffusion_steps
    trig = np.zeros(T - 1, dtype=bool)
    if cfg.guidance:
        for j, i in enumerate(range(T - 1, 0, -1)):
            i_val = (T - 1 - i) if cfg.guidance_reverse else i
            if cfg.guidance_sets is not None:
                trig[j] = i_val in cfg.guidance_sets
            elif cfg.guidance_freq is not None:
                trig[j] = (i_val % cfg.guidance_freq) == 0
            else:
                trig[j] = i <= cfg.guidance_before
    return trig


def _fast_taus(cfg: Config) -> np.ndarray:
    """Timestep subsequence for the fast samplers (ddim / dpm++).

    Uniform over [1, T-1] by default.  With ``cfg.fast_guided_focus > 0``
    and a banded trigger schedule (``guidance_before < T-1``, the
    reference's published closed-loop schedule fires guidance only on the
    last denoise steps — nusc_train.py:589-598 via README.md:175), a
    ``focus`` fraction of the S evaluations is placed INSIDE the guided
    band [1, guidance_before] and the rest uniformly above it: denser
    guidance correction where `_guidance_step` actually fires recovers
    full-chain compliance at the same network-evaluation count
    (beyond-reference; VERDICT r3 #9).
    """
    T = cfg.diffusion_steps
    S = min(cfg.ddim_steps, T - 1)
    focus = cfg.fast_guided_focus
    banded = (cfg.guidance and cfg.guidance_sets is None
              and cfg.guidance_freq is None and not cfg.guidance_reverse
              and 0 < cfg.guidance_before < T - 1)
    # band: the guided sub-range when the trigger is banded, else an
    # explicit override (fast_focus_band) — with all-steps guidance the
    # low-t end is still where correction moves the final sample most
    gb = cfg.fast_focus_band or (cfg.guidance_before if banded else 0)
    if focus <= 0.0 or not 0 < gb < T - 1:
        return np.linspace(T - 1, 1, S).round().astype(np.int32)
    s_lo = int(np.clip(round(S * focus), 1, min(S - 1, gb)))
    s_hi = min(S - s_lo, T - 2 - gb)
    hi = np.linspace(T - 1, gb + 1, s_hi).round()
    lo = np.linspace(gb, 1, s_lo).round()
    taus = np.concatenate([hi, lo]).astype(np.int32)
    # rounding can collide neighbors inside a dense band: enforce strictly
    # decreasing (both samplers assume tau_next < tau)
    for i in range(1, len(taus)):
        taus[i] = min(taus[i], taus[i - 1] - 1)
    return np.maximum(taus, 1)


def make_guidance_ctx(score_rows: Callable, valid: Array,
                      states_flat: Array, fused_loss=None):
    """Context consumed by the in-sampler guidance: a per-row robustness
    function (specs.make_score_rows), the validity mask, the dense initial
    states, and optionally a prebuilt candidate-minor fused loss
    (specs.CandMinorGuidanceLoss — the fast path)."""
    return (score_rows, valid, states_flat, fused_loss)


def _refresh_schedule(trig: np.ndarray, k: int) -> np.ndarray:
    """Static refresh mask for ``guidance_sel_every=k``: True on every k-th
    GUIDED scan step (counting only steps where ``trig`` is True), so the
    frozen selections are recomputed on the 1st, (k+1)-th, ... guided step
    and reused in between."""
    refresh = np.zeros_like(trig)
    cnt = 0
    for j in range(len(trig)):
        if trig[j]:
            refresh[j] = (cnt % k) == 0
            cnt += 1
    return refresh


# seam for layout-parity tests: the reverse samplers draw noise through
# this alias so a test can pin the draw to a layout-independent stream
_normal = jax.random.normal


def _guidance_step(mu: Array, beta_t: Array, ctx, cfg: Config,
                   maximize: bool, frozen=None, mu_cm=None,
                   cm_io: bool = False) -> Array:
    """Inner gradient ascent on STL robustness (nusc_train.py:599-627).

    mu: (N, nt*2) normalized posterior mean.  ctx from
    :func:`make_guidance_ctx`.  Runs ``cfg.guidance_niters`` Adam steps on a
    copy of mu, then applies the reference's clamp: delta =
    clip(|mu'-mu|, beta_t) added positively (quirk) or the signed variant
    when the quirk flag is off.

    ``frozen``/``mu_cm``: caller-provided frozen selections and the
    candidate-minor view of mu (the ``guidance_sel_every`` carry path in
    :func:`reverse_sample`); when None they are computed here.
    ``cm_io``: the caller's mu ALREADY lives in candidate-minor (the
    cm-sampler path) — return candidate-minor too, no transposes at all.
    """
    score_rows, valid, states_flat, *rest = ctx
    fused_loss = rest[0] if rest else None
    thres = 100.0 if maximize else cfg.stl_nn_thres
    assert not cm_io or fused_loss is not None

    if fused_loss is not None:
        # the whole Adam loop runs in candidate-minor (bs, T, 2, R)
        # layout: one transpose in, one out, instead of a layout
        # round-trip inside every iteration's forward+backward (Adam and
        # the trust-region clip are elementwise, so the optimization is
        # identical under the permutation)
        mu_init = mu_cm if mu_cm is not None \
            else fused_loss._to_cand_minor(mu)
        post = (lambda x: x) if cm_io else fused_loss._from_cand_minor
        if frozen is None and cfg.guidance_reuse_selection:
            frozen = fused_loss.freeze_cm(mu_init)

        def loss_fn(mu_cm_):
            return fused_loss.loss_cm(mu_cm_, thres, frozen=frozen)
    else:
        mu_init = mu
        post = lambda x: x

        def loss_fn(mu_flat):
            u = denormalize_controls(mu_flat, cfg, clip=False)
            trajs = dyn.rollout(states_flat, u, cfg.dt)
            scores = score_rows(trajs[:, :-1])
            return specs.mask_mean(jax.nn.relu(thres - scores), valid)

    if cfg.guidance_remat:
        loss_fn = jax.checkpoint(
            loss_fn, policy=jax.checkpoint_policies.nothing_saveable)
    grad_fn = jax.grad(loss_fn)
    lr, b1, b2, eps = cfg.guidance_lr, 0.9, 0.999, 1e-8

    def body(it, carry):
        mu_opt, m, v = carry
        g = grad_fn(mu_opt)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = it + 1
        mh = m / (1 - b1 ** step)
        vh = v / (1 - b2 ** step)
        mu_opt = mu_opt - lr * mh / (jnp.sqrt(vh) + eps)
        if cfg.guidance_positive_offset_quirk:
            delta = jnp.clip(jnp.abs(mu_opt - mu_init), -beta_t, beta_t)
        else:
            delta = jnp.clip(mu_opt - mu_init, -beta_t, beta_t)
        return (mu_init + delta, m, v)

    carry = (mu_init, jnp.zeros_like(mu_init), jnp.zeros_like(mu_init))
    if cfg.guidance_niters <= 8:
        # unroll the Adam iterations: niters is tiny and static, and a
        # lax.fori_loop lowers to a while-loop whose per-iteration entry
        # barrier stops XLA fusing and scheduling across iterations.
        # Same ops in the same order — identical numerics, straight-line
        # HLO.
        for it in range(cfg.guidance_niters):
            carry = body(it, carry)
        mu_opt = carry[0]
    else:
        mu_opt, _, _ = jax.lax.fori_loop(0, cfg.guidance_niters, body,
                                         carry)
    return jax.lax.stop_gradient(post(mu_opt))


def reverse_sample(key: Array, apply_fn: Callable, batch: Dict[str, Array],
                   highlevel: Array, feature: Array, cfg: Config,
                   coeffs: Coeffs, n: int,
                   guidance_ctx=None, maximize: bool = False,
                   mono: bool = False, tmp_stlp: Optional[Array] = None,
                   cm_fn: Optional[Callable] = None):
    """Full reverse DDPM as one ``lax.scan`` (``diffusion_rollout``,
    nusc_train.py:557-645).

    apply_fn(ext) -> epsilon prediction (n, nt*2); the caller closes over
    network params, the (densified) batch, and the precomputed scene feature
    so each scan step is a single fused MLP pass.

    Returns (controls (n, nt, 2), all_steps (T, n, nt, 2)) — all_steps are
    the denormalized per-step decodings (diff_full semantics), with
    all_steps[-1] == controls.
    """
    T = cfg.diffusion_steps
    trig_np = _trigger_schedule(cfg)
    use_guidance = guidance_ctx is not None and bool(trig_np.any())
    always_guided = use_guidance and bool(trig_np.all())
    trig = jnp.asarray(trig_np)
    k_init, k_loop = jax.random.split(key)

    # guidance_sel_every > 1: carry the frozen argmin selections across
    # denoise steps, refreshing every k-th guided step (staleness stays
    # inside the |delta| <= beta_t trust region, like the intra-step reuse
    # of guidance_reuse_selection).
    fused_loss = (guidance_ctx[3] if guidance_ctx is not None
                  and len(guidance_ctx) > 3 else None)
    # candidate-minor sampler: the whole reverse scan (net forward,
    # posterior mean, guidance, noise injection) runs in (bs, nt, 2, R)
    # layout — zero per-step transposes; one batched conversion at the end
    use_cm = (cm_fn is not None and fused_loss is not None and use_guidance)
    # opt-in candidate-axis (tensor-parallel) sharding: constraining the
    # candidate axis of the initial noise lets GSPMD shard the whole
    # reverse scan over the mesh (parallel/mesh.py candidate_sharding)
    if use_cm:
        x0 = constrain_candidates(
            _normal(k_init, (fused_loss.bs, cfg.nt, 2, fused_loss.R)), -1,
            batch_dim=0)
    else:
        x0 = constrain_candidates(_normal(k_init, (n, cfg.nt * 2)), 0)
    carry_sel = (use_guidance and cfg.guidance_reuse_selection
                 and fused_loss is not None and cfg.guidance_sel_every > 1)
    if carry_sel:
        refresh = jnp.asarray(
            _refresh_schedule(trig_np, cfg.guidance_sel_every))
        frozen0 = fused_loss.freeze_zeros()

    if mono:
        ext_extra = {"stlp": tmp_stlp, "gt_stlp": tmp_stlp}
    else:
        ext_extra = {"stlp": batch["stlp_dense"]}

    def step(carry, xs):
        if carry_sel:
            x, k, frozen = carry
            t_scalar, triggered, refresh_f = xs
        else:
            x, k = carry
            t_scalar, triggered = xs      # t = T-1-j for step j
            frozen = None
        k, k_z = jax.random.split(k)
        if use_cm:
            eps = cm_fn(x, t_scalar)
        else:
            t_col = jnp.full((n, 1), t_scalar, dtype=jnp.float32)
            ext = {"timestep": t_col, "highlevel": highlevel, "noise": x,
                   **ext_extra}
            eps = apply_fn(ext).reshape(n, cfg.nt * 2)
        alpha = coeffs.alpha[t_scalar]
        alpha_hat = coeffs.alpha_hat[t_scalar]
        beta = coeffs.beta[t_scalar]
        mu = (x - ((1 - alpha) / jnp.sqrt(1 - alpha_hat)) * eps) / jnp.sqrt(alpha)
        if use_guidance:
            if carry_sel:
                def guided(m, f):
                    m_cm = m if use_cm else fused_loss._to_cand_minor(m)
                    f2 = jax.lax.cond(
                        refresh_f,
                        lambda ff: fused_loss.freeze_cm(m_cm),
                        lambda ff: ff, f)
                    return _guidance_step(m, beta, guidance_ctx, cfg,
                                          maximize, frozen=f2,
                                          mu_cm=m_cm, cm_io=use_cm), f2
            else:
                def guided(m, f):
                    return _guidance_step(m, beta, guidance_ctx, cfg,
                                          maximize, mu_cm=m if use_cm
                                          else None, cm_io=use_cm), f
            if always_guided:   # static schedule: no cond, straight-line HLO
                mu, frozen = guided(mu, frozen)
            else:
                mu, frozen = jax.lax.cond(
                    triggered, guided, lambda m, f: (m, f), mu, frozen)
        z = jnp.where(t_scalar > 1, _normal(k_z, x.shape), 0.0)
        x_next = mu + cfg.sample_noise_scale * jnp.sqrt(beta) * z
        new_carry = (x_next, k, frozen) if carry_sel else (x_next, k)
        return new_carry, (x_next if cfg.diff_full else None)

    ts = jnp.arange(T - 1, 0, -1)
    xs_in = (ts, trig, refresh) if carry_sel else (ts, trig)
    init_carry = (x0, k_loop, frozen0) if carry_sel else (x0, k_loop)
    final_carry, xs_hist = jax.lax.scan(step, init_carry, xs_in,
                                        unroll=cfg.diffusion_scan_unroll)
    x_last = final_carry[0]
    conv = fused_loss._from_cand_minor if use_cm else (lambda v: v)
    if not cfg.diff_full:
        # --diff_full off (reference keeps only the final decode,
        # nusc_train.py:630): nothing stacked, all_steps is just the result
        final = denormalize_controls(conv(x_last), cfg)
        return final, final[None]
    # denormalized per-step decodings incl. the initial noise, excl. dup of
    # the final step: [x0, x_1, ..., x_{T-1}] -> T entries (reference's
    # final_list, nusc_train.py:632-634).  In cm mode the layout converts
    # here as ONE batched transpose over all T steps.
    full = jnp.concatenate([x0[None], xs_hist], axis=0)
    all_steps = jax.vmap(lambda v: denormalize_controls(conv(v), cfg))(full)
    return all_steps[-1], all_steps


def reverse_sample_ddim(key: Array, apply_fn: Callable,
                        batch: Dict[str, Array], highlevel: Array,
                        feature: Array, cfg: Config, coeffs: Coeffs, n: int,
                        guidance_ctx=None, maximize: bool = False,
                        mono: bool = False,
                        tmp_stlp: Optional[Array] = None):
    """DDIM sampler (Song et al. 2020, arXiv:2010.02502) over a uniform
    timestep subsequence — a beyond-reference fast-sampling mode: 5x fewer
    network evaluations at eta=0 with deterministic trajectories.  Guidance
    is applied to the pre-noise update exactly like the DDPM path; the
    per-step decodings feed multi-cands/refinement the same way.
    """
    T = cfg.diffusion_steps
    taus = _fast_taus(cfg)
    taus_next = np.concatenate([taus[1:], [0]]).astype(np.int32)
    use_guidance = guidance_ctx is not None and cfg.guidance
    k_init, k_loop = jax.random.split(key)
    x0 = constrain_candidates(jax.random.normal(k_init, (n, cfg.nt * 2)), 0)
    if mono:
        ext_extra = {"stlp": tmp_stlp, "gt_stlp": tmp_stlp}
    else:
        ext_extra = {"stlp": batch["stlp_dense"]}
    eta = cfg.ddim_eta

    def step(carry, xs):
        x, k = carry
        t, t_next = xs
        k, k_z = jax.random.split(k)
        t_col = jnp.full((n, 1), t, dtype=jnp.float32)
        ext = {"timestep": t_col, "highlevel": highlevel, "noise": x,
               **ext_extra}
        eps = apply_fn(ext).reshape(n, cfg.nt * 2)
        ab_t = coeffs.alpha_hat[t]
        ab_n = jnp.where(t_next > 0, coeffs.alpha_hat[t_next], 1.0)
        x0_hat = (x - jnp.sqrt(1 - ab_t) * eps) / jnp.sqrt(ab_t)
        sigma = (eta * jnp.sqrt((1 - ab_n) / (1 - ab_t))
                 * jnp.sqrt(1 - ab_t / ab_n))
        dir_coef = jnp.sqrt(jnp.maximum(1 - ab_n - sigma ** 2, 0.0))
        mu = jnp.sqrt(ab_n) * x0_hat + dir_coef * eps
        if use_guidance:
            beta = coeffs.beta[t]
            mu = _guidance_step(mu, beta, guidance_ctx, cfg, maximize)
        z = jnp.where(t_next > 0, jax.random.normal(k_z, x.shape), 0.0)
        x_next = mu + cfg.sample_noise_scale * sigma * z
        return (x_next, k), (x_next if cfg.diff_full else None)

    (x_last, _), xs_hist = jax.lax.scan(step, (x0, k_loop),
                                        (jnp.asarray(taus),
                                         jnp.asarray(taus_next)))
    if not cfg.diff_full:
        final = denormalize_controls(x_last, cfg)
        return final, final[None]
    full = jnp.concatenate([x0[None], xs_hist], axis=0)
    all_steps = jax.vmap(lambda v: denormalize_controls(v, cfg))(full)
    return all_steps[-1], all_steps


def reverse_sample_dpmpp(key: Array, apply_fn: Callable,
                         batch: Dict[str, Array], highlevel: Array,
                         feature: Array, cfg: Config, coeffs: Coeffs,
                         n: int, guidance_ctx=None, maximize: bool = False,
                         mono: bool = False,
                         tmp_stlp: Optional[Array] = None):
    """DPM-Solver++(2M) multistep sampler (Lu et al. 2022,
    arXiv:2211.01095) — beyond-reference fast mode: second-order
    data-prediction updates in log-SNR time, typically matching the DDPM
    chain's sample quality in 10-20 network evaluations instead of 99.
    Deterministic (no injected noise).  Guidance applies to the updated
    state each step, like the DDIM path; per-step decodings feed
    multi-cands identically.
    """
    taus = _fast_taus(cfg)
    use_guidance = guidance_ctx is not None and cfg.guidance
    k_init, _ = jax.random.split(key)
    x0 = constrain_candidates(jax.random.normal(k_init, (n, cfg.nt * 2)), 0)
    if mono:
        ext_extra = {"stlp": tmp_stlp, "gt_stlp": tmp_stlp}
    else:
        ext_extra = {"stlp": batch["stlp_dense"]}

    ab = coeffs.alpha_hat
    alpha_t = jnp.sqrt(ab)
    sigma_t = jnp.sqrt(1.0 - ab)
    lam = jnp.log(alpha_t) - jnp.log(sigma_t)       # half log-SNR

    def x0_pred(x, t):
        t_col = jnp.full((n, 1), t, dtype=jnp.float32)
        ext = {"timestep": t_col, "highlevel": highlevel, "noise": x,
               **ext_extra}
        eps = apply_fn(ext).reshape(n, cfg.nt * 2)
        return (x - sigma_t[t] * eps) / alpha_t[t]

    def step(carry, xs):
        x, d_prev, h_prev = carry
        t_prev, t, first = xs
        d = x0_pred(x, t_prev)
        h = lam[t] - lam[t_prev]
        r = h_prev / jnp.where(h == 0, 1.0, h)
        # first step: first-order (DDIM) update; later: 2M correction
        d_used = jnp.where(first, d,
                           (1 + 1 / (2 * jnp.maximum(r, 1e-6))) * d
                           - (1 / (2 * jnp.maximum(r, 1e-6))) * d_prev)
        x_next = (sigma_t[t] / sigma_t[t_prev] * x
                  - alpha_t[t] * jnp.expm1(-h) * d_used)
        if use_guidance:
            x_next = _guidance_step(x_next, coeffs.beta[t], guidance_ctx,
                                    cfg, maximize)
        return (x_next, d, h), (x_next if cfg.diff_full else None)

    t_prevs = jnp.asarray(taus[:-1])
    t_nexts = jnp.asarray(taus[1:])
    firsts = jnp.asarray([True] + [False] * (len(taus) - 2))
    (x_last, d_last, _), xs_hist = jax.lax.scan(
        step, (x0, jnp.zeros_like(x0), jnp.asarray(1.0)),
        (t_prevs, t_nexts, firsts))
    # final decode at the last timestep: data prediction at tau_min
    x_final = x0_pred(x_last, taus[-1])
    if not cfg.diff_full:
        final = denormalize_controls(x_final, cfg)
        return final, final[None]
    full = jnp.concatenate([x0[None], xs_hist, x_final[None]], axis=0)
    all_steps = jax.vmap(lambda v: denormalize_controls(v, cfg))(full)
    return all_steps[-1], all_steps


def sample(key: Array, apply_fn: Callable, batch: Dict[str, Array],
           highlevel: Array, feature: Array, cfg: Config, coeffs: Coeffs,
           n: int, **kw):
    """Dispatch to the configured sampler (ddpm parity / ddim / dpm++)."""
    fn = {"ddim": reverse_sample_ddim,
          "dpmpp": reverse_sample_dpmpp}.get(cfg.sampler, reverse_sample)
    if fn is not reverse_sample:
        kw.pop("cm_fn", None)   # cm layout is a DDPM-scan optimization
    return fn(key, apply_fn, batch, highlevel, feature, cfg, coeffs, n, **kw)


def select_multi_cands(all_steps: Array, k: int, states_flat: Array,
                       score_rows: Callable, cfg: Config):
    """Score the last k intermediate decodings under STL and take the
    per-sample argmax (nusc_train.py:993-1024).

    all_steps: (S, n, nt, 2); returns (best_controls (n, nt, 2),
    best_scores (n,)).
    """
    cands = all_steps[-k:]                                  # (k, n, nt, 2)

    def score_one(u):
        trajs = dyn.rollout(states_flat, u, cfg.dt)
        return score_rows(trajs[:, :-1])

    scores = jax.vmap(score_one)(cands)                     # (k, n)
    best_i = jnp.argmax(scores, axis=0)                     # (n,)
    best_scores = jnp.max(scores, axis=0)
    best = jnp.take_along_axis(cands, best_i[None, :, None, None],
                               axis=0)[0]
    return best, best_scores
