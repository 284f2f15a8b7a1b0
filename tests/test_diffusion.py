"""DDPM schedule / prep / reverse sampler / guidance / multi-cands."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pstl_tpu import diffusion, specs
from pstl_tpu.config import Config
from pstl_tpu.models import Net
from pstl_tpu.ops import dynamics as dyn
from tests.test_specs import make_batch


def small_cfg(**kw):
    kw.setdefault("diffusion", True)
    kw.setdefault("diff_full", True)
    kw.setdefault("n_randoms", 2)
    kw.setdefault("n_neighbors", 2)
    kw.setdefault("diffusion_steps", 10)
    kw.setdefault("compute_dtype", "float32")
    return Config(**kw)


def test_cosine_schedule_reference_values():
    """Schedule matches an independent recomputation of the reference
    formula (nusc_train.py:528-537), incl. the x0.2 scaling."""
    cfg = small_cfg(diffusion_steps=100)
    c = diffusion.get_coeffs(cfg)
    t = np.linspace(0, 1, 101)
    ab = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
    beta = np.clip(1 - ab[1:] / ab[:-1], 0, 0.999) * 0.2
    np.testing.assert_allclose(np.asarray(c.beta), beta, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(c.alpha_hat),
                               np.cumprod(1 - beta), rtol=1e-5)
    assert float(c.beta[0]) < float(c.beta[-1])  # monotone increasing-ish


def test_normalize_denormalize_roundtrip():
    cfg = small_cfg()
    rng = np.random.RandomState(0)
    u = jnp.asarray(rng.uniform(-1, 1, (4, cfg.nt, 2))
                    * np.array([cfg.mul_w_max, cfg.mul_a_max]),
                    dtype=jnp.float32)
    x = diffusion.normalize_controls(u, cfg)
    back = diffusion.denormalize_controls(x.reshape(4, -1), cfg, clip=False)
    np.testing.assert_allclose(np.asarray(back), np.asarray(u), rtol=1e-5,
                               atol=1e-6)


def test_prep_statistics():
    """x_t = sqrt(ab)x0 + sqrt(1-ab)eps: marginal variance ~ ab*var(x0)+(1-ab)."""
    cfg = small_cfg(diffusion_steps=100)
    coeffs = diffusion.get_coeffs(cfg)
    bs, M = 64, 2
    controls = jnp.zeros((bs, M, 3, cfg.nt, 2))    # x0 = 0
    noise, t, xt = diffusion.prep(jax.random.PRNGKey(0), controls, cfg,
                                  coeffs)
    n = bs * M * 3
    assert noise.shape == (n, cfg.nt * 2) and xt.shape == (n, cfg.nt * 2)
    assert t.shape == (n, 1)
    assert int(t.min()) >= 1 and int(t.max()) < cfg.diffusion_steps
    # with x0=0: xt = sqrt(1-ab_t) * eps exactly
    ab = np.asarray(coeffs.alpha_hat)[np.asarray(t[:, 0])]
    np.testing.assert_allclose(np.asarray(xt),
                               np.sqrt(1 - ab)[:, None] * np.asarray(noise),
                               rtol=1e-4, atol=1e-5)


def make_sampler_setup(cfg, bs=1, guidance=False, fused=False):
    batch = make_batch(cfg, bs=bs)
    batch["neighbors"] = batch["neighbor_trajs_aug"][:, :, 0, :]
    batch["neighbors_traj"] = batch["neighbor_trajs_aug"]
    stlp = specs.calibrate_stlp(batch, batch["ego_traj"][..., :4], cfg)
    dense = specs.densify_batch(batch, stlp, cfg, key=jax.random.PRNGKey(0))
    n = bs * cfg.n_randoms * 3
    net = Net(cfg)
    ext0 = {"timestep": jnp.ones((n, 1)),
            "highlevel": dense["highlevel_dense"],
            "noise": jnp.zeros((n, cfg.nt * 2))}
    params = net.init(jax.random.PRNGKey(1), dense, ext0)
    _, feature = net.apply(params, dense, ext0, get_feature=True)

    def apply_fn(ext):
        return net.apply(params, dense, ext, prev_feature=feature)

    states = batch["ego_traj"][:, 0, :4]
    states_flat = jnp.broadcast_to(states[:, None, None],
                                   (bs, cfg.n_randoms, 3, 4)).reshape(n, 4)
    coeffs = diffusion.get_coeffs(cfg)
    formulas = specs.build_formulas(cfg)
    signal_base = specs.dense_signal_input(dense)
    score_rows = specs.make_score_rows(batch, dense, cfg)
    if guidance:
        fl = specs.make_guidance_loss(
            batch, dense, cfg, states,
            dense["valids_dense"].reshape(-1)) if fused else None
        ctx = diffusion.make_guidance_ctx(
            score_rows, dense["valids_dense"].reshape(-1), states_flat, fl)
    else:
        ctx = None
    return (apply_fn, dense, feature, states_flat, coeffs, formulas,
            signal_base, ctx, n)


@pytest.mark.slow
def test_reverse_sampler_shapes_and_determinism():
    cfg = small_cfg()
    (apply_fn, dense, feature, states_flat, coeffs, formulas, signal_base,
     ctx, n) = make_sampler_setup(cfg)
    controls, all_steps = diffusion.reverse_sample(
        jax.random.PRNGKey(2), apply_fn, dense, dense["highlevel_dense"],
        feature, cfg, coeffs, n)
    assert controls.shape == (n, cfg.nt, 2)
    assert all_steps.shape == (cfg.diffusion_steps, n, cfg.nt, 2)
    np.testing.assert_allclose(np.asarray(all_steps[-1]),
                               np.asarray(controls), atol=1e-6)
    # same key -> identical samples; different key -> different
    c2, _ = diffusion.reverse_sample(
        jax.random.PRNGKey(2), apply_fn, dense, dense["highlevel_dense"],
        feature, cfg, coeffs, n)
    np.testing.assert_allclose(np.asarray(c2), np.asarray(controls))
    c3, _ = diffusion.reverse_sample(
        jax.random.PRNGKey(3), apply_fn, dense, dense["highlevel_dense"],
        feature, cfg, coeffs, n)
    assert np.abs(np.asarray(c3) - np.asarray(controls)).max() > 1e-4


@pytest.mark.slow
def test_guidance_improves_robustness():
    """Guided sampling must score no worse than unguided (same key)."""
    cfg = small_cfg(guidance=True, guidance_niters=2, guidance_lr=0.05)
    (apply_fn, dense, feature, states_flat, coeffs, formulas, signal_base,
     ctx, n) = make_sampler_setup(cfg, guidance=True)
    valid = signal_base["dense_valids"].reshape(-1)

    def score(controls):
        trajs = dyn.rollout(states_flat, controls, cfg.dt)
        sig = dict(signal_base)
        sig["ego_traj"] = trajs[:, :-1]
        _, s, _ = specs.compute_scores(sig, formulas,
                                       dense["highlevel_dense"], valid, cfg)
        return float(specs.mask_mean(s, valid))

    cfg_off = cfg.with_(guidance=False)
    c_plain, _ = diffusion.reverse_sample(
        jax.random.PRNGKey(5), apply_fn, dense, dense["highlevel_dense"],
        feature, cfg_off, coeffs, n)
    c_guided, _ = diffusion.reverse_sample(
        jax.random.PRNGKey(5), apply_fn, dense, dense["highlevel_dense"],
        feature, cfg, coeffs, n, guidance_ctx=ctx)
    assert score(c_guided) >= score(c_plain) - 1e-3


def test_guidance_trigger_schedule():
    cfg = small_cfg(guidance=True, guidance_sets=(2, 4))
    trig = diffusion._trigger_schedule(cfg)
    # steps run i = 9..1; triggered where i in {2,4}
    want = [i in (2, 4) for i in range(9, 0, -1)]
    assert list(trig) == want
    cfg = small_cfg(guidance=True, guidance_freq=3)
    trig = diffusion._trigger_schedule(cfg)
    want = [(i % 3) == 0 for i in range(9, 0, -1)]
    assert list(trig) == want
    cfg = small_cfg(guidance=True, guidance_before=4)
    trig = diffusion._trigger_schedule(cfg)
    want = [i <= 4 for i in range(9, 0, -1)]
    assert list(trig) == want


@pytest.mark.slow
def test_guidance_sel_every():
    """guidance_sel_every: (a) the static refresh schedule counts only
    GUIDED steps; (b) with a single guided step the carried-selection path
    (k=2) is numerically identical to k=1 (the one step always refreshes,
    so only the plumbing differs); (c) a multi-trigger k=2 run stays
    finite."""
    trig = np.array([0, 1, 1, 0, 1, 1, 1], bool)
    assert list(diffusion._refresh_schedule(trig, 2)) == [
        False, True, False, False, True, False, True]

    cfg = small_cfg(guidance=True, guidance_niters=2, guidance_lr=0.05,
                    guidance_reuse_selection=True, guidance_sets=(3,))
    out = {}
    for k in (1, 2):
        cfgk = cfg.with_(guidance_sel_every=k)
        (apply_fn, dense, feature, _states_flat, coeffs, _formulas,
         _sig, ctx, n) = make_sampler_setup(cfgk, guidance=True, fused=True)
        c, _ = diffusion.reverse_sample(
            jax.random.PRNGKey(7), apply_fn, dense,
            dense["highlevel_dense"], feature, cfgk, coeffs, n,
            guidance_ctx=ctx)
        out[k] = np.asarray(c)
    np.testing.assert_allclose(out[2], out[1], rtol=1e-6, atol=1e-7)

    cfg2 = small_cfg(guidance=True, guidance_niters=1,
                     guidance_reuse_selection=True, guidance_sel_every=2)
    (apply_fn, dense, feature, _states_flat, coeffs, _formulas,
     _sig, ctx, n) = make_sampler_setup(cfg2, guidance=True, fused=True)
    c, _ = diffusion.reverse_sample(
        jax.random.PRNGKey(3), apply_fn, dense, dense["highlevel_dense"],
        feature, cfg2, coeffs, n, guidance_ctx=ctx)
    assert np.isfinite(np.asarray(c)).all()


@pytest.mark.slow
def test_multi_cands_selection():
    cfg = small_cfg()
    (apply_fn, dense, feature, states_flat, coeffs, formulas, signal_base,
     ctx, n) = make_sampler_setup(cfg)
    _, all_steps = diffusion.reverse_sample(
        jax.random.PRNGKey(7), apply_fn, dense, dense["highlevel_dense"],
        feature, cfg, coeffs, n)
    batch = make_batch(cfg, bs=1)   # same seed as make_sampler_setup
    batch["neighbors_traj"] = batch["neighbor_trajs_aug"]
    score_rows = specs.make_score_rows(batch, dense, cfg)
    best, best_scores = diffusion.select_multi_cands(
        all_steps, 3, states_flat, score_rows, cfg)
    assert best.shape == (n, cfg.nt, 2)
    # best >= each candidate's score
    valid = signal_base["dense_valids"].reshape(-1)
    for k in range(1, 4):
        trajs = dyn.rollout(states_flat, all_steps[-k], cfg.dt)
        sig = dict(signal_base)
        sig["ego_traj"] = trajs[:, :-1]
        _, s, _ = specs.compute_scores(sig, formulas,
                                       dense["highlevel_dense"], valid, cfg)
        assert np.all(np.asarray(best_scores) >= np.asarray(s) - 1e-4)


def test_sampler_jits():
    cfg = small_cfg()
    (apply_fn, dense, feature, states_flat, coeffs, formulas, signal_base,
     ctx, n) = make_sampler_setup(cfg)

    @jax.jit
    def run(key):
        c, _ = diffusion.reverse_sample(key, apply_fn, dense,
                                        dense["highlevel_dense"], feature,
                                        cfg, coeffs, n)
        return c

    c = run(jax.random.PRNGKey(0))
    assert np.all(np.isfinite(np.asarray(c)))


def test_guidance_positive_offset_quirk_parity():
    """Strict-parity mode pin (nusc_train.py:624-626): with the quirk ON,
    the applied delta is clip(|mu'-mu|, beta) added POSITIVELY — for a
    single Adam iteration from zero moments the update magnitude is
    lr*|g|/(|g|+eps) ~= lr, so every coordinate with a nonzero gradient
    moves by exactly +min(lr, beta) regardless of the gradient sign."""
    cfg = small_cfg(guidance=True, guidance_niters=1, guidance_lr=0.01,
                    guidance_positive_offset_quirk=True)
    n, T = 6, cfg.nt
    states_flat = jnp.zeros((n, 4)).at[:, 3].set(2.0)
    valid = jnp.ones((n,))
    # score = +-sum(u): gradient sign differs per row; scores << thres so
    # the hinge is active everywhere
    sign = jnp.asarray([1.0, -1.0] * 3)

    def score_rows(ego):
        # recover controls from the rollout states: d(theta)/dt, dv/dt
        # (ego: (n, T, 4) states 0..T-1); depends smoothly on mu
        return sign * jnp.sum(ego[..., 3], axis=-1) * 1e-3 - 10.0

    ctx = diffusion.make_guidance_ctx(score_rows, valid, states_flat)
    mu = jnp.zeros((n, T * 2))
    beta = jnp.float32(0.004)
    out = diffusion._guidance_step(mu, beta, ctx, cfg, maximize=False)
    delta = np.asarray(out - mu)
    # quirk: positive offset of min(lr, beta) on every driven coordinate
    driven = np.abs(delta) > 1e-9
    assert driven.any()
    np.testing.assert_allclose(delta[driven], float(beta), rtol=1e-3)
    assert (delta >= -1e-9).all()
    # fixed (signed) variant: direction follows the per-row gradient sign
    cfg2 = cfg.with_(guidance_positive_offset_quirk=False)
    out2 = diffusion._guidance_step(mu, beta, ctx, cfg2, maximize=False)
    d2 = np.asarray(out2 - mu)
    # rows that want larger speed (sign=+1) get positive accel updates;
    # rows with sign=-1 get negative ones on the same coordinates
    a_cols = d2.reshape(n, T, 2)[..., 1]
    assert (a_cols[0] >= -1e-9).all() and (a_cols[1] <= 1e-9).all()


@pytest.mark.slow
def test_cm_sampler_layout_parity(monkeypatch):
    """cfg.cm_sampler: (a) models.make_cm_eps_fn equals the Net diffusion
    forward on matched inputs (the linear layer-1 split is exact in fp32);
    (b) the full candidate-minor reverse scan equals the row-major scan
    when the noise stream is pinned to a layout-independent draw; (c) the
    guidance_sel_every carry plumbing also matches."""
    from pstl_tpu.models import net as models_net

    cfg = small_cfg(guidance=True, guidance_niters=2, guidance_lr=0.05,
                    guidance_reuse_selection=True)
    bs = 2
    batch = make_batch(cfg, bs=bs)
    batch["neighbors"] = batch["neighbor_trajs_aug"][:, :, 0, :]
    batch["neighbors_traj"] = batch["neighbor_trajs_aug"]
    stlp = specs.calibrate_stlp(batch, batch["ego_traj"][..., :4], cfg)
    dense = specs.densify_batch(batch, stlp, cfg, key=jax.random.PRNGKey(0))
    n = bs * cfg.n_randoms * 3
    net = Net(cfg)
    hl = dense["highlevel_dense"]
    ext0 = {"timestep": jnp.ones((n, 1)), "highlevel": hl,
            "noise": jnp.zeros((n, cfg.nt * 2))}
    params = net.init(jax.random.PRNGKey(1), dense, ext0)
    _, feature = net.apply(params, dense, ext0, get_feature=True)

    def apply_fn(ext):
        return net.apply(params, dense, ext, prev_feature=feature)

    states = batch["ego_traj"][:, 0, :4]
    states_flat = jnp.broadcast_to(states[:, None, None],
                                   (bs, cfg.n_randoms, 3, 4)).reshape(n, 4)
    valid = dense["valids_dense"].reshape(-1)
    score_rows = specs.make_score_rows(batch, dense, cfg)
    fl = specs.make_guidance_loss(batch, dense, cfg, states, valid)
    ctx = diffusion.make_guidance_ctx(score_rows, valid, states_flat, fl)
    coeffs = diffusion.get_coeffs(cfg)
    cm_fn = models_net.make_cm_eps_fn(params, dense, hl, feature, cfg)

    # (a) one epsilon prediction, both layouts
    x = jax.random.normal(jax.random.PRNGKey(3), (n, cfg.nt * 2))
    ext = {"timestep": jnp.full((n, 1), 5.0), "highlevel": hl, "noise": x,
           "stlp": dense["stlp_dense"]}
    eps_ref = np.asarray(apply_fn(ext)).reshape(n, cfg.nt * 2)
    eps_cm = fl._from_cand_minor(cm_fn(fl._to_cand_minor(x),
                                       jnp.float32(5.0)))
    np.testing.assert_allclose(np.asarray(eps_cm), eps_ref,
                               rtol=2e-4, atol=2e-4)

    # (b) full reverse scan, pinned layout-independent noise stream
    def pinned_normal(key, shape, dtype=jnp.float32):
        if len(shape) == 4:     # cm request (bs, nt, 2, R)
            return fl._to_cand_minor(
                jax.random.normal(key, (n, cfg.nt * 2), dtype))
        return jax.random.normal(key, shape, dtype)

    monkeypatch.setattr(diffusion, "_normal", pinned_normal)
    key = jax.random.PRNGKey(11)
    c_mm, steps_mm = diffusion.reverse_sample(
        key, apply_fn, dense, hl, feature, cfg, coeffs, n,
        guidance_ctx=ctx, maximize=True)
    c_cm, steps_cm = diffusion.reverse_sample(
        key, apply_fn, dense, hl, feature, cfg, coeffs, n,
        guidance_ctx=ctx, maximize=True, cm_fn=cm_fn)
    np.testing.assert_allclose(np.asarray(c_cm), np.asarray(c_mm),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(steps_cm), np.asarray(steps_mm),
                               rtol=1e-4, atol=1e-4)

    # (c) sel_every carry path
    cfg2 = cfg.with_(guidance_sel_every=2)
    c2_mm, _ = diffusion.reverse_sample(
        key, apply_fn, dense, hl, feature, cfg2, coeffs, n,
        guidance_ctx=ctx, maximize=True)
    c2_cm, _ = diffusion.reverse_sample(
        key, apply_fn, dense, hl, feature, cfg2, coeffs, n,
        guidance_ctx=ctx, maximize=True, cm_fn=cm_fn)
    np.testing.assert_allclose(np.asarray(c2_cm), np.asarray(c2_mm),
                               rtol=1e-4, atol=1e-4)


def test_sample_noise_scale():
    """sample_noise_scale is a pure temperature on the injected noise:
    scale=1 reproduces the default path bit-for-bit; scale=0 makes the
    ancestral sampler deterministic given x0 (mu-only updates); scale>1
    spreads the samples (larger pairwise distances on average)."""
    cfg = small_cfg()
    (apply_fn, dense, feature, states_flat, coeffs, formulas, signal_base,
     ctx, n) = make_sampler_setup(cfg)

    def run(scale, key=7):
        c, _ = diffusion.reverse_sample(
            jax.random.PRNGKey(key), apply_fn, dense,
            dense["highlevel_dense"], feature,
            cfg.with_(sample_noise_scale=scale), coeffs, n)
        return np.asarray(c)

    np.testing.assert_allclose(run(1.0), run(1.0000001), atol=1e-5)
    base = run(1.0)
    hot = run(2.5)
    assert np.abs(hot - base).max() > 1e-4
    # temperature raises candidate spread (diversity proxy)
    def spread(c):
        flat = c.reshape(n, -1)
        return float(np.linalg.norm(flat[:, None] - flat[None], axis=-1).mean())
    assert spread(hot) > spread(run(0.0))
