"""Smoke test of the planner and the trainer on one GPU, at flagship width.

    python chip_smoke.py            # one GPU: phases 0-4, then one JSON line
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Everything runs in this one process: a JAX process reserves most of a
card's memory, so the entry points (``bench``'s contract runner,
``pstl_tpu.cli.main``, ``train.make_train_step``) are called in-process.

Phases (one GPU):

0. environment: the card's ``name, power.limit``, JAX's version and device,
   the compile-cache directory; exits non-zero unless the device is a GPU;
1. reference comparisons at flagship widths, each printed with its
   tolerance and matmul precision;
2. the ``heavy``, ``parity`` and ``parity_nog`` closed-loop contracts with
   the committed ``e7_round5`` weights at bench sizes;
3. ``cli sim --preset ours_guidance --ckpt checkpoints/e7_round5``;
4. three ``e7_ours`` train steps from ``e5b_round5`` at the preset's batch.

``--multi`` runs one data-parallel train step on a 4-device ``data`` mesh
against the same step on one device, and one replanning step and one
closed-loop chunk on a 2x2 ``data`` x ``cand`` mesh against the unsharded
ones.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the process exits non-zero and prints no such
line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

E7_CKPT = os.path.join(ROOT, "checkpoints", "e7_round5")
E5B_CKPT = os.path.join(ROOT, "checkpoints", "e5b_round5")
CONTRACTS = ("heavy", "parity", "parity_nog")
# Share of guided-step entries where the candidate-minor loop and the
# row-major path may differ by more than 1e-3: with exact selections on
# both sides, and with the production's frozen selections and coarse
# clearance pair on the candidate-minor side.
GUIDED_EXACT_TOL = 0.002
GUIDED_FROZEN_TOL = 0.005
# STL parameters under which the clearance and heading terms bind
# (v_min, v_max, d_min, d_max, d_safe = 8 m, theta_max).
CAUTIOUS_STLP = (1.0, 9.0, -3.0, 2.0, 8.0, 0.2)
# bf16-sized bound for comparing two runs of the planner or the trainer
# whose matmuls round in another order.
BF16_TOL = 2e-2


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Widths and run lengths.  The defaults are the flagship e7 policy at
    bench sizes; tests shrink them to run the same phases on a CPU."""
    bs: int = 16                   # closed-loop scenes
    n_randoms: int = 64            # candidates per (scene, maneuver)
    n_neighbors: int = 8
    diffusion_steps: int = 100
    chunk: int = 8                 # replanning steps per dispatch
    dispatches: int = 4            # timed dispatches per contract
    cli_scenes: int = 4
    cli_steps: int = 8
    train_batch: int = 0           # 0: the preset's batch size
    train_steps: int = 3
    multi_train_batch: int = 32
    check_quality: bool = True     # compliance/collision limits (flagship)

    def cfg(self, cfg):
        return cfg.with_(n_randoms=self.n_randoms,
                         n_neighbors=self.n_neighbors,
                         diffusion_steps=self.diffusion_steps)


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"== {name}")
    t0 = time.time()
    yield
    log(f"   {name}: done in {time.time() - t0:.1f} s")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def faults(*conds) -> list:
    """The descriptions of the ``(ok, what)`` pairs that failed."""
    return [what for ok, what in conds if not ok]


def max_rel(a, b) -> float:
    """max |a - b| over max |b|."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def environment(n_devices: int):
    """Print the card and JAX's view of it; SystemExit off a GPU."""
    import jax
    from pstl_tpu.utils import device

    cache = device.configure_compile_cache()
    info = device.require_gpu()
    card = device.gpu_card()
    log(card)
    log(f"jax {jax.__version__}: platform={info['platform']} "
        f"kind={info['kind']} count={info['count']} compile_cache={cache}")
    check(info["count"] >= n_devices,
          f"needs {n_devices} GPUs, JAX has {info['count']}")
    return info, card


# ---------------------------------------------------------------------------
# phase 1: reference comparisons
# ---------------------------------------------------------------------------

def planner_inputs(cfg, scenes, stlp=None):
    """The planner's first-step inputs: observation, densified batch, start
    states, validity — built the way ``sim.make_planner`` builds them, with
    the STL parameters ``stlp`` (default: the planner's aggressive set)."""
    import jax
    import jax.numpy as jnp
    from pstl_tpu import sim, specs

    bs = scenes.ego_full.shape[0]
    n = bs * cfg.n_randoms * 3
    obs = jax.vmap(lambda s, e, t: sim.observe(s, e, t, cfg))(
        scenes, scenes.ego_full[:, 0], jnp.zeros((bs,), jnp.int32))
    stlp = jnp.asarray(sim.AGGRESSIVE_STLP if stlp is None else stlp)
    dense = specs.densify_batch(obs, jnp.broadcast_to(stlp, (bs, 6)), cfg,
                                key=jax.random.PRNGKey(2),
                                stlp_dense=jnp.broadcast_to(stlp, (n, 1, 6)))
    states = obs["ego_traj"][:, 0, :4]
    return obs, dense, states, dense["valids_dense"].reshape(-1)


def guided_step_diff(cfg, obs, dense, states, valid, seed: int = 4,
                     t: int = 50, scale: float = 0.5):
    """One guided denoise step at timestep ``t`` from a random mu of
    standard deviation ``scale``: the
    candidate-minor XLA loop against the row-major loss path, both under
    ``highest``.  Returns the fraction of entries off by more than 1e-3,
    the 99th percentile of |d| and the fraction the step moved."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pstl_tpu import diffusion, specs

    bs, M = states.shape[0], cfg.n_randoms
    n = bs * M * 3
    fused = specs.make_guidance_loss(obs, dense, cfg, states, valid)
    score_rows = specs.make_score_rows(obs, dense, cfg)
    states_flat = jnp.broadcast_to(states[:, None, None],
                                   (bs, M, 3, 4)).reshape(n, 4)
    beta = diffusion.get_coeffs(cfg).beta[t]
    mu = scale * jax.random.normal(jax.random.PRNGKey(seed),
                                   (n, cfg.nt * 2))
    ctx_cm = diffusion.make_guidance_ctx(score_rows, valid, states_flat,
                                         fused)
    ctx_rm = diffusion.make_guidance_ctx(score_rows, valid, states_flat)
    step_cm = jax.jit(lambda m: fused._from_cand_minor(
        diffusion._guidance_step(m, beta, ctx_cm, cfg, True,
                                 mu_cm=fused._to_cand_minor(m),
                                 cm_io=True)))
    step_rm = jax.jit(lambda m: diffusion._guidance_step(
        m, beta, ctx_rm, cfg, True))
    with jax.default_matmul_precision("highest"):
        g_cm, g_rm = np.asarray(step_cm(mu)), np.asarray(step_rm(mu))
    d = np.abs(g_cm - g_rm)
    return {"frac": float(np.mean(d > 1e-3)),
            "p99": float(np.quantile(d, 0.99)),
            "moved": float(np.mean(np.abs(g_rm - np.asarray(mu)) > 1e-6))}


def guided_comparisons(cfg, scenes, seed: int = 4) -> dict:
    """Phase 1's guided-step comparisons, ``{name: (readings,
    tolerance)}``: exact selections on an input where the lane and speed
    terms bind and on one where the clearance and heading terms bind, then
    the production's frozen selections."""
    import numpy as np

    exact = cfg.with_(guidance_reuse_selection=False,
                      clearance_coarse_pair=False)
    lane = planner_inputs(cfg, scenes)
    safe = planner_inputs(cfg, scenes, np.asarray(CAUTIOUS_STLP, np.float32))
    return {
        "exact selection, aggressive STL, mu sd 0.5": (
            guided_step_diff(exact, *lane, seed=seed), GUIDED_EXACT_TOL),
        "exact selection, d_safe 8 m, mu sd 0.05": (
            guided_step_diff(exact, *safe, seed=seed, scale=0.05),
            GUIDED_EXACT_TOL),
        "frozen selection, aggressive STL, mu sd 0.5": (
            guided_step_diff(cfg, *lane, seed=seed), GUIDED_FROZEN_TOL),
    }


def references(sizes: Sizes, scenes, cfg) -> None:
    """Phase 1: eps network, guided step and selection gathers against
    their plain references."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pstl_tpu import specs
    from pstl_tpu.models import Net
    from pstl_tpu.models.net import make_cm_eps_fn
    from pstl_tpu.ops import geometry as geom

    import bench

    _, params = bench.load_planner(cfg, scenes, E7_CKPT)
    obs, dense, states, valid = planner_inputs(cfg, scenes)
    bs, M = states.shape[0], cfg.n_randoms
    n = bs * M * 3
    hl = dense["highlevel_dense"]
    fused = specs.make_guidance_loss(obs, dense, cfg, states, valid)
    x = jax.random.normal(jax.random.PRNGKey(3), (n, cfg.nt * 2))
    t = 50
    ext0 = {"timestep": jnp.ones((n, 1)), "highlevel": hl,
            "noise": jnp.zeros((n, cfg.nt * 2))}
    ext = {"timestep": jnp.full((n, 1), float(t)), "highlevel": hl,
           "noise": x}

    def eps_pair(c):
        """(row-major Net.apply eps, candidate-minor eps) under ``c``."""
        net_c = Net(c)

        @jax.jit
        def run(params, x_cm):
            _, feature = net_c.apply(params, dense, ext0, get_feature=True)
            ref = net_c.apply(params, dense, ext, prev_feature=feature)
            cm_fn = make_cm_eps_fn(params, dense, hl, feature, c)
            return (ref.reshape(n, -1),
                    fused._from_cand_minor(cm_fn(x_cm, jnp.float32(t))))

        return run(params, fused._to_cand_minor(x))

    # (a) the candidate-minor eps network against Net.apply, both fp32
    cfg32 = cfg.with_(compute_dtype="float32")
    with jax.default_matmul_precision("highest"):
        ref32, cm32 = eps_pair(cfg32)
    err = max_rel(cm32, ref32)
    log(f"   eps cm vs Net.apply: fp32, precision=highest: "
        f"max|d|/max|ref| = {err:.2e} (tolerance 1e-5)")
    check(err <= 1e-5, "candidate-minor eps differs from Net.apply")

    # (b) the production bf16 eps (the MLP output, eps - x) against fp32
    _, cm_bf = eps_pair(cfg)
    num = float(jnp.linalg.norm((cm_bf - x) - (ref32 - x)))
    rel = num / float(jnp.linalg.norm(ref32 - x))
    log(f"   eps bf16 ({cfg.compute_dtype} matmuls) vs fp32 reference: "
        f"||d||/||ref|| = {rel:.2e} (tolerance {BF16_TOL})")
    check(rel <= BF16_TOL, "bf16 eps too far from the fp32 reference")

    # (c) one guided denoise step: candidate-minor XLA loop vs row-major
    for name, (g, tol) in guided_comparisons(cfg, scenes).items():
        log(f"   guided step ({cfg.guidance_niters} Adam iterations) cm vs "
            f"row-major, {name}, precision=highest: entries off by > 1e-3: "
            f"{g['frac']:.4f} (tolerance {tol}), p99|d| {g['p99']:.2e}; "
            f"entries moved {g['moved']:.3f}")
        check(g["frac"] <= tol, f"candidate-minor guided step differs "
                                f"from the row-major step ({name})")
        check(g["moved"] > 0.1, f"the guided step moved nothing ({name})")

    # (d) selection gathers and clearances against a host numpy gather
    def host_eq(dev, want, what):
        diff = float(np.abs(np.asarray(dev, np.float64) - want).max())
        log(f"   {what}: max|device - host gather| = {diff:.1e} "
            f"(tolerance 1e-6)")
        check(diff <= 1e-6, f"{what} differs from the host gather")

    @jax.jit
    def selections(mu):
        x_s, y_s, _, _, cth, sth = fused._rollout(fused._to_cand_minor(mu))
        mi = fused._lane_argmin(x_s, y_s)
        ie, inn = fused._clear_pair(x_s, y_s, cth, sth)
        csel = fused._clear_gather(ie, inn)
        return (x_s, y_s, cth, sth, mi, fused._lane_gather(mi), ie, inn,
                csel, fused._clear_mnd(x_s, y_s, cth, sth, csel))

    mu = 0.5 * jax.random.normal(jax.random.PRNGKey(4), (n, cfg.nt * 2))
    x_s, y_s, cth, sth, mi, lsel, ie, inn, csel, mnd = jax.device_get(
        selections(mu))
    pay = np.asarray(fused.lane_payload_g, np.float64)    # (bs,5,S-1,R)
    want = np.take_along_axis(pay[:, :, None], mi[:, None, :, None],
                              axis=3)[:, :, :, 0]
    for c, k in enumerate(("x2", "y2", "th2", "x3", "y3")):
        host_eq(lsel[k], want[:, c], f"lane gather {k}")
    nxh, nyh = (np.asarray(v, np.float64) for v in (fused.nx, fused.ny))
    axe = np.asarray(fused.axe, np.float64)
    host_eq(csel["axe"], axe[ie], "ego-disc gather")
    host_eq(csel["nx"], np.take_along_axis(nxh, inn, axis=3),
            "neighbor-disc gather x")
    host_eq(csel["ny"], np.take_along_axis(nyh, inn, axis=3),
            "neighbor-disc gather y")
    # frozen-pair clearance, recomputed on the host in float64
    xs, ys, ct, st = (np.asarray(v, np.float64) for v in (x_s, y_s, cth, sth))
    ex = xs[:, None] + axe[ie] * ct[:, None]
    ey = ys[:, None] + axe[ie] * st[:, None]
    d2 = ((ex - np.take_along_axis(nxh, inn, axis=3)) ** 2
          + (ey - np.take_along_axis(nyh, inn, axis=3)) ** 2)
    per = (np.sqrt(d2 + 1e-12) - fused.re
           - np.asarray(fused.rn, np.float64)[..., None])
    vk = np.asarray(fused.nvalid, np.float64)[..., None]
    mnd_h = np.min(np.clip(per, -5, 20) * vk + (1 - vk) * 100.0, axis=1)
    err = float(np.abs(mnd - mnd_h).max() / max(np.abs(mnd_h).max(), 1.0))
    log(f"   frozen-pair clearance vs host float64: max|d|/max|ref| = "
        f"{err:.1e} (tolerance 1e-6)")
    check(err <= 1e-6, "clearance differs from the host recomputation")
    # lane-segment endpoints of the scorer at map coordinates 1e3 m out
    off = jnp.asarray([1e3, 1e3, 0.0])
    pts = (obs["ego_traj"][:, None, :, :3] + off).repeat(3, axis=1)
    lanes = jnp.stack([obs["currlane_wpts"], obs["leftlane_wpts"],
                       obs["rightlane_wpts"]], axis=1) + off
    idx, p2 = jax.device_get(jax.jit(lambda p, l: (
        geom.segment_argmin(p, l),
        geom.take_rows(l[..., :-1, :], geom.segment_argmin(p, l))))(
            pts, lanes))
    want = np.take_along_axis(np.asarray(lanes, np.float64)[..., :-1, :],
                              idx[..., None], axis=-2)
    host_eq(p2, want, "polyline endpoint gather at +1e3 m")


# ---------------------------------------------------------------------------
# phases 2-4
# ---------------------------------------------------------------------------

def closed_loop(sizes: Sizes, scenes, card: str) -> None:
    """Phase 2: the three bench contracts through sim.make_closed_loop_step."""
    import bench

    for mode in CONTRACTS:
        cfg = sizes.cfg(bench.build_cfg(mode))
        sps, d = bench.measure(cfg, scenes, sizes.bs,
                               sizes.dispatches * sizes.chunk, sizes.chunk,
                               E7_CKPT)
        log(f"   {mode}: compile {d['compile_s']} s, dispatch p50 "
            f"{d['dispatch_p50_s']} s ({d['n_dispatches']} dispatches of "
            f"{sizes.chunk} steps x {sizes.bs} scenes), {sps:.1f} "
            f"agent-steps/s on {card}; peak_bytes_in_use "
            f"{d['peak_bytes_in_use']}; compliance {d['stl_compliance']}, "
            f"collision {d['collide_rate']}, out-of-lane "
            f"{d['out_of_lane_rate']}")
        if sizes.check_quality:
            check(d["collide_rate"] == 0 and d["out_of_lane_rate"] == 0,
                  f"{mode}: collision or out-of-lane")
            if mode == "heavy":
                check(d["stl_compliance"] >= 0.90,
                      f"heavy: compliance {d['stl_compliance']} < 0.90")


def cli_sim(sizes: Sizes) -> None:
    """Phase 3: ``cli sim`` on a few synthetic scenes, in-process."""
    import math

    from pstl_tpu import cli

    argv = ["sim", "--preset", "ours_guidance", "--ckpt", E7_CKPT,
            "--scenes", str(sizes.cli_scenes), "--steps",
            str(sizes.cli_steps), "--set",
            f"n_randoms={sizes.n_randoms}",
            f"n_neighbors={sizes.n_neighbors}",
            f"diffusion_steps={sizes.diffusion_steps}"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    res = json.loads(out.getvalue())
    log(f"   cli {' '.join(argv[:5])}: {json.dumps(res)}")
    check(all(math.isfinite(v) for v in res.values()),
          "cli sim printed a non-finite metric")
    check(res["traj_len"] > 0, "cli sim ran no steps")


def train_batch(cfg, batch_size: int):
    """One training batch of ``batch_size`` synthetic scenes (random
    trajopt controls stand in for the augmentation pass)."""
    import jax.numpy as jnp
    from pstl_tpu.data.dataset import SceneDataset, batch_iterator

    ds = SceneDataset.from_synthetic(
        cfg, n_scenes=int(batch_size / cfg.train_ratio) + 2)
    ds.ensure_random_params(0)
    b = next(batch_iterator(ds, "train", batch_size, shuffle=False))
    return {k: jnp.asarray(v) for k, v in b.items()
            if not k.startswith(("scene_", "traj_i", "ti"))}


def train_setup(cfg, batch):
    """``train.train``'s set-up: init, pretrained load, optimizer."""
    import jax
    from pstl_tpu import diffusion, specs, train
    from pstl_tpu.models import Net

    net = Net(cfg)
    state = train.init_state(cfg, net, batch, jax.random.PRNGKey(0))
    state = train.load_params_only(cfg.net_pretrained_path, state)
    opt = train.make_optimizer(cfg, state.params)
    state = train.TrainState(state.params, opt.init(state.params),
                             state.step)
    step = train.make_train_step(cfg, net, specs.build_scorer(cfg),
                                 diffusion.get_coeffs(cfg), opt)
    return state, step


def trainer(sizes: Sizes) -> None:
    """Phase 4: e7_ours train steps from the e5b base; only the RefineNet
    head may move."""
    import jax
    import numpy as np
    from pstl_tpu.config import PRESETS

    cfg = sizes.cfg(PRESETS["e7_ours"]).with_(net_pretrained_path=E5B_CKPT)
    if sizes.train_batch:
        cfg = cfg.with_(batch_size=sizes.train_batch)
    batch = train_batch(cfg, cfg.batch_size)
    state0, step = train_setup(cfg, batch)
    state, key, losses = state0, jax.random.PRNGKey(1), []
    for i in range(sizes.train_steps):
        key, k = jax.random.split(key)
        t0 = time.time()
        state, rd = step(state, batch, k)
        losses.append(float(rd["loss"]))
        log(f"   train step {i}: loss {losses[-1]:.5f} acc "
            f"{float(rd['acc']):.3f} ({time.time() - t0:.1f} s, batch "
            f"{cfg.batch_size})")
    check(bool(np.isfinite(losses).all()), "non-finite training loss")
    moved = set()
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(state0.params)[0],
            jax.tree_util.tree_leaves(state.params)):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            moved.add(path[1].key)
    log(f"   heads that moved: {sorted(moved)} (may: rect_net, merge_net)")
    check(moved <= {"rect_net", "merge_net"},
          f"train steps moved {sorted(moved)}, not only the RefineNet head")
    if sizes.check_quality:
        check(bool(moved), "train steps moved no parameter")


# ---------------------------------------------------------------------------
# --multi: four devices
# ---------------------------------------------------------------------------

def adam_moments(opt_state):
    """Adam's first moments by leaf path.  One step from ``opt.init``
    leaves (1 - b1) times the gradient there."""
    import jax
    import numpy as np
    import optax

    is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)
    return {jax.tree_util.keystr(path): np.asarray(v, np.float64)
            for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam)
            if is_adam(s)
            for path, v in jax.tree_util.tree_flatten_with_path(s.mu)[0]}


def dp_step_faults(one, sharded) -> list:
    """One train step from the same state, ``(state, metrics)`` on one
    device and on the data mesh: the loss, the gradient of every trained
    leaf (read from Adam's first moment) and the parameters must agree.
    Prints the readings; returns what disagrees."""
    import jax
    import numpy as np

    (s1, rd1), (s4, rd4) = one, sharded
    l1, l4 = float(rd1["loss"]), float(rd4["loss"])
    g1, g4 = adam_moments(s1.opt_state), adam_moments(s4.opt_state)
    check(bool(g1) and g1.keys() == g4.keys(), "no Adam moments to compare")
    grad_d = max(float(np.linalg.norm(g4[k] - g1[k])
                       / max(np.linalg.norm(g1[k]), 1e-30)) for k in g1)
    dp = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
             for a, b in zip(jax.tree_util.tree_leaves(s1.params),
                             jax.tree_util.tree_leaves(s4.params)))
    log(f"   train step vs one device: loss {l4:.6f} vs {l1:.6f} (rel "
        f"tolerance 1e-3); gradient, worst of {len(g1)} leaves: "
        f"||d||/||ref|| = {grad_d:.2e} (tolerance {BF16_TOL}); "
        f"max|param d| {dp:.2e} (tolerance 1e-5)")
    return faults(
        (abs(l4 - l1) <= 1e-3 * max(abs(l1), 1e-6),
         "data-parallel loss differs from the one-device loss"),
        (grad_d <= BF16_TOL,
         "data-parallel gradient differs from the one-device gradient"),
        (dp <= 1e-5,
         "data-parallel parameters differ from the one-device step"))


def plan_step_faults(one, sharded) -> list:
    """One replanning step from the same carry, ``(carry, info)`` on one
    device and on the mesh.  The mesh must pick, per scene, the argmax of
    its own lane-keep scores over all candidates (exact); candidates and
    scores must agree at a bf16-sized bound; and where a scene picks
    another candidate, that candidate must score within that bound of the
    one-device pick on one device (a near-tie).
    Prints the readings; returns what disagrees."""
    import numpy as np

    (c1, i1), (c4, i4) = one, sharded
    ks1 = np.asarray(i1["keep_scores"], np.float64)
    ks4 = np.asarray(i4["keep_scores"], np.float64)
    bs, R = ks1.shape
    best1, best4 = np.asarray(i1["best"]), np.asarray(i4["best"])
    tr4 = np.asarray(i4["trajs"]).reshape(bs, R, *i4["trajs"].shape[1:])
    global_pick = (np.array_equal(best4, ks4.argmax(axis=1))
                   and np.array_equal(np.asarray(i4["plan_traj"]),
                                      tr4[np.arange(bs), best4]))
    u1 = np.asarray(i1["controls"], np.float64).reshape(bs, R, -1)
    u4 = np.asarray(i4["controls"], np.float64).reshape(bs, R, -1)
    cand_d = np.abs(u4 - u1).max(axis=-1) / np.abs(u1).max()
    keep = np.arange(R) % 3 == 0          # lane-keep columns, (M, 3) flat
    score_d = np.abs(ks4 - ks1)[:, keep]
    top2 = np.sort(ks1[:, keep], axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    rows = np.arange(bs)
    gap = ks1[rows, best1] - ks1[rows, best4]   # one-device score lost
    flips = np.flatnonzero(best1 != best4)
    ego_d = np.abs(np.asarray(c4.ego) - np.asarray(c1.ego)).max(axis=-1)
    q = lambda v: "/".join(f"{x:.1e}" for x in
                           np.quantile(v, [0.5, 0.9, 1.0]))
    log(f"   one plan step vs one device: candidates max|d|/max|u| "
        f"p50/p90/max {q(cand_d)} (p50 tolerance {BF16_TOL}); lane-keep "
        f"score |d| p50/p90/max {q(score_d)} (p50 tolerance {BF16_TOL}); "
        f"top-2 margins p50/min {np.median(margin):.1e}/{margin.min():.1e}; "
        f"picks differ in {len(flips)}/{bs} scenes; ego after the step "
        f"max|d| {ego_d.max():.1e}")
    for i in flips:
        log(f"     scene {i}: pick {best1[i]} -> {best4[i]}, top-2 margin "
            f"{margin[i]:.2e}, one-device score gap {gap[i]:.2e}, score d "
            f"at the two picks "
            f"{abs(ks4[i, best1[i]] - ks1[i, best1[i]]):.2e} / "
            f"{abs(ks4[i, best4[i]] - ks1[i, best4[i]]):.2e}")
    return faults(
        (global_pick, "the mesh's pick is not the argmax over all "
                      "candidates"),
        (np.median(cand_d) <= BF16_TOL,
         "sharded candidates differ from the unsharded ones"),
        (np.median(score_d) <= BF16_TOL,
         "sharded candidate scores differ from the unsharded ones"),
        (bool(np.all(gap <= BF16_TOL)),
         "a scene picked a candidate clearly worse than the one-device "
         "pick"))


def multi(sizes: Sizes, scenes) -> None:
    """Data-parallel train step, and a 2x2 closed-loop step and chunk,
    each against the same computation on one device."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from pstl_tpu import diffusion, sim, specs
    from pstl_tpu.config import PRESETS
    from pstl_tpu.parallel import (candidate_sharding, data_sharding,
                                   replicate, shard_batch)

    import bench

    devs = jax.devices()[:4]
    # (a) one train step: 4-device data mesh vs device 0
    cfg = sizes.cfg(PRESETS["e7_ours"]).with_(
        net_pretrained_path=E5B_CKPT, batch_size=sizes.multi_train_batch)
    batch = train_batch(cfg, cfg.batch_size)
    state, step = train_setup(cfg, batch)
    key = jax.random.PRNGKey(1)
    one = step(*jax.device_put((state, batch), devs[0]), key)
    mesh = Mesh(np.asarray(devs), ("data",))
    log(f"   data mesh {dict(mesh.shape)}, batch {cfg.batch_size}")
    found = dp_step_faults(one, step(jax.device_put(state, replicate(mesh)),
                                     shard_batch(batch, mesh), key))

    # (b) the heavy closed loop: 2x2 data x cand mesh vs unsharded
    cfg = sizes.cfg(bench.build_cfg("heavy"))
    net, params = bench.load_planner(cfg, scenes, E7_CKPT)
    formulas, coeffs = specs.build_scorer(cfg), diffusion.get_coeffs(cfg)
    mesh2 = Mesh(np.asarray(devs).reshape(2, 2), ("data", "cand"))
    scenes2 = type(scenes)(*[
        None if v is None else jax.device_put(v, data_sharding(mesh2))
        for v in scenes])

    def pair(**kw):
        """The same program from the same carry, on device 0 and on the
        2x2 mesh, fetched to the host."""
        init, step = sim.make_closed_loop_step(
            scenes, cfg, net, params, formulas, coeffs, **kw)
        out1 = jax.device_get(step(jax.device_put(
            init(jax.random.PRNGKey(0)), devs[0])))
        with candidate_sharding(mesh2, "cand"):
            init2, step2 = sim.make_closed_loop_step(
                scenes2, cfg, net, params, formulas, coeffs, **kw)
            out4 = jax.device_get(step2(init2(jax.random.PRNGKey(0))))
        return out1, out4

    log(f"   mesh {dict(mesh2.shape)}, heavy, {sizes.bs} scenes")
    found += plan_step_faults(*pair(with_info=True))
    # Over a chunk, a pick that flips on a tie sends a scene down another
    # path, so the chunk is held to the episode metrics; the scene-level
    # agreement is reported.
    c1, c4 = pair(chunk=sizes.chunk)
    ego_d = np.abs(np.asarray(c4.ego) - np.asarray(c1.ego)).max(axis=-1)
    m1, m4 = (jax.tree_util.tree_map(lambda v: float(np.mean(v)),
                                     sim._carry_metrics(c))
              for c in (c1, c4))
    log(f"   closed-loop chunk ({sizes.chunk} steps) vs one device: "
        f"compliance {m4['stl_acc']:.3f} vs {m1['stl_acc']:.3f} (tolerance "
        f"0.05), progress {m4['progress']:.2f} vs {m1['progress']:.2f} m "
        f"(tolerance 10 %), collision {m4['collide']} vs {m1['collide']}, "
        f"out-of-lane {m4['out_of_lane']} vs {m1['out_of_lane']}; scenes "
        f"with ego within 1e-3: {int(np.sum(ego_d <= 1e-3))}/{len(ego_d)}")
    found += faults((m4["collide"] == m1["collide"]
                     and m4["out_of_lane"] == m1["out_of_lane"]
                     and abs(m4["stl_acc"] - m1["stl_acc"]) <= 0.05
                     and abs(m4["progress"] - m1["progress"])
                     <= 0.1 * max(m1["progress"], 1e-6),
                     "sharded closed-loop metrics differ from the "
                     "unsharded ones"))
    check(not found, "; ".join(found))


# ---------------------------------------------------------------------------

def run(sizes: Sizes, multi_only: bool = False, card: str = "") -> None:
    """Phases 1-4 (or the ``--multi`` path) on JAX's current devices."""
    from pstl_tpu import sim
    from pstl_tpu.data import synthetic

    import bench

    cfg = sizes.cfg(bench.build_cfg("heavy"))
    scenes = sim.scenes_from_dataset(
        synthetic.generate_dataset(0, sizes.bs, cfg, scene_len=38))
    if multi_only:
        with phase("multi: 4-device paths vs one device"):
            multi(sizes, scenes)
        return
    with phase("1 references at flagship widths"):
        references(sizes, scenes, cfg)
    with phase("2 closed loop: heavy, parity, parity_nog"):
        closed_loop(sizes, scenes, card)
    with phase("3 cli sim"):
        cli_sim(sizes)
    with phase("4 trainer: e7_ours from e5b_round5"):
        trainer(sizes)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="only the 4-GPU paths and what they are compared "
                        "with")
    args = p.parse_args(argv)
    n_dev = 4 if args.multi else 1
    with phase("0 environment"):
        info, card = environment(n_dev)
    run(Sizes(), multi_only=args.multi, card=card)
    log(card)
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()
