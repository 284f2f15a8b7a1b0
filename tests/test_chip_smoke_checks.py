"""``chip_smoke.py``'s comparisons catch the faults they are meant to: a
term missing from the candidate-minor guidance loss, a gradient that was
not reduced across the data mesh, and a sharded planner that picks among
its own shard's candidates only."""

import dataclasses
import importlib.util
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import chip_smoke
from tests.test_chip_smoke import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _readings_script():
    spec = importlib.util.spec_from_file_location(
        "guided_step_readings",
        os.path.join(ROOT, "scripts", "guided_step_readings.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", ["no clearance term", "no heading term",
                                   "no lane-distance term"])
def test_guided_comparison_catches_missing_loss_term(monkeypatch, fault):
    """With one term taken out of the candidate-minor loss, some guided-step
    comparison of phase 1 exceeds its tolerance."""
    import bench
    from pstl_tpu import sim
    from pstl_tpu.data import synthetic
    from pstl_tpu.ops.guidance_loss import CandMinorGuidanceLoss

    sizes = chip_smoke.Sizes(bs=4, n_randoms=8)
    cfg = sizes.cfg(bench.build_cfg("heavy"))
    scenes = sim.scenes_from_dataset(
        synthetic.generate_dataset(0, sizes.bs, cfg, scene_len=38))
    attr, fn = _readings_script().planted_faults()[fault]
    monkeypatch.setattr(CandMinorGuidanceLoss, attr, fn)
    got = chip_smoke.guided_comparisons(cfg, scenes)
    assert any(g["frac"] > tol for g, tol in got.values()), got


def test_dp_check_catches_a_shard_local_gradient():
    """A step that trained on one shard's quarter of the batch, reported
    with the full batch's loss (a missing gradient all-reduce), fails the
    gradient and parameter checks; the same step twice passes.  (At the
    full T=100 of the e5b base the RefineNet head gets a gradient; at
    TINY's 6 steps it gets none.)"""
    from pstl_tpu.config import PRESETS

    sizes = dataclasses.replace(TINY, diffusion_steps=100)
    cfg = sizes.cfg(PRESETS["e7_ours"]).with_(
        net_pretrained_path=chip_smoke.E5B_CKPT,
        batch_size=sizes.multi_train_batch)
    batch = chip_smoke.train_batch(cfg, cfg.batch_size)
    state, step = chip_smoke.train_setup(cfg, batch)
    key = jax.random.PRNGKey(1)
    one = step(state, batch, key)
    quarter = {k: v[:cfg.batch_size // 4] for k, v in batch.items()}
    local, _ = step(state, quarter, key)
    assert chip_smoke.adam_moments(one[0].opt_state)
    assert chip_smoke.dp_step_faults(one, one) == []
    found = chip_smoke.dp_step_faults(one, (local, one[1]))
    assert any("gradient" in f for f in found), found
    assert any("parameters" in f for f in found), found


def _plan_step(keep_scores, best, rng, nt=4):
    """A ``(carry, info)`` pair shaped like ``sim``'s planner info."""
    bs, R = keep_scores.shape
    trajs = rng.normal(size=(bs * R, nt + 1, 4))
    info = {"keep_scores": keep_scores, "best": best,
            "controls": rng.normal(size=(bs * R, nt, 2)), "trajs": trajs,
            "plan_traj": trajs.reshape(bs, R, nt + 1, 4)[np.arange(bs),
                                                         best]}
    return SimpleNamespace(ego=np.zeros((bs, 4))), info


def _planted(case, one):
    """The mesh's ``(carry, info)`` for the named case."""
    c1, i1 = one
    ks = i1["keep_scores"].copy()
    bs, R = ks.shape
    info = dict(i1)
    if case == "tie flip":               # the top two, 1e-3 apart, swap
        ks[np.arange(bs), i1["best"]] -= 2e-3
    elif case == "shard-local argmax":   # argmax over cand shard 0 only
        info["best"] = ks[:, :R // 2].argmax(axis=1)
    elif case == "clear flip":           # picks one that scored <= 1
        ks[:, 0] = 5.0
    elif case == "lost shard":           # cand shard 1 came back wrong
        info["controls"] = info["controls"].reshape(bs, R, -1).copy()
        info["controls"][:, R // 2:] = 0.0
        info["controls"] = info["controls"].reshape(bs * R, *i1[
            "controls"].shape[1:])
        ks[:, R // 2:] = np.where(ks[:, R // 2:] > -5000, -1.0,
                                  ks[:, R // 2:])
    info["keep_scores"] = ks
    if case != "shard-local argmax":
        info["best"] = ks.argmax(axis=1)
    trajs = info["trajs"].reshape(bs, R, *info["trajs"].shape[1:])
    info["plan_traj"] = trajs[np.arange(bs), info["best"]]
    return c1, info


@pytest.mark.parametrize("case, want", [
    ("same", []),
    ("tie flip", []),
    ("shard-local argmax", ["argmax over all candidates", "clearly worse"]),
    ("clear flip", ["clearly worse"]),
    ("lost shard", ["candidates differ", "scores differ", "clearly worse"]),
])
def test_plan_step_check(case, want):
    """``plan_step_faults`` passes a bit-identical step and a swap of
    two near-tied candidates, and names each planted sharding fault."""
    rng = np.random.default_rng(0)
    bs, M = 2, 8
    ks = np.full((bs, M * 3), -10000.0)
    ks[:, ::3] = rng.uniform(0.0, 1.0, size=(bs, M))
    # the two best lane-keep candidates, in cand shard 1, 1e-3 apart
    ks[:, -3] = 2.0
    ks[:, -6] = 2.0 - 1e-3
    one = _plan_step(ks, ks.argmax(axis=1), rng)
    found = chip_smoke.plan_step_faults(one, _planted(case, one))
    assert len(found) == len(want), found
    for w in want:
        assert any(w in f for f in found), (w, found)
