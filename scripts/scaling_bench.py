"""Multi-chip weak-scaling evidence on the virtual 8-device CPU mesh.

Backs the claim that plan throughput scales linearly across devices with
a measured dispatch-level table: the chunked closed-loop step
sharded over n_dev in {1, 2, 4, 8} with a FIXED per-device scene count
(weak scaling) — ideal scaling keeps the per-dispatch time flat as devices
and total scenes grow together.

CPU devices have no device links, so absolute times are meaningless; what the table
shows is that the program stays pure-DP (no cross-scene collectives in the
plan step — the only reduction is the metric mean at readout), so added
devices add no communication on the hot path.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
       python scripts/scaling_bench.py
"""
import json
import os
import sys
import time

# FORCE the virtual CPU mesh: the device count and the platform are set
# before the first backend initialization.
if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"
                               ).strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

from pstl_tpu import diffusion, sim, specs, train
from pstl_tpu.config import Config
from pstl_tpu.data import synthetic
from pstl_tpu.data.dataset import SceneDataset, batch_iterator
from pstl_tpu.models import Net
from pstl_tpu.parallel import data_sharding, make_mesh

PER_DEV = int(os.environ.get("SCALE_PER_DEV", "2"))
CHUNK = int(os.environ.get("SCALE_CHUNK", "2"))
STEPS = int(os.environ.get("SCALE_STEPS", "4"))
MODE = os.environ.get("SCALE_MODE", "data")  # data | cand

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")


def count_collectives(compiled_text: str):
    """Count collective op DEFINITIONS (one per `= <opcode>(` line).

    Plain substring counting also matches the def's own %name, every
    operand reference, and -start/-done pairs — it inflated the first
    published census ~3x.  Async pairs count once (the -start)."""
    import re
    counts = {op: 0 for op in _COLLECTIVES}
    # the type between '=' and the opcode may be a TUPLE with spaces for
    # async ops: '%cp = (f32[..], u32[]) collective-permute-start(...)'
    pat = re.compile(r"=\s*(?:\([^)]*\)\s*|\S+\s+)?([a-z][a-z\-]*)\(")
    for line in compiled_text.splitlines():
        m = pat.search(line)
        if not m:
            continue
        name = m.group(1)
        if name.endswith("-done"):
            continue                       # async pair: count the -start
        if name.endswith("-start"):
            name = name[:-len("-start")]
        if name in counts:
            counts[name] += 1
    return counts


def main_cand():
    """Candidate-axis (tensor-parallel) strong scaling: ONE scene, the
    R-candidate fan sharded over n_dev devices (parallel.candidate_sharding
    + the constrain_candidates hooks in diffusion.py).  Reports median
    dispatch latency per device count AND the number of collective ops in
    the compiled plan-step program — the point is that the 99-step
    denoise+guidance scan shards cleanly with collectives only at the
    cross-candidate selection/diversity reductions, not per-iteration."""
    from pstl_tpu.parallel import candidate_sharding

    devs = jax.devices()
    cfg = Config(diffusion=True, rect_head=True, diverse_loss=True,
                 multi_cands=2, n_randoms=8, n_neighbors=4, n_shards=2,
                 diffusion_steps=8, guidance=True, guidance_niters=1,
                 compute_dtype="float32",
                 guidance_blend_scores=bool(os.environ.get("SCALE_BLEND")),
                 flex=True).finalize().with_(epochs=1, test=True)
    data = synthetic.generate_dataset(3, 1, cfg, scene_len=30)
    scenes = sim.scenes_from_dataset(data)
    net = Net(cfg)
    ds = SceneDataset({k: v for k, v in data.items()
                       if not k.startswith("scene_")}, cfg)
    sample = next(batch_iterator(ds, "val", 1, shuffle=False,
                                 drop_last=False))
    state = train.init_state(cfg, net, sample, jax.random.PRNGKey(0))
    formulas = specs.build_scorer(cfg)
    coeffs = diffusion.get_coeffs(cfg)
    rows = []
    for n_dev in (1, 2, 4, 8):
        if n_dev > len(devs):
            break
        mesh = make_mesh((n_dev,), ("cand",), devices=devs[:n_dev])
        with candidate_sharding(mesh, "cand"):
            init_carry, step = sim.make_closed_loop_step(
                scenes, cfg, net, state.params, formulas, coeffs,
                chunk=CHUNK)
            c0 = init_carry(jax.random.PRNGKey(0))
            # AOT-compile ONCE and reuse for census + timing (calling the
            # jit wrapper would compile the same program a second time —
            # AOT lowering doesn't populate jit's call cache)
            compiled = step.lower(c0).compile()
            colls = count_collectives(compiled.as_text())
            c = jax.block_until_ready(compiled(c0))
            times = []
            for _ in range(max(STEPS // CHUNK, 3)):
                c = init_carry(jax.random.PRNGKey(1))
                t0 = time.time()
                c = compiled(c)
                jax.block_until_ready(c.ego)
                times.append(time.time() - t0)
        med = sorted(times)[len(times) // 2]
        rows.append({"devices": n_dev,
                     "dispatch_ms": round(med * 1e3, 1),
                     "collectives": {k: v for k, v in colls.items() if v}})
        print(f"# cand n_dev={n_dev} median dispatch {med * 1e3:.1f} ms "
              f"collectives={rows[-1]['collectives']}",
              file=sys.stderr, flush=True)
    base = rows[0]["dispatch_ms"]
    for r in rows:
        r["latency_speedup"] = round(base / r["dispatch_ms"], 3)
    print(json.dumps({"mode": "cand", "chunk": CHUNK, "scenes": 1,
                      "rows": rows}))


def main():
    devs = jax.devices()
    cfg = Config(diffusion=True, rect_head=True, diverse_loss=True,
                 multi_cands=2, n_randoms=4, n_neighbors=4, n_shards=2,
                 diffusion_steps=8, guidance=True, guidance_niters=1,
                 compute_dtype="float32",
                 flex=True).finalize().with_(epochs=1, test=True)
    rows = []
    for n_dev in (1, 2, 4, 8):
        if n_dev > len(devs):
            break
        bs = PER_DEV * n_dev
        data = synthetic.generate_dataset(3, bs, cfg, scene_len=30)
        scenes = sim.scenes_from_dataset(data)
        from jax.sharding import Mesh
        mesh = Mesh(np.array(devs[:n_dev]), ("data",))
        scenes = type(scenes)(*[
            jax.device_put(x, data_sharding(mesh)) if x is not None else None
            for x in scenes])
        net = Net(cfg)
        ds = SceneDataset({k: v for k, v in data.items()
                           if not k.startswith("scene_")}, cfg)
        sample = next(batch_iterator(ds, "train", 2, shuffle=False,
                                     drop_last=False))
        state = train.init_state(cfg, net, sample, jax.random.PRNGKey(0))
        formulas = specs.build_scorer(cfg)
        coeffs = diffusion.get_coeffs(cfg)
        init_carry, step = sim.make_closed_loop_step(
            scenes, cfg, net, state.params, formulas, coeffs, chunk=CHUNK)
        c = jax.block_until_ready(step(init_carry(jax.random.PRNGKey(0))))
        times = []
        for _ in range(max(STEPS // CHUNK, 2)):
            c = init_carry(jax.random.PRNGKey(1))
            t0 = time.time()
            c = step(c)
            jax.block_until_ready(c.ego)
            times.append(time.time() - t0)
        med = sorted(times)[len(times) // 2]
        rows.append({"devices": n_dev, "scenes": bs,
                     "dispatch_ms": round(med * 1e3, 1),
                     "agent_steps_per_dispatch": bs * CHUNK})
        print(f"# n_dev={n_dev} bs={bs} median dispatch "
              f"{med * 1e3:.1f} ms", file=sys.stderr, flush=True)
    base = rows[0]["dispatch_ms"]
    for r in rows:
        r["weak_scaling_eff"] = round(base / r["dispatch_ms"], 3)
    print(json.dumps({"per_device_scenes": PER_DEV, "chunk": CHUNK,
                      "rows": rows}))


if __name__ == "__main__":
    main_cand() if MODE == "cand" else main()
