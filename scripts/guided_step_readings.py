"""Readings behind ``chip_smoke``'s guided-step tolerance.

Runs the phase-1 comparisons (one guided denoise step: the
candidate-minor XLA loop against the row-major loss path, both under
``highest``; see ``chip_smoke.guided_comparisons``) on several seeds of
mu, and then with one term taken out of the candidate-minor loss, a
planted fault the comparisons must catch.

    python scripts/guided_step_readings.py            # flagship widths
    python scripts/guided_step_readings.py --small    # CPU-sized

Prints one line per run and comparison: seed or fault, share of entries
off by > 1e-3 against its tolerance, 99th percentile of |d|, share of
entries the step moved.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def planted_faults():
    """{name: (method name, replacement)} of CandMinorGuidanceLoss, each
    dropping one term of the candidate-minor loss."""
    import jax.numpy as jnp
    from pstl_tpu.ops.guidance_loss import CandMinorGuidanceLoss as C

    lane_terms = C._lane_terms

    def no_heading(self, *a):
        d, th = lane_terms(self, *a)
        return d, jnp.zeros_like(th)

    def no_lane_distance(self, *a):
        d, th = lane_terms(self, *a)
        return jnp.zeros_like(d), th

    return {
        "no clearance term": (
            "_clear_mnd", lambda self, x_s, *a: jnp.full_like(x_s, 100.0)),
        "no heading term": ("_lane_terms", no_heading),
        "no lane-distance term": ("_lane_terms", no_lane_distance),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--small", action="store_true",
                   help="4 scenes x 8 candidates x 3 maneuvers")
    p.add_argument("--seeds", type=int, default=5)
    args = p.parse_args(argv)

    from pstl_tpu import sim
    from pstl_tpu.data import synthetic
    from pstl_tpu.ops.guidance_loss import CandMinorGuidanceLoss
    from pstl_tpu.utils import device

    import bench
    import chip_smoke

    device.configure_compile_cache()
    sizes = (chip_smoke.Sizes(bs=4, n_randoms=8) if args.small
             else chip_smoke.Sizes())
    cfg = sizes.cfg(bench.build_cfg("heavy"))
    scenes = sim.scenes_from_dataset(
        synthetic.generate_dataset(0, sizes.bs, cfg, scene_len=38))
    print(device.gpu_card() if not args.small else "CPU-sized run")
    print(f"bs={sizes.bs} n_randoms={sizes.n_randoms}; share of entries "
          f"off by > 1e-3, p99|d|, share moved")

    def lines(run, comparisons):
        for name, (g, tol) in comparisons.items():
            print(f"{run:>22} | {name:44}: {g['frac']:.5f} (tolerance "
                  f"{tol}{', exceeded' if g['frac'] > tol else ''})  "
                  f"{g['p99']:.2e}  {g['moved']:.3f}", flush=True)

    for seed in range(4, 4 + args.seeds):
        lines(f"seed {seed}", chip_smoke.guided_comparisons(cfg, scenes,
                                                            seed))
    for name, (attr, fn) in planted_faults().items():
        orig = getattr(CandMinorGuidanceLoss, attr)
        setattr(CandMinorGuidanceLoss, attr, fn)
        try:
            lines(name, chip_smoke.guided_comparisons(cfg, scenes))
        finally:
            setattr(CandMinorGuidanceLoss, attr, orig)


if __name__ == "__main__":
    main()
