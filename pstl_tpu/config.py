"""Typed experiment configuration.

Replaces the reference's ~115-flag argparse namespace
(``nusc_train.py:1635-1814``) with a frozen dataclass.  The imperative
post-parse coupling rules of the reference (``nusc_train.py:1779-1813``) are
made explicit in :func:`Config.finalize`.  The README's e0..e8 experiment
commands become named presets in :data:`PRESETS`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class Config:
    # ---- experiment ----------------------------------------------------
    seed: int = 1007
    exp_name: Optional[str] = None
    epochs: int = 500
    test: bool = False
    net_pretrained_path: Optional[str] = None
    batch_size: int = 128
    lr: float = 3e-4
    hiddens: Tuple[int, ...] = (256, 256)
    print_freq: int = 10
    save_freq: int = 100
    viz_freq: int = 50
    num_viz: int = 10
    no_viz: bool = False
    mini: bool = False
    train_ratio: float = 0.7

    # ---- scene tensor shapes -------------------------------------------
    n_neighbors: int = 8          # k neighbor slots
    n_randoms: int = 64           # M candidate seeds per (scene, maneuver)
    n_segs: int = 15              # lane centerline waypoints
    n_expands: int = 4            # lane-graph expansion depth (extraction)

    # ---- dynamics & geometry -------------------------------------------
    ego_L: float = 4.084
    ego_W: float = 1.730
    refined_nL: int = 4           # anchor discs along length
    refined_nW: int = 1           # anchor discs along width
    nt: int = 20                  # control horizon (steps)
    dt: float = 0.5               # seconds per step
    mul_w_max: float = 0.5        # |steer-rate| bound (rad/s)
    mul_a_max: float = 5.0        # |accel| bound (m/s^2)

    # ---- STL semantics ---------------------------------------------------
    smoothing_factor: float = 100.0   # tau for soft min/max
    clip_dist: bool = False           # clip lane distance to [-5, 5]
    inline: bool = False              # polyline endpoint handling
    norm_stl: bool = False            # normalize clauses by parameter ranges
    flex: bool = False                # widened calibration margins
    # NOTE: the reference declares --use_gt_stlp (nusc_train.py:1676) but
    # never reads it anywhere — dead in the reference, so not carried here.
    stl_nn_thres: float = 0.0005
    stl_trajopt_thres: float = 0.01

    # ---- data ------------------------------------------------------------
    collect_data: bool = False
    offline: bool = True
    cache_path: str = "e0_nusc_cache"
    params_load_path: Optional[str] = "e1_nusc_trajopt"
    load_stlp: bool = False
    load_tj: bool = False
    gt_nei: bool = True
    generate_split_on_the_fly: bool = False
    synthetic: bool = True        # synthetic scene source by default
    n_synth_scenes: int = 512     # synthetic dataset size
    # fraction of synthetic scenes generated in a LOW-SPEED regime
    # (v0 in [0.3, 3) m/s, target speed may approach 0): training coverage
    # for the near-stop states where the strict raw-Euler env used to go
    # out-of-distribution (round-1 reversal-depth OOL root cause).
    # 0 = round-1..3 data distribution
    synth_low_speed_frac: float = 0.0

    # ---- trajopt augmentation ---------------------------------------------
    trajopt_only: bool = False
    traj_opt_iters: int = 2000
    trajopt_lr: float = 0.005
    opt_epochs: int = 0
    reg_loss: float = 10.0
    # beyond-reference oracle robustness: optimize the expected hinge over
    # this many independent flex-stlp draws (training redraws stlp per
    # epoch, so 1 draw overfits; see trajopt.trajopt_loss).  1 = reference
    trajopt_robust_draws: int = 4
    # beyond-reference: hinge weight on negative rollout speed in the
    # trajopt oracle loss — keeps augmented controls from braking past
    # v=0 (the unicycle Euler integrator would reverse), so the policy
    # never LEARNS reversal and the strict raw-Euler env (no forward
    # shield) stays in-distribution.  0 = reference loss exactly
    trajopt_nonneg_speed: float = 0.0

    # ---- model modes -------------------------------------------------------
    stl_weight: float = 1.0
    bc: bool = False
    bc_weight: float = 0.0
    vae: bool = False
    vae_dim: int = 64
    weight_vae_bc: float = 1.0
    weight_vae_kl: float = 1.0
    diffusion: bool = False
    diffusion_steps: int = 100
    beta_start: float = 1e-4
    beta_end: float = 0.02
    cos: bool = True              # cosine schedule (forced on in reference)
    # fast sampling (beyond-reference): "ddpm" = ancestral (parity),
    # "ddim" = deterministic subsequence sampler (Song et al. 2020),
    # "dpmpp" = DPM-Solver++(2M) multistep (Lu et al. 2022) — both use
    # ddim_steps network evaluations
    sampler: str = "ddpm"
    ddim_steps: int = 20
    ddim_eta: float = 0.0
    # guidance-aware step placement for the fast samplers: fraction of the
    # ddim_steps evaluations placed INSIDE the guided band
    # [1, guidance_before] (diffusion._fast_taus); 0 = uniform spacing
    fast_guided_focus: float = 0.0
    # explicit focus-band size override (timesteps from t=1 upward); 0 =
    # derive from guidance_before when the trigger schedule is banded
    fast_focus_band: int = 0
    grad_rollout: bool = False
    use_init_hint: bool = False
    gt_data_training: bool = False
    stl_bc_mask: bool = True      # forced on in reference

    # ---- RefineNet ----------------------------------------------------------
    rect_head: bool = False
    rect_hiddens: Tuple[int, ...] = (256, 256)
    rect_reg_loss: float = 0.0
    joint: bool = False
    extra_rect_reg: Optional[float] = None
    not_use_rect: bool = False
    interval: bool = False
    clip_rect: bool = False
    diffusion_clip: bool = False
    diff_full: bool = False
    multi_cands: Optional[int] = None
    n_rolls: Optional[int] = None
    no_refinenet: bool = False

    # ---- diversity -------------------------------------------------------
    diverse_loss: bool = False
    diversity_weight: float = 1.0
    diversity_scale: float = 1.0
    no_arch: bool = False
    n_shards: int = 4
    diverse_fuse_type: str = "add"   # "add" | "cat"
    diverse_detach: bool = False
    measure_diversity: bool = False
    extra_diversity: bool = False

    # ---- guidance (CTG-style) ----------------------------------------------
    guidance: bool = False
    guidance_niters: int = 3
    guidance_before: int = 1000
    guidance_lr: float = 0.01
    guidance_reverse: bool = False
    guidance_sets: Optional[Tuple[int, ...]] = None
    guidance_freq: Optional[int] = None
    # Reference quirk (nusc_train.py:624-626): the per-step guidance delta is
    # |mu'-mu| clipped to beta and *added* (always positive offset).  A/B on
    # trained checkpoints shows the quirk makes guidance HURT (acc 0.015 vs
    # 0.038 unguided) while the signed-delta fix more than doubles accuracy
    # and diversity (0.087 acc, 2.7x hull volume) — so the fix is the
    # default; set True for strict reference parity.
    guidance_positive_offset_quirk: bool = False
    # reverse-pass noise temperature (beyond-reference diversity lever):
    # scales the fresh-noise injection sigma = sqrt(beta_t) in the DDPM
    # ancestral sampler (and the DDIM eta-noise).  1.0 = reference
    # semantics; >1 trades a little compliance for sample entropy
    sample_noise_scale: float = 1.0

    # ---- losses extras ------------------------------------------------------
    collision_loss: Optional[float] = None    # TrafficSim-style
    oracle_filter: bool = False

    # ---- evaluation ----------------------------------------------------------
    run_sampling_test: bool = False
    sampling_size: int = 64
    n_trials: int = 100
    refinement: bool = False
    raw_refinement: bool = False
    lite_refine: bool = False
    backup: bool = False
    # backup controller Adam budget — reference solve_bak uses 500
    # (nusc_sim.py:762); rounds 1-3 silently ran 100 (now a documented
    # knob, default = reference parity)
    backup_niters: int = 500
    # Closed-loop selection shield (beyond-reference): penalize candidates
    # whose rollout speed goes negative by the reversal depth — "reversing
    # by braking past zero" is a unicycle-integrator artifact that puts the
    # policy out of distribution.  Off = reference behavior.
    forward_shield: bool = True
    # Environment realism (beyond-reference): the executed sim step clamps
    # speed at zero — a braking car stops, it does not reverse.  The
    # reference's raw Euler env can reverse (nusc_sim.py:118) but its
    # curated scenes never trigger it; denser synthetic traffic does, and
    # the resulting v<0 states are out-of-distribution for the policy.
    env_nonnegative_speed: bool = True
    test_scenes: bool = False
    test_aggressive: bool = False

    # ---- device execution -----------------------------------------------------
    mesh_shape: Tuple[int, ...] = (-1,)       # data-parallel mesh (-1 = all)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    compute_dtype: str = "bfloat16"           # network matmul dtype
    robustness_dtype: str = "float32"         # STL robustness dtype
    # dtype of the guidance loss's big SELECTION fields ((bs,T,S,R) lane
    # distances, (bs,K,T,nLe,nLn,R) disc pairs) and the frozen per-(t,row)
    # payloads streamed through every Adam iteration.  bfloat16 halves
    # that HBM traffic; geometry is recentered per scene at the ego start
    # (specs.CandMinorGuidanceLoss), so the bf16 rounding costs ~0.1 m on
    # stored payloads only — the Adam-iteration arithmetic stays fp32.
    geometry_dtype: str = "float32"
    # run the whole DDPM reverse scan in candidate-minor (bs, nt, 2, R)
    # layout (models.make_cm_eps_fn): the policy MLP's linear first layer
    # splits into a precomputed per-row base + per-step time vector +
    # candidate-minor noise einsum, so the scan needs NO per-step layout
    # transposes.
    # Takes effect with diffusion + guidance + the fused loss; the RNG
    # draw shapes differ from the row-major path, so per-candidate noise
    # realizations differ (same distribution; layout-parity is tested
    # with a pinned noise stream in tests/test_diffusion.py)
    cm_sampler: bool = True
    # lax.scan unroll factor for the DDPM reverse scan: >1 trades compile
    # time + program size for cross-step fusion/prefetch overlap
    diffusion_scan_unroll: int = 1
    # coarse-to-fine frozen-pair selection in the guidance clearance
    # freeze: nearest ego disc to the neighbor center, then nearest
    # neighbor disc to it — 2*nL instead of nL^2 pair distances.  Opt-in
    # approximation (perturbs only WHICH near-minimal pair is frozen)
    clearance_coarse_pair: bool = False
    # cm-sampler dot form: broadcast the layer weights over the scene
    # batch so the dot_general's canonical output order IS (bs, k, R) —
    # removes the per-layer stablehlo.transpose the plain einsum lowers to
    cm_broadcast_dots: bool = True
    # TiledScorer fast path for the canonical dense layout (exact same
    # scores; per-row formula selection + per-scene constants); False falls
    # back to ClauseBank over pre-tiled signals
    tiled_scorer: bool = True
    # candidate-minor fused guidance loss (specs.CandMinorGuidanceLoss):
    # same math as rollout+TiledScorer (grad differs only on segment-argmin
    # ties), one fully-fusable function with the candidate axis minor —
    # the guidance inner-loop fast path
    guidance_fused_loss: bool = True
    # remat the guidance loss so its backward recomputes instead of
    # storing residuals (opt-in; not measured on the GPU).
    guidance_remat: bool = False
    # freeze the discrete argmin selections (nearest lane segment per (t,
    # row), nearest ego-disc/neighbor-disc pair per (k, t, row)) at the
    # posterior mean ONCE per denoise step and reuse them for all
    # ``guidance_niters`` Adam iterations.  Exact for niters=1 (the
    # reference's own closed-loop config, nusc_sim README row); for
    # niters>1 iterations 2.. see selections that are one Adam step stale
    # (the trust region is |delta| <= beta_t, so flips are rare).  Cuts the
    # two heaviest guidance fusions — the (bs,T,S,R) lane-segment search
    # and the (bs,K,T,nLe,nLn,R) disc-pair search — out of every iteration.
    guidance_reuse_selection: bool = False
    # with guidance_reuse_selection, refresh the frozen selections only on
    # every k-th GUIDED denoise step (carried through the reverse-scan
    # state in between).  1 = refresh every guided step (exact
    # reuse-selection semantics).  Staleness across steps stays inside the
    # shrinking |delta| <= beta_t trust region.
    # DDPM sampler only (DDIM/DPM++ refresh per step).
    guidance_sel_every: int = 1
    # compute keep+change maneuver scores for ALL R columns and blend by
    # a static is_keep mask instead of slicing R at M (exact; removes the
    # slice/pad halo exchanges under candidate-axis sharding at ~1.6x
    # redundant reduction FLOPs — single-chip keeps exact slices)
    guidance_blend_scores: bool = False
    # serve training batches from the C++ mmap shard store (thread-pool
    # gather + double-buffered prefetch) instead of numpy slicing — the
    # native replacement for the reference's DataLoader(num_workers=8)
    use_shard_store: bool = False
    # optimizer steps per dispatched program during training (lax.scan over
    # stacked batches) — EXACT same steps/keys; spreads the host's
    # per-dispatch cost over the chunk.
    # 1 = per-batch dispatch (mesh / shard-store / profiling paths)
    train_chunk: int = 8
    time_profile: bool = False

    # ------------------------------------------------------------------
    @property
    def multi_check(self) -> bool:
        """Generative multi-candidate mode (nusc_train.py:1217)."""
        return (self.diffusion or self.vae or self.bc) and not self.gt_data_training

    @property
    def latent_dim(self) -> int:
        """Mode-specific latent width fed to the policy head (nusc_model.py:24-35)."""
        stlp_dim = 6
        if self.diffusion:
            d = self.nt * 2 + 32 + 1 + stlp_dim
        elif self.bc:
            d = 1 + stlp_dim
        elif self.vae:
            d = self.vae_dim + 1 + stlp_dim
        else:
            d = 1 + stlp_dim
        if self.use_init_hint:
            d += self.nt * 2
        return d

    def finalize(self) -> "Config":
        """Apply the reference's flag-coupling rules (nusc_train.py:1779-1813)."""
        c = self
        upd = {}
        upd["gt_nei"] = True
        upd["stl_bc_mask"] = True
        upd["cos"] = True
        if not c.collect_data and not c.trajopt_only:
            upd["measure_diversity"] = True
        if c.run_sampling_test:
            upd["test"] = True
            upd["extra_diversity"] = True
        if c.collect_data:
            upd.update(epochs=1, batch_size=1024)
        if c.trajopt_only:
            upd.update(opt_epochs=1, epochs=1, batch_size=1024,
                       diffusion=True, flex=True)
        if c.opt_epochs > 0 or upd.get("opt_epochs", 0) > 0:
            upd["epochs"] = max(c.opt_epochs, upd.get("opt_epochs", 0))
        if c.load_stlp:
            upd["load_tj"] = True
        if c.rect_head:
            upd.update(interval=True, diffusion_clip=True, diff_full=True)
        upd["offline"] = not c.collect_data
        if c.test or upd.get("test"):
            upd["epochs"] = 1
        return replace(c, **upd)

    def with_(self, **kw) -> "Config":
        return replace(self, **kw)

    def ref_parity(self, open_loop: bool = False) -> "Config":
        """One-switch FULL reference-parity bundle: revert every documented
        intentional deviation at once (VERDICT r3 #4).

        Reverted deviations (see docs/ARCHITECTURE.md "Intentional
        deviations" for the A/B evidence behind each default):

        - ``guidance_positive_offset_quirk=True`` — the always-positive
          guidance delta clamp (nusc_train.py:624-626);
        - ``forward_shield=False`` — no reversal-depth selection penalty;
        - ``env_nonnegative_speed=False`` — raw Euler env, speed may go
          negative (nusc_sim.py:118);
        - ``backup_niters=500`` — solve_bak's budget (nusc_sim.py:762);
        - ``sample_noise_scale=1.0`` — no sampler temperature;
        - the README guidance schedule: last 10 denoise steps, 1 Adam
          iteration, lr 0.01 open-loop (README.md:115) / 0.04 closed-loop
          (README.md:175), multi_cands 10 / 5.

        Training-recipe parity (the DPP-only e7 loss, stl_weight=0) is a
        property of the checkpoint, not the eval config — use the
        ``e7_ours`` preset as-is to train it (the "ref-exact recipe" rows
        of docs/RESULTS.md).
        """
        c = self.with_(
            guidance_positive_offset_quirk=True,
            forward_shield=False,
            env_nonnegative_speed=False,
            backup_niters=500,
            sample_noise_scale=1.0,
        )
        if self.guidance:
            c = c.with_(guidance_before=10, guidance_niters=1,
                        guidance_lr=0.01 if open_loop else 0.04,
                        multi_cands=10 if open_loop else 5)
        return c

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _p(**kw) -> Config:
    return Config(**kw).finalize()


#: Named presets mirroring the reference README's e0..e8 experiment commands
#: (README.md:54-202).
PRESETS = {
    # e0: data collection (NuScenes -> tensor cache)  (README.md:55-57)
    "e0_cache": _p(exp_name="e0_cache", collect_data=True),
    # e1: trajopt augmentation (64 seeds x 3 maneuvers, 2000 Adam iters)
    "e1_trajopt": _p(exp_name="e1_trajopt", trajopt_only=True),
    # e2: VAE trained on GT controls only ("mono")  (README.md:84-86)
    "e2_vae_mono": _p(exp_name="e2_vae_mono", vae=True,
                      gt_data_training=True, bc_weight=1.0, stl_weight=0.0,
                      load_stlp=True, flex=True),
    # e3: VAE baseline on augmented data  (README.md:89-91)
    "e3_vae": _p(exp_name="e3_vae", vae=True, bc_weight=1.0, stl_weight=0.0,
                 use_init_hint=True, load_tj=True, load_stlp=True,
                 flex=True),
    # e4: DDPM trained on GT controls only ("mono")  (README.md:94-96)
    "e4_ddpm_mono": _p(exp_name="e4_ddpm_mono", diffusion=True,
                       stl_weight=0.0, load_stlp=True,
                       gt_data_training=True),
    # e5: DDPM on augmented data  (README.md:64)
    "e5_ddpm": _p(exp_name="e5_ddpm", diffusion=True, stl_weight=0.0,
                  load_tj=True, load_stlp=True, flex=True),
    # e6: TrafficSim baseline (VAE + collision loss)  (README.md:101-103)
    "e6_trafficsim": _p(exp_name="e6_trafficsim", vae=True, bc_weight=1.0,
                        stl_weight=1.0, collision_loss=1.0, load_tj=True,
                        load_stlp=True, flex=True),
    # e7: ours = DDPM + RefineNet + DPP diversity + multi_cands
    # (README.md:66, trained from an e5 checkpoint via --ckpt)
    "e7_ours": _p(exp_name="e7_ours", diffusion=True, stl_weight=0.0,
                  rect_head=True, diverse_loss=True, multi_cands=5,
                  load_tj=True, load_stlp=True, flex=True),
    # e8: STL-weight ablation (L_STL, diversity off)  (README.md:77)
    "e8_stl": _p(exp_name="e8_stl", diffusion=True, stl_weight=1.0,
                 rect_head=True, diverse_loss=True, diversity_weight=0.0,
                 multi_cands=5, n_shards=4, load_tj=True, load_stlp=True,
                 flex=True),
    # ours + guidance, open-loop flavor (README.md:115: multi_cands 10,
    # guidance_before 10, niters 1, lr 0.01, n_rolls 3)
    "ours_guidance": _p(exp_name="ours_guidance", diffusion=True,
                        stl_weight=0.0, rect_head=True, diverse_loss=True,
                        multi_cands=10, guidance=True, guidance_before=10,
                        guidance_niters=1, guidance_lr=0.01, n_rolls=3,
                        load_tj=True, load_stlp=True, flex=True),
    # ours + guidance, closed-loop flavor (README.md:177: multi_cands 5,
    # guidance_before 10, niters 1, lr 0.04)
    "ours_guidance_sim": _p(exp_name="ours_guidance_sim", diffusion=True,
                            stl_weight=0.0, rect_head=True,
                            diverse_loss=True, multi_cands=5, guidance=True,
                            guidance_before=10, guidance_niters=1,
                            guidance_lr=0.04, load_tj=True, load_stlp=True,
                            flex=True, test_scenes=True),
    # CTG baseline: plain e5 DDPM + default guidance (all steps, 3 iters;
    # README.md:160-163, 200-203)
    "ctg": _p(exp_name="ctg", diffusion=True, stl_weight=0.0, guidance=True,
              load_tj=True, load_stlp=True, flex=True),
}
