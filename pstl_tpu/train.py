"""Training engine.

Parity target: the epoch loop of ``nusc_train.main`` (nusc_train.py:1185-1632)
re-architected for one compiled program per step:

- ONE jitted train step containing everything the reference does per batch —
  stlp calibration, batch densification, diffusion prep, policy forward, the
  full 99-step reverse sampler (when rect_head), multi-candidate selection,
  RefineNet, STL scoring, all losses, and the optimizer update.  Host code
  only shuffles indices and logs.
- RefineNet-only training (reference: optimizer over ``net.rect_net``
  parameters, nusc_train.py:1229-1233) via ``optax.multi_transform`` masking.
- data parallel over a 1-D mesh: batches sharded on the leading axis,
  params replicated, reductions lowered to psums by XLA.
- ``.npz`` checkpoints of params + opt state + step (the reference only
  saves model weights, utils.py:81-85 — we keep full resume state).
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from pstl_tpu import diffusion, losses, specs
from pstl_tpu.config import Config
from pstl_tpu.data.dataset import SceneDataset, batch_iterator
from pstl_tpu.models import Net
from pstl_tpu.ops import dynamics as dyn

Array = jax.Array


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: Array


def make_optimizer(cfg: Config, params) -> optax.GradientTransformation:
    """Adam; RefineNet-head-only updates unless ``joint``
    (nusc_train.py:1229-1235)."""
    adam = optax.adam(cfg.lr)
    if cfg.rect_head and not cfg.joint:
        def label_fn(p):
            return jax.tree_util.tree_map_with_path(
                lambda path, _: "train" if any(
                    getattr(k, "key", None) in ("rect_net", "merge_net")
                    for k in path) else "freeze", p)
        return optax.multi_transform(
            {"train": adam, "freeze": optax.set_to_zero()}, label_fn(params))
    return adam


def init_state(cfg: Config, net: Net, sample_batch: Dict[str, Array],
               key: Array) -> TrainState:
    dense, ext = _init_inputs(cfg, sample_batch, key)
    params = net.init(key, dense, ext, method=Net.init_all)
    opt = make_optimizer(cfg, params)
    return TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))


def attach_neighbors(batch: Dict[str, Array], cfg: Config) -> Dict[str, Array]:
    """GT neighbor tracks vs constant-velocity prediction
    (``gt_nei``, nusc_train.py:1262-1265).  The reference forces gt_nei=True
    post-parse; the const-vel branch stays reachable via ``with_``."""
    batch = dict(batch)
    batch["neighbors"] = batch["neighbors_traj"][:, :, 0, :]
    if cfg.gt_nei:
        batch["neighbor_trajs_aug"] = batch["neighbors_traj"]
    else:
        batch["neighbor_trajs_aug"] = dyn.neighbor_rollout(
            batch["neighbors"], cfg.nt, cfg.dt, full=True)
    return batch


def _init_inputs(cfg: Config, batch, key):
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    batch = attach_neighbors(batch, cfg)
    gt = batch["ego_traj"][..., :4]
    stlp = specs.calibrate_stlp(batch, gt, cfg)
    dense = specs.densify_batch(batch, stlp, cfg, key=key)
    bs = gt.shape[0]
    if cfg.gt_data_training:
        # mono mode: per-scene ext rows, gt_stlp conditioning
        n = bs * cfg.n_randoms
        if cfg.diffusion:
            ext = {"timestep": jnp.ones((n, 1)),
                   "highlevel": batch["gt_high_level"],
                   "noise": jnp.zeros((n, cfg.nt * 2)), "gt_stlp": stlp}
        else:
            ext = {"gt_stlp": stlp, "highlevel": batch["gt_high_level"],
                   "gt_controls": jnp.zeros((bs, cfg.nt, 2)),
                   "noise": jnp.zeros((n, cfg.vae_dim))}
        return dense, ext
    n = bs * cfg.n_randoms * 3
    if cfg.diffusion:
        ext = {"timestep": jnp.ones((n, 1)),
               "highlevel": dense["highlevel_dense"],
               "noise": jnp.zeros((n, cfg.nt * 2))}
    elif cfg.vae:
        ext = {"highlevel": dense["highlevel_dense"],
               "noise": jnp.zeros((n, cfg.vae_dim)),
               "trajopt_controls": jnp.zeros((n, cfg.nt, 2))}
    else:
        ext = {"highlevel": dense["highlevel_dense"]}
    return dense, ext


# ---------------------------------------------------------------------------
# the fused per-batch computation
# ---------------------------------------------------------------------------

def batch_forward_and_loss(params, key: Array, batch: Dict[str, Array],
                           cfg: Config, net: Net, formulas,
                           coeffs: diffusion.Coeffs,
                           train: bool) -> Tuple[Array, Dict[str, Array]]:
    """Everything between dataloader and optimizer for one batch
    (mirrors nusc_train.py:1251-1525 multi_check branch)."""
    k_dense, k_prep, k_sample, k_vae = jax.random.split(key, 4)
    batch = attach_neighbors(batch, cfg)
    gt_trajs = batch["ego_traj"][..., :4]
    states = gt_trajs[:, 0, :4]
    bs = states.shape[0]
    n = bs * cfg.n_randoms * 3

    gt_stlp = specs.calibrate_stlp(batch, gt_trajs, cfg)

    if cfg.gt_data_training:
        return _mono_forward_and_loss(params, key, batch, cfg, net, formulas,
                                      coeffs, gt_stlp, states, gt_trajs)

    dense = specs.densify_batch(batch, gt_stlp, cfg, key=k_dense)
    states_flat = jnp.broadcast_to(
        states[:, None, None], (bs, cfg.n_randoms, 3, 4)).reshape(n, 4)
    highlevel = dense["highlevel_dense"]
    signal_base = specs.dense_signal_input(dense, cfg=cfg)
    valid = dense["valids_dense"].reshape(-1)

    # trajopt-augmented targets (precomputed offline, nusc_train.py:1279-1300)
    dense_controls = batch["params"].reshape(n, cfg.nt, 2)
    if "tj_scores_prior" in batch:
        dense_scores = batch["tj_scores_prior"].reshape(-1)
    else:
        tj_trajs = dyn.rollout(states_flat, dense_controls, cfg.dt)
        sig = dict(signal_base)
        sig["ego_traj"] = tj_trajs[:, :-1]
        _, dense_scores, _ = specs.compute_scores(
            sig, formulas, highlevel, valid, cfg)

    rd: Dict[str, Array] = {}

    score_rows = specs.make_score_rows(batch, dense, cfg, formulas)

    def score_controls(controls):
        trajs = dyn.rollout(states_flat, controls, cfg.dt)
        s = score_rows(trajs[:, :-1])
        acc = specs.mask_mean((s > 0).astype(jnp.float32), valid)
        return None, s, acc

    def coll_loss(controls):
        """TrafficSim collision loss on generated rollouts
        (nusc_train.py:416-421), active when cfg.collision_loss is set."""
        if cfg.collision_loss is None:
            return jnp.zeros(())
        trajs = dyn.rollout(states_flat, controls, cfg.dt)
        sig = dict(signal_base)
        sig["ego_traj"] = trajs[:, :-1]
        sig = specs.prep_signals(sig, cfg, with_collision=True)
        return losses.collision(sig["min_centroid_d"], sig["radius_sum"],
                                cfg)

    if cfg.diffusion:
        noise, steps, noised = diffusion.prep(
            k_prep, batch["params"], cfg, coeffs)
        ext = {"timestep": steps.astype(jnp.float32), "highlevel": highlevel,
               "noise": noised}
        eps_hat, feature = net.apply(params, dense, ext, get_feature=True)
        eps_hat = eps_hat.reshape(n, cfg.nt * 2)
        rd["loss_diffusion"] = losses.diffusion_eps_mse(
            noise, eps_hat, dense_scores, valid, cfg)

        if cfg.rect_head:
            def apply_fn(e):
                return net.apply(params, dense, e, prev_feature=feature)

            guidance_ctx = (diffusion.make_guidance_ctx(
                score_rows, valid, states_flat) if cfg.guidance else None)
            nn_controls, all_steps = diffusion.sample(
                k_sample, apply_fn, dense, highlevel, feature, cfg, coeffs,
                n, guidance_ctx=guidance_ctx)
            if cfg.multi_cands is not None:
                nn_controls, prev_scores = diffusion.select_multi_cands(
                    all_steps, cfg.multi_cands, states_flat, score_rows, cfg)
            else:
                _, prev_scores, _ = score_controls(nn_controls)
            nn_controls = jax.lax.stop_gradient(nn_controls)
            prev_scores = jax.lax.stop_gradient(prev_scores)
            rect_controls = net.apply(
                params, feature, highlevel, dense["stlp_dense"][:, 0],
                nn_controls, prev_scores, method=Net.rect)
            _, scores, acc = score_controls(rect_controls)
            rd["loss_stl"] = losses.stl_hinge(scores, valid,
                                              cfg.stl_nn_thres,
                                              cfg.stl_weight)
            if cfg.diverse_loss:
                rd["loss_diversity"] = losses.dpp_diversity(
                    rect_controls, scores, cfg)
                # stay-close mask uses the POST-rect scores
                # (nusc_train.py:466)
                rd["loss_reg"], _ = losses.rect_reg(
                    rect_controls, nn_controls, scores, cfg)
                rd["loss"] = (rd["loss_stl"]
                              + rd["loss_reg"] * cfg.rect_reg_loss
                              + rd["loss_diversity"])
            else:
                rd["loss_reg"], rd["extra_loss_reg"] = losses.rect_reg(
                    rect_controls, nn_controls, prev_scores, cfg)
                rd["loss_coll"] = coll_loss(rect_controls)
                rd["loss"] = (rd["loss_stl"] + rd["loss_reg"]
                              + rd["extra_loss_reg"] + rd["loss_coll"])
        elif cfg.grad_rollout:
            # --grad_rollout: differentiate THROUGH the full reverse sampler
            # (nusc_train.py:562 enables grads when grad_rollout and no
            # rect head; :1370 runs the sampler in training) and train on
            # the STL hinge of the sampled controls
            def apply_fn(e):
                return net.apply(params, dense, e, prev_feature=feature)

            guidance_ctx = (diffusion.make_guidance_ctx(
                score_rows, valid, states_flat) if cfg.guidance else None)
            nn_controls, _ = diffusion.sample(
                k_sample, apply_fn, dense, highlevel, feature, cfg, coeffs,
                n, guidance_ctx=guidance_ctx)
            _, scores, acc = score_controls(nn_controls)
            rd["loss_stl"] = losses.stl_hinge(scores, valid,
                                              cfg.stl_nn_thres,
                                              cfg.stl_weight)
            rd["loss_coll"] = coll_loss(nn_controls)
            rd["loss"] = (rd["loss_stl"] + rd["loss_diffusion"]
                          + rd["loss_coll"])
        else:
            # plain DDPM: STL measured on trajopt targets' score statistics;
            # the sampler is only run for metrics at viz epochs in the
            # reference, so training loss is just eps-MSE + stl on dense set
            scores = dense_scores
            acc = specs.mask_mean((scores > 0).astype(jnp.float32), valid)
            rd["loss_stl"] = losses.stl_hinge(scores, valid,
                                              cfg.stl_nn_thres,
                                              cfg.stl_weight) * 0.0
            rd["loss_coll"] = coll_loss(dense_controls)
            rd["loss"] = (rd["loss_stl"] + rd["loss_diffusion"]
                          + rd["loss_coll"])

    elif cfg.vae:
        noise = jax.random.normal(k_vae, (n, cfg.vae_dim))
        ext = {"highlevel": highlevel, "noise": noise,
               "trajopt_controls": dense_controls}
        nn_controls, latent_stats = net.apply(params, dense, ext)
        _, scores, acc = score_controls(nn_controls)
        rd["loss_stl"] = losses.stl_hinge(scores, valid, cfg.stl_nn_thres,
                                          cfg.stl_weight)
        rd["loss_vae_bc"], rd["loss_vae_kl"] = losses.vae_losses(
            nn_controls, dense_controls, latent_stats, dense_scores, valid,
            cfg)
        rd["loss_coll"] = coll_loss(nn_controls)
        rd["loss"] = (rd["loss_stl"] + rd["loss_vae_bc"]
                      + rd["loss_vae_kl"] + rd["loss_coll"])

    elif cfg.bc:
        ext = {"highlevel": highlevel}
        nn_controls = net.apply(params, dense, ext)
        _, scores, acc = score_controls(nn_controls)
        rd["loss_stl"] = losses.stl_hinge(scores, valid, cfg.stl_nn_thres,
                                          cfg.stl_weight)
        rd["loss_bc"] = losses.bc_mse(nn_controls, dense_controls,
                                      dense_scores, valid, cfg)
        rd["loss_coll"] = coll_loss(nn_controls)
        rd["loss"] = rd["loss_stl"] + rd["loss_bc"] + rd["loss_coll"]
    else:
        raise NotImplementedError("mode")

    rd["acc"] = acc
    rd["tj_acc"] = specs.mask_mean((dense_scores > 0).astype(jnp.float32),
                                   valid)
    return rd["loss"], rd


def _mono_forward_and_loss(params, key, batch, cfg, net, formulas, coeffs,
                           gt_stlp, states, gt_trajs):
    """GT-data ("mono") training branch (nusc_train.py:1435-1492): train the
    generative model on finite-difference GT controls only, n_randoms
    samples per scene, STL evaluated under the calibrated spec."""
    bs = states.shape[0]
    M = cfg.n_randoms
    n = bs * M
    k_prep, k_sample, k_vae = jax.random.split(key, 3)
    rd: Dict[str, Array] = {}

    # finite-difference GT controls (nusc_train.py:1438-1439)
    gt_controls = (batch["ego_traj"][:, 1:, 2:4]
                   - batch["ego_traj"][:, :-1, 2:4]) / cfg.dt
    gt_controls = jnp.concatenate([gt_controls, gt_controls[:, -1:]], axis=1)

    states_mul = jnp.broadcast_to(states[:, None], (bs, M, 4)).reshape(n, 4)
    hl = batch["gt_high_level"]

    def mono_signals(trajs):
        def mul(x):
            return jnp.repeat(x, M, axis=0)
        return {
            "ego_traj": trajs[:, :-1],
            "neighbors": mul(batch["neighbor_trajs_aug"]),
            "currlane_wpts": mul(batch["currlane_wpts"]),
            "leftlane_wpts": mul(batch["leftlane_wpts"]),
            "rightlane_wpts": mul(batch["rightlane_wpts"]),
            "stlp": mul(gt_stlp)[:, None, :],
        }

    if cfg.diffusion:
        noise, steps, noised = diffusion.prep(k_prep, gt_controls, cfg,
                                              coeffs, mono=True)
        ext = {"timestep": steps.astype(jnp.float32), "highlevel": hl,
               "noise": noised, "gt_stlp": gt_stlp}
        eps_hat, feature = net.apply(params, batch, ext, get_feature=True)
        eps_hat = eps_hat.reshape(n, cfg.nt * 2)
        rd["loss_diffusion"] = jnp.mean(jnp.square(noise - eps_hat))

        hl_mul = jnp.repeat(hl, M, axis=0)
        gt_stlp_mul = jnp.repeat(gt_stlp, M, axis=0)

        def apply_fn(e):
            # reuse the (bs, 224) scene feature across all sampler steps
            # (the reference computes it once, nusc_train.py:571-578)
            return net.apply(params, batch, e, prev_feature=feature,
                             n_randoms=M)

        controls, _ = diffusion.sample(
            k_sample, apply_fn, batch, hl, None, cfg, coeffs, n, mono=True,
            tmp_stlp=gt_stlp)
        if not cfg.grad_rollout:
            controls = jax.lax.stop_gradient(controls)
        trajs = dyn.rollout(states_mul, controls, cfg.dt)
        sig = mono_signals(trajs)
        _, scores, acc = specs.compute_scores(sig, formulas, hl_mul,
                                              jnp.ones((n,)), cfg)
        rd["loss_stl"] = losses.stl_hinge(scores, jnp.ones((n,)),
                                          cfg.stl_nn_thres,
                                          cfg.stl_weight)
        # sampling happens under stop_gradient unless --grad_rollout
        # (nusc_train.py:562): default mono training signal is the eps-MSE
        # alone with loss_stl a metric; grad_rollout trains through it
        rd["loss"] = rd["loss_diffusion"] + (rd["loss_stl"]
                                             if cfg.grad_rollout else 0.0)
    elif cfg.vae:
        noise = jax.random.normal(k_vae, (n, cfg.vae_dim))
        ext = {"gt_stlp": gt_stlp, "highlevel": hl,
               "gt_controls": gt_controls, "noise": noise}
        controls_mul, latent_stats = net.apply(params, batch, ext)
        trajs = dyn.rollout(states_mul, controls_mul, cfg.dt)
        hl_mul = jnp.repeat(hl, M, axis=0)
        sig = mono_signals(trajs)
        _, scores, acc = specs.compute_scores(sig, formulas, hl_mul,
                                              jnp.ones((n,)), cfg)
        # minimum-over-n recon (nusc_train.py:1459-1477)
        l2 = jnp.mean(jnp.mean(jnp.square(
            controls_mul.reshape(bs, M, cfg.nt, 2)
            - gt_controls[:, None]), axis=-1), axis=-1)
        rd["loss_vae_bc"] = jnp.mean(jnp.min(l2, axis=1)) * cfg.bc_weight
        mean, logstd, std = latent_stats
        rd["loss_vae_kl"] = (-0.5 * jnp.mean(1 + 2 * logstd - mean * mean
                                             - std * std)) * cfg.weight_vae_kl
        rd["loss_stl"] = losses.stl_hinge(scores, jnp.ones((n,)),
                                          cfg.stl_nn_thres, cfg.stl_weight)
        rd["loss"] = (rd["loss_vae_bc"] + rd["loss_vae_kl"] + rd["loss_stl"])
    else:
        raise NotImplementedError("mono mode needs diffusion or vae")
    rd["acc"] = acc
    rd["tj_acc"] = acc * 0.0
    return rd["loss"], rd


def make_train_step(cfg: Config, net: Net, formulas,
                    coeffs: diffusion.Coeffs,
                    opt: optax.GradientTransformation):
    @jax.jit
    def train_step(state: TrainState, batch: Dict[str, Array], key: Array):
        def loss_fn(p):
            return batch_forward_and_loss(p, key, batch, cfg, net, formulas,
                                          coeffs, train=True)
        (loss, rd), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), rd

    return train_step


METRIC_KEYS = ("loss", "loss_stl", "loss_diffusion", "loss_reg",
               "loss_diversity", "loss_vae_bc", "loss_vae_kl", "loss_bc",
               "acc", "tj_acc")


def make_chunked_steps(cfg: Config, net: Net, formulas,
                       coeffs: diffusion.Coeffs,
                       opt: optax.GradientTransformation):
    """Device-side epoch chunking: run ``cfg.train_chunk`` optimizer steps
    per dispatched program as a ``lax.scan`` over stacked batches.

    It spreads the host's per-dispatch cost over ``train_chunk`` steps.
    Chunking is EXACT —
    the same steps with the same per-batch keys in the same order — only
    the host/device boundary moves.  Metrics come back stacked per step.
    """

    def one_step(state, batch, key, train):
        def loss_fn(p):
            return batch_forward_and_loss(p, key, batch, cfg, net, formulas,
                                          coeffs, train=train)
        if train:
            (_, rd), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params)
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            params = optax.apply_updates(state.params, updates)
            state = TrainState(params, opt_state, state.step + 1)
        else:
            _, rd = loss_fn(state.params)
        return state, {k: rd[k] for k in METRIC_KEYS if k in rd}

    @functools.partial(jax.jit, static_argnames=("train",))
    def chunk_fn(state: TrainState, batches: Dict[str, Array], keys: Array,
                 train: bool):
        def body(st, xs):
            batch, key = xs
            return one_step(st, batch, key, train)

        return jax.lax.scan(body, state, (batches, keys))

    return chunk_fn


def make_eval_step(cfg: Config, net: Net, formulas,
                   coeffs: diffusion.Coeffs):
    @jax.jit
    def eval_step(state: TrainState, batch: Dict[str, Array], key: Array):
        _, rd = batch_forward_and_loss(state.params, key, batch, cfg, net,
                                       formulas, coeffs, train=False)
        return rd

    return eval_step


# ---------------------------------------------------------------------------
# checkpointing (numpy .npz)
# ---------------------------------------------------------------------------
#
# One ``step_<n>.npz`` per save: ``params/<head>/Dense_<i>/<kernel|bias>``
# holds the parameter tree by key path, ``opt_state/<i>`` the optimizer
# state's leaves in treedef order, and ``step`` the step counter.

def _params_arrays(params) -> Dict[str, np.ndarray]:
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(["params"] + [str(k.key) for k in path]): np.asarray(v)
            for path, v in flat}


def _params_tree(arrays) -> Dict:
    tree: Dict = {}
    for name in arrays:
        if not name.startswith("params/"):
            continue
        *parents, leaf = name.split("/")[1:]
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = arrays[name]
    return tree


def _write_atomic(path: str, write) -> None:
    """``write(file)`` into a temporary sibling, then rename it over
    ``path``: a reader never sees a half-written file, and an earlier
    checkpoint at ``path`` is only ever replaced by a complete one."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int) -> str:
    """Write params + optimizer state + step; returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}.npz"
    path = os.path.join(ckpt_dir, name)
    arrays = _params_arrays(state.params)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(state.opt_state)):
        arrays[f"opt_state/{i:05d}"] = np.asarray(leaf)
    arrays["step"] = np.asarray(state.step)
    _write_atomic(path, lambda f: np.savez(f, **arrays))
    # rolling "last" pointer (utils.py:81-85 behavior), relative to the dir
    _write_atomic(os.path.join(ckpt_dir, "LAST"),
                  lambda f: f.write(name.encode()))
    return path


def _resolve_ckpt(ckpt: str) -> str:
    """A checkpoint file, or a directory: its ``LAST`` pointer, else its
    newest ``step_*.npz``."""
    if os.path.isfile(ckpt):
        return ckpt
    last = os.path.join(ckpt, "LAST")
    if os.path.exists(last):
        with open(last) as f:
            return os.path.join(ckpt, f.read().strip())
    steps = sorted(n for n in os.listdir(ckpt)
                   if n.startswith("step_") and n.endswith(".npz"))
    if not steps:
        raise FileNotFoundError(f"no step_*.npz checkpoint in {ckpt}")
    return os.path.join(ckpt, steps[-1])


def _read_arrays(ckpt: str) -> Dict[str, np.ndarray]:
    with np.load(_resolve_ckpt(ckpt), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_checkpoint(ckpt_dir: str, state: TrainState) -> TrainState:
    """Full resume state; ``state`` supplies the tree structures."""
    arrays = _read_arrays(ckpt_dir)
    params = _params_tree(arrays)
    want = jax.tree_util.tree_structure(state.params)
    if jax.tree_util.tree_structure(params) != want:
        raise ValueError(f"checkpoint {ckpt_dir} holds another parameter "
                         "tree than the model")
    opt_def = jax.tree_util.tree_structure(state.opt_state)
    n_opt = sum(k.startswith("opt_state/") for k in arrays)
    if n_opt != opt_def.num_leaves:
        raise ValueError(f"checkpoint {ckpt_dir} has {n_opt} optimizer "
                         f"leaves, the optimizer {opt_def.num_leaves}")
    opt_state = jax.tree_util.tree_unflatten(
        opt_def, [jnp.asarray(arrays[f"opt_state/{i:05d}"])
                  for i in range(n_opt)])
    return TrainState(jax.tree_util.tree_map(jnp.asarray, params), opt_state,
                      jnp.asarray(arrays["step"]))


def load_params_only(ckpt_dir: str, state: TrainState) -> TrainState:
    """Pretrained-weights load, tolerant of a missing RefineNet head
    (reference: strict=not rect_head, nusc_train.py:1215): every head the
    checkpoint holds replaces the model's, the others keep their init."""
    src = _params_tree(_read_arrays(ckpt_dir))["params"]
    merged = dict(state.params["params"])
    for k in merged:
        if k in src:
            merged[k] = jax.tree_util.tree_map(jnp.asarray, src[k])
    return state._replace(params={"params": merged})


# ---------------------------------------------------------------------------
# training loop
# ---------------------------------------------------------------------------

def train(cfg: Config, ds: SceneDataset, mesh=None, log=print,
          epochs: Optional[int] = None, epoch_cb=None) -> TrainState:
    """Epoch loop over {train, val} (nusc_train.py:1245-1632).

    ``epoch_cb(epi, state)``, when given, runs after each epoch's val pass
    — long unattended runs use it to write work-in-progress checkpoints so
    a killed process resumes instead of restarting from scratch
    (scripts/e5_continue.py)."""
    from pstl_tpu.parallel import shard_batch
    from pstl_tpu.utils.meters import MeterDict, Timer

    formulas = specs.build_scorer(cfg)
    coeffs = diffusion.get_coeffs(cfg)
    net = Net(cfg)
    ds.ensure_random_params(cfg.seed)

    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    sample = next(batch_iterator(ds, "train", min(cfg.batch_size,
                                                  ds.split_len("train")),
                                 shuffle=False))
    state = init_state(cfg, net, sample, k_init)
    if cfg.net_pretrained_path:
        state = load_params_only(cfg.net_pretrained_path, state)
    opt = make_optimizer(cfg, state.params)
    state = TrainState(state.params, opt.init(state.params), state.step)
    train_step = make_train_step(cfg, net, formulas, coeffs, opt)
    eval_step = make_eval_step(cfg, net, formulas, coeffs)
    # device-side epoch chunking (exact; see make_chunked_steps).  The
    # mesh / shard-store / profiling paths keep per-batch dispatch.
    use_chunk = (cfg.train_chunk > 1 and mesh is None
                 and not cfg.use_shard_store and not cfg.time_profile)
    chunk_fn = (make_chunked_steps(cfg, net, formulas, coeffs, opt)
                if use_chunk else None)

    from pstl_tpu.utils.meters import EtaEstimator
    n_epochs = epochs if epochs is not None else cfg.epochs

    store = None
    if cfg.use_shard_store:
        # native data path: mmap column store + C++ thread-pool gather with
        # double-buffered prefetch (replaces DataLoader(num_workers=8))
        from pstl_tpu.data.dataset import (shard_store_iterator,
                                           to_shard_store)
        from pstl_tpu.runtime import ShardStore
        sdir = os.path.join("exps", cfg.exp_name or "_tmp", "shard_store")
        if not os.path.exists(os.path.join(sdir, "meta.json")):
            to_shard_store(ds, sdir)
        store = ShardStore(sdir)
        store_cols = tuple(
            c for c in store.columns
            if c.startswith(("ego", "neighbors", "curr", "left", "right",
                             "gt_", "params", "tj_scores", "pre_stlp")))

    def make_iter(mode, epi):
        if store is not None:
            return shard_store_iterator(store, ds, mode, cfg.batch_size,
                                        shuffle=(mode == "train"),
                                        seed=cfg.seed, epoch=epi,
                                        columns=store_cols)
        return batch_iterator(ds, mode, cfg.batch_size,
                              shuffle=(mode == "train"), seed=cfg.seed,
                              epoch=epi)

    eta = EtaEstimator(n_epochs, ds.split_len("train") // cfg.batch_size,
                       ds.split_len("val") // cfg.batch_size, cfg.viz_freq)
    COLS = ("ego", "neighbors", "curr", "left", "right", "gt_", "params",
            "tj_scores", "pre_stlp")
    for epi in range(n_epochs):
        for mode in ("train", "val"):
            md = MeterDict()
            it = make_iter(mode, epi)
            t0 = time.time()
            bi = -1
            timer = Timer() if cfg.time_profile else None
            if chunk_fn is not None:
                all_batches = [
                    {k: v for k, v in b.items() if k.startswith(COLS)}
                    for b in it]
                ks = []
                for _ in all_batches:
                    key, k_step = jax.random.split(key)
                    ks.append(k_step)
                C = cfg.train_chunk
                nb = len(all_batches)
                i0 = 0
                while i0 < nb:
                    j = min(i0 + C, nb)
                    if j - i0 == C:
                        stacked = jax.tree_util.tree_map(
                            lambda *xs: jnp.stack(
                                [jnp.asarray(x) for x in xs]),
                            *all_batches[i0:j])
                        st2, rds = chunk_fn(state, stacked,
                                            jnp.stack(ks[i0:j]),
                                            mode == "train")
                        if mode == "train":
                            state = st2
                        for k, v in rds.items():
                            v = np.asarray(v)
                            for t in range(C):
                                md.update(k, float(v[t]))
                    else:           # remainder: per-batch dispatch
                        for t in range(i0, j):
                            b = {k: jnp.asarray(v)
                                 for k, v in all_batches[t].items()}
                            if mode == "train":
                                state, rd = train_step(state, b, ks[t])
                            else:
                                rd = eval_step(state, b, ks[t])
                            for k in METRIC_KEYS:
                                if k in rd:
                                    md.update(k, float(rd[k]))
                    bi = j - 1
                    if mode == "train" and cfg.print_freq > 0 \
                            and (i0 // C) % max(cfg.print_freq // C, 1) == 0:
                        log(f"{mode:5s}[{epi:03d}|{bi:04d}] " + md.summary())
                    i0 = j
                dur = time.time() - t0
                eta.update(mode, dur, n=max(bi + 1, 1))
                if mode == "val":
                    eta.epoch_done()
                log(f"{mode:5s}[{epi:03d}] " + md.summary()
                    + f" T:{dur:.1f}s ETA:{eta.eta_str()}")
                continue
            for bi, batch in enumerate(it):
                if timer:
                    timer.add("data")
                batch = {k: jnp.asarray(v) for k, v in batch.items()
                         if k.startswith(("ego", "neighbors", "curr", "left",
                                          "right", "gt_", "params",
                                          "tj_scores", "pre_stlp"))}
                if mesh is not None:
                    batch = shard_batch(batch, mesh)
                key, k_step = jax.random.split(key)
                if timer:
                    timer.add("h2d")
                if mode == "train":
                    state, rd = train_step(state, batch, k_step)
                else:
                    rd = eval_step(state, batch, k_step)
                if timer:
                    jax.block_until_ready(rd["loss"])
                    timer.add("step")
                for k in ("loss", "loss_stl", "loss_diffusion", "loss_reg",
                          "loss_diversity", "loss_vae_bc", "loss_vae_kl",
                          "loss_bc", "acc", "tj_acc"):
                    if k in rd:
                        md.update(k, float(rd[k]))
                if timer:
                    timer.add("log")
                # per-batch progress (nusc_train.py:1544 print gating)
                if mode == "train" and cfg.print_freq > 0 \
                        and bi % cfg.print_freq == 0:
                    log(f"{mode:5s}[{epi:03d}|{bi:04d}] " + md.summary())
            if timer:
                log(f"profile[{epi:03d}|{mode}] " + timer.report())
            dur = time.time() - t0
            eta.update(mode, dur, n=max(bi + 1, 1))
            if mode == "val":
                eta.epoch_done()
            log(f"{mode:5s}[{epi:03d}] " + md.summary()
                + f" T:{dur:.1f}s ETA:{eta.eta_str()}")
        if epoch_cb is not None:
            epoch_cb(epi, state)
        if cfg.exp_name and (epi % cfg.save_freq == 0 or epi == n_epochs - 1):
            save_checkpoint(os.path.join("exps", cfg.exp_name, "models"),
                            state, epi)
        if (cfg.exp_name and not cfg.no_viz
                and (epi % cfg.viz_freq == 0 or epi == n_epochs - 1)):
            _viz_epoch(cfg, ds, epi, net=net, state=state,
                       formulas=formulas, coeffs=coeffs)
    return state


def _viz_epoch(cfg: Config, ds: SceneDataset, epi: int, net=None, state=None,
               formulas=None, coeffs=None, n_nn: int = 8):
    """Per-epoch scene plots (``plot_nuscene_viz``, nusc_viz.py:204-339):
    GT + the trajopt candidate fan + (for generative modes) a sampled model
    candidate fan with per-maneuver satisfaction in the title."""
    try:
        from pstl_tpu import viz
        from pstl_tpu.ops import dynamics as dyn_
        batch = next(batch_iterator(ds, "val", min(cfg.num_viz,
                                                   ds.split_len("val")),
                                    shuffle=False, drop_last=False))
        bs = batch["ego_traj"].shape[0]
        states = jnp.asarray(batch["ego_traj"][:, 0, :4])
        params_col = jnp.asarray(batch["params"])
        dense_states = jnp.broadcast_to(
            states[:, None, None], (bs, cfg.n_randoms, 3, 4))
        trajs = np.asarray(dyn_.rollout(dense_states, params_col, cfg.dt))
        scores = batch.get("tj_scores_prior")
        nn_trajs = nn_scores = None
        if (state is not None and cfg.multi_check and cfg.diffusion
                and formulas is not None):
            nn_trajs, nn_scores = _viz_sample(cfg, net, state.params,
                                              formulas, coeffs, batch, n_nn)
        batch = dict(batch)
        # drivable-raster backdrop (the reference draws map patches,
        # nusc_viz.py:204-339): scene_* tensors live in the per-SCENE
        # store — index them per sample via traj_i
        sd = getattr(ds, "scene_data", {})
        if "scene_drivable" in sd and "traj_i" in batch:
            ti = np.asarray(batch["traj_i"]).astype(int).reshape(-1)
            for k2 in ("scene_drivable", "scene_drivable_origin",
                       "scene_drivable_res"):
                batch[k2] = np.asarray(sd[k2])[ti]
        for i in range(min(bs, cfg.num_viz)):
            viz.plot_training_viz(
                os.path.join("exps", cfg.exp_name, "viz",
                             f"epoch{epi:04d}_scene{i:02d}.png"),
                batch, i, tj_trajs=trajs[i],
                tj_scores=(np.asarray(scores[i]) if scores is not None
                           else None),
                nn_trajs=(nn_trajs[i] if nn_trajs is not None else None),
                nn_scores=(nn_scores[i] if nn_scores is not None else None),
                epoch=epi, split="val")
    except Exception as e:   # viz must never kill training
        print(f"[viz] skipped: {e}")


def _viz_sample(cfg: Config, net, params, formulas, coeffs, batch, S: int):
    """Sample S candidates per (scene, maneuver) for visualization."""
    cfg_s = cfg.with_(n_randoms=S)
    batch = {k: jnp.asarray(v) for k, v in batch.items()
             if not k.startswith("scene_")}
    batch = attach_neighbors(batch, cfg_s)
    gt_trajs = batch["ego_traj"][..., :4]
    states = gt_trajs[:, 0, :4]
    bs = states.shape[0]
    n = bs * S * 3
    key = jax.random.PRNGKey(7)
    gt_stlp = specs.calibrate_stlp(batch, gt_trajs, cfg_s)
    dense = specs.densify_batch(batch, gt_stlp, cfg_s, key=key)
    ext0 = {"timestep": jnp.ones((n, 1)),
            "highlevel": dense["highlevel_dense"],
            "noise": jnp.zeros((n, cfg.nt * 2))}
    _, feature = net.apply(params, dense, ext0, get_feature=True,
                           n_randoms=S)
    controls, _ = diffusion.sample(
        key, lambda e: net.apply(params, dense, e, prev_feature=feature,
                                 n_randoms=S),
        dense, dense["highlevel_dense"], feature, cfg_s, coeffs, n)
    states_flat = jnp.broadcast_to(states[:, None, None],
                                   (bs, S, 3, 4)).reshape(n, 4)
    trajs = dyn.rollout(states_flat, controls, cfg_s.dt)
    score_rows = specs.make_score_rows(batch, dense, cfg_s, formulas,
                                       n_randoms=S)
    s = score_rows(trajs[:, :-1])
    return (np.asarray(trajs[:, :-1]).reshape(bs, S, 3, cfg.nt, 4),
            np.asarray(s).reshape(bs, S, 3))
