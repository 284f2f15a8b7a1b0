"""Policy network (diffusion / VAE / BC heads + RefineNet) in plain JAX.

Parity target: ``nusc_model.py:8-289`` (``Net``).  Architecture: all-MLP.
Encoders (ego 6->32, neighbor 7->32 with min/avg/max pooling over K, lane
45->32 per lane x3) produce a 224-dim scene feature; the policy head consumes
the feature plus a mode-specific latent; the RefineNet head maps
(feature, highlevel, stlp, controls [, fused diverse controls]) to a control
delta applied only to STL-violating samples, with an optional tanh interval
reparameterization that keeps corrected controls inside the box constraints.

Matmuls run in a configurable compute dtype (bf16 by default) with fp32
params and fp32 outputs at the head; all candidate tiling is plain
reshape/broadcast so XLA fuses it into the first matmul.

Parameters are a plain nested dict ``{"params": {<head>: {"Dense_<i>":
{"kernel", "bias"}}}}`` (lecun-normal kernels, zero biases, fp32).
``Net(cfg).init(key, *args, method=...)`` builds it lazily, creating only
the heads the traced method calls; ``Net(cfg).apply(params, *args,
method=...)`` runs a method against it.
"""

from __future__ import annotations

import copy
import functools
import zlib
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from pstl_tpu.config import Config

Array = jax.Array


def normalize_xyth(state: Array, base: Array, valid: Optional[Array] = None,
                   no_theta: bool = False) -> Array:
    """Ego-frame normalization (nusc_model.py:238-263): translate by base
    (x, y) (gated by ``valid``) and rotate into the base heading frame."""
    x, y = state[..., 0], state[..., 1]
    bx, by, bth = base[..., 0], base[..., 1], base[..., 2]
    if valid is not None:
        xt = x - bx * valid
        yt = y - by * valid
    else:
        xt = x - bx
        yt = y - by
    c, s = jnp.cos(bth), jnp.sin(bth)
    x_rel = xt * c + yt * s
    y_rel = -xt * s + yt * c
    if no_theta:
        return jnp.stack([x_rel, y_rel], axis=-1)
    th = state[..., 2]
    th_rel = th - bth * valid if valid is not None else th - bth
    return jnp.stack([x_rel, y_rel, th_rel], axis=-1)


def pos_encoding(t: Array, channels: int) -> Array:
    """Sinusoidal diffusion-timestep embedding (nusc_model.py:48-53).
    t: (n, 1) -> (n, channels)."""
    inv_freq = 1.0 / (10000 ** (jnp.arange(0, channels, 2,
                                           dtype=jnp.float32) / channels))
    ang = t.astype(jnp.float32) * inv_freq[None, :]
    return jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)


def init_mlp(key: Array, d_in: int, features: Sequence[int]) -> Dict:
    """Dense-stack parameters: lecun-normal kernels, zero biases, fp32."""
    init = jax.nn.initializers.lecun_normal()
    params = {}
    for i, (k, f) in enumerate(zip(jax.random.split(key, len(features)),
                                   features)):
        params[f"Dense_{i}"] = {"kernel": init(k, (d_in, f), jnp.float32),
                                "bias": jnp.zeros((f,), jnp.float32)}
        d_in = f
    return params


def mlp_apply(params: Dict, x: Array, dtype=jnp.float32) -> Array:
    """Dense-ReLU stack, ReLU between layers only (utils.py:91-101).
    Inputs, kernels and biases are cast to ``dtype``; the output is fp32."""
    n = len(params)
    x = x.astype(dtype)
    for i in range(n):
        layer = params[f"Dense_{i}"]
        x = jax.lax.dot_general(x, layer["kernel"].astype(dtype),
                                (((x.ndim - 1,), (0,)), ((), ())))
        x = x + layer["bias"].astype(dtype)
        if i < n - 1:
            x = jax.nn.relu(x)
    return x.astype(jnp.float32)


class _Scope:
    """The parameter dict one ``init`` or ``apply`` call reads.  With a key
    (``init``), a head that has no parameters yet gets fresh ones."""

    def __init__(self, params: Dict, key: Optional[Array] = None):
        self.params = params
        self.key = key

    def mlp(self, name: str, features: Tuple[int, ...], dtype, x: Array):
        if name not in self.params:
            if self.key is None:
                raise KeyError(f"no parameters for head {name!r}")
            k = jax.random.fold_in(self.key,
                                   zlib.crc32(name.encode()) & 0x7FFFFFFF)
            self.params[name] = init_mlp(k, x.shape[-1], features)
        return mlp_apply(self.params[name], x, dtype)


class Net:
    """Conditional policy network with diffusion / VAE / BC modes and an
    optional RefineNet rectification head."""

    FEAT_DIM: int = 32
    STLP_DIM: int = 6
    TIME_DIM: int = 32
    LANE_DIM: int = 3

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def _heads(self) -> Dict[str, Tuple[int, ...]]:
        """Output widths of every Dense stack this configuration has."""
        cfg = self.cfg
        h = tuple(cfg.hiddens)
        heads = {"ego_encoder": h + (self.FEAT_DIM,),
                 "neighbor_encoder": h + (self.FEAT_DIM,),
                 "lane_encoder": h + (self.FEAT_DIM,),
                 "policy_net": h + (cfg.nt * 2,)}
        if cfg.vae:
            heads["traj_encoder"] = h + (cfg.vae_dim * 2,)
        if cfg.rect_head:
            if cfg.diverse_loss:
                heads["merge_net"] = (32, 32, cfg.nt * 2)
            heads["rect_net"] = tuple(cfg.rect_hiddens) + (cfg.nt * 2,)
        return heads

    def _bind(self, scope: _Scope) -> "Net":
        """A copy of this net whose head attributes (``self.ego_encoder``
        ...) run against ``scope``'s parameters."""
        dt = (jnp.bfloat16 if self.cfg.compute_dtype == "bfloat16"
              else jnp.float32)
        bound = copy.copy(self)
        for name, features in self._heads().items():
            setattr(bound, name, functools.partial(scope.mlp, name, features,
                                                   dt))
        return bound

    def init(self, key: Array, *args, method=None, **kw) -> Dict:
        """Parameters for every head ``method`` (default ``__call__``)
        reaches on these inputs."""
        scope = _Scope({}, key)
        (method or Net.__call__)(self._bind(scope), *args, **kw)
        return {"params": scope.params}

    def apply(self, params: Dict, *args, method=None, **kw):
        """Run ``method`` (default ``__call__``) with ``params``."""
        return (method or Net.__call__)(self._bind(_Scope(params["params"])),
                                        *args, **kw)

    # ------------------------------------------------------------------
    def encode(self, batch: Dict[str, Array]) -> Array:
        """Scene feature (nusc_model.py:55-95): 7*32 = 224 dims."""
        cfg = self.cfg
        bs = batch["ego_traj"].shape[0]
        ego = batch["ego_traj"][:, 0]                     # (bs, >=4)
        ego_un = ego[:, None, :]

        neis = batch["neighbors"]                         # (bs, K, 7)
        neis_xyth = normalize_xyth(neis[..., 1:4], ego_un[..., :3],
                                   neis[..., 0])
        neis_in = jnp.concatenate([neis[..., 0:1], neis_xyth, neis[..., 4:7]],
                                  axis=-1)

        lanes = []
        for key in ("curr", "left", "right"):
            lanes.append(normalize_xyth(batch[f"{key}lane_wpts"],
                                        ego_un[..., :3],
                                        batch[f"{key}_id"]))
        lanes = jnp.stack(lanes, axis=1)                  # (bs, 3, nseg, 3)
        # difference encoding: first waypoint + deltas (nusc_model.py:73-76)
        lanes_in = jnp.concatenate(
            [lanes[..., 0:1, :], lanes[..., 1:, :] - lanes[..., :-1, :]],
            axis=-2).reshape(bs, 3, cfg.n_segs * self.LANE_DIM)

        ego_xyth = normalize_xyth(ego[..., :3], ego[..., :3])
        ego_in = jnp.concatenate([ego_xyth, ego[..., 3:]], axis=-1)

        ego_feat = self.ego_encoder(ego_in)               # (bs, 32)
        nei_feat = self.neighbor_encoder(neis_in)         # (bs, K, 32)
        nei_feat = jnp.concatenate([jnp.min(nei_feat, 1), jnp.mean(nei_feat, 1),
                                    jnp.max(nei_feat, 1)], axis=-1)
        lane_feat = self.lane_encoder(lanes_in).reshape(bs, -1)  # (bs, 96)
        return jnp.concatenate([ego_feat, nei_feat, lane_feat], axis=-1)

    # ------------------------------------------------------------------
    def __call__(self, batch: Dict[str, Array], ext: Dict[str, Array],
                 prev_feature: Optional[Array] = None,
                 n_randoms: Optional[int] = None, get_feature: bool = False,
                 sample: Optional[Array] = None):
        """Forward pass (nusc_model.py:97-180).

        ext keys per mode:
          diffusion: timestep (n,1), highlevel (n,1), noise (n, nt*2)
          vae:       highlevel, noise (n, vae_dim) [,"trajopt_controls"] or
                     ``sample`` latent directly
          bc:        highlevel
        In multi-candidate mode the scene feature is tiled to
        bs * n_randoms * 3 rows; ``stlp_dense`` supplies the conditioning
        parameters.
        """
        cfg = self.cfg
        bs = batch["ego_traj"].shape[0]
        multi = cfg.multi_check
        if n_randoms is None:
            n_randoms = cfg.n_randoms

        if prev_feature is not None:
            feature = prev_feature
        else:
            feature = self.encode(batch)
            if multi:
                k = feature.shape[-1]
                n_rep = n_randoms * 3
                feature = jnp.broadcast_to(feature[:, None, :],
                                           (bs, n_rep, k)).reshape(-1, k)

        if multi:
            stlp_feat = batch["stlp_dense"][:, 0]
        else:
            stlp_feat = ext["gt_stlp"]

        latent_stats = (None, None, None)

        def tile(v):
            return jnp.broadcast_to(
                v[:, None, :], (bs, n_randoms) + v.shape[1:]).reshape(
                    (bs * n_randoms,) + v.shape[1:])

        if cfg.diffusion:
            time_feat = pos_encoding(ext["timestep"], self.TIME_DIM)
            if multi:
                pin = jnp.concatenate([feature, ext["noise"], time_feat,
                                       ext["highlevel"], stlp_feat], axis=-1)
            else:
                # mono (gt_data_training) path: tile per-scene tensors
                pin = jnp.concatenate([tile(feature), ext["noise"], time_feat,
                                       tile(ext["highlevel"]),
                                       tile(stlp_feat)], axis=-1)
        elif cfg.bc:
            pin = jnp.concatenate([feature, ext["highlevel"], stlp_feat],
                                  axis=-1)
        elif cfg.vae:
            if sample is not None:
                latent = sample
                feat, hl, stlp = feature, ext["highlevel"], stlp_feat
            else:
                if multi:
                    code = self.traj_encoder(
                        ext["trajopt_controls"].reshape(-1, cfg.nt * 2))
                    feat, hl, stlp = feature, ext["highlevel"], stlp_feat
                else:
                    code = self.traj_encoder(
                        ext["gt_controls"].reshape(-1, cfg.nt * 2))
                    code = tile(code)
                    feat, hl, stlp = (tile(feature), tile(ext["highlevel"]),
                                      tile(stlp_feat))
                mean = code[..., :cfg.vae_dim]
                logstd = code[..., cfg.vae_dim:]
                std = jnp.exp(logstd)
                latent = ext["noise"] * std + mean
                latent_stats = (mean, logstd, std)
            pin = jnp.concatenate([feat, latent, hl, stlp], axis=-1)
        else:
            pin = jnp.concatenate([feature, batch["gt_high_level"],
                                   stlp_feat], axis=-1)

        if cfg.use_init_hint:
            hint = batch["params_init"].reshape(pin.shape[:-1] + (cfg.nt * 2,))
            pin = jnp.concatenate([pin, hint], axis=-1)

        raw = self.policy_net(pin)
        if cfg.diffusion:
            # residual epsilon-prediction (nusc_model.py:161-162), unbounded
            raw = raw + ext["noise"]
            controls = raw.reshape(-1, cfg.nt, 2)
        else:
            raw = raw.reshape(-1, cfg.nt, 2)
            controls = jnp.stack(
                [jnp.tanh(raw[..., 0]) * cfg.mul_w_max,
                 jnp.tanh(raw[..., 1]) * cfg.mul_a_max], axis=-1)

        if get_feature:
            return controls, feature
        if cfg.vae:
            return controls, latent_stats
        return controls

    # ------------------------------------------------------------------
    def init_all(self, batch: Dict[str, Array], ext: Dict[str, Array]):
        """Initialization entry that touches every head (``__call__`` alone
        never traces the RefineNet).  Use as
        ``net.init(key, batch, ext, method=Net.init_all)``."""
        cfg = self.cfg
        out = self(batch, ext, get_feature=True)
        controls, feature = out[0], out[-1]
        if cfg.rect_head:
            n = feature.shape[0]
            hl = (ext.get("highlevel") if "highlevel" in ext
                  else jnp.zeros((n, 1)))
            stlp = (batch["stlp_dense"][:, 0] if "stlp_dense" in batch
                    else jnp.zeros((n, self.STLP_DIM)))
            zeros_u = jnp.zeros((n, cfg.nt, 2))
            self.rect(feature, hl, stlp, zeros_u, jnp.zeros((n,)))
        return controls

    # ------------------------------------------------------------------
    def rect(self, feature: Array, highlevel: Array, stlp: Array,
             init_controls: Array, scores: Array) -> Array:
        """RefineNet rectification (nusc_model.py:182-235).

        Maps violating candidates (scores < 0) to corrected controls; with
        ``cfg.interval`` the delta is tanh-reparameterized so the result
        stays inside [-mul_w_max, mul_w_max] x [-mul_a_max, mul_a_max].
        With ``cfg.diverse_loss`` a merge-net + shard-wise max pool fuses
        information across each candidate shard before rectifying.
        """
        cfg = self.cfg
        n = feature.shape[0]
        if cfg.diverse_loss and not cfg.no_arch:
            fused = self.merge_net(init_controls.reshape(-1, cfg.nt * 2))
            bs = n // (3 * cfg.n_randoms)
            NS = cfg.n_shards
            assert cfg.n_randoms % NS == 0 and n % (3 * cfg.n_randoms) == 0, (
                f"rect diversity fusion needs n_randoms ({cfg.n_randoms}) "
                f"divisible by n_shards ({NS}) and rows ({n}) divisible by "
                f"3*n_randoms")
            fused = fused.reshape(bs, cfg.n_randoms, 3, cfg.nt * 2)
            fused = jnp.transpose(fused, (0, 2, 1, 3))
            fused = fused.reshape(bs, 3, NS, cfg.n_randoms // NS, cfg.nt * 2)
            fused = jnp.max(fused, axis=3, keepdims=True)
            fused = jnp.broadcast_to(
                fused, (bs, 3, NS, cfg.n_randoms // NS, cfg.nt * 2)).reshape(
                    bs, 3, cfg.n_randoms, cfg.nt * 2)
            fused = jnp.transpose(fused, (0, 2, 1, 3)).reshape(n, cfg.nt, 2)
            if cfg.diverse_fuse_type == "add":
                fused = init_controls + fused
                pin = jnp.concatenate([feature, highlevel, stlp,
                                       fused.reshape(n, cfg.nt * 2)], axis=-1)
            elif cfg.diverse_fuse_type == "cat":
                pin = jnp.concatenate([feature, highlevel, stlp,
                                       init_controls.reshape(n, cfg.nt * 2),
                                       fused.reshape(n, cfg.nt * 2)], axis=-1)
            else:
                raise NotImplementedError(cfg.diverse_fuse_type)
        else:
            pin = jnp.concatenate([feature, highlevel, stlp,
                                   init_controls.reshape(n, cfg.nt * 2)],
                                  axis=-1)
        raw = self.rect_net(pin).reshape(n, cfg.nt, 2)

        if cfg.interval:
            init_w, init_a = init_controls[..., 0], init_controls[..., 1]
            t = jnp.tanh(raw)
            w_mask = (t[..., 0] >= 0).astype(t.dtype)
            a_mask = (t[..., 1] >= 0).astype(t.dtype)
            w0 = t[..., 0] * (init_w + cfg.mul_w_max)
            w1 = t[..., 0] * (cfg.mul_w_max - init_w)
            a0 = t[..., 1] * (init_a + cfg.mul_a_max)
            a1 = t[..., 1] * (cfg.mul_a_max - init_a)
            raw = jnp.stack([w0 * (1 - w_mask) + w1 * w_mask,
                             a0 * (1 - a_mask) + a1 * a_mask], axis=-1)

        violated = (scores < 0).astype(raw.dtype)[:, None, None]
        out = init_controls + raw * violated
        if cfg.clip_rect:
            out = jnp.stack(
                [jnp.clip(out[..., 0], -cfg.mul_w_max, cfg.mul_w_max),
                 jnp.clip(out[..., 1], -cfg.mul_a_max, cfg.mul_a_max)],
                axis=-1)
        return out


# ----------------------------------------------------------------------
def make_cm_eps_fn(params, batch: Dict[str, Array], highlevel: Array,
                   feature: Array, cfg: Config,
                   n_randoms: Optional[int] = None):
    """Candidate-minor epsilon predictor for the DDPM reverse scan.

    The diffusion forward (``Net.__call__``, multi-candidate path; ref
    nusc_model.py:97-162) is pin = concat([feature, noise, time_emb,
    highlevel, stlp]) -> Dense/ReLU stack -> raw + noise.  Layer 1 is
    LINEAR, so it splits by input block:

    - feature / highlevel / stlp (+ init hint) are loop-invariant per
      denoise step -> their layer-1 contribution ``base`` is computed once
      and transposed to candidate-minor (bs, h1, R) BEFORE the scan;
    - the timestep embedding is identical for every row -> one (h1,)
      vector per denoise step;
    - only the noise block depends on x -> einsum('bdr,dh->bhr') keeps the
      candidate axis minor.

    Layers 2+ run as (bs, h, R) x (h, k) batched matmuls.  The reverse
    scan therefore needs NO per-step layout transposes.  Split == fused
    Dense up to bf16 summation order
    (exact in fp32; equality-tested in tests/test_diffusion.py).

    Returns ``eps_cm(x_cm, t_scalar) -> eps`` on (bs, nt, 2, R) arrays,
    r = j * M + m j-major — specs.CandMinorGuidanceLoss's layout.
    """
    p = params["params"]["policy_net"]
    nl = len(cfg.hiddens) + 1
    kern = [p[f"Dense_{i}"]["kernel"] for i in range(nl)]
    bias = [p[f"Dense_{i}"]["bias"] for i in range(nl)]
    dt = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
    M = n_randoms if n_randoms is not None else cfg.n_randoms
    D = cfg.nt * 2
    TD = Net.TIME_DIM
    F = feature.shape[-1]
    bs = feature.shape[0] // (M * 3)
    R = M * 3
    stlp_feat = batch["stlp_dense"][:, 0]
    W1 = kern[0]
    o = F + D + TD                     # pin column offsets past time block
    base = (feature.astype(dt) @ W1[:F].astype(dt)
            + highlevel.astype(dt) @ W1[o:o + 1].astype(dt)
            + stlp_feat.astype(dt) @ W1[o + 1:o + 1 + Net.STLP_DIM]
            .astype(dt)
            + bias[0].astype(dt))
    if cfg.use_init_hint:
        hint = batch["params_init"].reshape(-1, D)
        base = base + hint.astype(dt) @ W1[o + 1 + Net.STLP_DIM:].astype(dt)
    h1 = base.shape[-1]
    # m-major rows (bs, M, 3, h1) -> candidate-minor (bs, h1, R), r=j*M+m
    base_cm = jnp.transpose(base.reshape(bs, M, 3, h1),
                            (0, 3, 2, 1)).reshape(bs, h1, R)
    Wn = W1[F:F + D].astype(dt)
    Wt = W1[F + D:o].astype(dt)

    def mm(h, W):
        """(bs, d, R) x (d, k) -> (bs, k, R).  The plain einsum lowers to
        dot_general -> (k, bs, R) plus a per-layer stablehlo.transpose;
        the broadcast-batch form puts bs in BOTH operands so the dot's
        canonical (batch, lhs_free, rhs_free) output IS (bs, k, R) —
        zero transposes in the lowered module (the broadcast weight read
        is ~the same bytes as the transpose it replaces)."""
        if cfg.cm_broadcast_dots:
            Wb = jnp.broadcast_to(W.T[None], (bs, W.shape[1], W.shape[0]))
            return jnp.einsum("bkh,bhr->bkr", Wb, h)
        return jnp.einsum("bhr,hk->bkr", h, W)

    def eps_cm(x_cm: Array, t_scalar) -> Array:
        te = pos_encoding(jnp.full((1, 1), t_scalar, jnp.float32), TD)
        h = (base_cm + (te.astype(dt) @ Wt)[0][None, :, None]
             + mm(x_cm.reshape(bs, D, R).astype(dt), Wn))
        h = jax.nn.relu(h)
        for i in range(1, nl - 1):
            h = jax.nn.relu(mm(h, kern[i].astype(dt))
                            + bias[i].astype(dt)[None, :, None])
        raw = (mm(h, kern[-1].astype(dt))
               + bias[-1].astype(dt)[None, :, None])
        return raw.astype(jnp.float32).reshape(bs, cfg.nt, 2, R) + x_cm

    return eps_cm
