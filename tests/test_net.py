"""Plain-JAX policy network: forward against a float64 numpy reference built
from the parameter tree, and the parameter tree against the manifest of the
earlier flax module (the checkpoints' layout)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pstl_tpu import specs, train
from pstl_tpu.config import Config, PRESETS
from pstl_tpu.data.dataset import SceneDataset, batch_iterator
from pstl_tpu.models import Net
from tests.test_specs import make_batch

MANIFEST = os.path.join(os.path.dirname(__file__), "golden",
                        "net_param_manifest.json")


# ---------------------------------------------------------------------------
# float64 numpy reference forward
# ---------------------------------------------------------------------------

def np_mlp(p, x):
    n = len(p)
    for i in range(n):
        x = x @ np.asarray(p[f"Dense_{i}"]["kernel"], np.float64) \
            + np.asarray(p[f"Dense_{i}"]["bias"], np.float64)
        if i < n - 1:
            x = np.maximum(x, 0.0)
    return x


def np_normalize(state, base, valid=None):
    x, y, th = state[..., 0], state[..., 1], state[..., 2]
    bx, by, bth = base[..., 0], base[..., 1], base[..., 2]
    v = 1.0 if valid is None else valid
    xt, yt = x - bx * v, y - by * v
    c, s = np.cos(bth), np.sin(bth)
    return np.stack([xt * c + yt * s, -xt * s + yt * c, th - bth * v], -1)


def np_feature(p, b, n_rep):
    b = {k: np.asarray(v, np.float64) for k, v in b.items()}
    ego = b["ego_traj"][:, 0]
    neis = b["neighbors"]
    nei_in = np.concatenate([neis[..., 0:1],
                             np_normalize(neis[..., 1:4], ego[:, None, :3],
                                          neis[..., 0]),
                             neis[..., 4:7]], -1)
    lanes = np.stack([np_normalize(b[f"{k}lane_wpts"], ego[:, None, :3],
                                   b[f"{k}_id"])
                      for k in ("curr", "left", "right")], 1)
    lanes = np.concatenate([lanes[..., :1, :],
                            lanes[..., 1:, :] - lanes[..., :-1, :]], -2)
    bs = ego.shape[0]
    ego_in = np.concatenate([np_normalize(ego[:, :3], ego[:, :3]),
                             ego[:, 3:]], -1)
    nf = np_mlp(p["neighbor_encoder"], nei_in)
    f = np.concatenate([np_mlp(p["ego_encoder"], ego_in), nf.min(1),
                        nf.mean(1), nf.max(1),
                        np_mlp(p["lane_encoder"],
                               lanes.reshape(bs, 3, -1)).reshape(bs, -1)],
                       -1)
    return np.repeat(f, n_rep, axis=0)


def np_pos_encoding(t, ch):
    inv = 1.0 / (10000 ** (np.arange(0, ch, 2) / ch))
    ang = t * inv[None]
    return np.concatenate([np.sin(ang), np.cos(ang)], -1)


def np_forward(cfg, p, dense, ext):
    n_rep = cfg.n_randoms * 3
    feat = np_feature(p, dense, n_rep)
    ext = {k: np.asarray(v, np.float64) for k, v in ext.items()}
    stlp = np.asarray(dense["stlp_dense"], np.float64)[:, 0]
    if cfg.diffusion:
        pin = np.concatenate([feat, ext["noise"],
                              np_pos_encoding(ext["timestep"], 32),
                              ext["highlevel"], stlp], -1)
        return (np_mlp(p["policy_net"], pin) + ext["noise"]).reshape(
            -1, cfg.nt, 2)
    if cfg.vae:
        code = np_mlp(p["traj_encoder"],
                      ext["trajopt_controls"].reshape(-1, cfg.nt * 2))
        latent = (ext["noise"] * np.exp(code[:, cfg.vae_dim:])
                  + code[:, :cfg.vae_dim])
        pin = np.concatenate([feat, latent, ext["highlevel"], stlp], -1)
    else:
        pin = np.concatenate([feat, ext["highlevel"], stlp], -1)
    raw = np_mlp(p["policy_net"], pin).reshape(-1, cfg.nt, 2)
    return np.stack([np.tanh(raw[..., 0]) * cfg.mul_w_max,
                     np.tanh(raw[..., 1]) * cfg.mul_a_max], -1)


def np_rect(cfg, p, feat, hl, stlp, u, scores):
    n = feat.shape[0]
    pin = np.concatenate([feat, hl, stlp, u.reshape(n, -1)], -1)
    t = np.tanh(np_mlp(p["rect_net"], pin).reshape(n, cfg.nt, 2))
    lo = np.stack([u[..., 0] + cfg.mul_w_max, u[..., 1] + cfg.mul_a_max], -1)
    hi = np.stack([cfg.mul_w_max - u[..., 0], cfg.mul_a_max - u[..., 1]], -1)
    delta = np.where(t >= 0, t * hi, t * lo)
    return u + delta * (scores < 0)[:, None, None]


def _setup(cfg, seed=0):
    bs = 2
    batch = make_batch(cfg, bs=bs, seed=seed)
    batch["neighbors"] = batch["neighbor_trajs_aug"][:, :, 0, :]
    stlp = specs.calibrate_stlp(batch, batch["ego_traj"][..., :4], cfg)
    dense = specs.densify_batch(batch, stlp, cfg, key=jax.random.PRNGKey(0))
    n = bs * cfg.n_randoms * 3
    rng = np.random.RandomState(seed)
    hl = dense["highlevel_dense"]
    if cfg.diffusion:
        ext = {"timestep": jnp.asarray(rng.randint(1, 99, (n, 1)),
                                       jnp.float32),
               "highlevel": hl,
               "noise": jnp.asarray(rng.randn(n, cfg.nt * 2), jnp.float32)}
    elif cfg.vae:
        ext = {"highlevel": hl,
               "noise": jnp.asarray(rng.randn(n, cfg.vae_dim), jnp.float32),
               "trajopt_controls": jnp.asarray(rng.randn(n, cfg.nt, 2),
                                               jnp.float32)}
    else:
        ext = {"highlevel": hl}
    return dense, ext


MODES = {
    "diffusion": dict(diffusion=True),
    "bc": dict(bc=True),
    "vae": dict(vae=True),
    "rect": dict(diffusion=True, rect_head=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_forward_matches_numpy_reference(mode):
    cfg = Config(n_randoms=4, n_neighbors=2, compute_dtype="float32",
                 **MODES[mode]).finalize()
    net = Net(cfg)
    dense, ext = _setup(cfg)
    params = net.init(jax.random.PRNGKey(1), dense, ext, method=Net.init_all)
    p = params["params"]
    with jax.default_matmul_precision("highest"):
        out = net.apply(params, dense, ext, get_feature=True)
        if mode == "rect":
            feat = out[-1]
            n = feat.shape[0]
            rng = np.random.RandomState(3)
            u = jnp.asarray(rng.randn(n, cfg.nt, 2) * 0.3, jnp.float32)
            sc = jnp.asarray(rng.randn(n), jnp.float32)
            hl, st = dense["highlevel_dense"], dense["stlp_dense"][:, 0]
            got = net.apply(params, feat, hl, st, u, sc, method=Net.rect)
            want = np_rect(cfg, p, np_feature(p, dense, cfg.n_randoms * 3),
                           np.asarray(hl, np.float64),
                           np.asarray(st, np.float64),
                           np.asarray(u, np.float64), np.asarray(sc))
        else:
            got, want = out[0], np_forward(cfg, p, dense, ext)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# parameter tree
# ---------------------------------------------------------------------------

def _manifest(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(k.key for k in path): list(np.shape(v))
            for path, v in flat}


MANIFEST_MODES = ["bc", "e2_vae_mono", "e3_vae", "e4_ddpm_mono", "e5_ddpm",
                  "e6_trafficsim", "e7_ours"]


@pytest.mark.parametrize("mode", MANIFEST_MODES)
def test_param_tree_matches_flax_manifest(mode):
    """Same key paths and shapes as the flax module the checkpoints were
    written from, for ``init_all`` and for the default ``__call__`` init
    (which creates only the heads the call reaches)."""
    with open(MANIFEST) as f:
        want = json.load(f)[mode]
    cfg = (Config(bc=True, rect_head=True).finalize() if mode == "bc"
           else PRESETS[mode]).with_(n_randoms=8, batch_size=2)
    ds = SceneDataset.from_synthetic(cfg, n_scenes=4)
    ds.ensure_random_params(0)
    b = next(batch_iterator(ds, "train", 2, shuffle=False))
    b = {k: jnp.asarray(v) for k, v in b.items()
         if not k.startswith(("scene_", "traj_i", "ti"))}
    net = Net(cfg)
    dense, ext = train._init_inputs(cfg, b, jax.random.PRNGKey(0))
    assert _manifest(net.init(jax.random.PRNGKey(0), dense, ext,
                              method=Net.init_all)) == want["init_all"]
    assert _manifest(net.init(jax.random.PRNGKey(0), dense,
                              ext)) == want["call"]
