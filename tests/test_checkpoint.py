"""``.npz`` checkpoints: round trip with optimizer state, pretrained-weight
loads, the committed flagship checkpoints."""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pstl_tpu import train
from pstl_tpu.config import PRESETS
from pstl_tpu.data.dataset import SceneDataset, batch_iterator
from pstl_tpu.models import Net

CKPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints")


def _state(preset):
    cfg = PRESETS[preset].with_(n_randoms=4, n_neighbors=2, batch_size=2)
    ds = SceneDataset.from_synthetic(cfg, n_scenes=4)
    ds.ensure_random_params(0)
    b = next(batch_iterator(ds, "train", 2, shuffle=False))
    b = {k: jnp.asarray(v) for k, v in b.items()
         if not k.startswith(("scene_", "traj_i", "ti"))}
    return train.init_state(cfg, Net(cfg), b, jax.random.PRNGKey(0))


def _leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def test_roundtrip_with_optimizer_state(tmp_path):
    """Params, the RefineNet-only multi_transform Adam state and the step
    come back bit for bit, into the same tree structures."""
    st = _state("e7_ours")
    # make the optimizer state non-trivial: perturb every leaf
    st = jax.tree_util.tree_map(
        lambda x: x + jnp.ones_like(x) if x.dtype != jnp.int32 else x + 3,
        st)
    path = train.save_checkpoint(str(tmp_path), st, 7)
    assert os.path.basename(path) == "step_00000007.npz"
    back = train.load_checkpoint(str(tmp_path), _state("e7_ours"))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(st))
    for a, b in zip(_leaves(back), _leaves(st)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the file itself resolves too, and no temporary file is left behind
    assert train._resolve_ckpt(path) == path
    assert sorted(os.listdir(tmp_path)) == ["LAST", "step_00000007.npz"]


def test_load_params_only_tolerates_missing_rect_head(tmp_path):
    """A DDPM base checkpoint (no RefineNet) loads into an e7 model: the
    shared heads are replaced, the RefineNet heads keep their init."""
    base = _state("e5_ddpm")
    base = base._replace(params=jax.tree_util.tree_map(
        lambda x: x + 1.0, base.params))
    train.save_checkpoint(str(tmp_path), base, 0)
    e7 = _state("e7_ours")
    out = train.load_params_only(str(tmp_path), e7).params["params"]
    for head in ("ego_encoder", "policy_net"):
        np.testing.assert_array_equal(
            np.asarray(out[head]["Dense_0"]["kernel"]),
            np.asarray(base.params["params"][head]["Dense_0"]["kernel"]))
    for head in ("rect_net", "merge_net"):
        np.testing.assert_array_equal(
            np.asarray(out[head]["Dense_0"]["kernel"]),
            np.asarray(e7.params["params"][head]["Dense_0"]["kernel"]))


def test_load_checkpoint_rejects_other_model(tmp_path):
    train.save_checkpoint(str(tmp_path), _state("e5_ddpm"), 0)
    with pytest.raises(ValueError):
        train.load_checkpoint(str(tmp_path), _state("e7_ours"))


@pytest.mark.parametrize("name,preset", [("e7_round5", "e7_ours"),
                                         ("e5b_round5", "e5_ddpm")])
def test_committed_checkpoint_matches_checksums(name, preset):
    """Every array of the committed checkpoint matches the checksum taken
    when it was converted, and the checkpoint loads into its model with
    its optimizer state."""
    with open(os.path.join(CKPTS, "CHECKSUMS.json")) as f:
        want = json.load(f)[name]
    path = train._resolve_ckpt(os.path.join(CKPTS, name))
    with np.load(path) as z:
        got = {k: hashlib.sha256(np.ascontiguousarray(z[k]).tobytes())
               .hexdigest()[:16] for k in z.files}
    assert got == want
    st = train.load_checkpoint(os.path.join(CKPTS, name), _state(preset))
    assert all(np.isfinite(x).all() for x in _leaves(st.params))
