"""Device mesh and sharding helpers.

The reference is single-process/single-GPU (SURVEY.md §2.9 — no NCCL/MPI/
torch.distributed anywhere); its semantic parallel axes are the dense batch
(bs x n_randoms x 3) and the candidate axes.  This framework shards those
embarrassingly-parallel leading axes over a 1-D ``data`` mesh (device
links within a host; the mesh follows ``jax.devices()`` order and assumes
no topology):

- batches enter with ``shard_batch`` (leading axis split across devices),
- params/optimizer state are replicated,
- loss/metric reductions become compiler-scheduled ``psum``s (jnp.mean inside
  jit over sharded arrays lowers to the collective automatically),
- multi-host extends the same mesh across hosts via ``jax.distributed``.

Model parallelism is unnecessary at this scale (~0.5M-param MLP), so the
design is pure DP with XLA inserting all collectives.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",),
              devices=None) -> Mesh:
    """1-D (or user-shaped) device mesh.  shape entries of -1 absorb all
    remaining devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,)
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = n // known
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) axis, replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicate(mesh: Mesh):
    return NamedSharding(mesh, P())


def shard_batch(batch: Dict[str, Array], mesh: Mesh,
                axis: str = "data") -> Dict[str, Array]:
    """Place every batch array with its leading axis split over the mesh.
    Scalars / split-indivisible arrays are replicated."""
    n_dev = int(np.prod([mesh.shape[a] for a in (axis,)]))
    sharded = data_sharding(mesh, axis)
    repl = replicate(mesh)

    def place(x):
        x = jnp.asarray(x)
        if x.ndim >= 1 and x.shape[0] % n_dev == 0:
            return jax.device_put(x, sharded)
        return jax.device_put(x, repl)

    return {k: place(v) for k, v in batch.items()}


def psum_metrics(metrics: Dict[str, Array], axis: str = "data"):
    """Explicit cross-device mean for metrics inside shard_map bodies."""
    return {k: jax.lax.pmean(v, axis) for k, v in metrics.items()}


# --- candidate-axis (tensor-parallel) sharding -------------------------
#
# Scene-axis DP shards the batch; for SINGLE-scene latency the parallel
# axis is the candidate fan (n = bs*M*3 dense rows / the R axis of the
# candidate-minor sampler layout).  The planner's math is per-candidate
# independent until the final selection argmax, so constraining the
# candidate axis at the sampler's noise-creation point lets GSPMD shard
# the whole denoise+guidance scan over the mesh, inserting collectives only at
# the cross-candidate selection/diversity reductions.  Opt-in via
# ``candidate_sharding(mesh, "cand")`` around the jitted plan step; the
# hooks below are no-ops otherwise.

_CAND_CTX: list = [None]    # (Mesh, axis_name) or None


class candidate_sharding:
    """Context manager enabling candidate-axis sharding constraints.

    The context is read at TRACE time by :func:`constrain_candidates`, and
    jit's cache key cannot see it — a function first traced OUTSIDE the
    context would silently reuse its unsharded trace inside it (and vice
    versa).  To make that impossible, entering/exiting a context that
    CHANGES the active state clears jax's compilation caches: correctness
    over warm caches (the intended use is one enter per process, wrapping
    both construction and execution of the jitted step)."""

    def __init__(self, mesh: Mesh, axis: str = "cand"):
        self._entry = (mesh, axis)

    def __enter__(self):
        self._prev = _CAND_CTX[0]
        if self._prev != self._entry:
            jax.clear_caches()
        _CAND_CTX[0] = self._entry
        return self

    def __exit__(self, *exc):
        if _CAND_CTX[0] != self._prev:
            jax.clear_caches()
        _CAND_CTX[0] = self._prev
        return False


def constrain_candidates(x: Array, dim: int, batch_dim: int = None) -> Array:
    """Constrain array axis ``dim`` to the active candidate mesh axis
    (identity when no candidate_sharding context is active).

    On a 2-D (data x cand) mesh the scene axis must be co-sharded or GSPMD
    reshards at every consumer: ``batch_dim`` (candidate-minor layouts,
    where the scene axis is separate) pins that axis to "data"; when
    ``batch_dim is None`` and the mesh has a "data" axis, ``dim`` is the
    flat scene-major dense-row axis (bs*M*3) and is sharded over BOTH axes.
    """
    ctx = _CAND_CTX[0]
    if ctx is None or x is None:
        return x
    mesh, axis = ctx
    has_data = "data" in mesh.shape and axis != "data"
    ndim = x.ndim
    if dim < 0:
        dim += ndim
    names = [None] * ndim
    if batch_dim is None:
        names[dim] = ("data", axis) if has_data else axis
    else:
        names[dim] = axis
        if has_data:
            names[batch_dim % ndim] = "data"
    spec = P(*names)
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
