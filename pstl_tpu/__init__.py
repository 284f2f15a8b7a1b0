"""pstl_tpu — a JAX framework for diverse, controllable,
rule-compliant diffusion driving policies with parametric Signal Temporal
Logic (pSTL).

Re-implements the full capability surface of ``mengyuest/pSTL-diffusion-policy``
(RA-L 2024 / ICRA 2025) as a layered, device-resident JAX library:

- ``pstl_tpu.ops.stl``       differentiable STL robustness (soft & hard semantics)
- ``pstl_tpu.ops.dynamics``  unicycle rollout as ``lax.scan``
- ``pstl_tpu.ops.geometry``  lane-distance / car-clearance kernels
- ``pstl_tpu.specs``         driving pSTL formulas, calibration, dense batching
- ``pstl_tpu.models``        policy network (diffusion / VAE / BC + RefineNet)
- ``pstl_tpu.diffusion``     DDPM sampler with fused STL guidance (one scan)
- ``pstl_tpu.trajopt``       gradient trajectory-optimization data augmentation
- ``pstl_tpu.losses``        STL / diffusion / VAE / BC / DPP-diversity losses
- ``pstl_tpu.train``         training engine (optax, .npz checkpoints, data mesh)
- ``pstl_tpu.sim``           device-resident closed-loop replanning simulator
- ``pstl_tpu.eval_openloop`` open-loop evaluation harness (Table-I metrics)
- ``pstl_tpu.metrics``       on-device diversity metrics (std/hull/entropy/area)
- ``pstl_tpu.parallel``      mesh construction and sharding helpers
- ``pstl_tpu.data``          synthetic scene generator + fixed-shape datasets

Design stance (compiled, not a port): static shapes everywhere, explicit PRNG
keys, ``lax.scan`` for every sequential loop, ``vmap`` over candidate axes,
``jax.sharding`` over a data mesh axis, robustness computed in float32.
"""

__version__ = "0.1.0"


from pstl_tpu.config import Config  # noqa: F401
