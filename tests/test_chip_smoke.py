"""``chip_smoke.py`` on the CPU: its device guard, its compile-cache rule,
and its phases at tiny widths (the flagship run needs the GPU)."""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import pytest

import chip_smoke
from pstl_tpu.utils import device

TINY = chip_smoke.Sizes(bs=2, n_randoms=4, n_neighbors=2, diffusion_steps=6,
                        chunk=2, dispatches=1, cli_scenes=2, cli_steps=2,
                        train_batch=4, train_steps=2, multi_train_batch=8,
                        check_quality=False)


def test_device_guard_refuses_cpu(capsys):
    """On a CPU-only JAX, main() exits non-zero before any phase and
    prints no result line."""
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_device_guard_accepts_gpu(monkeypatch):
    """With JAX reporting a GPU, the guard passes and reports it."""
    fake = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    monkeypatch.setattr(jax, "devices", lambda *a: [fake])
    assert device.require_gpu() == {"platform": "gpu",
                                    "kind": "NVIDIA H100", "count": 1}


def test_standalone_script_fails(tmp_path):
    """Copied alone into an empty directory, the script exits non-zero and
    prints no result."""
    shutil.copy(chip_smoke.__file__, tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_rule(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    ``<checkout>/.jax_cache``."""
    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache")
    try:
        assert device.configure_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_phases_run_on_cpu_tiny(capsys):
    """Phases 1-4 end to end at tiny widths with the committed weights:
    every comparison inside holds (they raise otherwise)."""
    chip_smoke.run(TINY)
    out = capsys.readouterr().out
    for mark in ("eps cm vs Net.apply", "guided step", "lane gather x2",
                 "heavy:", "parity_nog:", "cli sim", "train step 1",
                 "heads that moved"):
        assert mark in out, mark


@pytest.mark.gpu
def test_references_on_gpu(gpu_device):
    """Phase 1's comparisons on the card at tiny widths."""
    from pstl_tpu import sim
    from pstl_tpu.data import synthetic

    import bench

    cfg = TINY.cfg(bench.build_cfg("heavy"))
    scenes = sim.scenes_from_dataset(
        synthetic.generate_dataset(0, TINY.bs, cfg, scene_len=38))
    chip_smoke.references(TINY, scenes, cfg)


def test_last_line_contract(monkeypatch, capsys):
    """main() ends with the card line and then exactly one JSON object
    naming the device as JAX reports it."""
    info = {"platform": "gpu", "kind": "NVIDIA H100", "count": 1}
    monkeypatch.setattr(chip_smoke, "environment",
                        lambda n: (info, "NVIDIA H100, 700.00 W"))
    monkeypatch.setattr(chip_smoke, "run", lambda *a, **k: None)
    chip_smoke.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "NVIDIA H100, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": info}
