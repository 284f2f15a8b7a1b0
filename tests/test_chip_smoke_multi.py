"""``chip_smoke.py --multi``'s comparisons on four virtual CPU devices."""

import jax

import chip_smoke
from tests.test_chip_smoke import TINY


def test_multi_matches_one_device_on_4_cpu_devices(capsys):
    """The ``--multi`` path on four virtual CPU devices: the data-parallel
    train step, and the 2x2-mesh replanning step and closed-loop chunk,
    match one device."""
    assert len(jax.devices()) >= 4
    chip_smoke.run(TINY, multi_only=True)
    out = capsys.readouterr().out
    assert "data mesh {'data': 4}" in out
    assert "picks differ in 0/2 scenes" in out
    assert "scenes with ego within 1e-3: 2/2" in out
