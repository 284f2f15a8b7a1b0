"""Every Config field named in docs/FLAGS.md must actually exist."""

import os
import re

from pstl_tpu.config import Config

DOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "FLAGS.md")


def test_mapped_fields_exist():
    cfg = Config()
    text = open(DOC).read()
    missing = []
    for line in text.splitlines():
        if not line.startswith("| --"):
            continue
        cells = [c.strip() for c in line.split("|")]
        here = cells[2]
        if "n/a" in here or "absorbed" in here or "CLI" in here:
            continue
        for field in re.split(r"\s*/\s*", here):
            field = field.split()[0].strip("`")
            if field.startswith("*"):
                continue
            if not hasattr(cfg, field):
                missing.append(field)
    assert not missing, f"FLAGS.md names unknown Config fields: {missing}"


def test_extras_exist():
    cfg = Config()
    for field in ("sampler", "ddim_steps", "ddim_eta",
                  "guidance_positive_offset_quirk",
                  "mesh_shape", "compute_dtype"):
        assert hasattr(cfg, field), field


def test_no_dead_config_fields():
    """Every Config field must be READ somewhere outside config.py (wired
    behavior, not declared parity).  Guards against dead-flag rot."""
    import dataclasses
    import glob
    import pstl_tpu

    root = os.path.dirname(os.path.abspath(pstl_tpu.__file__))
    repo = os.path.dirname(root)
    sources = []
    for pat in (os.path.join(root, "**", "*.py"),
                os.path.join(repo, "scripts", "*.py"),
                os.path.join(repo, "bench.py"),
                os.path.join(repo, "__graft_entry__.py")):
        sources += [f for f in glob.glob(pat, recursive=True)
                    if not f.endswith("config.py")]
    blob = "\n".join(open(f).read() for f in sources)
    dead = []
    for f in dataclasses.fields(Config):
        # read as cfg.<name>, set via with_(<name>=...) / a string key
        if not re.search(rf"\.{f.name}\b", blob) and \
           not re.search(rf"\b{f.name}\s*=", blob) and \
           not re.search(rf"[\"']{f.name}[\"']", blob):
            dead.append(f.name)
    assert not dead, f"Config fields with no usage outside config.py: {dead}"
