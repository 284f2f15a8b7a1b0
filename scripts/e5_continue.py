"""Continue e5 DDPM training from an existing checkpoint.

Round-2/3 quality scaling: open/closed-loop compliance rose monotonically
with e5 budget (150 -> 290 epochs: open-loop 0.411 -> 0.457, closed-loop
+guidance 0.703 -> 0.851), so this is the knob future rounds should keep
turning.  Saves E5B_DST (default models_e5b);
scripts/e7_v2_retrain.py (E7V2_SRC=models_e5b) builds the RefineNet on top.

Env: E2E_OUT (exps/e2e_r2), E5B_EPOCHS (140), E5B_SRC (models_e5),
E5B_DST (models_e5b).
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/pstl_tpu_jax_cache")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
from pstl_tpu import train
from pstl_tpu.config import PRESETS
from pstl_tpu.data.dataset import SceneDataset
OUT = os.environ.get("E2E_OUT", "exps/e2e_r2")
EPOCHS = int(os.environ.get("E5B_EPOCHS", "140"))
SRC = os.environ.get("E5B_SRC", "models_e5")
DST = os.environ.get("E5B_DST", "models_e5b")
T0 = time.time()
def log(m): print(f"[{time.time()-T0:7.1f}s] {m}", flush=True)
base = dict(n_randoms=64, n_neighbors=8, batch_size=16)
# Work-in-progress resume: a killed or hung process resumes from the last
# snapshot.  Snapshot every 25 epochs to DST_wip +
# an EPOCHS_DONE sidecar; a relaunch warm-starts from the snapshot and
# trains only the remaining epochs instead of losing the whole run.
WIP = os.path.join(OUT, DST + "_wip")
DONE_F = os.path.join(WIP, "EPOCHS_DONE")
done = int(open(DONE_F).read().strip()) if os.path.exists(DONE_F) else 0
src_path = WIP if done > 0 else os.path.join(OUT, SRC)
cfg = PRESETS["e5_ddpm"].with_(**base).with_(
    epochs=max(EPOCHS - done, 0), net_pretrained_path=src_path)
ds = SceneDataset.load(os.path.join(OUT, "cache_aug.npz"), cfg)


def _wip_cb(epi, state):
    if (epi + 1) % 25 == 0:
        train.save_checkpoint(WIP, state, 0)
        with open(DONE_F, "w") as f:
            f.write(str(done + epi + 1))
        log(f"wip snapshot @ {done + epi + 1}/{EPOCHS} epochs")


log(f"continuing e5 from {os.path.basename(src_path)} "
    f"+{EPOCHS - done} epochs (of {EPOCHS}; {done} already done)...")
# epochs=0 (everything already in WIP) just returns the loaded state
st = train.train(cfg.with_(exp_name=None), ds, log=log, epoch_cb=_wip_cb)
train.save_checkpoint(os.path.join(OUT, DST), st, 0)
log(f"saved {DST}")
