"""Fixed-shape scene dataset and batch iterator.

Replaces the reference's ``MyDataset``/``DataLoader`` stack
(``nusc_dataset.py:12-244``, ``nusc_train.py:153-188``): instead of
per-sample ``.npy`` sidecar files and worker processes, everything lives in
one stacked array store (npz on disk, optionally served by the C++ shard
runtime), and batching is pure array slicing — the input pipeline is
just an index shuffle + gather, so batches are ready to donate to device.

Trajopt sidecars (params / params_init / pre_stlp / tj_scores_prior) are
columns of the same store keyed by scene index, replacing the
``params_%05d_%04d.npy`` file-per-sample workflow (nusc_dataset.py:202-232).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from pstl_tpu.config import Config


class SceneDataset:
    """Dict-of-arrays dataset with train/val split and trajopt columns."""

    def __init__(self, data: Dict[str, np.ndarray], cfg: Config,
                 split_seed: int = 1007):
        # scene_* rows are per-SCENE closed-loop tensors (count != sample
        # count); keep them out of the per-sample store so gather/len never
        # index them, but round-trip them through save() for `sim --cache`
        self.scene_data = {k: v for k, v in data.items()
                           if k.startswith("scene_")}
        self.data = {k: v for k, v in data.items()
                     if not k.startswith("scene_")}
        self.cfg = cfg
        any_key = next(iter(self.data))
        self.n = self.data[any_key].shape[0]
        rng = np.random.RandomState(split_seed)
        perm = rng.permutation(self.n)
        n_train = int(self.n * cfg.train_ratio)
        self.splits = {"train": perm[:n_train], "val": perm[n_train:]}

    # ------------------------------------------------------------------
    @classmethod
    def from_synthetic(cls, cfg: Config, seed: Optional[int] = None,
                       n_scenes: Optional[int] = None,
                       scene_len: Optional[int] = None) -> "SceneDataset":
        from pstl_tpu.data import synthetic
        if n_scenes is None:
            n_scenes = cfg.n_synth_scenes
            if cfg.mini:   # v1.0-mini analogue (nusc_api.py:98-99)
                n_scenes = max(n_scenes // 8, 16)
        return cls(synthetic.generate_dataset(
            seed if seed is not None else cfg.seed,
            n_scenes, cfg, scene_len=scene_len), cfg)

    @classmethod
    def load(cls, path: str, cfg: Config) -> "SceneDataset":
        with np.load(path, allow_pickle=False) as f:
            data = {k: f[k] for k in f.files}
        ds = cls(data, cfg)
        # persisted split (data/*_split.txt analogue) is authoritative unless
        # --generate_split_on_the_fly (nusc_dataset.py:22)
        split_path = path + ".split.txt"
        if not cfg.generate_split_on_the_fly and os.path.exists(split_path):
            ds.load_split(split_path)
        return ds

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, **self.data, **self.scene_data)
        self.save_split(path + ".split.txt")

    TRAJOPT_COLUMNS = ("params", "params_init", "pre_stlp",
                       "tj_scores_prior")

    def load_trajopt_sidecar(self, path: str):
        """Attach trajopt columns from another store (``--params_load_path``,
        nusc_dataset.py:209-232): reuse an augmentation run's params / stlp /
        scores with a dataset that lacks them.  Resamples the seed axis M ->
        n_randoms on mismatch (nusc_dataset.py:233-240)."""
        with np.load(path, allow_pickle=False) as f:
            for k in self.TRAJOPT_COLUMNS:
                if k not in f.files:
                    continue
                v = f[k]
                assert v.shape[0] == self.n, (k, v.shape, self.n)
                M = v.shape[1]
                if M != self.cfg.n_randoms:
                    rng = np.random.RandomState(0)
                    idx = rng.randint(0, M, self.cfg.n_randoms)
                    v = v[:, idx]
                self.data[k] = v

    # ------------------------------------------------------------------
    def __len__(self):
        return self.n

    def split_len(self, split: str) -> int:
        return len(self.splits[split])

    def attach(self, key: str, values: np.ndarray):
        """Attach a derived column (e.g. trajopt params) aligned to scenes."""
        assert values.shape[0] == self.n, (key, values.shape)
        self.data[key] = values

    def has(self, key: str) -> bool:
        return key in self.data

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.data.items()}

    def save_split(self, path: str):
        """Persist the train/val index split as text (one ``split index``
        line per scene) — the equivalent of the reference's
        ``data/*_split.txt`` files (nusc_gen_data_split.py)."""
        with open(path, "w") as f:
            for split, idx in self.splits.items():
                for i in idx:
                    f.write(f"{split} {int(i)}\n")

    def load_split(self, path: str):
        import collections
        d = collections.defaultdict(list)
        with open(path) as f:
            for line in f:
                split, i = line.split()
                d[split].append(int(i))
        self.splits = {k: np.asarray(v) for k, v in d.items()}

    def ensure_random_params(self, seed: int = 0):
        """Default random control seeds when no trajopt params exist
        (nusc_dataset.py:215-218): w ~ 0.1*U(-w_max, w_max), a ~ U(-a_max, a_max)."""
        if "params" in self.data:
            return
        cfg = self.cfg
        rng = np.random.RandomState(seed)
        shape = (self.n, cfg.n_randoms, 3, cfg.nt)
        w = rng.uniform(-cfg.mul_w_max, cfg.mul_w_max, shape) * 0.1
        a = rng.uniform(-cfg.mul_a_max, cfg.mul_a_max, shape)
        params = np.stack([w, a], axis=-1).astype(np.float32)
        self.data["params"] = params
        self.data["params_init"] = params.copy()


def to_shard_store(ds: SceneDataset, path: str):
    """Persist the dataset as a native shard-store directory."""
    from pstl_tpu.runtime import write_store
    write_store(path, ds.data)


def shard_store_iterator(store, ds: SceneDataset, split: str,
                         batch_size: int, shuffle: bool, seed: int = 0,
                         epoch: int = 0,
                         columns: Optional[Tuple[str, ...]] = None):
    """Batch iterator backed by the C++ shard store: the native worker
    thread assembles batch k+1 (mmap gather, thread pool) while batch k is
    being transferred/consumed — the replacement for the reference's
    DataLoader(num_workers=8)."""
    idx = ds.splits[split].copy()
    if shuffle:
        rng = np.random.RandomState(seed * 100003 + epoch)
        rng.shuffle(idx)
    yield from store.iter_batches(idx, batch_size, columns=columns)


def batch_iterator(ds: SceneDataset, split: str, batch_size: int,
                   shuffle: bool, seed: int = 0, drop_last: bool = True,
                   epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape batches.  ``drop_last=True`` keeps every batch the
    same shape (no recompilation); the val epoch wraps the tail instead of
    dropping it so all scenes are evaluated."""
    idx = ds.splits[split].copy()
    if shuffle:
        rng = np.random.RandomState(seed * 100003 + epoch)
        rng.shuffle(idx)
    n = len(idx)
    if n == 0:
        return
    if not drop_last and n % batch_size != 0:
        pad = batch_size - n % batch_size
        # wrap as many times as needed (tiny splits can be smaller than
        # one batch)
        idx = np.concatenate([idx, np.tile(idx, -(-pad // n))[:pad]])
        n = len(idx)
    for i in range(0, n - batch_size + 1, batch_size):
        yield ds.gather(idx[i:i + batch_size])
