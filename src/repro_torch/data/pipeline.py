"""Synthetic data pipelines: deterministic and prefetched (the JAX
package's ``data/pipeline.py``).

The source is synthetic and seeded: every batch is a pure function of
(seed, step), so a restarted run regenerates the exact same stream.  The
generators are numpy's, as in the JAX package, so the two packages'
batches are equal bit for bit.

- :class:`SyntheticLMDataset` — next-token LM batches (token/label shift,
  patch/frame stubs for vlm/encdec configs).
- :class:`SyntheticDLRMDataset` — the paper's own workload: dense features
  + 26 multi-hot categorical bags (variable pooling, padded to fixed
  shape).
- :class:`Prefetcher` — a background thread that makes the next batches
  (and, given a device, moves them there) while the caller runs.

:func:`make_dataset` serves the families the port has (``dlrm`` and the
RWKV ``ssm``); placing a batch across a device mesh (the JAX
``shard_batch``) waits for ROADMAP A8.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig

#: ROADMAP items that port each family the pipeline does not serve yet
_NOT_PORTED = {
    "dense": "A4 (LM decode and serving)",
    "moe": "A4 (LM decode and serving)",
    "vlm": "A4 (LM decode and serving)",
    "encdec": "A7 (other families: whisper)",
    "hybrid": "A7 (other families: mamba / hymba)",
}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # DLRM-specific knobs (paper Table I scale-down happens in configs)
    avg_pool: int = 100
    max_pool: int = 128


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


class SyntheticLMDataset:
    """Seeded synthetic LM batches in the JAX package's layouts."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig()):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg, shape = self.cfg, self.shape
        rng = _rng_for(self.data_cfg.seed, step)
        B, S = shape.global_batch, shape.seq_len
        text_len = S
        batch: Dict[str, np.ndarray] = {}
        if cfg.family == "vlm":
            text_len = S - cfg.n_patches
            batch["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.patch_dim), dtype=np.float32)
        if cfg.family == "hybrid":
            text_len = S - cfg.meta_tokens
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model), dtype=np.float32)
        toks = rng.integers(0, cfg.vocab, (B, text_len + 1), dtype=np.int64)
        batch["tokens"] = toks[:, :-1].astype(np.int32)
        if shape.kind == "train":
            batch["labels"] = toks[:, 1:].astype(np.int32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class SyntheticDLRMDataset:
    """The paper's workload: dense features + multi-hot categorical bags.

    Bags use the fixed-shape padded layout of ``core.abft_embedding``:
    ``indices [n_tables, B, max_pool]`` padded with -1, pooling sizes drawn
    uniformly in ``[1, max_pool]``.
    """

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig()):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg

    @property
    def extras(self):
        from repro_torch.configs.dlrm import EXTRAS
        return EXTRAS

    def batch_at(self, step: int, *, table_rows: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        ex, dc = self.extras, self.data_cfg
        rows = table_rows or ex.table_rows
        rng = _rng_for(dc.seed, step)
        B = self.shape.global_batch
        dense = rng.standard_normal((B, ex.n_dense)).astype(np.float32)
        pools = rng.integers(1, dc.max_pool + 1, (ex.n_tables, B))
        idx = rng.integers(0, rows,
                           (ex.n_tables, B, dc.max_pool), dtype=np.int64)
        mask = np.arange(dc.max_pool)[None, None, :] < pools[..., None]
        idx = np.where(mask, idx, -1).astype(np.int32)
        label = rng.integers(0, 2, (B,)).astype(np.float32)
        return {"dense": dense, "bags": idx, "label": label}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_dataset(cfg: ArchConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig()):
    if cfg.family == "dlrm":
        return SyntheticDLRMDataset(cfg, shape, data_cfg)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP "
            f"{_NOT_PORTED[cfg.family]})")
    return SyntheticLMDataset(cfg, shape, data_cfg)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (copies: the tensors never
    alias the batch's arrays)."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in batch.items()}


class Prefetcher:
    """Double-buffered background batch pipeline: a thread makes the next
    ``depth`` batches of ``it`` (moved to ``device`` when one is given)
    while the caller consumes.  Use it as a context manager, or call
    :meth:`close`, to stop the thread."""

    def __init__(self, it: Iterator, device=None, depth: int = 2):
        self._it = it
        self._device = device
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._finished = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            for batch in self._it:
                if self._device is not None:
                    batch = to_device(batch, self._device)
                if not self._put(batch):
                    return
        except Exception as e:     # handed to the consumer, raised there
            self._error = e
        finally:
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._finished = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the thread: no batch is made after this returns."""
        self._stop.set()
        self._finished = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
