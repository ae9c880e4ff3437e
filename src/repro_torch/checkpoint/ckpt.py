"""Checksummed, async checkpoints of a tensor tree (the JAX package's
``checkpoint/ckpt.py``, same on-disk layout, so each package restores
the other's checkpoints).

Layout (one directory per step)::

    <dir>/step_000000123/
        shard_00000.npz          # flat {"a<i>" -> array}, i in flatten order
        MANIFEST.json            # tree description, shapes, dtypes,
                                 # per-leaf checksums
        COMMIT                   # written last: a step without it is torn

- Integrity: every leaf is checksummed (the mod 2^31-1 sum of its bytes)
  at save; restore verifies before handing the state over, so a flipped
  bit in storage surfaces as :class:`CheckpointCorruption`.  The sum is
  taken where the tensor lies (on the card for a CUDA leaf) in chunks,
  never as a uint64 copy of the whole leaf.
- Leaf order is ``jax.tree.flatten``'s (dict keys sorted, named tuples
  in order): leaf ``i`` is array ``a<i>`` in both packages.  bfloat16
  leaves are stored as raw 2-byte words with ``"bfloat16"`` in the
  manifest, as numpy stores JAX's.
- Atomicity: write to a ``.tmp`` directory, fsync, rename, then the
  COMMIT marker; :func:`latest_step` considers committed steps only.
- Async save: the caller's thread takes the checksums and the host
  copies (the state may change after ``maybe_save`` returns); a
  background thread writes each leaf as soon as it is copied, and goes
  on after ``maybe_save`` returns.  ``wait()`` joins before the next
  save or a restore.
- ``keep_last`` garbage collection, and a restore that falls back past a
  corrupt newest step.
- A sharded state (``DTensor`` leaves, a model mesh's) is saved whole,
  in the same layout: every rank gathers each leaf in turn and the
  group's rank 0 keeps the host copy; a restore reads the whole leaf
  and cuts each rank's block out by the leaf's placements.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_unflatten_like

_STEP_RE = re.compile(r"^step_(\d{9})$")
_MOD = 2147483647  # 2^31-1
#: bytes summed at once: bounds the int64 working copy of a chunk
_CHUNK = 1 << 26
#: leaves read from a shard at once on restore
_READERS = 4


class CheckpointCorruption(RuntimeError):
    """A shard failed its checksum on restore."""


def tensor_checksum(t: torch.Tensor) -> int:
    """The mod-(2^31-1) sum of ``t``'s bytes (the JAX package's
    ``_np_checksum``), taken on ``t``'s device in chunks."""
    u8 = t.detach().contiguous().reshape(-1).view(torch.uint8)
    total = torch.zeros((), dtype=torch.int64, device=u8.device)
    for i in range(0, u8.numel(), _CHUNK):
        total += u8[i:i + _CHUNK].sum(dtype=torch.int64)
    return int(total) % _MOD


def _np_checksum(x: np.ndarray) -> int:
    """:func:`tensor_checksum` of a host array."""
    u8 = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
    return tensor_checksum(torch.from_numpy(u8))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 as raw 2-byte words."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.dtype("V2"))
    return host.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.view(np.dtype(dtype))).to(device)


def _treedef(tree) -> str:
    """The tree's structure in ``PyTreeDef`` notation (leaves as ``*``);
    descriptive only: restore reads the leaf count."""
    def rec(node):
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {rec(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return f"{type(node).__name__}(" + ", ".join(
                f"{f}={rec(v)}" for f, v in zip(node._fields, node)) + ")"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(rec(v) for v in node)
            return f"[{inner}]" if isinstance(node, list) else f"({inner})"
        return "*"
    return f"PyTreeDef({rec(tree)})"


def _process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:09d}")


def _committed(base: str) -> List[int]:
    """The committed steps in ``base``."""
    if not os.path.isdir(base):
        return []
    steps = []
    for name in os.listdir(base):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(base, name, "COMMIT")):
            steps.append(int(m.group(1)))
    return steps


def latest_step(base: str) -> Optional[int]:
    """Largest committed step in ``base`` (None if empty)."""
    steps = _committed(base)
    return max(steps) if steps else None


class _Snapshot:
    """What a save needs of a state, taken in the caller's thread: the
    leaves' checksums (on their devices), dtypes, shapes and the tree's
    description; then :meth:`copies` makes the host copies, one leaf at a
    time, for the writer."""

    def __init__(self, state: Any):
        self.leaves = tree_leaves(state)
        self.treedef = _treedef(state)
        self.checksums: List[int] = [tensor_checksum(t)
                                     for t in self.leaves]
        self.dtypes = [_dtype_name(t) for t in self.leaves]
        self.shapes = [list(t.shape) for t in self.leaves]

    @classmethod
    def gathered(cls, state: Any, keep: bool):
        """(snapshot, host copies) of a state with ``DTensor`` leaves:
        each leaf made whole in turn, a collective every rank takes part
        in; the copies and checksums are kept where ``keep`` (the
        writer), each whole leaf dropped once copied."""
        from repro_torch.sharding.gspmd import whole
        snap = cls.__new__(cls)
        leaves = tree_leaves(state)
        snap.leaves = None
        snap.treedef = _treedef(state)
        snap.dtypes = [_dtype_name(t) for t in leaves]
        snap.shapes = [list(t.shape) for t in leaves]
        snap.checksums, arrays = [], []
        for t in leaves:
            full = whole(t)
            if keep:
                snap.checksums.append(tensor_checksum(full))
                arrays.append(_to_numpy(full))
            del full
        return snap, arrays

    def copies(self):
        """The leaves' host copies in flatten order (the snapshot lets
        go of each leaf once copied)."""
        leaves, self.leaves = self.leaves, None
        for i in range(len(leaves)):
            yield _to_numpy(leaves[i])
            leaves[i] = None


class _Feed:
    """Host copies handed from the caller's thread to the writer's as
    they are made: the writer starts on the first leaf while the rest
    are copied, and the caller returns once all are copied (as JAX's
    ``device_get`` snapshot does)."""

    def __init__(self, n: int):
        self.q: queue.Queue = queue.Queue()
        self.n = n

    def __iter__(self):
        for _ in range(self.n):
            yield self.q.get()


def _savez(path: str, named) -> None:
    """``np.savez(path, **dict(named))``'s file (stored members
    ``<name>.npy``) from ``(name, array)`` pairs, each array's bytes
    written from its own buffer in large chunks rather than copied out
    16 MiB at a time (a quarter less time for a full-width state)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, a in named:
            a = np.require(a, requirements="C")     # keeps a 0-d shape
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(a))
                raw = memoryview(a.reshape(-1).view(np.uint8))
                for i in range(0, len(raw), _CHUNK):
                    f.write(raw[i:i + _CHUNK])


def save_checkpoint(base: str, step: int, state: Any, *,
                    shard: Optional[int] = None) -> str:
    """Synchronous checksummed save (as shard ``shard``, by default this
    process's rank).  Returns the committed directory."""
    snap = _Snapshot(state)
    return _write(base, step, snap, snap.copies(), shard)


def _write(base: str, step: int, snap: _Snapshot, arrays,
           shard_index: Optional[int] = None) -> str:
    """Write ``arrays`` (the snapshot's host copies, in order) and the
    manifest into the step's directory, then commit it."""
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    n = len(snap.checksums)
    manifest = {
        "step": step,
        "treedef": snap.treedef,
        "n_leaves": n,
        "leaves": {
            f"a{i}": {"shape": snap.shapes[i], "dtype": snap.dtypes[i],
                      "checksum": snap.checksums[i]}
            for i in range(n)
        },
    }
    if shard_index is None:
        shard_index = _process_index()
    shard = os.path.join(tmp, f"shard_{shard_index:05d}.npz")
    _savez(shard, ((f"a{i}", a) for i, a in enumerate(arrays)))
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # COMMIT last: a crash before this line leaves a torn (ignored) step
    with open(os.path.join(final, "COMMIT"), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    return final


def load_checkpoint(base: str, step: int, like: Any, *,
                    verify: bool = True, shard: Optional[int] = None) -> Any:
    """Restore ``step`` into the structure of ``like`` (a tensor tree)
    from shard ``shard`` (by default this process's rank's).  Each leaf
    lands on the device of ``like``'s leaf in its place and is verified
    there."""
    d = _step_dir(base, step)
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves_like = tree_leaves(like)
    if len(leaves_like) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, "
            f"target structure has {len(leaves_like)}")
    if shard is None:
        shard = _process_index()
    from repro_torch.sharding import distribute
    from repro_torch.sharding.gspmd import is_dtensor
    shard = os.path.join(d, f"shard_{shard:05d}.npz")

    def read(key):
        # each reader its own handle: the members are read (and their
        # zip CRCs checked) in parallel, the GIL released while they are
        with np.load(shard) as z:
            return z[key]

    leaves = []
    keys = [f"a{i}" for i in range(len(leaves_like))]
    with ThreadPoolExecutor(min(_READERS, len(keys)) or 1) as pool:
        for key, ref, arr in zip(keys, leaves_like, pool.map(read, keys)):
            meta = manifest["leaves"][key]
            t = _from_numpy(arr, meta["dtype"], ref.device).reshape(
                meta["shape"])
            del arr
            if verify:
                got = tensor_checksum(t)
                if got != meta["checksum"]:
                    raise CheckpointCorruption(
                        f"{d}: leaf {key} checksum mismatch "
                        f"(manifest {meta['checksum']}, got {got})")
            if is_dtensor(ref):
                # this rank's block of the whole leaf, by its placements
                t = distribute(t, ref.device_mesh, ref.placements)
            leaves.append(t)
    return tree_unflatten_like(like, leaves)


class CheckpointManager:
    """Async save + keep-last-k + resume, for the fault-tolerant loop.

    With ``group`` (the data group of a replicated state: every rank
    holds the same state, as the train CLI's mesh step keeps it) only
    the group's rank 0 writes, as shard 0, and every rank restores from
    that full copy once rank 0's write is done (a barrier), so a world
    of any size, a smaller one after an elastic restart too, resumes
    from it."""

    def __init__(self, base: str, *, keep_last: int = 3,
                 save_every: int = 100, group=None):
        self.base = base
        self.keep_last = keep_last
        self.save_every = save_every
        self.group = group
        self.writer = True
        if group is not None:
            import torch.distributed as dist
            self.writer = dist.get_rank(group) == 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: the last save's step and seconds: the caller's snapshot
        #: (checksums and host copy) and the background write
        self.last_save: dict = {}
        os.makedirs(base, exist_ok=True)

    def maybe_save(self, step: int, state: Any, *, force: bool = False):
        if not force and (self.save_every <= 0
                          or step % self.save_every != 0):
            return False
        from repro_torch.sharding.gspmd import is_dtensor
        sharded = any(is_dtensor(t) for t in tree_leaves(state))
        if not self.writer and not sharded:
            return False
        if self.writer:
            self.wait()
        t0 = time.perf_counter()
        if sharded:
            # every rank takes part in each leaf's gather
            snap, arrays = _Snapshot.gathered(state, keep=self.writer)
            if not self.writer:
                return False
        else:
            snap, arrays = _Snapshot(state), None
        feed = _Feed(len(snap.checksums))

        shard = None if self.group is None else 0

        def work():
            try:
                _write(self.base, step, snap, feed, shard)
                self.last_save["write_s"] = time.perf_counter() - t0
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self.last_save = {"step": step}
        self._thread.start()
        # the copies are the sync point: the state may change once this
        # returns, while the writer goes on
        for arr in (snap.copies() if arrays is None else arrays):
            feed.q.put(arr)
        self.last_save["snapshot_s"] = time.perf_counter() - t0
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for m in
            (_STEP_RE.match(n) for n in os.listdir(self.base)) if m)
        committed = [s for s in steps if os.path.exists(
            os.path.join(_step_dir(self.base, s), "COMMIT"))]
        for s in committed[:-self.keep_last]:
            shutil.rmtree(_step_dir(self.base, s), ignore_errors=True)

    def restore_latest(self, like: Any, *, verify: bool = True):
        """(state, step) from the newest committed checkpoint, else None.
        A corrupt newest step falls back to the previous committed one."""
        self.wait()
        shard = None
        if self.group is not None:
            import torch.distributed as dist
            if dist.get_world_size(self.group) > 1:
                dist.barrier(group=self.group)    # rank 0's write is done
            shard = 0
        step = latest_step(self.base)
        tried = []
        while step is not None:
            try:
                return (load_checkpoint(self.base, step, like,
                                        verify=verify, shard=shard), step)
            # any unreadable committed step (our checksum, zip CRC, torn
            # file) is corruption: evict it and fall back one step (the
            # writer evicts; a reader of rank 0's copy only passes it)
            except Exception as e:  # noqa: BLE001 — deliberate fallback
                tried.append(str(e))
                if self.writer:
                    shutil.rmtree(_step_dir(self.base, step),
                                  ignore_errors=True)
                    step = latest_step(self.base)
                else:
                    older = [s for s in _committed(self.base) if s < step]
                    step = max(older) if older else None
        if tried:
            raise CheckpointCorruption(
                "all checkpoints corrupt:\n" + "\n".join(tried))
        return None
