"""Checkpoints: durable saves on disk and in-memory (store-resident) ones.

Port of ``src/repro/train/checkpoint.py``, on the same on-disk layout, so
a checkpoint one package writes restores in the other:

1. **Durable checkpoints** (:func:`save` / :func:`restore`): every tensor
   leaf is written as an ``.npy`` blob under ``step_%010d`` with a JSON
   manifest (each leaf's ``/``-joined path, file, shape and dtype), and
   published by an atomic rename.  A path is a dict key, a named tuple's
   field name or a sequence index, as JAX names its pytree paths.  bf16
   leaves are written as the reference's numpy writes them (two-byte void
   records, manifest dtype ``bfloat16``), since numpy has no bf16.
   :func:`restore` matches leaves by path and writes each into the
   ``like`` tree's tensor in place (its device and dtype), so a restore
   at full width never holds two states on the card; the reference builds
   new arrays.  :class:`Checkpointer` copies the state leaf by leaf into
   host buffers it allocates once (one arena, page-locked when the state
   is on a card) and writes them on a background thread, so the card
   holds no second copy and the train loop waits only for the copies,
   which run on its own stream ahead of its next in-place update (the
   port's train step updates its state in place, where the reference's
   arrays are immutable).

2. **In-memory checkpoints** (:class:`MemoryCheckpoint`): the train state
   parked in the server's host metadata between epochs, every tensor leaf
   cloned (the counterpart of the reference's ``_copy_array_leaves``), so
   a crashed trainer restarts from one metadata read.

3. **Retention**: the ``keep`` newest step directories are kept.
"""

from __future__ import annotations

import json
import shutil
import threading
import weakref
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "latest_step", "Checkpointer",
           "MemoryCheckpoint"]


def _flatten_with_paths(tree, prefix: tuple = ()) -> list:
    """``[(path, leaf)]`` in a JAX pytree's order (dict keys sorted), so
    the leaves' files are numbered as the reference numbers them;
    ``None`` and empty containers hold no leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_paths(tree[k], (*prefix, str(k)))]
    if isinstance(tree, (list, tuple)):
        names = tree._fields if hasattr(tree, "_fields") \
            else [str(i) for i in range(len(tree))]
        return [x for n, v in zip(names, tree)
                for x in _flatten_with_paths(v, (*prefix, n))]
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` in :func:`_flatten_with_paths`' order."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves) for v in like]
        return type(like)(*out) if hasattr(like, "_fields") \
            else type(like)(out)
    return next(leaves)


def _save_leaf(path: Path, leaf) -> tuple[list, str]:
    """Write one leaf as the reference's ``np.save`` does → its shape and
    manifest dtype.  A bf16 tensor gets the header numpy writes for
    ``ml_dtypes.bfloat16`` (``'<V2'``) over its raw bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": "<V2", "fortran_order": False,
                        "shape": bits.shape})
                bits.tofile(f)
            return list(bits.shape), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _into(arr: np.ndarray, dtype: str, key: str, like):
    """A saved array as ``like``'s leaf: written into ``like``'s tensor in
    place (converted to its dtype, moved to its device), or a Python
    scalar of ``like``'s type."""
    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(arr)
    if not isinstance(like, torch.Tensor):
        return type(like)(t.item())
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"leaf {key!r}: saved shape {tuple(t.shape)}, "
                         f"like's {tuple(like.shape)}")
    with torch.no_grad():
        return like.copy_(t)


def _write(path: Path, step: int, state: Any) -> dict:
    """Write ``state``'s leaves under ``path`` → the manifest."""
    manifest: dict = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten_with_paths(state)):
        shape, dtype = _save_leaf(path / f"leaf_{i:05d}.npy", leaf)
        manifest["leaves"].append({"key": key, "file": f"leaf_{i:05d}.npy",
                                   "shape": shape, "dtype": dtype})
    return manifest


def save(ckpt_dir: str | Path, step: int, state: Any, keep: int = 3) -> Path:
    """Synchronous save of ``state`` as step ``step``; keeps the ``keep``
    newest steps.  Returns the checkpoint's path."""
    ckpt_dir = Path(ckpt_dir)
    path = ckpt_dir / f"step_{step:010d}"
    tmp = ckpt_dir / f".tmp_step_{step:010d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = _write(tmp, step, state)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)                     # atomic publish
    _apply_retention(ckpt_dir, keep)
    return path


def save_async(ckpt_dir: str | Path, step: int, state: Any,
               keep: int = 3) -> threading.Thread:
    """:func:`save` on a background thread, of a host copy of ``state``
    staged now (the caller may go on updating ``state`` in place, on the
    same stream).  The host buffers are this call's own; a
    :class:`Checkpointer` reuses its.  Returns the started thread."""
    stage = _HostStage(_tensor_leaves(state))
    snapshot = stage.stage(state)

    def _run():
        try:
            stage.wait()
            save(ckpt_dir, step, snapshot, keep=keep)
        finally:
            stage.close()

    thread = threading.Thread(target=_run, daemon=True)
    thread.start()
    return thread


def _apply_retention(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*"))
    return steps[-1] if steps else None


def restore(ckpt_dir: str | Path, like: Any, step: int | None = None) -> Any:
    """The checkpoint of ``step`` (default: the latest) in ``like``'s
    structure, each leaf matched by path.  ``like`` is overwritten: each
    tensor leaf receives the saved values in place (``copy_``, to its own
    dtype and device, one leaf at a time), and the returned tree holds
    those same tensors; a non-tensor leaf comes back as a new value."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = ckpt_dir / f"step_{step:010d}"
    manifest = json.loads((path / "manifest.json").read_text())
    by_key = {m["key"]: m for m in manifest["leaves"]}
    leaves = []
    for key, leaf in _flatten_with_paths(like):
        m = by_key.get(key)
        if m is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        leaves.append(_into(np.load(path / m["file"]), m["dtype"], key,
                            leaf))
    return _unflatten(like, iter(leaves))


def _map_tensor_leaves(fn, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every tensor leaf, in dict insertion
    order; other leaves (and containers other than dicts, lists and
    tuples) pass through."""
    if isinstance(tree, dict):
        return {k: _map_tensor_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_tensor_leaves(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _tensor_leaves(tree: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map_tensor_leaves(out.append, tree)
    return out


def _clone_tensor_leaves(tree: Any) -> Any:
    return _map_tensor_leaves(torch.Tensor.clone, tree)


_ALIGN = 256            # bytes: each leaf's offset in the arena


def _unregister(arena: torch.Tensor) -> None:
    torch.cuda.cudart().cudaHostUnregister(arena.data_ptr())


class _HostStage:
    """Host copies of one state's tensor leaves, in one arena of host
    memory allocated once and reused save after save.

    When a leaf lives on a card the arena is page-locked
    (``cudaHostRegister``, exactly its size: ``pin_memory`` rounds each
    block up to a power of two), the copies are non-blocking on the
    current stream, so they run before any update the caller queues after
    them, and one event marks their end; :meth:`wait` waits for it.  On
    the CPU the copies are plain and done on return.
    """

    def __init__(self, tensors: list[torch.Tensor]):
        self.layout = [(t.shape, t.dtype) for t in tensors]
        offsets, total = [], 0
        for t in tensors:
            total = -(-total // _ALIGN) * _ALIGN
            offsets.append(total)
            total += t.numel() * t.element_size()
        self.nbytes = total
        self.arena = torch.empty(max(total, 1), dtype=torch.uint8)
        cuda = [t.device for t in tensors if t.is_cuda]
        self.device = cuda[0] if cuda else None
        self._release = None
        if self.device is not None:
            err = int(torch.cuda.cudart().cudaHostRegister(
                self.arena.data_ptr(), self.arena.numel(), 0))
            if err:
                raise RuntimeError(f"cudaHostRegister of the {total}-byte "
                                   f"checkpoint arena failed ({err})")
            self._release = weakref.finalize(self, _unregister, self.arena)
        self.views = [
            self.arena[o:o + t.numel() * t.element_size()]
            .view(t.dtype).view(t.shape) for o, t in zip(offsets, tensors)]
        self._done = None

    def fits(self, tensors: list[torch.Tensor]) -> bool:
        return self.layout == [(t.shape, t.dtype) for t in tensors]

    def stage(self, state: Any) -> Any:
        """Copy ``state``'s tensor leaves into the arena → ``state``'s
        structure over the arena's views."""
        views = iter(self.views)
        if self.device is None:
            return _map_tensor_leaves(lambda t: next(views).copy_(t), state)
        with torch.cuda.device(self.device):
            out = _map_tensor_leaves(
                lambda t: next(views).copy_(t, non_blocking=True), state)
            self._done = torch.cuda.Event()
            self._done.record()
        return out

    def wait(self) -> None:
        """Until the last :meth:`stage`'s copies have landed."""
        if self._done is not None:
            self._done.synchronize()

    def close(self) -> None:
        """Unpin the arena (its views must no longer be read)."""
        if self._release is not None:
            self._release()


class Checkpointer:
    """Async checkpoint manager: ``maybe_save`` stages the state into host
    buffers (:class:`_HostStage`, allocated at the first save and reused)
    and writes them in the background, overlapping the file I/O with the
    next train steps.  One save in flight at a time: a newer save first
    waits for it, since it reuses its buffers.  :meth:`close` releases
    the buffers."""

    def __init__(self, ckpt_dir: str | Path, interval_steps: int = 100,
                 keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.interval = interval_steps
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._stage: _HostStage | None = None
        self.saves = 0
        self.errors: list[str] = []

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        if not force and (self.interval <= 0 or step % self.interval):
            return False
        self.wait()
        tensors = _tensor_leaves(state)
        if self._stage is None or not self._stage.fits(tensors):
            self.close()
            self._stage = _HostStage(tensors)
        stage = self._stage
        snapshot = stage.stage(state)

        def _run():
            try:
                stage.wait()
                save(self.dir, step, snapshot, keep=self.keep)
                self.saves += 1
            except Exception as e:  # noqa: BLE001
                self.errors.append(repr(e))

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def close(self) -> None:
        """Wait for the save in flight, then release the host buffers."""
        self.wait()
        if self._stage is not None:
            self._stage.close()
            self._stage = None


class MemoryCheckpoint:
    """Train-state checkpoints parked in the server's host metadata.

    ``key`` namespaces the checkpoint so several components can park state
    in one store.  Saves clone every tensor leaf, so a state the train
    loop later updates in place stays restorable; the metadata puts and
    gets are host traffic and never move the store's op counters.
    """

    def __init__(self, server, key: str | None = None):
        self.server = server
        self._prefix = "__memckpt" if key is None else f"__memckpt_{key}"

    def save(self, step: int, state: Any) -> None:
        self.server.put_meta(f"{self._prefix}_state",
                             _clone_tensor_leaves(state))
        self.server.put_meta(f"{self._prefix}_step", int(step))

    def restore(self) -> tuple[int, Any] | None:
        step = self.server.get_meta(f"{self._prefix}_step")
        if step is None:
            return None
        return int(step), self.server.get_meta(f"{self._prefix}_state")
