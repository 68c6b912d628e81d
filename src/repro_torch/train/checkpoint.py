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
   :func:`restore` matches leaves by path and puts each on the device and
   in the dtype of the ``like`` tree's leaf.  :class:`Checkpointer`
   copies the state on the device and writes it on a background thread,
   so the train loop blocks only for that copy (the port's train step
   updates its state in place, where the reference's arrays are
   immutable).

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
                f.write(bits.tobytes())
            return list(bits.shape), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, like):
    """A saved array as ``like``'s leaf: a tensor in ``like``'s dtype on
    ``like``'s device (a Python scalar stays one)."""
    t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return type(like)(t.item())


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
    """:func:`save` on a background thread, of a device copy of ``state``
    taken now (the caller may go on updating ``state`` in place).
    Returns the started thread."""
    snapshot = _clone_tensor_leaves(state)
    thread = threading.Thread(target=save, args=(ckpt_dir, step, snapshot),
                              kwargs={"keep": keep}, daemon=True)
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
    structure, each leaf matched by path and placed like ``like``'s."""
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
        leaves.append(_from_numpy(np.load(path / m["file"]), m["dtype"],
                                  leaf))
    return _unflatten(like, iter(leaves))


class Checkpointer:
    """Async checkpoint manager: ``maybe_save`` copies the state on the
    device at once and writes it in the background, overlapping the file
    I/O with the next train steps.  One save in flight at a time (a newer
    save waits for it)."""

    def __init__(self, ckpt_dir: str | Path, interval_steps: int = 100,
                 keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.interval = interval_steps
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.saves = 0
        self.errors: list[str] = []

    def maybe_save(self, step: int, state: Any, force: bool = False) -> bool:
        if not force and (self.interval <= 0 or step % self.interval):
            return False
        self.wait()
        snapshot = _clone_tensor_leaves(state)

        def _run():
            try:
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


def _clone_tensor_leaves(tree: Any) -> Any:
    """``tree`` with every tensor leaf cloned on its device; other leaves
    (and containers other than dicts, lists and tuples) pass through."""
    if isinstance(tree, dict):
        return {k: _clone_tensor_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_clone_tensor_leaves(v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


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
