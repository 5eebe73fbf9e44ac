"""Checkpoint/restart with elastic re-layout.

The reference's ``repro/checkpoint/checkpointer.py`` on tensor trees, in its
file format, so a checkpoint either package wrote restores in the other:

* step-versioned ``step_XXXXXXXX/`` directories holding ``shard_0.npz``
  (``leaf_i`` arrays) and ``manifest.json`` (``step``, ``time``, ``leaves:
  [{path, shape, dtype}]``, leaf paths spelled as the reference's
  ``jax.tree_util.keystr`` spells them), committed by an atomic rename — a
  writer that dies never corrupts the latest checkpoint;
* the checkpoint holds the LOGICAL state (global tensors, the
  ``TrainStepBundle.host_state`` of a laid-out state), so a restore lays it
  onto any cluster (``layout=``, e.g. ``bundle.layout_state``): the elastic
  path;
* async save: the state is copied to host memory on the calling thread —
  the train step donates its state and AdamW writes it in place, so the
  copy must be taken before the next step runs — and written on a worker
  thread; the loop only blocks on the previous save;
* transient IO failures retry with backoff; a save that fails every retry
  raises ``CheckpointSaveError`` from the next ``wait()`` / ``save()``;
* a torn step (truncated archive, corrupt manifest, missing leaf) is
  discarded with a warning naming it and the restore falls back to the
  previous intact step.

bfloat16 leaves are stored as their 16-bit patterns under the manifest
dtype ``bfloat16`` (numpy has no bfloat16 of its own).
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
import zipfile
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import tree as T

MANIFEST = "manifest.json"

#: What a torn (half-written / truncated / lost) step looks like when read
#: back: missing files, truncated npz archives, corrupt manifest JSON,
#: missing leaf keys.  Template / manifest MISMATCHES (shape, dtype, tree
#: structure) are caller bugs and still raise.
TORN_ERRORS = (OSError, ValueError, KeyError, zipfile.BadZipFile, zlib.error)


class CheckpointSaveError(RuntimeError):
    """An async save failed terminally (every IO retry exhausted)."""


def _leaf_paths(tree, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) in the reference's leaf order (dict keys sorted) and
    spelling (``['params']['embed']``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_paths(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.dtype(x.dtype))


def _to_host(x, copy: bool = True) -> np.ndarray:
    """A host copy the caller can no longer write to (``copy=False``: the
    caller hands over host tensors nobody else holds)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.array(x, copy=copy or None)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, root: str, *, keep: int = 3, io_retries: int = 3,
                 retry_backoff_s: float = 0.05):
        self.root = root
        self.keep = keep
        self.io_retries = io_retries
        self.retry_backoff_s = retry_backoff_s
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, *, blocking: bool = False,
             copy: bool = True) -> None:
        """Copy ``state`` (a tree of global tensors) to host memory now,
        write it on a worker thread.  ``copy=False`` skips the copy of
        leaves already on the host, for a caller that hands over fresh host
        tensors (``TrainStepBundle.host_state``'s).

        Transient IO failures are retried with bounded exponential backoff
        (``io_retries`` x ``retry_backoff_s`` doubling); a save that fails
        every retry is TERMINAL and raises ``CheckpointSaveError`` from the
        next ``wait()`` / ``save()``."""
        host = [(p, _dtype_name(x), _to_host(x, copy))
                for p, x in _leaf_paths(state)]
        self.wait()
        t = threading.Thread(target=self._write_with_retries,
                             args=(step, host), daemon=True)
        t.start()
        self._thread = t
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointSaveError(
                f"async checkpoint save failed after "
                f"{self.io_retries + 1} attempts: {err}") from err

    def _write_with_retries(self, step: int, host_state) -> None:
        delay = self.retry_backoff_s
        for attempt in range(self.io_retries + 1):
            try:
                self._write(step, host_state)
                return
            except OSError as e:
                if attempt == self.io_retries:
                    self._error = e      # terminal: surfaced by wait()
                    return
                time.sleep(delay)
                delay *= 2

    def _write(self, step: int, host_state) -> None:
        """``host_state``: (path, dtype name, host array) per leaf."""
        tmp = os.path.join(self.root, f".tmp-{step}-{os.getpid()}")
        final = os.path.join(self.root, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(),
                    "leaves": [{"path": p, "shape": list(a.shape),
                                "dtype": dt} for p, dt, a in host_state]}
        np.savez(os.path.join(tmp, "shard_0.npz"),
                 **{f"leaf_{i}": a for i, (_, _, a) in enumerate(host_state)})
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):  # idempotent: this step already committed
            for fn in os.listdir(tmp):
                os.remove(os.path.join(tmp, fn))
            os.rmdir(tmp)
        else:
            os.rename(tmp, final)  # atomic commit
        self._gc()

    def _remove_step(self, step: int) -> None:
        path = os.path.join(self.root, f"step_{step:08d}")
        for fn in os.listdir(path):
            os.remove(os.path.join(path, fn))
        os.rmdir(path)

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            self._remove_step(s)

    def discard_after(self, step: int) -> list[int]:
        """Drop every checkpoint NEWER than ``step`` (the elastic-recovery
        invalidation rule: after restoring step ``s`` onto a rebuilt
        cluster, saves from the aborted timeline are stale).  Returns the
        dropped steps."""
        dropped = [s for s in self.all_steps() if s > step]
        for s in dropped:
            self._remove_step(s)
        return dropped

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.root, d, MANIFEST)):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, *, step: Optional[int] = None,
                layout: Optional[Callable] = None):
        """Restore into the structure of ``like`` (a tree of tensors or
        arrays with the checkpoint's shapes and dtypes: ``meta``-device
        tensors do) as CPU tensors, then ``layout(tree)`` if given — the
        elastic path: the checkpoint is logical, the cluster is whatever
        survives.  Returns ``(state, step)``.

        A torn step is DISCARDED with a warning naming it and the restore
        falls back to the previous intact step.  ``step=`` pins the newest
        step the caller will accept; the fallback walks strictly OLDER
        steps, never newer ones."""
        steps = self.all_steps()
        if step is not None:
            steps = [s for s in steps if s <= step]
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.root}"
                                    + (f" at step <= {step}"
                                       if step is not None else ""))
        last_err: Optional[BaseException] = None
        for s in reversed(steps):
            try:
                restored = self._load_step(like, s)
            except TORN_ERRORS as e:
                warnings.warn(
                    f"checkpoint step {s} is torn "
                    f"({type(e).__name__}: {e}); discarding it and falling "
                    "back to the previous intact step", RuntimeWarning,
                    stacklevel=2)
                last_err = e
                continue
            return (layout(restored) if layout is not None else restored), s
        raise FileNotFoundError(
            f"no intact checkpoint under {self.root}: every candidate step "
            f"{steps} is torn") from last_err

    def _load_step(self, like, step: int):
        path = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        recs = manifest["leaves"]
        with np.load(os.path.join(path, "shard_0.npz")) as data:
            leaves = [data[f"leaf_{i}"] for i in range(len(recs))]
        want = [x for _, x in _leaf_paths(like)]
        assert len(want) == len(leaves), "structure mismatch"
        out = []
        for w, a, rec in zip(want, leaves, recs):
            assert tuple(w.shape) == tuple(a.shape) == tuple(rec["shape"]), (
                tuple(w.shape), a.shape)
            stored = "bfloat16" if rec["dtype"] == "bfloat16" \
                else str(a.dtype)
            assert stored == rec["dtype"] or (
                rec["dtype"] == "bfloat16" and a.dtype.itemsize == 2), \
                f"{rec['path']}: shard dtype {a.dtype} != " \
                f"manifest {rec['dtype']}"
            assert _dtype_name(w) == rec["dtype"], \
                f"{rec['path']}: template dtype {_dtype_name(w)} != " \
                f"manifest {rec['dtype']}"
            out.append(_from_host(a, rec["dtype"]))
        return T.unflatten(like, out)
