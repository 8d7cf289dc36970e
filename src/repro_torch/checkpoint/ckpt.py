"""Atomic, async checkpoints that restore onto any device (the
reference's ``repro.checkpoint.ckpt``).

Layout:  <dir>/step_00000042/  MANIFEST.json + one .npy per tree leaf
         <dir>/LATEST          (text file naming the committed step dir)

Commit protocol: write into step_X.tmp, fsync each file, rename to
step_X (atomic), then replace LATEST: a crash mid-save never corrupts the
checkpoint committed before it, and :meth:`CheckpointManager.latest_step`
falls back to the newest complete step when LATEST names a missing one.

Leaves are keyed by their tree paths (``params/segments/0/1/attn/wq/w``,
``opt/m/...``; an ``OptState``'s fields by name). A bf16 leaf is stored
as its int16 bits with ``"dtype": "bfloat16"`` in the manifest (numpy has
no bf16 of its own). :meth:`CheckpointManager.restore` puts each leaf on
whatever device it is asked for: written from the card, read on the
CPU, the port's counterpart of the reference's reshard-on-load.

Async: one writer thread. :meth:`CheckpointManager.save` copies the tree
to host memory before it returns (so the next step may change the
tensors), then queues the write; :meth:`CheckpointManager.wait` joins
the write in flight and raises its error, if any.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading

import numpy as np
import torch

_STEP_DIR = re.compile(r"step_\d+")


def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} over dicts, lists and named tuples, in tree order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten_like(tree, leaves: iter):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten_like(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, leaves) for v in tree)
    return next(leaves)


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().copy()
    return t.numpy().copy()


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _fsync_write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._err: BaseException | None = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- save

    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Copy ``tree`` to host memory now, then write it as step
        ``step`` on the writer thread (``blocking``: and wait for it)."""
        host = {k: (_to_host(v), "bfloat16" if v.dtype == torch.bfloat16
                    else str(v.dtype).removeprefix("torch."))
                for k, v in flatten(tree).items()}
        self._q.put((step, host))
        if blocking:
            self.wait()

    def wait(self) -> None:
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def _run(self):
        while True:
            step, host = self._q.get()
            try:
                self._write(step, host)
            except Exception as e:  # noqa: BLE001 - raised by wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, host: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for i, (key, (arr, dtype)) in enumerate(host.items()):
            fname = f"leaf_{i:05d}.npy"
            _fsync_write(os.path.join(tmp, fname),
                         lambda f, a=arr: np.save(f, a))
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": dtype}
        _fsync_write(os.path.join(tmp, "MANIFEST.json"), lambda f: f.write(
            json.dumps({"step": step, "leaves": manifest}).encode()))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        _fsync_write(latest_tmp,
                     lambda f: f.write(os.path.basename(final).encode()))
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir)
                       if _STEP_DIR.fullmatch(d))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---------------------------------------------------------- restore

    def latest_step(self) -> int | None:
        """The step LATEST names or, if that directory is incomplete, the
        newest complete one; None without any."""
        latest = os.path.join(self.dir, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.dir, name, "MANIFEST.json")):
            cands = sorted(
                d for d in os.listdir(self.dir) if _STEP_DIR.fullmatch(d)
                and os.path.exists(os.path.join(self.dir, d,
                                                "MANIFEST.json")))
            if not cands:
                return None
            name = cands[-1]
        return int(name.split("_")[1])

    def restore(self, step: int, tree, device=None):
        """Load step ``step`` into the structure of ``tree`` (its leaves
        give the paths, shapes and dtypes). Each leaf goes to ``device``,
        or to its template leaf's device when ``device`` is None."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)["leaves"]
        flat = flatten(tree)
        missing = [k for k in flat if k not in manifest]
        if missing:
            raise ValueError(f"checkpoint missing leaves: {missing[:5]}")
        out = []
        for key, want in flat.items():
            entry = manifest[key]
            t = _from_host(np.load(os.path.join(path, entry["file"])),
                           entry["dtype"])
            if tuple(t.shape) != tuple(want.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(t.shape)} vs {tuple(want.shape)}")
            out.append(t.to(device=device if device is not None
                            else want.device, dtype=want.dtype))
        return _unflatten_like(tree, iter(out))
