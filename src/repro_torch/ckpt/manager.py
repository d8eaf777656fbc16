"""Fault-tolerant checkpoints: the port of ``repro.ckpt.manager``, on the
same on-disk format, so either package restores what the other wrote.

* **Atomicity**: arrays go to ``<dir>/tmp.<step>.<pid>/arrays.npz``, then
  ``manifest.json`` (names, dtypes, shapes, the npz's sha256, layout
  ``replicated-npz-v1``, ``extra``) is written last and the directory is
  moved into place as ``step_<step>`` with ``os.replace``. A directory
  whose manifest is missing or whose checksum does not match is ignored.
* **Keep-k GC**: after a save, all but the newest ``keep`` valid steps are
  removed, and ``tmp.*`` directories older than an hour (crashed writers).
* **Resume-latest**: ``latest_step`` / ``restore_latest``.

A tree is nested dicts, lists and tuples whose leaves are tensors or host
integers. Leaves are named as JAX's ``tree_flatten_with_path`` names them in
the reference: the tuple or list index, then each dict key in sorted order,
joined by ``/``; a ``None`` subtree carries no leaf. A host integer (the
optimisers' ``step``) is saved as a 0-d int32 array and restored as an int.
bfloat16 leaves are written as their 16-bit patterns, which is what numpy
writes for the reference's ``ml_dtypes`` arrays (void, 2 bytes; the
manifest says ``bfloat16``), and read back bit for bit without
``ml_dtypes``. ``restore`` puts the tensors on ``device`` in the dtypes of
``like`` (a tree of tensors, meta tensors included), where the reference
takes target shardings.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.optim import tree_map, tree_named_leaves

_STEP_RE = re.compile(r"^step_(\d+)$")
_BF16 = np.dtype("V2")                  # how numpy stores a bfloat16 array


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array written, the dtype name the manifest records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16), "bfloat16"
        a = t.numpy()
    elif isinstance(leaf, int) and not isinstance(leaf, bool):
        a = np.asarray(leaf, np.int32)
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A loaded array (fresh and writable) as a tensor, sharing its memory."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict[str, Any]] = None) -> str:
        leaves = tree_named_leaves(tree)
        names = [name for name, _ in leaves]
        written = {name: _to_numpy(leaf) for name, leaf in leaves}
        arrays = {k: a for k, (a, _) in written.items()}

        tmp = os.path.join(self.directory, f"tmp.{step}.{os.getpid()}")
        final = os.path.join(self.directory, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **{k.replace("/", "|"): v for k, v in arrays.items()})
        manifest = {
            "step": step,
            "time": time.time(),
            "names": names,
            "dtypes": {k: dt for k, (_, dt) in written.items()},
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "checksum": _file_sha256(npz_path),
            "layout": "replicated-npz-v1",
            "extra": extra or {},
        }
        # manifest written LAST: its presence marks the checkpoint complete.
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    # -- restore --------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            m = _STEP_RE.match(d)
            if m and self._valid(os.path.join(self.directory, d)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Any, device="cuda") -> Any:
        """Restore into the structure of ``like``: each tensor leaf becomes a
        tensor of its dtype on ``device``, each int leaf an int."""
        d = os.path.join(self.directory, f"step_{step}")
        if not self._valid(d):
            raise FileNotFoundError(f"no valid checkpoint at step {step}")
        dtypes = self.manifest(step)["dtypes"]
        with np.load(os.path.join(d, "arrays.npz")) as z:
            data = {k.replace("|", "/"): z[k] for k in z.files}
        out = []
        for name, leaf in tree_named_leaves(like):
            if name not in data:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            if isinstance(leaf, int) and not isinstance(leaf, bool):
                out.append(int(data[name]))
                continue
            t = _to_tensor(data[name], dtypes[name])
            out.append(t.to(device=device, dtype=leaf.dtype))
        it = iter(out)
        return tree_map(lambda _: next(it), like)

    def restore_latest(self, like: Any, device="cuda"):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, device=device)

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.directory, f"step_{step}", "manifest.json")) as f:
            return json.load(f)

    # -- internals ------------------------------------------------------------
    def _valid(self, d: str) -> bool:
        man = os.path.join(d, "manifest.json")
        npz = os.path.join(d, "arrays.npz")
        if not (os.path.exists(man) and os.path.exists(npz)):
            return False
        try:
            with open(man) as f:
                m = json.load(f)
            return m.get("checksum") == _file_sha256(npz)
        except (json.JSONDecodeError, OSError):
            return False

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)
        # remove stale tmp dirs from crashed writers
        for d in os.listdir(self.directory):
            if d.startswith("tmp."):
                full = os.path.join(self.directory, d)
                if time.time() - os.path.getmtime(full) > 3600:
                    shutil.rmtree(full, ignore_errors=True)


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
