"""Fault-tolerant checkpointing: atomic commits, integrity manifest, async
snapshots, keep-K retention, restore onto any device.

The reference's layout, byte for byte, so that each package reads the
other's checkpoints (one directory per step):
    <root>/step_000123/
        arrays.npz            flattened param/opt tree (path-keyed:
                              ``params/layers/attn/wq``, ``opt/step``)
        manifest.json         step, keys, shapes, dtypes,
                              sha256(arrays.npz), extra
    <root>/step_000123.tmp/   staging dir — atomic os.replace on commit

A bfloat16 leaf is stored as the reference's numpy writes one: its 16-bit
patterns as ``|V2`` under manifest dtype ``"bfloat16"``; it is read back
by viewing the bits, so no bfloat16 numpy type is needed.

Crash safety: a checkpoint is visible iff its final directory exists, and
the manifest hash detects torn/corrupt files.  ``latest_step`` ignores
.tmp leftovers, so a killed save never poisons restart.

Restore puts each leaf on its template's device and dtype, or on
``device`` when one is given: the one-card case of the reference's
elastic restore onto another mesh.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import api

BF16 = "bfloat16"


def _flatten(tree) -> Dict[str, torch.Tensor]:
    """Leaves keyed by their ``/``-joined dict keys, keys sorted at every
    level (the reference's order)."""
    return {"/".join(path): v for path, v in api.leaves(tree)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the array the reference writes for it."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array (manifest dtype ``dtype``) as a host tensor of the
    same bits."""
    if dtype == BF16:
        return api.tensor_from_numpy(a.view(np.int16), "cpu").view(
            torch.bfloat16)
    return api.tensor_from_numpy(a, "cpu")


def _unflatten_into(template, flat: Dict[str, torch.Tensor], device,
                    prefix: str = ""):
    out = {}
    for k, leaf in template.items():
        key = f"{prefix}{k}"
        if isinstance(leaf, dict):
            out[k] = _unflatten_into(leaf, flat, device, key + "/")
            continue
        t = flat[key]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"model shape {tuple(leaf.shape)}")
        out[k] = t.to(device=leaf.device if device is None else device,
                      dtype=leaf.dtype)
    return out


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, root: str | Path, keep: int = 3,
                 async_save: bool = False):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Write ``tree`` (nested dicts of tensors on any device) as step
        ``step``.  An async save copies every leaf to the host before it
        returns, so a step that then updates the tensors in place does
        not change what the thread writes."""
        if self.async_save:
            self.wait()
            snapshot = {k: v.detach().to("cpu", copy=True)
                        for k, v in _flatten(tree).items()}
            self._thread = threading.Thread(
                target=self._save_sync, args=(step, snapshot, extra),
                daemon=True)
            self._thread.start()
        else:
            self._save_sync(step, tree, extra)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _save_sync(self, step: int, tree, extra):
        try:
            final = self.root / f"step_{step:09d}"
            tmp = self.root / f"step_{step:09d}.tmp"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            flat = {k: v.detach().cpu() for k, v in _flatten(tree).items()}
            npz = tmp / "arrays.npz"
            np.savez(npz, **{k: _to_numpy(v) for k, v in flat.items()})
            manifest = {
                "step": step,
                "keys": sorted(flat),
                "shapes": {k: list(v.shape) for k, v in flat.items()},
                "dtypes": {k: str(v.dtype).replace("torch.", "")
                           for k, v in flat.items()},
                "sha256": _sha256(npz),
                "extra": extra or {},
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)      # atomic commit
            self._gc()
        except BaseException as e:      # surfaced on next wait()
            self._error = e
            raise

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for p in self.root.glob("step_*"):
            if p.suffix == ".tmp" or not p.is_dir():
                continue
            if not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any, device=None,
                verify: bool = True) -> Any:
        """Step ``step`` in ``template``'s structure: each leaf checked
        against its template's shape and put in its dtype on its device,
        or on ``device`` when one is given."""
        d = self.root / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        if verify:
            got = _sha256(d / "arrays.npz")
            if got != manifest["sha256"]:
                raise IOError(f"checkpoint {step} corrupt: sha mismatch")
        with np.load(d / "arrays.npz") as z:
            flat = {k: _to_tensor(z[k], manifest["dtypes"][k])
                    for k in z.files}
        return _unflatten_into(template, flat, device)

    def restore_latest(self, template: Any, device=None
                       ) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, template, device)
