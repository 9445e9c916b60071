"""Async, integrity-checked checkpoints (port of
``src/repro/checkpoint/manager.py:50``), in the reference's on-disk layout so
that checkpoints cross-load between the two packages in both directions:

    ckpt_dir/
      step_000000120/
        manifest.json         # step, extra, and per leaf: file, shape, dtype, digest
        arrays/00000.npy      # one file per leaf, numbered in sorted leaf-key order
      LATEST                  # atomically replaced pointer file

* leaf keys are the reference's (``params/backbone/units/0/attn/wq``,
  ``opt/master/...``, ``opt/m/...``, ``opt/step``; ``repro_torch.tree``);
* bf16 leaves are stored as raw ``u2`` with the logical dtype ``bfloat16``;
* every file carries a blake2s-16 digest that ``restore`` verifies;
* ``save`` snapshots the tensors to host memory, then writes on a background
  thread (one outstanding save at a time: a second save waits);
* a torn step (no manifest) is skipped, the directory is published with an
  atomic rename, and only the newest ``keep`` steps are kept;
* a tree on a mesh (DTensor leaves) is saved whole: every rank gathers each
  leaf, the MoE experts go back to the port's whole layout
  (``convert.experts_whole``), rank 0 writes, and the other ranks wait for
  its write to be published (``wait``). ``restore`` with ``shardings``
  re-blocks the experts for the restoring mesh's model size and places
  every leaf by its sharding, so a checkpoint moves between meshes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.convert import experts_blocked, experts_whole
from repro_torch.parallel.specs import place, whole
from repro_torch.tree import leaf_paths, tree_map, unflatten_like


def _digest(arr: np.ndarray) -> str:
    return hashlib.blake2s(arr.tobytes(), digest_size=16).hexdigest()


def _stored(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array as written, logical dtype name) of a host tensor."""
    if t.dtype == torch.bfloat16:  # numpy has no bf16: its raw bits as u2
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _logical(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(np.dtype(dtype_name), copy=False))


class CheckpointManager:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._mesh_save = False  # a save from a mesh is pending: the ranks meet in wait

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict[str, Any]] = None,
             block: bool = False) -> None:
        """Snapshot now (a host copy of every leaf), write asynchronously. A
        tree with DTensor leaves is a collective: every rank of its mesh
        calls ``save``, and rank 0 writes."""
        self.wait()  # back-pressure: one outstanding save max
        on_mesh = any(isinstance(t, DTensor) for t in leaf_paths(tree).values())
        if on_mesh:
            tree = experts_whole(tree_map(whole, tree))
            self._mesh_save = True
        if not on_mesh or dist.get_rank() == 0:
            host = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
            t = threading.Thread(target=self._write, args=(step, host, extra or {}),
                                 daemon=True, name=f"ckpt-{step}")
            self._pending = t
            t.start()
        if block:
            self.wait()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._mesh_save:  # the other ranks wait for rank 0's write
            self._mesh_save = False
            dist.barrier()

    def _write(self, step: int, host_tree: Any, extra: Dict[str, Any]) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
        final = os.path.join(self.dir, f"step_{step:09d}")
        arrays_dir = os.path.join(tmp, "arrays")
        os.makedirs(arrays_dir, exist_ok=True)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for i, (key, t) in enumerate(sorted(leaf_paths(host_tree).items())):
            arr, logical_dtype = _stored(t)
            fname = f"{i:05d}.npy"
            np.save(os.path.join(arrays_dir, fname), arr, allow_pickle=False)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": logical_dtype, "stored_dtype": str(arr.dtype),
                "digest": _digest(arr),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final)  # atomic publish
        with open(os.path.join(self.dir, ".LATEST_tmp"), "w") as f:
            f.write(os.path.basename(final))
        os.replace(os.path.join(self.dir, ".LATEST_tmp"), os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -- restore ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        candidates = []
        ptr = os.path.join(self.dir, "LATEST")
        if os.path.exists(ptr):
            with open(ptr) as f:
                candidates.append(f.read().strip())
        candidates += sorted((d for d in os.listdir(self.dir) if d.startswith("step_")),
                             reverse=True)
        for c in candidates:
            if os.path.exists(os.path.join(self.dir, c, "manifest.json")):
                return int(c.split("_")[1])
        return None

    def restore(self, step: Optional[int], like: Any, shardings: Optional[Any] = None
                ) -> Tuple[Any, int, Dict[str, Any]]:
        """Load into the structure of ``like`` (a tree of tensors), each leaf in
        its ``like`` leaf's dtype and on its device. With ``shardings`` (a
        tree like ``like`` of ``parallel.axes.NamedSharding``, or None for a
        leaf kept whole, as ``parallel.specs.make_shardings`` gives) the MoE
        experts are blocked as ``like``'s and every leaf is placed by its
        sharding: each rank keeps its own chunks. Verifies digests and
        raises on corruption (IOError), a shape mismatch (ValueError) or a
        missing leaf (KeyError). Returns (tree, step, extra)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        like_leaves = leaf_paths(like)
        # experts blocked in ``like`` (a mesh's layout) are stored whole: check
        # and load them whole, then block them as ``like``'s
        shapes = leaf_paths(experts_whole(tree_map(
            lambda t: torch.empty(t.shape, device="meta"), like)))
        tps = {t.shape[1] for k, t in like_leaves.items()
               if k.endswith("moe/w_gate") and t.dim() == 5}
        loaded: Dict[str, torch.Tensor] = {}
        for key, meta in manifest["leaves"].items():
            if key not in like_leaves:
                continue
            arr = np.load(os.path.join(d, "arrays", meta["file"]), allow_pickle=False)
            if _digest(arr) != meta["digest"]:
                raise IOError(f"checkpoint corruption in {key} @ step {step}")
            target = like_leaves[key]
            if list(arr.shape) != list(shapes[key].shape):
                raise ValueError(f"{key}: ckpt shape {arr.shape} != model "
                                 f"{tuple(shapes[key].shape)}")
            t = _logical(arr, meta["dtype"])
            loaded[key] = t.to(device=target.device, dtype=target.dtype)
        missing = set(like_leaves) - set(loaded)
        if missing:
            raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
        out = unflatten_like(like, loaded)
        if tps:
            out = experts_blocked(out, tps.pop())
        if shardings is not None:
            out = tree_map(place, out, shardings)
        return out, manifest["step"], manifest.get("extra", {})
