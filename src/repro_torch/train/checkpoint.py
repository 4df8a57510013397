"""Checkpointing: async, atomic, latest-k retention, **elastic** restore
(counterpart of :mod:`repro.train.checkpoint`, in its on-disk layout).

- Every rank writes the shards it holds of each leaf (a DTensor's local
  shard with its global offsets; a plain tensor whole) into its own
  files; a JSON manifest records the tree's leaf paths, global shapes,
  dtypes and the step.  No rank materialises a sharded global array.
  A replicated shard is written once, by the rank at index 0 of the mesh
  dims it is replicated over.
- Layout: ``step_%08d/manifest.host{rank}.json`` and one
  ``{path with "/" as "__"}.host{rank}.npz`` a leaf holding ``shard_i``
  and ``index_i`` ((start, stop) a dim); paths are the reference's
  (``"0/blocks/b0/attn/wq"``: dict keys sorted, sequence indices), so
  the two packages read each other's float32 and int32 checkpoints.
  bfloat16 leaves are stored as their uint16 bits with ``"bfloat16"`` in
  the manifest (numpy has no bfloat16 of its own).
- Writes go to ``step_XXXX.tmp{rank}`` and are atomically renamed after
  fsync (or merged into a directory another rank renamed first): a crash
  mid-write never corrupts the latest checkpoint.
- ``save_async`` copies the tensors to host memory now (a sync with the
  card) and writes them on a worker thread.
- **Elastic restore**: ``restore`` rebuilds each global array from every
  rank's shards and, given a sharding a leaf, lays it out on that mesh,
  whatever mesh wrote it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.model import tree_flatten_with_paths, \
    tree_map_with_path


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy().copy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _local_shards(leaf):
    """[(index, host array)] of what this rank writes of ``leaf``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(leaf, DTensor):
        return [(tuple((0, n) for n in leaf.shape), _to_numpy(leaf))]
    mesh, placements = leaf.device_mesh, leaf.placements
    coord = mesh.get_coordinate()
    if coord is None:                     # this rank is not on the mesh
        return []
    if any(isinstance(p, Replicate) and c != 0
           for p, c in zip(placements, coord)):
        return []                         # a replica another rank writes
    from repro_torch.launch.sharding import shard_slices
    index = shard_slices(tuple(leaf.shape), mesh, placements)
    return [(tuple((s.start, s.stop) for s in index),
             _to_numpy(leaf.to_local()))]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Synchronous atomic save.  In a process group every rank saves,
        and on return every rank's files are in place (a barrier)."""
        self._write(step, self._snapshot(tree), extra or {})
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.barrier()

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Snapshot now, write on a worker thread (overlaps with compute)."""
        self.wait()
        snap = self._snapshot(tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, snap, extra or {}), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _snapshot(self, tree):
        out = []
        for path, leaf in tree_flatten_with_paths(tree):
            if not isinstance(leaf, torch.Tensor):
                leaf = torch.as_tensor(leaf)
            out.append(("/".join(path), {
                "global_shape": tuple(leaf.shape),
                "dtype": _dtype_name(leaf),
                "shards": _local_shards(leaf)}))
        return out

    def _write(self, step: int, snap, extra: dict):
        rank = _rank()
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + f".tmp{rank}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for path, rec in snap:
            safe = path.replace("/", "__")
            manifest["leaves"][path] = {
                "global_shape": list(rec["global_shape"]),
                "dtype": rec["dtype"],
                "file": f"{safe}.host{rank}.npz",
            }
            arrs = {}
            for i, (index, data) in enumerate(rec["shards"]):
                arrs[f"shard_{i}"] = data
                arrs[f"index_{i}"] = np.array(index, np.int64).reshape(-1, 2)
            np.savez(os.path.join(tmp, manifest["leaves"][path]["file"]),
                     **arrs)
        with open(os.path.join(tmp, f"manifest.host{rank}.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.rename(tmp, final)
        except OSError:                   # another rank renamed first
            self._merge_into(tmp, final)
        self._gc()

    def _merge_into(self, tmp, final):
        for name in os.listdir(tmp):
            os.replace(os.path.join(tmp, name), os.path.join(final, name))
        shutil.rmtree(tmp, ignore_errors=True)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: Any, shardings: Any = None):
        """Restore into the structure of ``target_tree``, each leaf in its
        target's dtype and on its target's device (the CPU for a meta
        stand-in).

        ``shardings``: optional tree (the target's structure) of
        :class:`repro_torch.launch.sharding.NamedSharding` for **elastic**
        restore: each global array is rebuilt from the shards, then this
        rank's block of it becomes a DTensor on that mesh.
        Returns (tree, extra).
        """
        d = os.path.join(self.directory, f"step_{step:08d}")
        names = sorted(os.listdir(d))
        manifests = []
        for m in names:
            if m.startswith("manifest."):
                with open(os.path.join(d, m)) as f:
                    manifests.append(json.load(f))
        if not manifests:
            raise FileNotFoundError(f"no manifest in {d}")
        leaves_meta = {}
        for m in manifests:
            leaves_meta.update(m["leaves"])
        extra = manifests[0]["extra"]
        shard_of = dict(tree_flatten_with_paths(shardings)) \
            if shardings is not None else {}

        def one(path, leaf):
            key = "/".join(path)
            meta = leaves_meta[key]
            full = _read_global(d, names, key, meta)
            dev = leaf.device if leaf.device.type != "meta" else "cpu"
            t = full.to(dev, leaf.dtype)
            shd = shard_of.get(path)
            return t if shd is None else shd.distribute(t)

        return tree_map_with_path(one, target_tree), extra


def _read_global(d: str, names, key: str, meta: dict) -> torch.Tensor:
    """The global array of one leaf from every rank's shard files."""
    gshape = tuple(meta["global_shape"])
    bf16 = meta["dtype"] == "bfloat16"
    full = np.zeros(gshape, dtype=np.uint16 if bf16 else
                    np.dtype(meta["dtype"]))
    safe = key.replace("/", "__")
    for fname in names:
        if fname.startswith(safe + ".host"):
            with np.load(os.path.join(d, fname)) as z:
                n = len([k for k in z.files if k.startswith("shard_")])
                for i in range(n):
                    idx = z[f"index_{i}"]
                    sl = tuple(slice(int(a), int(b)) for a, b in idx)
                    data = z[f"shard_{i}"]
                    full[sl] = data.view(np.uint16) if bf16 else data
    if bf16:
        return torch.from_numpy(full.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(full)
