"""Checkpointing: atomic, keep-k, async, elastic restore.

Port of ``repro.checkpoint.manager``, with the reference's on-disk format,
so a checkpoint written by either package restores in the other:
``<dir>/step_<n>/arrays.npz`` (leaf path -> ndarray) + ``manifest.json``
(step, leaf paths, shapes, dtypes, save wall-time, extras).  Leaf paths are
the reference's pytree paths joined by ``"/"`` (:mod:`repro_torch._tree`);
a scanned stack's layers are saved as one array with a leading layer axis
and sliced back into the port's per-layer tensors on restore.  Writes go
to ``step_<n>.tmp`` and are ``os.replace``d on completion, so a crash
mid-save can never corrupt the latest checkpoint.

bfloat16 leaves: numpy has no bfloat16, and the reference's npz holds such
a leaf as its raw 2-byte words (``ml_dtypes``' bfloat16 is saved under the
void descriptor ``<V2``) with ``"bfloat16"`` in the manifest.  The port
writes the same bytes under the same descriptor (the tensor viewed as
int16, then as ``V2``) and, on restore, reads any leaf the manifest calls
``bfloat16`` back through an int16 view, so neither side needs
``ml_dtypes``.

Async: ``save_async`` snapshots to host memory synchronously and runs the
file I/O on a daemon thread; ``wait()`` drains pending writes.

Sharded state: ``save(..., mesh=, specs=)`` takes a tree of this rank's
blocks (each leaf's spec in ``specs``, a tree of resolved specs as
``Model.partition_specs`` gives it), assembles every leaf to its full array
(the port's counted gathers, on every rank), and rank 0 alone writes;
the other ranks wait at a barrier (``save_async``: at the next ``wait()``).
So a file is always the reference's format, whole leaves, readable by
either package.

Elastic restore: ``restore(..., mesh=, specs=)`` onto any mesh shape: each
rank reads the full arrays and cuts its block by the leaf's spec (after
checking the spec against the mesh's axes), on the mesh's device.  The
template's leaves may be whole (their shapes checked against the file) or
this rank's blocks.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

import torch.distributed as dist

from repro_torch import _tree
from repro_torch.launch.mesh import NamedSharding, assemble_tree

SEP = _tree.SEP
BF16 = "bfloat16"


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """The leaves as numpy arrays and their dtype names, by leaf path."""
    arrays = _tree.flatten(tree, _numpy, np.stack)
    dtypes = _tree.flatten(tree, _dtype_name, lambda names: names[0])
    return arrays, dtypes


def _spec_at(specs: Any, path: str):
    node = specs
    for part in path.split(SEP):
        while isinstance(node, _tree.Stacked):  # one spec for every layer of a stack
            node = node[0]
        if isinstance(node, dict):
            node = node[part]
        elif _tree._is_namedtuple(node):
            node = getattr(node, part)
        else:
            node = node[int(part)]
    return node


def _check_spec(spec, mesh, key: str, ndim: int) -> None:
    entries = tuple(spec or ())
    if len(entries) > ndim:
        raise ValueError(f"{key}: spec {spec} has more entries than the leaf's {ndim} dims")
    for entry in entries:
        for ax in entry if isinstance(entry, tuple) else (entry,):
            if ax is not None and ax not in mesh.mesh_dim_names:
                raise ValueError(f"{key}: spec {spec} names {ax!r}, not an axis of the mesh "
                                 f"{mesh.mesh_dim_names}")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._barrier = False  # a sharded save_async the ranks have not met after

    # ---------- save ----------
    def save(self, step: int, tree: Any, extra: dict | None = None, *, mesh=None,
             specs: Any = None) -> str:
        """Write ``tree`` as step ``step``; with ``mesh`` and ``specs`` the
        leaves are this rank's blocks, assembled here, rank 0 writing and
        every rank leaving once the file is complete."""
        if mesh is None:
            arrays, dtypes = _flatten(tree)
            return self._write(step, arrays, dtypes, extra or {})
        arrays, dtypes = _flatten(assemble_tree(tree, specs, mesh))
        path = os.path.join(self.dir, f"step_{step:08d}")
        if dist.get_rank() == 0:
            path = self._write(step, arrays, dtypes, extra or {})
        dist.barrier()
        return path

    def save_async(self, step: int, tree: Any, extra: dict | None = None, *, mesh=None,
                   specs: Any = None) -> None:
        """``save`` with the file I/O on a daemon thread; the tree is copied
        to host memory (assembled, on a mesh) before this returns."""
        self.wait()
        if mesh is not None:
            tree = assemble_tree(tree, specs, mesh)
            self._barrier = True
        arrays, dtypes = _flatten(tree)  # snapshot now; IO later
        if mesh is None or dist.get_rank() == 0:
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, dtypes, extra or {}), daemon=True
            )
            self._thread.start()

    def wait(self) -> None:
        """Drain the pending write; after a sharded ``save_async`` every rank
        waits here until rank 0's file is complete."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _write(self, step: int, arrays: dict[str, np.ndarray], dtypes: dict[str, str],
               extra: dict) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": dict(dtypes),
            "saved_at": time.time(),
            **extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ---------- restore ----------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        template: Any,
        step: int | None = None,
        *,
        mesh=None,
        specs: Any = None,
    ) -> tuple[Any, dict]:
        """Restore into the structure of ``template``: each leaf with the
        template leaf's shape (checked) and dtype, on its device.

        ``mesh`` (a ``DeviceMesh``) + ``specs`` (a tree of per-leaf specs,
        tuples of mesh axis names, matching ``template``) cut every leaf to
        this rank's block of the mesh, on the mesh's device: the template
        leaf is then the whole leaf or this rank's block.
        """
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        mesh_device = torch.device(mesh.device_type) if mesh is not None else None

        def convert(arr: np.ndarray, leaf, key: str):
            sharding = None
            if mesh is not None and specs is not None:
                spec = _spec_at(specs, key)
                _check_spec(spec, mesh, key, arr.ndim)
                sharding = NamedSharding.of(mesh, spec)
            if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(leaf.shape) and not (
                    sharding is not None
                    and sharding.block_shape(arr.shape) == tuple(leaf.shape)):
                raise ValueError(f"{key}: shape {arr.shape} != template {tuple(leaf.shape)}")
            if manifest["dtypes"].get(key) == BF16:
                t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.asarray(arr))
            if sharding is not None:
                t = sharding.cut(t)
            if mesh_device is not None:
                device = mesh_device
            else:
                device = leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cpu")
            dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else t.dtype
            return t.to(device=device, dtype=dtype)

        with np.load(os.path.join(path, "arrays.npz")) as data:
            tree = _tree.rebuild(template, lambda key: data[key], convert)
        return tree, manifest
