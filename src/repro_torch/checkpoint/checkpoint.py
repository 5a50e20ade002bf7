"""Checkpoints of nested dicts of tensors, with async save.

The port's counterpart of ``repro.checkpoint.checkpoint``, on the
reference's on-disk layout::

    <dir>/step_<n>/
        manifest.json      — step, leaf count, shapes, dtypes, "zstd"
        arr_<i>.npy.zst    — one npy per leaf (zstd-compressed if "zstd")

Leaves are numbered in the order ``jax.tree_util`` flattens a nested dict
(keys sorted at every level), so a checkpoint of a nested dict of arrays
written by either package restores in the other.  A step is written to
``step_<n>.tmp`` and renamed.  Files are compressed when the
``zstandard`` module imports; a reader follows the manifest's flag, not
the module, and raises naming the module when a compressed checkpoint
meets a machine without it.  numpy has no bfloat16, so a bf16 tensor is
written as fp32 (exact) and cast back to the dtype of the leaf it
restores into.

On a mesh a leaf may be a DTensor: it is saved whole (every rank joins in
gathering it), one rank (rank 0) writes the files, and the others wait for
the write at the next ``wait()``.  ``restore_checkpoint(...,
shardings=)`` places each leaf with its sharding's placements on its mesh,
whatever mesh wrote it: the elastic restart's resharding path.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

try:
    import zstandard as zstd
    _Z = True
except ImportError:                                  # pragma: no cover
    zstd = None
    _Z = False


def _leaves(tree: Any) -> List[Any]:
    """Leaves of a nested dict in sorted-key order (jax's dict order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """`leaves` (sorted-key order) in `like`'s structure and key order."""
    it = iter(leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        vals = {k: build(node[k]) for k in sorted(node)}
        return {k: vals[k] for k in node}

    return build(like)


def _distributed(leaves: List[Any]) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for x in leaves)


def _writer() -> bool:
    """Whether this process writes: rank 0, or a process without a
    group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _to_host(x: Any) -> np.ndarray:
    """A host copy of one leaf (a copy even of a CPU tensor: the trainer
    updates its tensors in place after the snapshot); a DTensor whole."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def _write_leaf(path: str, arr: np.ndarray) -> None:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    data = buf.getvalue()
    if _Z:
        data = zstd.ZstdCompressor(level=3).compress(data)
    with open(path, "wb") as f:
        f.write(data)


def _read_leaf(path: str, compressed: bool) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if compressed:
        if zstd is None:
            raise RuntimeError(
                f"{path} is zstd-compressed (manifest 'zstd': true) and the "
                f"'zstandard' module is not installed")
        data = zstd.ZstdDecompressor().decompress(data)
    return np.load(io.BytesIO(data), allow_pickle=False)


def _save_host(ckpt_dir: str, step: int, host: List[np.ndarray]) -> str:
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "treedef": None,
        "n_leaves": len(host),
        "leaves": [{"shape": list(a.shape), "dtype": str(a.dtype)}
                   for a in host],
        "zstd": _Z,
    }
    for i, a in enumerate(host):
        _write_leaf(os.path.join(tmp, f"arr_{i}.npy.zst"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(out):
        shutil.rmtree(out)
    os.rename(tmp, out)
    return out


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous save of a nested dict of tensors or arrays.  Returns
    the step directory.  With DTensor leaves every rank calls it and
    returns once rank 0 has written."""
    leaves = _leaves(tree)
    host = [_to_host(x) for x in leaves]
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writer():
        _save_host(ckpt_dir, step, host)
    if _distributed(leaves):
        _barrier()
    return out


def _steps(ckpt_dir: str) -> List[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any,
                       device: DeviceLike = None, shardings: Any = None
                       ) -> Any:
    """Restore into the structure of `like`, each leaf a tensor on
    `device` (None: the CUDA device) in the dtype of `like`'s leaf where
    that is a tensor, else the file's.

    `shardings` (a tree of ``launch.steps.NamedSharding`` in `like`'s
    structure, ``named(mesh, specs)``; a None leaf stays a plain tensor)
    places each leaf as a DTensor on its mesh, on the mesh's device: the
    resharding path, for a checkpoint written on any mesh.  Every rank
    reads the files and keeps its own shard."""
    sh_leaves = None
    if shardings is not None:
        from torch.distributed.tensor import distribute_tensor
        sh_leaves = _leaves(shardings)
        if len(sh_leaves) != len(_leaves(like)):
            raise ValueError(f"shardings has {len(sh_leaves)} leaves, like "
                             f"{len(_leaves(like))}")
        meshes = [sh.mesh for sh in sh_leaves if sh is not None]
        if meshes:
            device = meshes[0].device_type
    dev = resolve_device(device)
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = _leaves(like)
    if manifest["n_leaves"] != len(like_leaves):
        raise ValueError(f"leaf count mismatch: checkpoint "
                         f"{manifest['n_leaves']} vs {len(like_leaves)}")
    placed = []
    for i, ref in enumerate(like_leaves):
        a = _read_leaf(os.path.join(src, f"arr_{i}.npy.zst"),
                       manifest["zstd"])
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        if isinstance(ref, torch.Tensor):
            t = t.to(ref.dtype)
        if sh_leaves is not None and sh_leaves[i] is not None:
            sh = sh_leaves[i]
            t = distribute_tensor(t, sh.mesh, sh.placements,
                                  src_data_rank=None)
        placed.append(t)
    return _unflatten(like, placed)


class AsyncCheckpointer:
    """Snapshot to host synchronously, write on a background thread, keep
    the newest `keep` steps."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._distributed = False

    def save(self, step: int, tree: Any) -> None:
        self.wait()                                   # one in flight at a time
        leaves = _leaves(tree)
        host = [_to_host(x) for x in leaves]          # sync device -> host
        self._distributed = _distributed(leaves)
        if not _writer():
            return

        def work():
            try:
                _save_host(self.ckpt_dir, step, host)
                self._gc()
            except BaseException as e:                # raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """The write in flight done (and, after a save of DTensors, every
        rank past this point only once rank 0's write is)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._distributed:
            self._distributed = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
