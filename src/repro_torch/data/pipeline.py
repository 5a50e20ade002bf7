"""Deterministic synthetic LM data pipeline with background prefetch.

The port's counterpart of ``repro.data.pipeline``.  Tokens are a cheap
stateless hash of (step, position), so any worker can produce its shard
without coordination, a restart resumes bit-identically from the step
counter, and the stream has enough structure (a noisy periodic pattern)
for the loss to fall.  :class:`SyntheticLMDataset` is the reference's
numpy code unchanged, so both packages draw the same batches bit for bit.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class SyntheticLMDataset:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, structure: int = 97):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.structure = structure     # period of the learnable pattern

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Full global batch for `step` (deterministic)."""
        b, s = self.global_batch, self.seq_len
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        base = rng.integers(0, self.structure, size=(b, 1))
        pos = np.arange(s + 1)[None, :]
        pattern = (base + pos) % self.structure
        noise = rng.integers(0, self.vocab, size=(b, s + 1))
        mask = rng.random((b, s + 1)) < 0.15
        toks = np.where(mask, noise, pattern % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class PrefetchIterator:
    """Background-thread prefetch (double buffering: compute step i while
    the host builds batch i+1).  An exception in the producer is raised
    in the consumer after the items before it."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:          # propagate into consumer
                self._err = e
            finally:
                self._q.put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def _data_rows(mesh, dp_axes, rows: int) -> Optional[slice]:
    """This rank's rows of a batch of `rows` split over `dp_axes` (in
    mesh order, major to minor, as DTensor splits a dim), or None where
    the batch stays whole: one row, or rows the axes do not divide
    (``batch_spec``'s rule)."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    index, parts = 0, 1
    for a in dp_axes:
        n = mesh.size(names.index(a))
        index = index * n + coord[names.index(a)]
        parts *= n
    if rows <= 1 or rows % parts:
        return None
    per = rows // parts
    return slice(index * per, (index + 1) * per)


def make_batch_iter(ds: SyntheticLMDataset, start_step: int, num_steps: int,
                    device: DeviceLike = None, prefetch: int = 2, mesh=None,
                    dp_axes=("data",)):
    """Yields the batches of steps [start_step, start_step + num_steps) as
    int64 tensors on `device` (None: the CUDA device), built and copied on
    a background thread.  A CUDA copy goes through pinned memory and does
    not block; ``device="cpu"`` leaves the batch on the host.

    With a `mesh` each batch is a DTensor on it (its device type is the
    device), rows split over `dp_axes` and replicated on the other mesh
    dims, as the reference's ``PartitionSpec(dp_axes, None)`` places it:
    each rank copies only its own rows.  A batch of one row, or of rows
    the axes do not divide, is replicated instead, as ``batch_spec``
    leaves it."""
    if mesh is None:
        dev = resolve_device(device)
    else:
        from torch.distributed.tensor import DTensor
        from repro_torch.models.dtensor import P, to_placements
        dev = resolve_device(mesh.device_type)
        rows = _data_rows(mesh, dp_axes, ds.global_batch)
        placements = to_placements(
            mesh, P(tuple(dp_axes) if rows is not None else None, None))

    def copy(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.int64)))
        if dev.type == "cpu":
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    def place(a: np.ndarray) -> torch.Tensor:
        if mesh is None:
            return copy(a)
        local = a if rows is None else a[rows]
        return DTensor.from_local(copy(local), mesh, placements,
                                  run_check=False, shape=a.shape,
                                  stride=(a.shape[1], 1))

    def gen():
        for step in range(start_step, start_step + num_steps):
            yield {k: place(v) for k, v in ds.batch_at(step).items()}

    return PrefetchIterator(gen(), depth=prefetch)
