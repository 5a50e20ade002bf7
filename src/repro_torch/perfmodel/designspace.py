"""The GPU-node design space of the paper (Table 1).

Each design point is an 8-vector of *choice indices* (int32), one per
parameter, in the canonical order of :data:`PARAM_NAMES`.  Index-space is
the representation used everywhere (search algorithms, trajectory memory,
the CUDA ``ppa_eval`` kernel); :meth:`DesignSpace.decode` maps indices to
physical values.

Total cardinality: 4 * 14 * 4 * 6 * 6 * 7 * 7 * 12 = 4,741,632.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

# Canonical parameter order.  KEEP STABLE: trajectory memory and the CUDA
# kernel's design-value columns index by position.
PARAM_NAMES: tuple = (
    "link_count",        # interconnect links per GPU
    "core_count",        # number of cores (SM analogue)
    "sublane_count",     # sublanes per core (each has one systolic array slice)
    "sa_dim",            # systolic array height == width
    "vector_width",      # vector-unit lanes per sublane
    "sram_kb",           # per-core SRAM in KB
    "gbuf_mb",           # total global buffer (L2 analogue) in MB
    "mem_channels",      # HBM memory channel count
)

PARAM_CHOICES: Dict[str, tuple] = {
    "link_count": (6, 12, 18, 24),
    "core_count": (1, 2, 4, 8, 16, 32, 64, 96, 108, 128, 132, 136, 140, 256),
    "sublane_count": (1, 2, 4, 8),
    "sa_dim": (4, 8, 16, 32, 64, 128),
    "vector_width": (4, 8, 16, 32, 64, 128),
    "sram_kb": (32, 64, 128, 192, 256, 512, 1024),
    "gbuf_mb": (32, 64, 128, 256, 320, 512, 1024),
    "mem_channels": tuple(range(1, 13)),
}

# NVIDIA A100 reference design (paper Table 4).  The 40 MB global buffer is
# outside the searchable choices: encode_nearest snaps it.
A100_REFERENCE: Dict[str, int] = {
    "link_count": 12,
    "core_count": 108,
    "sublane_count": 4,
    "sa_dim": 16,
    "vector_width": 32,
    "sram_kb": 128,
    "gbuf_mb": 40,
    "mem_channels": 5,
}

# Paper Table 4, designs A and B discovered by Lumina.
DESIGN_A: Dict[str, int] = {
    "link_count": 24, "core_count": 64, "sublane_count": 4, "sa_dim": 32,
    "vector_width": 16, "sram_kb": 128, "gbuf_mb": 40, "mem_channels": 6,
}
DESIGN_B: Dict[str, int] = {
    "link_count": 18, "core_count": 96, "sublane_count": 4, "sa_dim": 32,
    "vector_width": 16, "sram_kb": 128, "gbuf_mb": 40, "mem_channels": 6,
}


@functools.lru_cache(maxsize=None)
def _choice_table_on(choices: tuple, device: str) -> torch.Tensor:
    """fp32 choice table on `device` (the reference runs without x64)."""
    tab = DesignSpace(choices=choices).choice_table()
    return torch.as_tensor(tab, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Index-coded categorical design space."""

    names: tuple = PARAM_NAMES
    choices: tuple = tuple(PARAM_CHOICES[n] for n in PARAM_NAMES)

    @property
    def n_params(self) -> int:
        return len(self.names)

    @property
    def cardinalities(self) -> np.ndarray:
        return np.array([len(c) for c in self.choices], dtype=np.int64)

    @property
    def size(self) -> int:
        return int(np.prod(self.cardinalities))

    def choice_table(self) -> np.ndarray:
        """(n_params, max_choices) float64 table; padded with the last value."""
        k = int(self.cardinalities.max())
        tab = np.zeros((self.n_params, k), dtype=np.float64)
        for i, ch in enumerate(self.choices):
            tab[i, : len(ch)] = ch
            tab[i, len(ch):] = ch[-1]
        return tab

    # ---------------- encode / decode ----------------
    def encode(self, values: Dict[str, int]) -> np.ndarray:
        """Physical value dict -> index vector. Values must be exact members."""
        idx = np.zeros(self.n_params, dtype=np.int32)
        for i, name in enumerate(self.names):
            ch = self.choices[i]
            v = values[name]
            if v not in ch:
                raise ValueError(f"{name}={v} not in design space choices {ch}")
            idx[i] = ch.index(v)
        return idx

    def encode_nearest(self, values: Dict[str, int]) -> np.ndarray:
        """Like encode but snaps to the nearest choice (for references that
        sit outside the space, e.g. the A100's 40 MB global buffer)."""
        idx = np.zeros(self.n_params, dtype=np.int32)
        for i, name in enumerate(self.names):
            ch = np.asarray(self.choices[i], dtype=np.float64)
            idx[i] = int(np.abs(ch - values[name]).argmin())
        return idx

    def decode(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Index tensor (..., n_params) -> dict of fp32 value tensors on the
        same device: a gather from the padded choice table."""
        vals = self.decode_values(idx)
        return {name: vals[..., i] for i, name in enumerate(self.names)}

    def decode_values(self, idx: torch.Tensor) -> torch.Tensor:
        """(..., n_params) indices -> (..., n_params) fp32 physical values in
        :data:`PARAM_NAMES` order (the ``ppa_eval`` kernel's input)."""
        tab = _choice_table_on(self.choices, str(idx.device))
        return tab[torch.arange(self.n_params, device=idx.device),
                   idx.long()].contiguous()

    def decode_np(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        idx = np.asarray(idx)
        tab = self.choice_table()
        vals = tab[np.arange(self.n_params), idx.astype(np.int64)]
        return {name: vals[..., i] for i, name in enumerate(self.names)}

    # ---------------- sampling / enumeration ----------------
    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Uniform random index vectors, shape (n, n_params)."""
        cards = self.cardinalities
        cols = [rng.integers(0, c, size=n, dtype=np.int32) for c in cards]
        return np.stack(cols, axis=1)

    def flat_to_idx(self, flat: np.ndarray) -> np.ndarray:
        """Mixed-radix unrank: flat id in [0, size) -> index vector(s)."""
        flat = np.asarray(flat, dtype=np.int64)
        out = np.zeros(flat.shape + (self.n_params,), dtype=np.int32)
        rem = flat.copy()
        for i in range(self.n_params - 1, -1, -1):
            c = int(self.cardinalities[i])
            out[..., i] = rem % c
            rem //= c
        return out

    def idx_to_flat(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, dtype=np.int64)
        flat = np.zeros(idx.shape[:-1], dtype=np.int64)
        for i in range(self.n_params):
            flat = flat * int(self.cardinalities[i]) + idx[..., i]
        return flat

    def clip(self, idx: np.ndarray) -> np.ndarray:
        """Clamp index vectors into valid ranges (after mutation steps)."""
        hi = ((self.cardinalities - 1)[None, :] if np.asarray(idx).ndim == 2
              else self.cardinalities - 1)
        return np.clip(idx, 0, hi).astype(np.int32)

    def neighbors(self, idx: np.ndarray) -> np.ndarray:
        """All +-1-step neighbors of one design. Returns (m, n_params)."""
        idx = np.asarray(idx, dtype=np.int32)
        out = []
        for i in range(self.n_params):
            for d in (-1, +1):
                j = idx.copy()
                j[i] += d
                if 0 <= j[i] < self.cardinalities[i]:
                    out.append(j)
        return np.stack(out, axis=0)


SPACE = DesignSpace()
