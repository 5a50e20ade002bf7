"""Weights and inputs made from the run's seed.

Every random draw of a run comes from a generator seeded by
:func:`stream_seed` (the run's seed and the purpose of the draw), so the
same seed gives the same weights and the same traffic whatever else the run
did.  The weights are one flat buffer filled by one normal draw on the
device, in the type they are served in, cut into views by the
``param_spec`` of the reference the configuration names, and each view
scaled by that reference's ``init_leaf``; the program and the reference
are handed the same dict.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from perfbench import reference


def stream_seed(seed: int, purpose: str) -> int:
    """A 63-bit generator seed for one purpose of a run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  purpose))


@torch.no_grad()
def make_weights(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of the configuration `conf` (its ``model``, in its
    ``dtype``) for `seed` on `device`: views of one buffer drawn in one
    call."""
    ref = reference.of(conf)
    spec = ref.param_spec(conf["model"])
    total = sum(math.prod(shape) for _, shape in spec)
    out = torch.empty(total, dtype=getattr(torch, conf["dtype"]),
                      device=device)
    out.normal_(generator=generator(seed, "weights", device))
    weights, at = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        weights[name] = out[at:at + n].view(shape)
        ref.init_leaf(name, weights[name])
        at += n
    return weights
