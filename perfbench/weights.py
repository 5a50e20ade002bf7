"""Weights and inputs made from the run's seed.

Every random draw of a run comes from a generator seeded by
:func:`stream_seed` (the run's seed and the purpose of the draw), so the
same seed gives the same weights and the same traffic whatever else the run
did.  The weights are one flat buffer filled by one normal draw on the
device, in the type they are served in, and cut into views by the
reference's :func:`~perfbench.reference.lm.param_spec`; the program and the
reference are handed the same dict.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from perfbench.reference.lm import param_spec


def stream_seed(seed: int, purpose: str) -> int:
    """A 63-bit generator seed for one purpose of a run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  purpose))


def _init_leaf(name: str, t: torch.Tensor) -> None:
    """Scale a unit normal leaf in place to its role: norm gains 1 +/- 0.1,
    biases 0.1, the embedding 1, a matrix 1 / sqrt(fan in), so that every
    layer's output and the logits stay of order one."""
    if name.endswith(("ln1", "ln2", "final_norm")):
        t.mul_(0.1).add_(1.0)
    elif name.endswith(".b"):
        t.mul_(0.1)
    elif name != "embed":
        t.mul_(1.0 / math.sqrt(t.shape[-2]))


@torch.no_grad()
def make_weights(model: dict, seed: int, device, dtype=torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """The model's weights for `seed` on `device`: views of one buffer
    drawn in one call."""
    spec = param_spec(model)
    total = sum(math.prod(shape) for _, shape in spec)
    out = torch.empty(total, dtype=dtype, device=device)
    out.normal_(generator=generator(seed, "weights", device))
    weights, at = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        weights[name] = out[at:at + n].view(shape)
        _init_leaf(name, weights[name])
        at += n
    return weights
