"""Step factories shared by the server and the prefill benchmark.

The port's counterpart of the step factories in ``repro.launch.steps``
(the abstract input specs and shardings belong to the mesh step and are
not ported yet).  PyTorch runs eagerly, so a step is the model call under
``torch.no_grad``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models.transformer import Model


def make_prefill_step(model: Model) -> Callable[[Dict[str, torch.Tensor]],
                                                torch.Tensor]:
    """The step takes the model's batch as it is: "tokens", or "embeds"
    in their place (vlm), and "frames" beside them (audio)."""
    @torch.no_grad()
    def prefill_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return model.forward(batch)
    return prefill_step


def make_serve_step(model: Model) -> Callable[[Dict, torch.Tensor],
                                              Tuple[torch.Tensor, Dict]]:
    @torch.no_grad()
    def serve_step(cache: Dict, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict]:
        return model.decode_step(cache, tokens)
    return serve_step
