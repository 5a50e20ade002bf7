"""Step factories shared by the trainer, the server and the prefill
benchmark.

The port's counterpart of the step factories in ``repro.launch.steps``
(the abstract input specs and shardings belong to the mesh step and are
not ported yet).  PyTorch runs eagerly, so a prefill or serve step is the
model call under ``torch.no_grad``, and a train step is the loss, its
backward and an in-place AdamW update.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, adamw_update


def loss_and_grads(model: Model, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The model's loss on `batch` (detached) and each parameter's
    gradient by name (zeros where the loss did not reach it, as
    ``jax.grad`` gives).  The parameters must require grad."""
    model.zero_grad(set_to_none=True)
    loss = model.loss(batch)
    loss.backward()
    return loss.detach(), {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()}


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    grad_fn: Optional[Callable[[Dict[str, torch.Tensor]],
                                               Dict[str, torch.Tensor]]]
                    = None
                    ) -> Callable[[dict, Dict[str, torch.Tensor]],
                                  Tuple[dict, dict]]:
    """train_step(opt_state, batch) -> (opt_state, {"loss", "grad_norm",
    "lr"}): the loss and its gradients, `grad_fn` on them where given
    (the trainer's int8 compression), then one AdamW step that writes
    the model's parameters in place.  Turns on the parameters' gradients
    (the model is built without them); they are freed after the update."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())

    def train_step(opt_state: dict, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[dict, dict]:
        loss, grads = loss_and_grads(model, batch)
        if grad_fn is not None:
            grads = grad_fn(grads)
        opt_state, metrics = adamw_update(opt_cfg, grads, opt_state, params)
        model.zero_grad(set_to_none=True)
        return opt_state, {"loss": loss, **metrics}
    return train_step


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
