"""What the harness takes from the program: its model built on the meta
device and given the benchmark's weights, and its step factories."""
from __future__ import annotations

import torch


def arch_config(model: dict):
    """The port's ArchConfig for a configuration's ``model`` dict."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**model)


def build(conf: dict, weights: dict, device: torch.device):
    """The port's Model of the configuration, its parameters the given
    weights (assigned, not copied); names and shapes must match."""
    from repro_torch.models import build_model
    model = build_model(arch_config(conf["model"]),
                        dtype=getattr(torch, conf["dtype"]), device="meta",
                        moe_capacity=conf.get("moe_capacity", 1.25),
                        remat=conf.get("remat", True))
    model.load_state_dict(weights, strict=True, assign=True)
    model.device = device
    return model
