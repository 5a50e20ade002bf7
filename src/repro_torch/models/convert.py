"""Carry a reference parameter pytree into the port's :class:`Model`.

The reference keeps its parameters as a nested dict of arrays with the
layer stack stacked on a leading dim (``params["layers"]["attn"]["q"]["w"]``
is ``(n_layers, d_in, d_out)``).  The port's modules use the same names and
the same ``(d_in, d_out)`` linear layout, one module per layer, so the map
is: flatten with dots, split the layer dim into ``layers.<i>.``, and move
the RWKV layer's flat ``rwkv_<name>`` keys under its ``rwkv`` submodule.
The hybrid family stacks Jamba blocks (``n_layers // attn_every``) on the
leading dim, and inside a block its Mamba sub-layers, MoE FFNs and dense
FFNs on a second dim: those split further into ``layers.<i>.mamba.<j>.``
(and ``moe``, ``mlp``), while ``mamba_ln`` and ``ffn_ln`` stay stacked
within the block.  The audio family's encoder stack ``enc_layers`` splits
into ``enc_layers.<i>.`` as ``layers`` does.  No array is transposed.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import FAMILIES

# sub-layer lists inside a Jamba block, stacked on the block's second dim
_BLOCK_LISTS = ("mamba.", "moe.", "mlp.")
# top-level trees stacked on a leading layer dim
_STACKS = ("layers", "enc_layers")


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)      # exact; load_state_dict casts back
    return torch.from_numpy(np.array(a))     # a writable copy


def params_from_jax(cfg: ArchConfig, tree: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """Reference pytree (numpy or jax arrays) -> the port's state dict, to
    pass to ``Model.load_state_dict`` (which casts to the model's dtype and
    device)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the families are "
                         f"{FAMILIES}")
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in _flatten({k: v for k, v in tree.items()
                               if k not in _STACKS}):
        out[key] = _tensor(leaf)
    hybrid = cfg.family == "hybrid"
    depth = {"layers": (cfg.n_layers // cfg.attn_every if hybrid
                        else cfg.n_layers),
             "enc_layers": cfg.enc_layers}
    for stack in _STACKS if cfg.family == "audio" else ("layers",):
        n = depth[stack]
        for key, leaf in _flatten(tree[stack]):
            stacked = _tensor(leaf)
            if stacked.shape[0] != n:
                what = ("blocks" if hybrid else "n_layers") \
                    if stack == "layers" else "enc_layers"
                raise ValueError(f"{stack}.{key}: leading dim "
                                 f"{stacked.shape[0]} != {what} {n}")
            if key.startswith("rwkv_"):
                key = "rwkv." + key[len("rwkv_"):]
            for i in range(n):
                if hybrid and key.startswith(_BLOCK_LISTS):
                    head, rest = key.split(".", 1)
                    for j, sub in enumerate(stacked[i]):
                        out[f"{stack}.{i}.{head}.{j}.{rest}"] = sub
                else:
                    out[f"{stack}.{i}.{key}"] = stacked[i]
    return out
