"""The LM stack: layers, attention, Mamba and RWKV6, MoE, model assembly
(``dense``, ``ssm`` and ``hybrid`` families) and the parameter converter
from the JAX reference."""
from repro_torch.models.transformer import Model, build_model

__all__ = ["Model", "build_model"]
