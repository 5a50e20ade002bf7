"""The LM stack: layers, attention, RWKV6, model assembly (``dense`` and
``ssm`` families) and the parameter converter from the JAX reference."""
from repro_torch.models.transformer import Model, build_model

__all__ = ["Model", "build_model"]
