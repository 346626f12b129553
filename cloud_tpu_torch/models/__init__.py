"""Models of the PyTorch port: `TransformerLM` (training forward and
decode), `generate()`, the decode-cache helpers and the JAX parameter
converters."""

from cloud_tpu_torch.models import decoding
from cloud_tpu_torch.models.convert import params_from_flax, params_to_flax
from cloud_tpu_torch.models.transformer import (CausalSelfAttention,
                                                TransformerBlock,
                                                TransformerLM, generate)

__all__ = ["CausalSelfAttention", "TransformerBlock", "TransformerLM",
           "decoding", "generate", "params_from_flax", "params_to_flax"]
