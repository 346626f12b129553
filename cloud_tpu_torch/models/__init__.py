"""Models of the PyTorch port: `TransformerLM` in decode mode,
`generate()`, the decode-cache helpers and the JAX parameter
converter."""

from cloud_tpu_torch.models import decoding
from cloud_tpu_torch.models.convert import params_from_flax
from cloud_tpu_torch.models.transformer import (CausalSelfAttention,
                                                TransformerBlock,
                                                TransformerLM, generate)

__all__ = ["CausalSelfAttention", "TransformerBlock", "TransformerLM",
           "decoding", "generate", "params_from_flax"]
