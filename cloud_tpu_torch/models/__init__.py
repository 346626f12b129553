"""Models of the PyTorch port: `TransformerLM` and `LlamaLM` (training
forward and decode), their mixture-of-experts MLPs, `generate()`, the
HuggingFace importers, the decode-cache helpers and the JAX parameter
converters."""

from cloud_tpu_torch.models import decoding
from cloud_tpu_torch.models.convert import (llama_params_from_flax,
                                            llama_params_to_flax,
                                            params_from_flax, params_to_flax)
from cloud_tpu_torch.models.hf_import import import_hf_gpt2, import_hf_llama
from cloud_tpu_torch.models.llama import (QWEN3_30B_A3B, TINYLLAMA_1_1B,
                                          GQAttention, LlamaLM, RopeScaling,
                                          apply_rope)
from cloud_tpu_torch.models.moe import MoEMLP, TopKMoEMLP
from cloud_tpu_torch.models.transformer import (CausalSelfAttention,
                                                TransformerBlock,
                                                TransformerLM, generate)

__all__ = ["CausalSelfAttention", "GQAttention", "LlamaLM", "MoEMLP",
           "QWEN3_30B_A3B", "RopeScaling", "TINYLLAMA_1_1B", "TopKMoEMLP",
           "TransformerBlock", "TransformerLM",
           "apply_rope", "decoding", "generate", "import_hf_gpt2",
           "import_hf_llama", "llama_params_from_flax",
           "llama_params_to_flax", "params_from_flax", "params_to_flax"]
