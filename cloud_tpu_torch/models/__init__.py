"""Models of the PyTorch port: `TransformerLM` and `LlamaLM` (training
forward and decode), their mixture-of-experts MLPs, `generate()`, the
HuggingFace importers, the decode-cache helpers, the image families
(`MLP`, `ConvNet`, `ResNet`, `ViT`) and the JAX parameter
converters."""

from cloud_tpu_torch.models import decoding
from cloud_tpu_torch.models.convert import (image_params_from_flax,
                                            image_params_to_flax,
                                            llama_params_from_flax,
                                            llama_params_to_flax,
                                            params_from_flax, params_to_flax)
from cloud_tpu_torch.models.hf_import import import_hf_gpt2, import_hf_llama
from cloud_tpu_torch.models.llama import (QWEN3_30B_A3B, TINYLLAMA_1_1B,
                                          GQAttention, LlamaLM, RopeScaling,
                                          apply_rope)
from cloud_tpu_torch.models.mnist import MLP, ConvNet
from cloud_tpu_torch.models.moe import MoEMLP, TopKMoEMLP
from cloud_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet34,
                                           ResNet50, ResNet101, ResNet152)
from cloud_tpu_torch.models.transformer import (CausalSelfAttention,
                                                TransformerBlock,
                                                TransformerLM, generate)
from cloud_tpu_torch.models.vit import ViT, ViT_B16, ViT_L16, ViT_S16

__all__ = ["CausalSelfAttention", "ConvNet", "GQAttention", "LlamaLM",
           "MLP", "MoEMLP", "QWEN3_30B_A3B", "ResNet", "ResNet101",
           "ResNet152", "ResNet18", "ResNet34", "ResNet50", "RopeScaling",
           "TINYLLAMA_1_1B", "TopKMoEMLP", "TransformerBlock",
           "TransformerLM", "ViT", "ViT_B16", "ViT_L16", "ViT_S16",
           "apply_rope", "decoding", "generate", "image_params_from_flax",
           "image_params_to_flax", "import_hf_gpt2",
           "import_hf_llama", "llama_params_from_flax",
           "llama_params_to_flax", "params_from_flax", "params_to_flax"]
