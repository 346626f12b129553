"""Kernels of the PyTorch port, each beside its plain PyTorch version.

`paged_attention` launches the hand-written CUDA kernel on CUDA tensors
and runs `paged_attention_reference` on CPU tensors.
"""

from cloud_tpu_torch.ops.paged_attention import paged_attention
from cloud_tpu_torch.ops.paged_attention import paged_attention_cost
from cloud_tpu_torch.ops.paged_attention import paged_attention_reference

__all__ = ["paged_attention", "paged_attention_cost",
           "paged_attention_reference"]
