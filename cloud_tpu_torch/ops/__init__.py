"""Kernels of the PyTorch port, each beside its plain PyTorch version.

`paged_attention` (also under the JAX package's name,
`paged_decode_attention`) launches the hand-written CUDA kernel on CUDA
tensors and runs `paged_attention_reference` on CPU tensors;
`flash_attention`
(and the dispatcher `ops.attention.attention`) launch the flash kernels
(forward, dq, dk/dv) on CUDA tensors and run `mha_reference` on CPU
tensors; `fused_rmsnorm` launches the fused residual-add + RMSNorm
kernel (or runs `rmsnorm_residual_reference`), and `fused_swiglu` the
two gated-MLP kernels (or runs `swiglu_reference`). `lm_head_loss` is
the chunked LM-head cross-entropy (no kernel: chunked matrix products,
beside `lm_head_loss_reference`, which materialises the logits).
`ops.attention`
stays the module: its dispatcher is not re-exported here under the
module's own name.
"""

from cloud_tpu_torch.ops.attention import flash_attention
from cloud_tpu_torch.ops.attention import flash_attention_cost
from cloud_tpu_torch.ops.attention import mha_reference
from cloud_tpu_torch.ops.fused_ce import lm_head_loss
from cloud_tpu_torch.ops.fused_ce import lm_head_loss_reference
from cloud_tpu_torch.ops.fused_mlp import fused_mlp_cost
from cloud_tpu_torch.ops.fused_mlp import fused_swiglu
from cloud_tpu_torch.ops.fused_mlp import swiglu_reference
from cloud_tpu_torch.ops.fused_norm import fused_norm_cost
from cloud_tpu_torch.ops.fused_norm import fused_rmsnorm
from cloud_tpu_torch.ops.fused_norm import rmsnorm_residual_reference
from cloud_tpu_torch.ops.paged_attention import paged_attention
from cloud_tpu_torch.ops.paged_attention import paged_attention_cost
from cloud_tpu_torch.ops.paged_attention import paged_attention_reference
from cloud_tpu_torch.ops.paged_attention import paged_decode_attention

__all__ = ["attention", "flash_attention", "flash_attention_cost",
           "fused_mlp_cost", "fused_norm_cost", "fused_rmsnorm", "fused_swiglu",
           "lm_head_loss", "lm_head_loss_reference", "mha_reference",
           "paged_attention", "paged_attention_cost",
           "paged_attention_reference", "paged_decode_attention",
           "rmsnorm_residual_reference", "swiglu_reference"]
