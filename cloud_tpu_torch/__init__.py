"""cloud_tpu_torch: the PyTorch/CUDA port of `cloud_tpu`.

Same module paths and public names as the JAX package, written in
PyTorch for an NVIDIA H100. This package imports torch, numpy and the
standard library only; its kernels are CUDA C++ sources under
`ops/csrc/`, compiled with nvcc at first use. Entry points run on the
CUDA card unless the caller passes `device="cpu"`, where each kernel's
plain PyTorch version runs instead.

Ported so far: paged decode attention (fp and int8 pages), flash
attention (forward and backward), the fused residual-add + RMSNorm and
the fused SwiGLU MLP; `TransformerLM` and `LlamaLM` (training forward
and decode), `generate()`, the HuggingFace importers, the image
families (`MLP`, `ConvNet`, `ResNet`, `ViT`), the plain serving path
(`Scheduler` -> `DecodeEngine`) and the single-device `Trainer` (fit /
evaluate / predict over arrays, streams or a device-resident dataset;
every optimizer, input casts, steps_per_execution, remat, warm starts,
callbacks, checkpoints and the resilient fit).
"""

from cloud_tpu_torch import models, ops, serving, training
from cloud_tpu_torch.models import (LlamaLM, TransformerLM, generate,
                                    llama_params_from_flax,
                                    llama_params_to_flax, params_from_flax,
                                    params_to_flax)
from cloud_tpu_torch.serving import (DecodeEngine, Scheduler, ServeRequest,
                                     ServeResult)
from cloud_tpu_torch.training import Trainer

__all__ = ["DecodeEngine", "LlamaLM", "Scheduler", "ServeRequest",
           "ServeResult", "Trainer", "TransformerLM", "generate",
           "llama_params_from_flax", "llama_params_to_flax", "models", "ops",
           "params_from_flax", "params_to_flax", "serving", "training"]
