"""Carries `cloud_tpu` `TransformerLM` parameters into the port's
`TransformerLM` state dict.

    embed/embedding [V, d]              -> embed.weight
    pos_embed/embedding [L, d]          -> pos_embed.weight
    block_i/ln_attn|ln_mlp/{scale,bias} -> blocks.i.ln_*.{weight,bias}
    block_i/attention/query|key|value/kernel [d, H, hd]
                                        -> ....weight [H*hd, d]
    block_i/attention/*/bias [H, hd]    -> ....bias [H*hd]
    block_i/attention/out/kernel [H, hd, d] -> ....out.weight [d, H*hd]
    block_i/mlp_in|mlp_out/kernel [in, out] -> ....weight [out, in]
    ln_final/{scale,bias}               -> ln_final.{weight,bias}
    lm_head/kernel [d, V] (no bias)     -> lm_head.weight [V, d]
"""

import re

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.array(value, np.float32)


def params_from_flax(params):
    """params: the JAX `TransformerLM` "params" tree (nested dicts of
    arrays, optionally wrapped as {"params": ...}) -> a state dict of
    float32 CPU tensors for the port's `TransformerLM`. Raises on any
    leaf it does not map."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    for path, arr in _flatten(params):
        name = "/".join(path)
        leaf = path[-1]
        if path[0] in ("embed", "pos_embed") and leaf == "embedding":
            state[path[0] + ".weight"] = arr
            continue
        match = re.fullmatch(r"block_(\d+)", path[0])
        module = (("blocks.%s." % match.group(1)) if match else "") \
            + ".".join(path[1 if match else 0:-1])
        if leaf == "scale":
            state[module + ".weight"] = arr
        elif leaf == "bias":
            state[module + ".bias"] = arr.reshape(-1)
        elif leaf != "kernel":
            raise ValueError("unmapped parameter {}".format(name))
        elif path[-2] in ("query", "key", "value"):
            state[module + ".weight"] = arr.reshape(arr.shape[0], -1).T
        elif path[-2] == "out":
            state[module + ".weight"] = arr.reshape(-1, arr.shape[-1]).T
        elif path[-2] in ("mlp_in", "mlp_out", "lm_head"):
            state[module + ".weight"] = arr.T
        else:
            raise ValueError("unmapped parameter {}".format(name))
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in state.items()}


__all__ = ["params_from_flax"]
