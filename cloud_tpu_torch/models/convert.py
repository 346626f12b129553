"""Carries `cloud_tpu` `TransformerLM` parameters into the port's
`TransformerLM` state dict (`params_from_flax`) and back
(`params_to_flax`, the exact inverse).

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


def params_to_flax(state_dict, num_heads):
    """The inverse of `params_from_flax`: a port `TransformerLM` state
    dict (tensors on any device) -> the JAX model's nested "params" dict
    of float32 numpy arrays. `num_heads` restores the [d, H, hd] /
    [H, hd, d] attention kernels. Raises on any key it does not map."""
    params = {}

    def put(path, value):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for name, tensor in state_dict.items():
        arr = tensor.detach().to("cpu", torch.float32).numpy().copy()
        parts = name.split(".")
        if parts[0] in ("embed", "pos_embed") and parts[1:] == ["weight"]:
            put((parts[0], "embedding"), arr)
            continue
        if parts[0] == "blocks":
            path = ("block_" + parts[1],) + tuple(parts[2:-1])
        else:
            path = tuple(parts[:-1])
        leaf = parts[-1]
        module = path[-1]
        if module.startswith("ln_"):
            put(path + ({"weight": "scale", "bias": "bias"}[leaf],), arr)
        elif module in ("query", "key", "value"):
            if leaf == "weight":
                put(path + ("kernel",),
                    arr.T.reshape(arr.shape[1], num_heads, -1))
            else:
                put(path + ("bias",), arr.reshape(num_heads, -1))
        elif module == "out" and leaf == "weight":
            put(path + ("kernel",), arr.T.reshape(num_heads, -1,
                                                  arr.shape[0]))
        elif module in ("out", "mlp_in", "mlp_out") and leaf == "bias":
            put(path + ("bias",), arr)
        elif module in ("mlp_in", "mlp_out", "lm_head") and leaf == "weight":
            put(path + ("kernel",), arr.T)
        else:
            raise ValueError("unmapped parameter {}".format(name))
    return {k: _contiguous(v) for k, v in params.items()}


def _contiguous(tree):
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    return np.ascontiguousarray(tree)


__all__ = ["params_from_flax", "params_to_flax"]
