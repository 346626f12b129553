"""Carries `cloud_tpu` `TransformerLM` parameters into the port's
`TransformerLM` state dict (`params_from_flax`) and back
(`params_to_flax`, the exact inverse); `llama_params_from_flax` and
`llama_params_to_flax` do the same for `LlamaLM` (mapping below them).

    embed/embedding [V, d]              -> embed.weight
    pos_embed/embedding [L, d]          -> pos_embed.weight
    block_i/ln_attn|ln_mlp/{scale,bias} -> blocks.i.ln_*.{weight,bias}
    block_i/attention/query|key|value/kernel [d, H, hd]
                                        -> ....weight [H*hd, d]
    block_i/attention/*/bias [H, hd]    -> ....bias [H*hd]
    block_i/attention/out/kernel [H, hd, d] -> ....out.weight [d, H*hd]
    block_i/mlp_in|mlp_out/kernel [in, out] -> ....weight [out, in]
    block_i/moe/{router,expert_in,expert_out} -> blocks.i.moe.<same>
                                           (the same layout)
    ln_final/{scale,bias}               -> ln_final.{weight,bias}
    lm_head/kernel [d, V] (no bias)     -> lm_head.weight [V, d]

The image families (`MLP`, `ConvNet`, `ResNet`, `ViT`) keep flax's
module names, so their paths map one to one
(`image_params_from_flax`, `image_params_to_flax`,
`image_param_path`):

    <path>/kernel [in, out] (Dense)       -> <path>.weight [out, in]
    <path>/kernel [kh, kw, in, out] (Conv) -> <path>.weight [out, in, kh, kw]
    block_i/query|key|value/kernel [D, H, hd] -> ....weight [H*hd, D]
    block_i/query|key|value/bias [H, hd]  -> ....bias [H*hd]
    block_i/out/kernel [H, hd, D]         -> ....out.weight [D, H*hd]
    <norm>/scale, <norm>/bias (BatchNorm, LayerNorm) -> .weight, .bias
    batch_stats <bn>/mean, <bn>/var       -> <bn>.running_mean, .running_var
    cls_token [1, 1, D], pos_embed [1, N, D] -> the same names
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


_SWITCH_LEAVES = ("router", "expert_in", "expert_out")
_TOPK_LEAVES = ("router", "expert_gate", "expert_up", "expert_down")


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
        if path[-2] == "moe" and leaf in _SWITCH_LEAVES:
            state[module + "." + leaf] = arr
        elif leaf == "scale":
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


def _jax_path(name, leaf_of):
    """The JAX parameter path of a port parameter `name`, the module
    path mapped as the converters map it (`blocks.i` -> `block_i`) and
    the leaf named by `leaf_of(module, leaf)`."""
    parts = name.split(".")
    if parts[0] in ("embed", "pos_embed") and parts[1:] == ["weight"]:
        return parts[0] + "/embedding"
    if parts[0] == "blocks":
        path = ["block_" + parts[1]] + parts[2:-1]
    else:
        path = parts[:-1]
    jax_leaf = leaf_of(path[-1] if path else "", parts[-1])
    if jax_leaf is None:
        raise ValueError("unmapped parameter {}".format(name))
    return "/".join(path + [jax_leaf])


def _transformer_leaf(module, leaf):
    if module == "moe" and leaf in _SWITCH_LEAVES:
        return leaf
    if module.startswith("ln_"):
        return {"weight": "scale", "bias": "bias"}.get(leaf)
    if module in ("query", "key", "value", "out", "mlp_in", "mlp_out"):
        return {"weight": "kernel", "bias": "bias"}.get(leaf)
    if module == "lm_head" and leaf == "weight":
        return "kernel"
    return None


def transformer_param_path(name):
    """The JAX `TransformerLM` path string of the port's parameter
    `name`, as `trainable=` and sharding rules match it (e.g.
    "blocks.3.attention.query.weight" -> "block_3/attention/query/kernel",
    "lm_head.weight" -> "lm_head/kernel")."""
    return _jax_path(name, _transformer_leaf)


def params_to_flax(state_dict, num_heads):
    """The inverse of `params_from_flax`: a port `TransformerLM` state
    dict (tensors on any device) -> the JAX model's nested "params" dict
    of float32 numpy arrays. `num_heads` restores the [d, H, hd] /
    [H, hd, d] attention kernels. Raises on any key it does not map."""
    params = {}
    for name, tensor in state_dict.items():
        arr = tensor.detach().to("cpu", torch.float32).numpy().copy()
        path = transformer_param_path(name).split("/")
        module, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
        if module in ("query", "key", "value"):
            arr = (arr.T.reshape(arr.shape[1], num_heads, -1)
                   if leaf == "kernel" else arr.reshape(num_heads, -1))
        elif module == "out" and leaf == "kernel":
            arr = arr.T.reshape(num_heads, -1, arr.shape[0])
        elif leaf == "kernel":
            arr = arr.T
        _put(params, path, arr)
    return {k: _contiguous(v) for k, v in params.items()}


def _put(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _contiguous(tree):
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    return np.ascontiguousarray(tree)


# -- LlamaLM ---------------------------------------------------------------
#
#   embed/embedding [V, d]                    -> embed.weight
#   block_i/{norm_attn,norm_mlp,norm_attn_post,norm_mlp_post}/scale
#                                             -> blocks.i.<norm>.weight
#   block_i/attention/{query,key,value}/kernel [d, H(_kv), hd]
#                                             -> ....weight [H(_kv)*hd, d]
#   block_i/attention/{query,key,value}/bias [H(_kv), hd] -> ....bias
#   block_i/attention/{q_norm,k_norm}/scale   -> ....weight [hd]
#   block_i/attention/out/kernel [H, hd, d]   -> ....out.weight [d, H*hd]
#   block_i/mlp/{gate,up,down}/kernel [in, out] -> ....weight [out, in]
#   block_i/moe/{router,expert_gate,expert_up,expert_down}
#                                             -> blocks.i.moe.<same> (the
#                                                same layout)
#   norm_final/scale                          -> norm_final.weight
#   lm_head/kernel [d, V]                     -> lm_head.weight [V, d]

_LLAMA_NORMS = ("norm_attn", "norm_mlp", "norm_attn_post", "norm_mlp_post",
                "q_norm", "k_norm", "norm_final")


def llama_params_from_flax(params):
    """params: the JAX `LlamaLM` "params" tree (optionally wrapped as
    {"params": ...}) -> a state dict of float32 CPU tensors for the
    port's `LlamaLM`. Raises on any leaf it does not map."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    for path, arr in _flatten(params):
        name = "/".join(path)
        match = re.fullmatch(r"block_(\d+)", path[0])
        module = (("blocks.%s." % match.group(1)) if match else "") \
            + ".".join(path[1 if match else 0:-1])
        owner, leaf = path[-2] if len(path) > 1 else "", path[-1]
        if path == ("embed", "embedding"):
            state["embed.weight"] = arr
        elif owner == "moe" and leaf in _TOPK_LEAVES:
            state[module + "." + leaf] = arr
        elif owner in _LLAMA_NORMS and leaf == "scale":
            state[module + ".weight"] = arr
        elif owner in ("query", "key", "value") and leaf == "kernel":
            state[module + ".weight"] = arr.reshape(arr.shape[0], -1).T
        elif owner in ("query", "key", "value") and leaf == "bias":
            state[module + ".bias"] = arr.reshape(-1)
        elif owner == "out" and leaf == "kernel":
            state[module + ".weight"] = arr.reshape(-1, arr.shape[-1]).T
        elif owner in ("gate", "up", "down", "lm_head") and leaf == "kernel":
            state[module + ".weight"] = arr.T
        else:
            raise ValueError("unmapped parameter {}".format(name))
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in state.items()}


def _llama_leaf(module, leaf):
    if module == "moe" and leaf in _TOPK_LEAVES:
        return leaf
    if module in _LLAMA_NORMS and leaf == "weight":
        return "scale"
    if module in ("query", "key", "value"):
        return {"weight": "kernel", "bias": "bias"}.get(leaf)
    if module in ("out", "gate", "up", "down", "lm_head") and \
            leaf == "weight":
        return "kernel"
    return None


def llama_param_path(name):
    """The JAX `LlamaLM` path string of the port's parameter `name`
    (e.g. "blocks.0.mlp.gate.weight" -> "block_0/mlp/gate/kernel")."""
    return _jax_path(name, _llama_leaf)


def llama_params_to_flax(state_dict, num_heads, num_kv_heads=None):
    """The inverse of `llama_params_from_flax`: a port `LlamaLM` state
    dict (tensors on any device) -> the JAX model's nested "params" dict
    of float32 numpy arrays. num_heads / num_kv_heads (default
    num_heads) restore the [d, H(_kv), hd] and [H, hd, d] attention
    kernels. Raises on any key it does not map."""
    num_kv_heads = num_kv_heads or num_heads
    heads = {"query": num_heads, "key": num_kv_heads,
             "value": num_kv_heads}
    params = {}
    for name, tensor in state_dict.items():
        arr = tensor.detach().to("cpu", torch.float32).numpy().copy()
        path = llama_param_path(name).split("/")
        module, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
        if module in heads:
            arr = (arr.T.reshape(arr.shape[1], heads[module], -1)
                   if leaf == "kernel" else
                   arr.reshape(heads[module], -1))
        elif module == "out" and leaf == "kernel":
            arr = arr.T.reshape(num_heads, -1, arr.shape[0])
        elif leaf == "kernel":
            arr = arr.T
        _put(params, path, arr)
    return {k: _contiguous(v) for k, v in params.items()}


def image_params_from_flax(variables):
    """The JAX image model's variables ({"params": ..., "batch_stats":
    ...}, or the params tree alone) -> a state dict of float32 CPU
    tensors (parameters and BatchNorm buffers) for the port's model of
    the same configuration. Raises on any leaf it does not map."""
    if "params" in variables:
        params = variables["params"]
        stats = variables.get("batch_stats", {})
    else:
        params, stats = variables, {}
    state = {}
    for path, arr in _flatten(params):
        leaf = path[-1]
        module = ".".join(path[:-1])
        prefix = module + "." if module else ""
        if path in (("cls_token",), ("pos_embed",)):
            state[leaf] = arr
        elif leaf == "scale":
            state[prefix + "weight"] = arr
        elif leaf == "bias":
            state[prefix + "bias"] = arr.reshape(-1)
        elif leaf != "kernel":
            raise ValueError("unmapped parameter {}".format("/".join(path)))
        elif arr.ndim == 2:
            state[prefix + "weight"] = arr.T
        elif arr.ndim == 4:
            state[prefix + "weight"] = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 3 and path[-2] == "out":
            state[prefix + "weight"] = arr.reshape(-1, arr.shape[-1]).T
        elif arr.ndim == 3:
            state[prefix + "weight"] = arr.reshape(arr.shape[0], -1).T
        else:
            raise ValueError("unmapped parameter {}".format("/".join(path)))
    for path, arr in _flatten(stats):
        buffer = {"mean": "running_mean", "var": "running_var"}.get(path[-1])
        if buffer is None:
            raise ValueError("unmapped batch stat {}".format("/".join(path)))
        state[".".join(path[:-1] + (buffer,))] = arr
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in state.items()}


def _image_leaves(model):
    """(port name, JAX path, kind) of every parameter and BatchNorm
    buffer of an image model; kind says how the array is laid out."""
    from cloud_tpu_torch.models import _layers
    from cloud_tpu_torch.models.vit import EncoderBlock

    rows = []
    for mname, module in model.named_modules():
        path = mname.split(".") if mname else []
        prefix = mname + "." if mname else ""
        parent = model.get_submodule(".".join(path[:-1])) if path else None
        if isinstance(module, torch.nn.Conv2d):
            kind, leaf = "conv", "kernel"
        elif isinstance(module, torch.nn.Linear):
            kind, leaf = "dense", "kernel"
            if isinstance(parent, EncoderBlock) and path[-1] in (
                    "query", "key", "value"):
                kind = "heads_in"
            elif isinstance(parent, EncoderBlock) and path[-1] == "out":
                kind = "heads_out"
        elif isinstance(module, (torch.nn.LayerNorm, _layers.BatchNorm)):
            kind, leaf = "plain", "scale"
        else:
            continue
        rows.append((prefix + "weight", path + [leaf], kind))
        if getattr(module, "bias", None) is not None:
            rows.append((prefix + "bias", path + ["bias"],
                         "heads_bias" if kind == "heads_in" else "plain"))
        if isinstance(module, _layers.BatchNorm):
            rows.append((prefix + "running_mean", path + ["mean"], "stat"))
            rows.append((prefix + "running_var", path + ["var"], "stat"))
    for name in ("cls_token", "pos_embed"):
        if name in dict(model.named_parameters(recurse=False)):
            rows.append((name, [name], "plain"))
    return rows


def image_param_path(model, name):
    """The JAX path string of the image model's parameter `name` (e.g.
    "BottleneckBlock_3.Conv_1.weight" ->
    "BottleneckBlock_3/Conv_1/kernel"), as `trainable=` matches it."""
    for port, path, _ in _image_leaves(model):
        if port == name:
            return "/".join(path)
    raise ValueError("unmapped parameter {}".format(name))


def image_params_to_flax(model):
    """The inverse of `image_params_from_flax` for a port image model:
    {"params": nested float32 numpy arrays} plus "batch_stats" when the
    model has BatchNorm."""
    state = model.state_dict()
    heads = getattr(model, "num_heads", None)
    tree = {"params": {}, "batch_stats": {}}
    for port, path, kind in _image_leaves(model):
        arr = state[port].detach().to("cpu", torch.float32).numpy().copy()
        if kind == "conv":
            arr = arr.transpose(2, 3, 1, 0)
        elif kind == "dense":
            arr = arr.T
        elif kind == "heads_in":
            arr = arr.T.reshape(arr.shape[1], heads, -1)
        elif kind == "heads_out":
            arr = arr.T.reshape(heads, -1, arr.shape[0])
        elif kind == "heads_bias":
            arr = arr.reshape(heads, -1)
        _put(tree["batch_stats" if kind == "stat" else "params"], path, arr)
    if not tree["batch_stats"]:
        del tree["batch_stats"]
    return {k: _contiguous(v) for k, v in tree.items()}


__all__ = ["image_param_path", "image_params_from_flax",
           "image_params_to_flax", "llama_param_path",
           "llama_params_from_flax", "llama_params_to_flax",
           "params_from_flax", "params_to_flax", "transformer_param_path"]
