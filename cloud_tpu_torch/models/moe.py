"""Mixture-of-experts MLPs; the port of `cloud_tpu/models/moe.py`.

`TopKMoEMLP` is the Mixtral / Qwen3-MoE layer (top-k routing over
SwiGLU experts), `MoEMLP` the Switch top-1 layer over GELU experts, and
`routed_expert_ffn` the expert computation they share. Parameters keep
the JAX layout and names: `router` [d, E] f32, `expert_gate` /
`expert_up` [E, d, f] and `expert_down` [E, f, d] (`expert_in` /
`expert_out` in `MoEMLP`). Each forward returns `(out, aux_loss)`.

The semantics are JAX's:

- Router logits are `x.float() @ router` in f32, then a softmax in f32.
  Top-k breaks ties toward the lower expert index, as `jax.lax.top_k`
  does (a stable descending sort; `torch.topk` does not promise it), and
  Switch's argmax takes the first maximum. With `norm_topk` the k gates
  are renormalised to sum to 1; without it they are the raw softmax
  mass.
- Capacity per expert: `int(factor * T * k / E)` (at least 1) for top-k,
  `int(factor * T / E)` for Switch, T (no drops) when the factor is
  None. Queue positions are slot-major: every token's first choice
  claims a position before any token's second choice, and within a slot
  tokens go in order t = b * S + s. A route at or past capacity is
  dropped and contributes zero. Every token of the call is routed,
  padding included.
- Experts run in the compute dtype: g = x W_g, u = x W_u, act(g) * u,
  then W_d (GELU, tanh-approximate, then W_out for Switch); weights are
  cast from f32 per call. The combine weights are rounded to the compute
  dtype, the weighted outputs summed in f32 and rounded once.
- The aux loss: E * sum_e (routes to e summed over the k slots, mean
  over tokens) * (mean router probability of e), so a uniform router
  scores k; Switch's E * sum(fraction routed * fraction of probability).

How it is computed here differs from JAX's dense one-hot dispatch and
combine einsums, which build [T, E, C] tensors (at T 4096, E 128, C T
that is 2.1 G elements a layer, and the dispatch product alone about 14
times the expert work). The slot-major route list [k T] is stable-sorted
by expert, which is JAX's queue order; each route's rank within its
expert's group is its position, and the routes below capacity are kept
(a second stable sort puts them first, still grouped by expert). The
kept rows are gathered, each non-empty expert runs its products on its
contiguous group (`torch.mm`, one call per product, in one
`autograd.Function` whose backward writes each expert's weight
gradients into one tensor per weight), and each kept route's gated
output is written to its own row of a [k T, d] f32 buffer
that is summed over the k slots: a fixed order, so the result does not
depend on the run. The group sizes are the one device-to-host read of a
layer's forward. The plain one-hot versions, line-by-line mirrors of
the JAX einsums, are kept as `routed_expert_ffn_reference` and
`switch_expert_ffn_reference` for the tests. There is no Pallas kernel
here, so there is no CUDA kernel either.

Router noise (`MoEMLP.router_noise`) draws from the caller's
`torch.Generator` (the Trainer's step generator), not from JAX's
threefry; it exists only in a training forward.

Not ported: `expert_parallel_rules` (JAX `PartitionSpec`s), which waits
for the parallel axes (ROADMAP: Modules to port, item 6).
"""

import torch
import torch.nn.functional as F
from torch import nn

from cloud_tpu_torch.ops import fused_mlp as mlp_ops


def capacity_of(capacity_factor, tokens, top_k, num_experts):
    """Queue slots per expert: `int(factor * T * k / E)`, at least 1, or
    T when the factor is None (no route is dropped)."""
    if capacity_factor is None:
        return tokens
    return max(1, int(capacity_factor * tokens * top_k / num_experts))


def top_k_lower_index(probs, k):
    """(values, indices) of the k largest entries along the last axis,
    ties broken toward the lower index (`jax.lax.top_k`)."""
    values, indices = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


def topk_route(logits, top_k, norm_topk=True):
    """Router logits [T, E] (f32) -> (probs [T, E], top_idx [T, k], gates
    [T, k]) as `TopKMoEMLP` routes."""
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_idx = top_k_lower_index(probs, top_k)
    if norm_topk:
        gates = top_probs / top_probs.sum(dim=-1, keepdim=True)
    else:  # Qwen3-MoE norm_topk_prob=False: the raw softmax mass
        gates = top_probs
    return probs, top_idx, gates


def topk_aux_loss(probs, top_idx):
    """E * sum_e (routes to e over the k slots, mean over tokens) *
    mean_t probs[t, e]: HF Mixtral's load-balancing scale."""
    tokens, num_experts = probs.shape
    counts = torch.bincount(top_idx.reshape(-1), minlength=num_experts)
    return num_experts * torch.sum(counts.float() / tokens
                                   * probs.mean(dim=0))


def dispatch_plan(top_idx, num_experts, capacity):
    """The kept routes of [T, k] expert choices, grouped by expert.

    Routes are numbered slot-major, r = slot * T + t; an expert's queue is
    its routes in increasing r. Returns (kept [N] route numbers, experts
    in order and each expert's routes in queue order; sizes: a Python
    list of the kept routes per expert). Reads the sizes from the device
    once."""
    tokens, k = top_idx.shape
    flat = top_idx.t().reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=num_experts)
    if capacity < tokens * k:
        starts = torch.cumsum(counts, 0) - counts
        grouped = flat[order]
        rank = (torch.arange(flat.numel(), device=flat.device)
                - starts[grouped])
        # Kept routes first, still grouped by expert in queue order.
        key = grouped + (rank >= capacity).long() * num_experts
        order = order[torch.sort(key, stable=True).indices]
        counts = torch.clamp(counts, max=capacity)
    sizes = counts.tolist()
    return order[:sum(sizes)], sizes


def expert_load(top_idx, num_experts, capacity):
    """Routing statistics of one call: routes per expert (before
    capacity, a Python list) and the share of routes dropped."""
    counts = torch.bincount(top_idx.reshape(-1),
                            minlength=num_experts).tolist()
    total = top_idx.numel()
    kept = sum(min(c, capacity) for c in counts)
    return {"routes_per_expert": counts,
            "dropped_share": (total - kept) / total if total else 0.0}


class _GroupedExperts(torch.autograd.Function):
    """The experts' products over rows grouped by expert (`sizes`, in
    expert order), one `torch.mm` per product of each non-empty group:
    y_e = (act(x_e W_in[e]) * (x_e W_up[e])) W_out[e], or act(x_e
    W_in[e]) W_out[e] without W_up (Switch), every product and the
    elementwise steps in the weights' dtype. The backward is autograd's
    for those operations, expert by expert, writing each expert's weight
    gradients into one zeroed [E, ., .] tensor per weight: autograd
    through per-expert slices of the weights would build and add a
    full-size gradient for every slice."""

    @staticmethod
    def forward(ctx, rows, w_in, w_up, w_out, sizes, activation):
        act = mlp_ops._activation(activation)
        outs, saved, start = [], [], 0
        for e, n in enumerate(sizes):
            if not n:
                continue
            part = rows[start:start + n]
            start += n
            g = torch.mm(part, w_in[e])
            u = None if w_up is None else torch.mm(part, w_up[e])
            h = act(g) if u is None else act(g) * u
            outs.append(torch.mm(h, w_out[e]))
            saved.append((g, u))
        ctx.save_for_backward(rows, w_in, w_up, w_out)
        ctx.sizes, ctx.saved, ctx.activation = sizes, saved, activation
        if not outs:
            return rows.new_zeros((0, w_out.shape[-1]))
        return torch.cat(outs)

    @staticmethod
    def backward(ctx, dy):
        rows, w_in, w_up, w_out = ctx.saved_tensors
        act = mlp_ops._activation(ctx.activation)
        d_rows = torch.empty_like(rows)
        d_in, d_out = torch.zeros_like(w_in), torch.zeros_like(w_out)
        d_up = None if w_up is None else torch.zeros_like(w_up)
        saved, start = iter(ctx.saved), 0
        for e, n in enumerate(ctx.sizes):
            if not n:
                continue
            part, dye = rows[start:start + n], dy[start:start + n]
            g, u = next(saved)
            with torch.enable_grad():
                gl = g.detach().requires_grad_(True)
                a = act(gl)
            h = a.detach() if u is None else a.detach() * u
            torch.mm(h.t(), dye, out=d_out[e])
            dh = torch.mm(dye, w_out[e].t())
            dg, = torch.autograd.grad(a, gl, dh if u is None else dh * u)
            torch.mm(part.t(), dg, out=d_in[e])
            dx = torch.mm(dg, w_in[e].t())
            if u is not None:
                du = dh * a.detach()
                torch.mm(part.t(), du, out=d_up[e])
                dx = dx + torch.mm(du, w_up[e].t())
            d_rows[start:start + n] = dx
            start += n
        ctx.saved = None
        return d_rows, d_in, d_up, d_out, None, None


def _combine(x2d, top_idx, gates, capacity, w_in, w_up, w_out, activation,
             compute_dtype):
    """Gather the kept routes' rows, run the experts (`_GroupedExperts`,
    weights [E, ., .] in the compute dtype) on each non-empty expert's
    group, and sum the gated outputs per token in f32 (gates rounded to
    the compute dtype); returns [T, d] in the compute dtype."""
    tokens, d_model = x2d.shape
    k = top_idx.shape[1]
    kept, sizes = dispatch_plan(top_idx, w_in.shape[0], capacity)
    rows = x2d.to(compute_dtype)[kept % tokens]
    y = _GroupedExperts.apply(rows, w_in, w_up, w_out, sizes, activation)
    gate = gates.t().reshape(-1)[kept].to(compute_dtype).float()
    weighted = y.float() * gate[:, None]
    buf = torch.zeros((k * tokens, d_model), dtype=torch.float32,
                      device=x2d.device).index_copy(0, kept, weighted)
    return buf.view(k, tokens, d_model).sum(dim=0).to(compute_dtype)


def routed_expert_ffn(x2d, top_idx, gates, w_gate, w_up, w_down, capacity,
                      activation="silu", compute_dtype=torch.bfloat16):
    """Top-k SwiGLU expert computation by sorted dispatch (module doc).

    x2d: [T, d] tokens; top_idx / gates: [T, k] chosen experts and their
    combine weights; w_gate / w_up [E, d, f] and w_down [E, f, d] (cast to
    `compute_dtype` here). Returns [T, d] in compute_dtype."""
    mlp_ops._activation(activation)
    return _combine(x2d, top_idx, gates, capacity,
                    *(w.to(compute_dtype) for w in (w_gate, w_up, w_down)),
                    activation, compute_dtype)


def _one_hot_plan(top_idx, num_experts, capacity):
    """JAX's dispatch: per slot-major route its [E, C] one-hot slot,
    zero where dropped; [k, T, E, C] f32."""
    tokens, k = top_idx.shape
    sel = F.one_hot(top_idx, num_experts).float()            # [T, k, E]
    sel_sm = sel.permute(1, 0, 2).reshape(k * tokens, num_experts)
    position = (torch.cumsum(sel_sm, dim=0) - 1.0) * sel_sm
    keep = (position < capacity).float() * sel_sm
    slot = torch.sum(position * keep, dim=-1).long()
    slot_oh = F.one_hot(slot, capacity).float()
    return (keep[:, :, None] * slot_oh[:, None, :]).reshape(
        k, tokens, num_experts, capacity)


def routed_expert_ffn_reference(x2d, top_idx, gates, w_gate, w_up, w_down,
                                capacity, activation="silu",
                                compute_dtype=torch.bfloat16):
    """The plain version of `routed_expert_ffn`: the JAX function's dense
    one-hot [T, E, C] dispatch and combine einsums, line by line (for
    tests at small sizes)."""
    act = mlp_ops._activation(activation)
    tokens, _ = x2d.shape
    k = top_idx.shape[1]
    num_experts = w_gate.shape[0]
    disp = _one_hot_plan(top_idx, num_experts, capacity)
    dispatch = disp.sum(dim=0)                                # [T, E, C]
    gates_sm = gates.t().reshape(k, tokens)
    combine = (disp * gates_sm[:, :, None, None].float()).sum(dim=0)
    xf = x2d.to(compute_dtype)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(compute_dtype), xf)
    g = torch.einsum("ecd,edf->ecf", expert_in, w_gate.to(compute_dtype))
    u = torch.einsum("ecd,edf->ecf", expert_in, w_up.to(compute_dtype))
    expert_out = torch.einsum("ecf,efd->ecd", act(g) * u,
                              w_down.to(compute_dtype))
    return torch.einsum("tec,ecd->td", combine.to(compute_dtype),
                        expert_out)


def switch_expert_ffn(x2d, expert_index, expert_gate, w_in, w_out, capacity,
                      compute_dtype=torch.bfloat16):
    """`MoEMLP`'s experts by sorted dispatch: top-1 routes in token order,
    GELU (tanh) experts, w_in [E, d, f] and w_out [E, f, d] cast to
    `compute_dtype`. Returns [T, d] in compute_dtype."""
    return _combine(x2d, expert_index[:, None], expert_gate[:, None],
                    capacity, w_in.to(compute_dtype), None,
                    w_out.to(compute_dtype), "gelu_tanh", compute_dtype)


def switch_expert_ffn_reference(x2d, expert_index, expert_gate, w_in, w_out,
                                capacity, compute_dtype=torch.bfloat16):
    """The plain version of `switch_expert_ffn`: the JAX `MoEMLP`'s dense
    dispatch and combine einsums, line by line."""
    num_experts = w_in.shape[0]
    one_hot = F.one_hot(expert_index, num_experts).float()    # [T, E]
    position_in_expert = (torch.cumsum(one_hot, dim=0) - 1.0) * one_hot
    keep = (position_in_expert < capacity).float() * one_hot
    position = torch.sum(position_in_expert * keep, dim=-1).long()
    position_oh = F.one_hot(position, capacity).float()       # [T, C]
    dispatch = keep[:, :, None] * position_oh[:, None, :]     # [T, E, C]
    combine = dispatch * expert_gate[:, None, None]
    xf = x2d.to(compute_dtype)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(compute_dtype), xf)
    h = torch.einsum("ecd,edf->ecf", expert_in, w_in.to(compute_dtype))
    h = F.gelu(h, approximate="tanh")
    expert_out = torch.einsum("ecf,efd->ecd", h, w_out.to(compute_dtype))
    return torch.einsum("tec,ecd->td", combine.to(compute_dtype),
                        expert_out)


class TopKMoEMLP(nn.Module):
    """Mixtral-style top-k routed MoE with SwiGLU experts stacked on a
    leading [num_experts] axis (the module doc has the semantics).

    `capacity_factor=None` is drop-free (capacity T): HF's inference
    semantics. `cast` (optional): the owning model's weight cast to the
    compute dtype (`_ComputeWeights`, which keeps the copies between
    calls without grad, as in decode). Called on [B, S, d], returns
    ([B, S, d] in x's dtype, the f32 aux loss)."""

    def __init__(self, d_model, num_experts=8, top_k=2, d_ff=2048,
                 capacity_factor=2.0, compute_dtype=torch.bfloat16,
                 activation="silu", norm_topk=True, cast=None,
                 device=None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError("top_k={} must be in [1, num_experts={}]."
                             .format(top_k, num_experts))
        mlp_ops._activation(activation)
        self.num_experts = num_experts
        self.top_k = top_k
        self.d_ff = d_ff
        self.capacity_factor = capacity_factor
        self.compute_dtype = compute_dtype
        self.activation = activation
        self.norm_topk = norm_topk
        self._cast = cast or (lambda w: w.to(compute_dtype))
        empty = dict(dtype=torch.float32, device=device)
        self.router = nn.Parameter(torch.empty((d_model, num_experts),
                                               **empty))
        self.expert_gate = nn.Parameter(
            torch.empty((num_experts, d_model, d_ff), **empty))
        self.expert_up = nn.Parameter(
            torch.empty((num_experts, d_model, d_ff), **empty))
        self.expert_down = nn.Parameter(
            torch.empty((num_experts, d_ff, d_model), **empty))

    def capacity(self, tokens):
        return capacity_of(self.capacity_factor, tokens, self.top_k,
                           self.num_experts)

    def route(self, x):
        """x [B, S, d] -> (probs [T, E], top_idx [T, k], gates [T, k])."""
        logits = x.float().reshape(-1, x.shape[-1]) @ self.router
        return topk_route(logits, self.top_k, self.norm_topk)

    def forward(self, x):
        batch, seq, d_model = x.shape
        tokens = batch * seq
        probs, top_idx, gates = self.route(x)
        aux_loss = topk_aux_loss(probs, top_idx)
        out = routed_expert_ffn(
            x.reshape(tokens, d_model), top_idx, gates,
            *(self._cast(w) for w in (self.expert_gate, self.expert_up,
                                      self.expert_down)),
            self.capacity(tokens), self.activation, self.compute_dtype)
        return out.reshape(batch, seq, d_model).to(x.dtype), aux_loss


class MoEMLP(nn.Module):
    """Switch-routing (top-1) MoE over GELU experts, a drop-in for a dense
    MLP (the module doc has the semantics). `router_noise` > 0 adds
    noise of that std to the logits in a training forward, drawn from the
    forward's `generator`. `cast` as `TopKMoEMLP`'s. Called on [B, S, d],
    returns ([B, S, d] in x's dtype, the f32 aux loss)."""

    def __init__(self, d_model, num_experts=8, d_ff=2048,
                 capacity_factor=1.25, compute_dtype=torch.bfloat16,
                 router_noise=0.0, cast=None, device=None):
        super().__init__()
        self.num_experts = num_experts
        self.d_ff = d_ff
        self.capacity_factor = capacity_factor
        self.compute_dtype = compute_dtype
        self.router_noise = float(router_noise)
        self._cast = cast or (lambda w: w.to(compute_dtype))
        empty = dict(dtype=torch.float32, device=device)
        self.router = nn.Parameter(torch.empty((d_model, num_experts),
                                               **empty))
        self.expert_in = nn.Parameter(
            torch.empty((num_experts, d_model, d_ff), **empty))
        self.expert_out = nn.Parameter(
            torch.empty((num_experts, d_ff, d_model), **empty))

    def capacity(self, tokens):
        return max(1, int(self.capacity_factor * tokens / self.num_experts))

    def route(self, x, generator=None):
        """x [B, S, d] -> (probs [T, E], expert_index [T], expert_gate
        [T]); noise on the logits when `generator` is given and
        router_noise > 0."""
        logits = x.float().reshape(-1, x.shape[-1]) @ self.router
        if self.router_noise and generator is not None:
            logits = logits + self.router_noise * torch.randn(
                logits.shape, generator=generator, device=logits.device)
        probs = torch.softmax(logits, dim=-1)
        expert_index = torch.argmax(probs, dim=-1)  # the first maximum
        return probs, expert_index, probs.amax(dim=-1)

    def forward(self, x, generator=None):
        batch, seq, d_model = x.shape
        tokens = batch * seq
        probs, expert_index, expert_gate = self.route(x, generator)
        fraction_routed = torch.bincount(
            expert_index, minlength=self.num_experts).float() / tokens
        aux_loss = self.num_experts * torch.sum(fraction_routed
                                                * probs.mean(dim=0))
        out = switch_expert_ffn(
            x.reshape(tokens, d_model), expert_index, expert_gate,
            self._cast(self.expert_in), self._cast(self.expert_out),
            self.capacity(tokens), self.compute_dtype)
        return out.reshape(batch, seq, d_model).to(x.dtype), aux_loss


__all__ = ["MoEMLP", "TopKMoEMLP", "capacity_of", "dispatch_plan",
           "expert_load", "routed_expert_ffn", "routed_expert_ffn_reference",
           "switch_expert_ffn", "switch_expert_ffn_reference",
           "top_k_lower_index", "topk_aux_loss", "topk_route"]
