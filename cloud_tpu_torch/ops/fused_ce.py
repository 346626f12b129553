"""Chunked LM-head cross-entropy: the loss without materialising logits.

The port of `cloud_tpu/ops/fused_ce.py`. `lm_head_loss(hidden, weights,
labels)` fuses the output projection with the softmax cross-entropy and
scans the vocabulary in chunks, so the [N, V] logits never exist:

    forward:  per chunk c: logits_c = h @ W[:, c] in f32, folded into an
              online logsumexp and the label logit of labels that land
              in the chunk.
    backward: recompute logits_c per chunk, p_c = exp(logits_c - lse),
              dh += (p_c - onehot) g @ W[:, c]^T and
              dW[:, c] += h^T (p_c - onehot) g.

Peak extra memory is one [N, chunk] f32 block, plus dW (the gradient,
accumulated in f32) and, on low-precision inputs, f32 copies of h and of
one chunk of W. There is no kernel here: as in JAX, the chunk products
are plain matrix products (`torch.matmul`) and the rest elementwise.

Numerics follow JAX's `preferred_element_type=f32`: every product and
sum is f32 whatever the input dtype. On bf16 or f16 inputs each chunk's
logits come from f32 copies of the chunk's operands (exact: a product of
two bf16 values fits in f32), multiplied in f32 with PyTorch's default
`torch.backends.cuda.matmul.allow_tf32 = False`, never as bf16 logits
cast up. The gradients take the inputs' dtypes.
"""

import torch

__all__ = ["lm_head_loss", "lm_head_loss_reference"]


def _f32(t):
    return t if t.dtype == torch.float32 else t.float()


def _chunks(vocab, chunk):
    """(start, keep_from) of each chunk: the last chunk's start is clamped
    to vocab - chunk, so every chunk has `chunk` columns and W is never
    padded; its first `keep_from` columns overlap the chunk before and
    are masked out (taken by no sum)."""
    for unclamped in range(0, vocab, chunk):
        start = min(unclamped, vocab - chunk)
        yield start, unclamped - start


def _label_hits(labels, start, keep_from, chunk):
    """Column of each row's label within the chunk (clamped into range)
    and whether the label lands in the chunk's unmasked columns."""
    local = labels - start
    hit = (local >= keep_from) & (local < chunk)
    return local.clamp(0, chunk - 1), hit


def _forward(hidden, weights, labels, chunk):
    n, vocab = hidden.shape[0], weights.shape[1]
    h32 = _f32(hidden)
    m = torch.full((n,), float("-inf"), dtype=torch.float32,
                   device=hidden.device)
    s = torch.zeros(n, dtype=torch.float32, device=hidden.device)
    label_logit = torch.zeros(n, dtype=torch.float32, device=hidden.device)
    for start, keep_from in _chunks(vocab, chunk):
        logits = h32 @ _f32(weights[:, start:start + chunk])
        col, hit = _label_hits(labels, start, keep_from, chunk)
        label_logit += torch.where(
            hit, logits.gather(1, col[:, None])[:, 0], 0.0)
        kept = logits[:, keep_from:]
        m_new = torch.maximum(m, kept.amax(1))
        s = (s * torch.exp(m - m_new)
             + kept.sub_(m_new[:, None]).exp_().sum(1))
        m = m_new
    lse = m + torch.log(s)
    # Ignore-index semantics: an out-of-range label (the usual -1 of a
    # padded position) carries loss 0 instead of a garbage lse - 0.
    valid = (labels >= 0) & (labels < vocab)
    return torch.where(valid, lse - label_logit, 0.0), lse


class _LmHeadLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, weights, labels, chunk):
        loss, lse = _forward(hidden, weights, labels, chunk)
        ctx.save_for_backward(hidden, weights, labels, lse)
        ctx.chunk = chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, weights, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        vocab = weights.shape[1]
        # Ignored positions have zero cotangent, matching their zero loss.
        valid = (labels >= 0) & (labels < vocab)
        g = torch.where(valid, g.float(), 0.0)
        h32 = _f32(hidden)
        dh = torch.zeros(h32.shape, dtype=torch.float32,
                         device=hidden.device)
        dw = torch.zeros(weights.shape, dtype=torch.float32,
                         device=weights.device)
        for start, keep_from in _chunks(vocab, chunk):
            w_c = _f32(weights[:, start:start + chunk])
            dlogits = (h32 @ w_c).sub_(lse[:, None]).exp_().mul_(g[:, None])
            dlogits[:, :keep_from] = 0.0   # the masked overlap
            col, hit = _label_hits(labels, start, keep_from, chunk)
            dlogits.scatter_add_(1, col[:, None],
                                 torch.where(hit, -g, 0.0)[:, None])
            dh += dlogits @ w_c.T
            # Accumulate (read-add-write): the clamped last chunk overlaps
            # the one before it, whose gradient there must stay.
            dw[:, start:start + chunk] += h32.T @ dlogits
        return dh.to(hidden.dtype), dw.to(weights.dtype), None, None


def lm_head_loss(hidden, weights, labels, chunk=8192):
    """Per-token softmax cross-entropy of `hidden @ weights` against
    `labels`, without the [N, V] logits.

    Args:
        hidden: [N, D] activations (flatten batch and sequence first).
        weights: [D, V] output projection (no bias).
        labels: [N] integer target ids. Ids in [0, V) contribute their
            cross-entropy; ids outside it (e.g. -1 for padding) give loss
            0 and gradient 0.
        chunk: vocabulary tile width; peak extra memory is one [N, chunk]
            f32 block (a chunk wider than V is V).

    Returns:
        [N] f32 per-token losses, differentiable in `hidden` and
        `weights` (gradients in their dtypes).
    """
    if hidden.ndim != 2 or weights.ndim != 2 or labels.ndim != 1:
        raise ValueError(
            "lm_head_loss takes hidden [N, D], weights [D, V], labels [N]; "
            "got {}, {}, {}.".format(tuple(hidden.shape),
                                     tuple(weights.shape),
                                     tuple(labels.shape)))
    if hidden.shape[1] != weights.shape[0] or \
            hidden.shape[0] != labels.shape[0]:
        raise ValueError(
            "lm_head_loss shapes disagree: hidden {}, weights {}, labels "
            "{}.".format(tuple(hidden.shape), tuple(weights.shape),
                         tuple(labels.shape)))
    chunk = min(int(chunk), weights.shape[1])
    if chunk < 1:
        raise ValueError("chunk must be positive; got {}.".format(chunk))
    return _LmHeadLoss.apply(hidden, weights, labels.long(), chunk)


def lm_head_loss_reference(hidden, weights, labels):
    """The plain version: the full f32 logits, then softmax cross-entropy
    per token (autograd through it). An out-of-range label gives loss 0,
    as `lm_head_loss` does; JAX's reference, which gathers it clipped,
    agrees with this one on in-range labels."""
    logits = _f32(hidden) @ _f32(weights)
    vocab = weights.shape[1]
    labels = labels.long()
    valid = (labels >= 0) & (labels < vocab)
    picked = logits.gather(1, labels.clamp(0, vocab - 1)[:, None])[:, 0]
    return torch.where(valid, torch.logsumexp(logits, 1) - picked, 0.0)
