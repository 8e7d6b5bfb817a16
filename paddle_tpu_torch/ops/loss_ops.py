"""Loss ops (counterpart of paddle_tpu/ops/loss_ops.py): cross_entropy
over probabilities, softmax_with_cross_entropy with folded label
smoothing — hard labels only — and sigmoid_cross_entropy_with_logits."""

from __future__ import annotations

import torch

from ..core import amp
from ..core.registry import register_op
from .common import in_desc, same_shape, set_output


def _cross_entropy_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    set_output(block, op, "Y", list(x.shape[:-1]) + [1], x.dtype)


@register_op("cross_entropy", infer_shape=_cross_entropy_infer,
             diff_inputs=["X"])
def _cross_entropy(ctx, ins, attrs):
    """-log(prob[label] + 1e-12) over probabilities; rows labelled
    ignore_index give 0."""
    if attrs.get("soft_label", False):
        raise NotImplementedError("soft labels are not ported")
    x0 = ins["X"][0]
    # the log runs fp32 for half-width probabilities; Y keeps X's dtype
    x = x0.to(amp.stats_dtype(x0))
    lab = ins["Label"][0]
    if lab.dim() == x.dim():
        lab = lab.squeeze(-1)
    loss = -torch.log(torch.gather(x, -1, lab.unsqueeze(-1).long()) + 1e-12)
    ignore = attrs.get("ignore_index", -100)
    return {"Y": [torch.where((lab != ignore).unsqueeze(-1), loss,
                              torch.zeros_like(loss)).to(x0.dtype)]}


def _swce_infer(op, block):
    x = in_desc(op, block, "Logits")
    if x is None:
        return
    set_output(block, op, "Softmax", x.shape, x.dtype)
    set_output(block, op, "Loss", list(x.shape[:-1]) + [1], x.dtype)


@register_op("softmax_with_cross_entropy", infer_shape=_swce_infer,
             diff_inputs=["Logits"])
def _softmax_with_cross_entropy(ctx, ins, attrs):
    """Numerically stable softmax + CE.  smooth_eps folds uniform label
    smoothing in: the target (1-eps)*onehot + eps/V gives
    (1-eps)*CE + eps*mean_V(-logp), with no [*, V] label tensor.  Softmax
    is made only when something reads it."""
    if attrs.get("soft_label", False):
        raise NotImplementedError("soft labels are not ported")
    logits = ins["Logits"][0]
    lab = ins["Label"][0]
    # half-width logits (amp keep_output) reduce in fp32; the outputs keep
    # the logits' dtype
    logp = torch.log_softmax(logits.to(amp.stats_dtype(logits)), dim=-1)
    if lab.dim() == logits.dim():
        lab = lab.squeeze(-1)
    loss = -torch.gather(logp, -1, lab.unsqueeze(-1).long())
    eps = attrs.get("smooth_eps", 0.0)
    if eps:
        loss = (1.0 - eps) * loss - eps * logp.mean(dim=-1, keepdim=True)
    ignore = attrs.get("ignore_index", -100)
    loss = torch.where((lab != ignore).unsqueeze(-1), loss,
                       torch.zeros_like(loss))
    softmax = (torch.exp(logp).to(logits.dtype) if ctx.is_read("Softmax")
               else None)
    return {"Softmax": [softmax], "Loss": [loss.to(logits.dtype)]}


@register_op("sigmoid_cross_entropy_with_logits", infer_shape=same_shape(),
             diff_inputs=["X"])
def _sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    """max(x, 0) - x * label + log(1 + exp(-|x|)), the stable form; 0
    where the label is ignore_index."""
    x = ins["X"][0]
    label = ins["Label"][0]
    loss = (torch.maximum(x, torch.zeros_like(x)) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    ignore = attrs.get("ignore_index", -100)
    return {"Out": [torch.where(label == ignore, torch.zeros_like(loss),
                                loss)]}
