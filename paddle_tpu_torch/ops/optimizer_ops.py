"""Optimizer ops (counterpart of paddle_tpu/ops/optimizer_ops.py):
parameter updates as ops in the program.  Each writes ``*Out`` slots whose
names alias its inputs; the executor writes them back to the scope.
Momentum (dense) and Adam (dense, and lazy over sparse gradients).

A sparse gradient (``SelectedRowsValue``) reaches Adam's row-wise path
only under ``lazy_mode``: untouched rows keep their moments undecayed, as
TF's LazyAdam.  Otherwise it is made dense and takes the dense path, so
that every row decays as the reference's SparseAdamFunctor sweeps it.
Row updates are out of place: a new table with the touched rows
replaced."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRowsValue
from .common import in_desc, set_output


def _dense(g):
    return g.to_dense() if isinstance(g, SelectedRowsValue) else g


def _row_update(table, ids, new_rows):
    """``table`` with whole rows replaced.  Slots that share an id carry
    identical rows (``merge``), so the order of the writes is immaterial."""
    return table.index_copy(0, ids, new_rows)


def _param_out_infer(op, block):
    p = in_desc(op, block, "Param")
    if p is None:
        return
    for slot in op.outputs:
        ref = in_desc(op, block, slot.replace("Out", "")) or p
        set_output(block, op, slot, ref.shape, ref.dtype)


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


@register_op("momentum", infer_shape=_param_out_infer, no_grad=True)
def _momentum(ctx, ins, attrs):
    if attrs.get("use_nesterov", False):
        raise NotImplementedError("Nesterov momentum is not ported")
    p = ins["Param"][0]
    g = _dense(ins["Grad"][0])
    v = ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    v_new = mu * v + g
    p_new = p - _lr(ins) * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


@register_op("adam", infer_shape=_param_out_infer, no_grad=True)
def _adam(ctx, ins, attrs):
    p = ins["Param"][0]
    m = ins["Moment1"][0]
    v = ins["Moment2"][0]
    b1p = ins["Beta1Pow"][0]
    b2p = ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = (_lr(ins) * torch.sqrt(1 - b2p.reshape(()))
            / (1 - b1p.reshape(())))
    pows = {"Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}
    g = ins["Grad"][0]
    if isinstance(g, SelectedRowsValue) and attrs.get("lazy_mode", False):
        # the touched rows only; with no live slot every row keeps its
        # old value
        srv = g.merge()
        keep = ~srv.live.any()
        pr, mr, vr = (t.index_select(0, srv.ids) for t in (p, m, v))
        gr = srv.rows
        m_new_r = b1 * mr + (1 - b1) * gr
        v_new_r = b2 * vr + (1 - b2) * gr * gr
        delta = lr_t * m_new_r / (torch.sqrt(v_new_r) + eps)
        return {
            "ParamOut": [_row_update(p, srv.ids,
                                     torch.where(keep, pr, pr - delta))],
            "Moment1Out": [_row_update(m, srv.ids,
                                       torch.where(keep, mr, m_new_r))],
            "Moment2Out": [_row_update(v, srv.ids,
                                       torch.where(keep, vr, v_new_r))],
            **pows}
    g = _dense(g)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return {"ParamOut": [p_new], "Moment1Out": [m_new],
            "Moment2Out": [v_new], **pows}
