"""SelectedRowsValue: sparse row-set gradients (counterpart of
paddle_tpu/core/selected_rows.py).

A [V, D] embedding table's gradient is kept as the rows the batch looked
up, with the same static-shape contract as the JAX package:

  ids:   [N] int64 row indices, duplicates allowed
  rows:  [N, D] the gradient of each slot
  live:  [N] bool, False in a dead slot

N is the number of looked-up ids; V (``height``) appears in no runtime
buffer.  The JAX package marks a dead slot (a padding id, a slot freed by
merging) with the sentinel id ``height`` and relies on XLA's out-of-bounds
modes: scatters drop it, gathers read zeros.  torch has no such mode (an
index out of range is a device-side assert on the card), so here every id
stays in range and a dead slot is one whose ``live`` is False:

- ``to_dense`` adds only the live slots' rows;
- after ``merge`` each id is live in one slot, and every other slot holds
  the id and the summed row of a live slot (its own id's, or the smallest
  live id's for a dead slot), so that a consumer that writes one new row
  a slot writes identical values wherever two slots share an id;
- a value with no live slot holds clamped ids; its consumers keep the old
  rows (``live.any()`` is False).

No step depends on the data's values for a shape, and every sum runs in a
fixed order: the ids are sorted stably and the rows summed by
``embedding_dense_backward``, the backward of ``F.embedding``, which on
the card sums each index's rows in sorted order, without atomic adds.  So
two runs of a step are bit-equal and a step can be captured into a CUDA
graph.
"""

from __future__ import annotations

import torch

__all__ = ["SelectedRowsValue", "segment_sum"]


def segment_sum(rows: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """[num_segments, D]: row s is the sum of ``rows[i]`` over the i with
    ``index[i] == s``, in a fixed order (F.embedding's backward)."""
    return torch.ops.aten.embedding_dense_backward(
        rows, index, num_segments, -1, False)


class SelectedRowsValue:
    __slots__ = ("ids", "rows", "height", "live")

    def __init__(self, ids: torch.Tensor, rows: torch.Tensor, height: int,
                 live: torch.Tensor):
        self.ids = ids
        self.rows = rows
        self.height = int(height)
        self.live = live

    def __repr__(self):
        return (f"SelectedRowsValue(n={self.rows.shape[0]}, "
                f"height={self.height}, dim={tuple(self.rows.shape[1:])})")

    def to_dense(self) -> torch.Tensor:
        """The [height, D] gradient: each live slot's row added at its id
        (duplicates accumulate, dead slots add nothing)."""
        live_rows = self.rows * self.live.unsqueeze(-1).to(self.rows.dtype)
        return segment_sum(live_rows, self.ids, self.height)

    def merge(self) -> "SelectedRowsValue":
        """Sum the rows of equal ids (the reference's merge_selected_rows /
        scatter::MergeAdd): still N slots, each id live in exactly one."""
        n = self.ids.shape[0]
        # dead slots sort after every id
        key, order = torch.sort(
            torch.where(self.live, self.ids, self.height), stable=True)
        slive = self.live[order]
        first = torch.ones_like(slive)
        first[1:] = key[1:] != key[:-1]
        seg = torch.cumsum(first, 0) - 1
        sums = segment_sum(self.rows.index_select(0, order), seg, n)
        # a dead slot takes slot 0's id and sum: the smallest live id's
        seg = torch.where(slive, seg, 0)
        ids = torch.where(slive, key, key[0]).clamp_(max=self.height - 1)
        return SelectedRowsValue(ids, sums.index_select(0, seg), self.height,
                                 first & slive)

    def concat(self, other: "SelectedRowsValue") -> "SelectedRowsValue":
        """Stack two sparse gradients of one table (the ``sum`` op's
        sparse + sparse case)."""
        if self.height != other.height:
            raise ValueError(
                f"height mismatch {self.height} vs {other.height}")
        return SelectedRowsValue(torch.cat([self.ids, other.ids]),
                                 torch.cat([self.rows, other.rows]),
                                 self.height,
                                 torch.cat([self.live, other.live]))

    def clone(self) -> "SelectedRowsValue":
        return SelectedRowsValue(self.ids.clone(), self.rows.clone(),
                                 self.height, self.live.clone())

    def to_numpy(self) -> "SelectedRowsValue":
        return SelectedRowsValue(
            self.ids.detach().cpu().numpy(),
            self.rows.detach().cpu().numpy(), self.height,
            self.live.cpu().numpy())
