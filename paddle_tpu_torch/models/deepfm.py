"""DeepFM CTR model over high-dimensional sparse features (counterpart of
paddle_tpu/models/deepfm.py; Guo et al., 2017): a first-order linear term,
the FM second-order pairwise term and a DNN, all over shared embeddings.

With ``is_sparse=True`` the two tables' gradients are SelectedRowsValues
(``ops/tensor_ops.py`` lookup_table_grad), so a step's gradient traffic is
O(batch * fields * dim), never O(vocab), and Adam with ``lazy_mode``
updates only the touched rows.  bench.py trains
``deepfm(num_fields=26, vocab_size=1000000, embed_dim=10)`` at batch 512
with ``AdamOptimizer(learning_rate=1e-3, lazy_mode=True)``.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np

from .. import layers
from .common import ModelSpec

__all__ = ["deepfm"]


def deepfm(num_fields: int = 26, vocab_size: int = 1000 * 1000,
           embed_dim: int = 10, hidden_sizes: Sequence[int] = (400, 400, 400),
           is_sparse: bool = True) -> ModelSpec:
    feat_ids = layers.data("feat_ids", [num_fields], dtype="int64")
    feat_vals = layers.data("feat_vals", [num_fields], dtype="float32")
    label = layers.data("label", [1], dtype="float32")

    vals = layers.reshape(feat_vals, [-1, num_fields, 1])

    # first-order term: sum_f w1[id_f] * val_f           [B, 1]
    w1 = layers.embedding(feat_ids, size=[vocab_size, 1],
                          is_sparse=is_sparse, param_attr="deepfm_w1")
    first = layers.reduce_sum(layers.elementwise_mul(w1, vals), dim=[1, 2])
    first = layers.reshape(first, [-1, 1])

    # shared embeddings: e_f = E[id_f] * val_f           [B, F, K]
    emb = layers.embedding(feat_ids, size=[vocab_size, embed_dim],
                           is_sparse=is_sparse, param_attr="deepfm_emb")
    emb = layers.elementwise_mul(emb, vals)

    # FM second-order: 0.5 * sum_k ((sum_f e)^2 - sum_f e^2)    [B, 1]
    sum_f = layers.reduce_sum(emb, dim=[1])                 # [B, K]
    sum_sq = layers.square(sum_f)
    sq_sum = layers.reduce_sum(layers.square(emb), dim=[1])  # [B, K]
    second = layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum),
                               dim=[1])
    second = layers.scale(layers.reshape(second, [-1, 1]), scale=0.5)

    # deep component over the flattened field embeddings
    deep = layers.reshape(emb, [-1, num_fields * embed_dim])
    for i, h in enumerate(hidden_sizes):
        deep = layers.fc(deep, size=h, act="relu", name=f"deepfm_fc{i}")
    deep = layers.fc(deep, size=1, name="deepfm_out")

    logit = layers.elementwise_add(layers.elementwise_add(first, second), deep)
    loss = layers.mean(layers.sigmoid_cross_entropy_with_logits(logit, label))
    predict = layers.sigmoid(logit)

    return ModelSpec(
        name="deepfm_ctr",
        feed_names=[feat_ids.name, feat_vals.name, label.name],
        loss=loss,
        metrics={},
        synthetic_batch=functools.partial(
            _ctr_batch, num_fields=num_fields, vocab_size=vocab_size),
        extras={"predict": predict},
    )


def _ctr_batch(batch_size: int, num_fields: int, vocab_size: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    return {
        "feat_ids": rng.randint(
            0, vocab_size, size=(batch_size, num_fields)).astype(np.int64),
        "feat_vals": rng.rand(batch_size, num_fields).astype(np.float32),
        "label": rng.randint(0, 2, size=(batch_size, 1)).astype(np.float32),
    }
