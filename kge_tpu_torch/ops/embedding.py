"""Embedding lookup (counterpart of ``kge_tpu/ops/embedding.py``).

``kge_tpu`` chooses between a row gather and a one-hot matmul per
``tpu.embedding_lookup``; every mode returns the same rows, and the
one-hot form exists only to use the TPU's matrix unit. Here a lookup is
always a row gather.
"""

from __future__ import annotations

import torch


def embedding_lookup(table: torch.Tensor,
                     indexes: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``indexes`` ([..., D] output)."""
    out = torch.index_select(table, 0, indexes.reshape(-1))
    return out.reshape(*indexes.shape, table.shape[1])
