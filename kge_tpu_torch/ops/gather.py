"""Row-wise column gather (counterpart of ``kge_tpu/ops/gather.py``).

``kge_tpu`` contracts against a one-hot matrix when the source row is
narrow, to use the TPU's matrix unit; both of its forms pick the same
values. Here the gather is ``torch.gather`` along dim 1.
"""

from __future__ import annotations

import torch


def row_gather(scores: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """out[b, k] = scores[b, cols[b, k]] for scores [B, U], cols [B, K]."""
    return torch.gather(scores, 1, cols.long())
