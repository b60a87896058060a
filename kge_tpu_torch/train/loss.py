"""Loss functions (counterpart of ``kge_tpu/train/loss.py``).

Contract (reference: kge/util/loss.py:19-23): a loss returns the SUM over
batch elements; the training job divides by the batch size. ``labels``
is either an index vector [B] (position of the single 1-label per row) or
a {0,1} matrix [B, N]. ``row_weights`` (0/1 per row) masks the padding
rows of a fixed-size batch.

Ported: ``kl`` (and its alias ``ce``). The other losses raise "not yet
ported".
"""

from __future__ import annotations

import torch

from kge_tpu_torch.config import Config

NOT_YET_PORTED = ("bce", "bce_mean", "bce_self_adversarial",
                  "margin_ranking", "soft_margin", "se")


def _row_weights(scores, row_weights):
    if row_weights is None:
        return torch.ones(scores.shape[0], dtype=scores.dtype,
                          device=scores.device)
    return row_weights.to(scores.dtype)


class KgeLoss:
    """Factory + base for losses (reference: kge/util/loss.py:18-91)."""

    def __init__(self, config: Config):
        self.config = config

    @staticmethod
    def create(config: Config) -> "KgeLoss":
        return _Float32Loss(KgeLoss._create(config))

    @staticmethod
    def _create(config: Config) -> "KgeLoss":
        name = config.check("train.loss", ["kl", "ce", *NOT_YET_PORTED])
        if name in ("kl", "ce"):
            return KLDivWithSoftmaxKgeLoss(config)
        raise NotImplementedError(
            f"train.loss {name} is not yet ported to kge_tpu_torch"
        )

    def __call__(self, scores, labels, row_weights=None, **kwargs
                 ) -> torch.Tensor:
        raise NotImplementedError


class _Float32Loss(KgeLoss):
    """Casts scores to float32 before the loss math."""

    def __init__(self, inner: KgeLoss):
        super().__init__(inner.config)
        self._inner = inner

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def __call__(self, scores, labels, row_weights=None, **kwargs):
        return self._inner(scores.float(), labels, row_weights=row_weights,
                           **kwargs)


class KLDivWithSoftmaxKgeLoss(KgeLoss):
    """Cross entropy for index labels; KL divergence against the
    L1-normalized label distribution for matrix labels."""

    def __call__(self, scores, labels, row_weights=None, **kwargs):
        w = _row_weights(scores, row_weights)
        log_probs = torch.log_softmax(scores, dim=1)
        if labels.dim() == 1:
            picked = torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]
            return torch.sum(-picked * w)
        labels = labels.to(scores.dtype)
        denom = torch.clamp(torch.sum(labels, dim=1, keepdim=True),
                            min=1e-30)
        target = labels / denom
        log_target = torch.where(
            target > 0, torch.log(torch.clamp(target, min=1e-30)),
            torch.zeros_like(target),
        )
        kl = torch.sum(target * (log_target - log_probs), dim=1)
        return torch.sum(kl * w)
