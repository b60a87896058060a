"""Loss functions (counterpart of ``kge_tpu/train/loss.py``).

Contract (reference: kge/util/loss.py:19-23): a loss returns the SUM over
batch elements; the training job divides by the batch size. ``labels``
is either an index vector [B] (position of the single 1-label per row) or
a {0,1} matrix [B, N]. ``row_weights`` (0/1 per row) masks the padding
rows of a fixed-size batch.

Every loss of ``kge_tpu`` is here, with its arithmetic and its gradient:
``jnp.maximum(x, 0)`` becomes ``torch.maximum`` against a zero tensor,
which like it gives half the gradient to each side at a tie (``relu``
and ``clamp`` give all or none), ``jnp.abs`` becomes a ``where`` whose
gradient at 0 is 1 as in JAX (``torch.abs`` gives 0), and
``stop_gradient`` becomes ``detach``.
"""

from __future__ import annotations

import math

import torch

from kge_tpu_torch.config import Config


def _labels_as_matrix(scores, labels):
    if labels.dim() == 2:
        return labels.to(scores.dtype)
    return torch.nn.functional.one_hot(
        labels.long(), scores.shape[1]).to(scores.dtype)


def _labels_as_indexes(labels):
    if labels.dim() == 1:
        return labels.long()
    return torch.argmax(labels, dim=1)


def _row_weights(scores, row_weights):
    if row_weights is None:
        return torch.ones(scores.shape[0], dtype=scores.dtype,
                          device=scores.device)
    return row_weights.to(scores.dtype)


def _maximum0(x):
    """``jnp.maximum(x, 0.0)``, its gradient at 0 included (0.5)."""
    return torch.maximum(x, torch.zeros_like(x))


def _abs(x):
    """``jnp.abs(x)``, its gradient at 0 included (1, where ``torch.abs``
    gives 0)."""
    return torch.where(x >= 0, x, -x)


def _bce_with_logits(scores, labels):
    # elementwise log(1 + exp(-|x|)) + max(x,0) - x*y  (stable BCE)
    return (_maximum0(scores) - scores * labels
            + torch.log1p(torch.exp(-_abs(scores))))


class KgeLoss:
    """Factory + base for losses (reference: kge/util/loss.py:18-91)."""

    def __init__(self, config: Config):
        self.config = config

    @staticmethod
    def create(config: Config) -> "KgeLoss":
        return _Float32Loss(KgeLoss._create(config))

    @staticmethod
    def _create(config: Config) -> "KgeLoss":
        config.check(
            "train.loss",
            ["bce", "bce_mean", "bce_self_adversarial", "margin_ranking",
             "ce", "kl", "soft_margin", "se"],
        )
        name = config.get("train.loss")
        if name in ("bce", "bce_mean", "bce_self_adversarial"):
            offset = config.get("train.loss_arg")
            if math.isnan(offset):
                offset = 0.0
                config.set("train.loss_arg", offset, log=True)
            if name == "bce":
                return BCEWithLogitsKgeLoss(config, offset=offset)
            if name == "bce_mean":
                return BCEWithLogitsKgeLoss(config, offset=offset,
                                            bce_type="mean")
            try:
                temperature = float(
                    config.get("user.bce_self_adversarial_temperature"))
            except KeyError:
                temperature = 1.0
            config.log(f"Using adversarial temperature {temperature}")
            return BCEWithLogitsKgeLoss(
                config, offset=offset, bce_type="self_adversarial",
                temperature=temperature,
            )
        if name in ("kl", "ce"):
            return KLDivWithSoftmaxKgeLoss(config)
        if name == "margin_ranking":
            margin = config.get("train.loss_arg")
            if math.isnan(margin):
                margin = 1.0
                config.set("train.loss_arg", margin, log=True)
            return MarginRankingKgeLoss(config, margin=margin)
        if name == "soft_margin":
            return SoftMarginKgeLoss(config)
        return SEKgeLoss(config)

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


class BCEWithLogitsKgeLoss(KgeLoss):
    def __init__(self, config, offset=0.0, bce_type=None, temperature=1.0):
        super().__init__(config)
        self._offset = offset
        self._bce_type = bce_type
        self._temperature = temperature

    def __call__(self, scores, labels, row_weights=None, **kwargs):
        labels_m = _labels_as_matrix(scores, labels)
        w = _row_weights(scores, row_weights)
        if self._offset != 0.0:
            scores = scores + self._offset
        losses = _bce_with_logits(scores, labels_m)
        if self._bce_type is None:
            return torch.sum(losses * w[:, None])
        # positives in the column indicated by labels; the rest negative
        idx = _labels_as_indexes(labels)
        pos = torch.gather(losses, 1, idx[:, None])[:, 0]
        if self._bce_type == "mean":
            neg = torch.sum(losses, dim=1) - pos
            per_row = (pos + neg / (scores.shape[1] - 1)) / 2.0
            return torch.sum(per_row * w)
        neg_mask = 1.0 - _labels_as_matrix(scores, idx)
        # softmax over negative scores only (positives masked to -inf)
        neg_scores = torch.where(
            neg_mask > 0, scores.detach(),
            torch.full_like(scores, -math.inf))
        weights = torch.softmax(neg_scores * self._temperature, dim=1)
        neg = torch.sum(weights * losses * neg_mask, dim=1)
        return torch.sum((pos + neg) / 2.0 * w)


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


class SoftMarginKgeLoss(KgeLoss):
    def __call__(self, scores, labels, row_weights=None, **kwargs):
        labels_m = _labels_as_matrix(scores, labels) * 2.0 - 1.0
        w = _row_weights(scores, row_weights)
        losses = torch.log1p(torch.exp(-labels_m * scores))
        return torch.sum(losses * w[:, None])


class MarginRankingKgeLoss(KgeLoss):
    """Pairs each positive (column 0) with its row's negatives.

    Only defined for negative-sampling scores [B, 1+num_negatives]
    (reference: kge/util/loss.py:228-262)."""

    def __init__(self, config, margin):
        super().__init__(config)
        self._margin = margin
        self._train_type = config.get("train.type")

    def __call__(self, scores, labels, row_weights=None, num_negatives=None,
                 **kwargs):
        if "negative_sampling" not in self._train_type:
            raise NotImplementedError(
                "margin ranking is only supported with negative sampling"
            )
        w = _row_weights(scores, row_weights)
        idx = _labels_as_indexes(labels)
        pos = torch.gather(scores, 1, idx[:, None])  # [B, 1]
        neg_mask = 1.0 - _labels_as_matrix(scores, idx)
        losses = _maximum0(self._margin - (pos - scores)) * neg_mask
        return torch.sum(losses * w[:, None])


class SEKgeLoss(KgeLoss):
    def __call__(self, scores, labels, row_weights=None, **kwargs):
        labels_m = _labels_as_matrix(scores, labels)
        w = _row_weights(scores, row_weights)
        return torch.sum((scores - labels_m) ** 2 * w[:, None])
