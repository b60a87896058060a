"""ConvE: a 2D convolution over stacked (s, p) reshapes and a projection
(counterpart of ``kge_tpu/models/conve.py``; reference:
kge/model/conve.py).

The conv and projection weights are the scorer's parameters, in
``kge_tpu``'s tree (``scorer.{conv_w, conv_b, proj_w, proj_b}``, the conv
kernel OIHW). The affine-free batch-norm running statistics are model
state (``bn1``, ``bn2``), threaded through ``Ctx``: training normalizes
with the batch statistics and writes the updated running ones into
``ctx.updates``; evaluation reads the running ones. The convolution is
``torch.nn.functional.conv2d`` (cuDNN on a card, with TF32 off as every
job of the port sets it), where ``kge_tpu`` computes it in XLA.

Embedding dimension 0 is the per-entity bias term, as in the reference
("HACK to add bias terms", conve.py:110-135): the model requests
entity/relation dim+1 from the embedders and scores with dims 1..d.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kge_tpu_torch.models.api import Ctx, KgeModel, RelationalScorer, promoted
from kge_tpu_torch.models.init import initialize
from kge_tpu_torch.parallel.collectives import data_sum


def batch_norm(x: torch.Tensor, name: str, ctx: Ctx,
               reduce_axes: Sequence[int], momentum: float = 0.1,
               eps: float = 1e-5) -> torch.Tensor:
    """Affine-free batch norm with torch's running-statistics semantics
    (``kge_tpu``'s): the biased variance normalizes, the unbiased one
    goes into the running statistics. Under a mesh (``ctx.shard``) the
    statistics are the global batch's, summed over the data group, as
    GSPMD computes them in ``kge_tpu``."""
    state = ctx.state[name]
    group = ctx.shard.group if ctx.shard is not None else None
    if ctx.train and group is not None:
        # under a mesh the statistics are the global part's: the sums
        # over the data group (two passes, as torch.var takes them)
        axes = tuple(reduce_axes)
        n = ctx.shard.total * math.prod(x.shape[ax] for ax in axes if ax)
        mean = data_sum(torch.sum(x, dim=axes), group) / n
        shape = [x.shape[i] if i not in reduce_axes else 1
                 for i in range(x.dim())]
        var = data_sum(torch.sum((x - mean.reshape(shape)) ** 2, dim=axes),
                       group) / n
    elif ctx.train:
        mean = torch.mean(x, dim=tuple(reduce_axes))
        var = torch.var(x, dim=tuple(reduce_axes), correction=0)
        n = math.prod(x.shape[ax] for ax in reduce_axes)
    if ctx.train:
        unbiased = var.detach() * n / max(n - 1, 1)
        ctx.updates[name] = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
            "var": (1 - momentum) * state["var"] + momentum * unbiased,
        }
    else:
        mean, var = state["mean"], state["var"]
    shape = [x.shape[i] if i not in reduce_axes else 1
             for i in range(x.dim())]
    return (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)


class ConvEScorer(RelationalScorer):
    """Scores sp_ and spo only: bare ConvE ranks subjects through the
    generic path of evaluation, reciprocal ConvE through its dot form."""

    def __init__(self, config, dataset, configuration_key=None, *,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 init_for_load_only: bool = False):
        super().__init__(config, dataset, configuration_key, device=device)
        self.emb_dim = self.get_option("entity_embedder.dim") - 1
        aspect_ratio = self.get_option("2D_aspect_ratio")
        self.emb_height = math.sqrt(self.emb_dim / aspect_ratio)
        self.emb_width = self.emb_height * aspect_ratio
        rounded_height = math.ceil(self.emb_height)
        if self.get_option("round_dim") and rounded_height != self.emb_height:
            self.emb_height = rounded_height
            self.emb_width = self.emb_height * aspect_ratio
            self.emb_dim = self.emb_height * self.emb_width
            self.set_option("entity_embedder.dim", self.emb_dim + 1, log=True)
            self.set_option("relation_embedder.dim", self.emb_dim + 1,
                            log=True)
            config.log(f"Rounded embedding dimension to {self.emb_dim}")
        elif self.emb_dim % self.emb_height or self.emb_dim % self.emb_width:
            raise ValueError(
                f"embedding dim {self.emb_dim} incompatible with aspect ratio "
                f"{aspect_ratio}; set conve.round_dim=true"
            )
        self.emb_height = int(self.emb_height)
        self.emb_width = int(self.emb_width)
        self.emb_dim = int(self.emb_dim)
        self.filter_size = self.get_option("filter_size")
        self.stride = self.get_option("stride")
        self.padding = self.get_option("padding")
        self.feature_map_dropout = self.get_option("feature_map_dropout")
        self.projection_dropout = self.get_option("projection_dropout")
        self.convolution_bias = self.get_option("convolution_bias")
        self.out_channels = 32
        self.conv_h = ((self.emb_height * 2 - self.filter_size
                        + 2 * self.padding) // self.stride + 1)
        self.conv_w_out = ((self.emb_width - self.filter_size
                            + 2 * self.padding) // self.stride + 1)
        self.flat = self.out_channels * self.conv_h * self.conv_w_out

        fan_in_conv = self.filter_size * self.filter_size
        bound_conv = 1.0 / math.sqrt(fan_in_conv)
        bound_proj = 1.0 / math.sqrt(self.flat)
        # a = sqrt(5) is torch's Conv2d/Linear reset_parameters value (NOT
        # the kaiming_uniform_ default)
        shapes = {
            "conv_w": ((self.out_channels, 1, self.filter_size,
                        self.filter_size),
                       "kaiming_uniform_", {"a": math.sqrt(5.0)}),
            "proj_w": ((self.emb_dim, self.flat), "kaiming_uniform_",
                       {"a": math.sqrt(5.0)}),
            "proj_b": ((self.emb_dim,), "uniform_",
                       {"a": -bound_proj, "b": bound_proj}),
        }
        if self.convolution_bias:
            shapes["conv_b"] = ((self.out_channels,), "uniform_",
                                {"a": -bound_conv, "b": bound_conv})
        for name, (shape, init, args) in shapes.items():
            if init_for_load_only:
                value = torch.empty(shape, dtype=torch.float32, device=device)
            else:
                value = initialize(generator, shape, init, args).to(device)
            setattr(self, name, nn.Parameter(value, requires_grad=False))

    def init_state(self) -> Dict[str, Any]:
        def stats(n):
            return {
                "mean": torch.zeros(n, dtype=torch.float32,
                                    device=self.device),
                "var": torch.ones(n, dtype=torch.float32, device=self.device),
            }

        return {"bn1": stats(self.out_channels), "bn2": stats(self.emb_dim)}

    def _features(self, s_emb, p_emb, ctx: Ctx) -> torch.Tensor:
        batch_size = p_emb.shape[0]
        s_2d = s_emb[:, 1:].reshape(-1, 1, self.emb_height, self.emb_width)
        p_2d = p_emb[:, 1:].reshape(-1, 1, self.emb_height, self.emb_width)
        stacked = torch.cat([s_2d, p_2d], dim=2)
        # bf16 embeddings (tpu.compute_dtype) meet the float32 kernel in
        # float32, as jnp promotes them (kge_tpu's lax.conv refuses the
        # mix instead)
        out = F.conv2d(*promoted(stacked, self.conv_w), stride=self.stride,
                       padding=self.padding)
        if self.convolution_bias:
            out = out + self.conv_b[None, :, None, None]
        out = batch_norm(out, "bn1", ctx, reduce_axes=(0, 2, 3))
        out = torch.relu(out)
        out = ctx.dropout(out, self.feature_map_dropout)
        out = out.reshape(batch_size, -1)
        out = out @ self.proj_w.T + self.proj_b
        out = ctx.dropout(out, self.projection_dropout)
        out = batch_norm(out, "bn2", ctx, reduce_axes=(0,))
        return torch.relu(out)

    # dot form: score = [1 || features(s,p)] . [bias || e_o] -- the raw
    # candidate row IS the candidate vector (bias lives in dim 0), so
    # reciprocal ConvE (both ranking sides rewrite to sp_) ranks through
    # the rank-count kernel reading the embedding table in place
    supports_dot_form = True
    dot_combines = ("sp_",)

    def query_vec(self, a_emb, p_emb, combine, ctx):
        if combine != "sp_":
            raise ValueError(
                "ConvE has no _po dot form (wrap in "
                "reciprocal_relations_model, which queries sp_ both ways)"
            )
        feats = self._features(a_emb, p_emb, ctx)
        return torch.cat([torch.ones_like(feats[:, :1]), feats], dim=1)

    def candidate_vec(self, cand_emb, combine, ctx):
        return cand_emb

    def score_emb(self, s_emb, p_emb, o_emb, combine, ctx: Ctx):
        if combine not in ("sp_", "spo"):
            raise ValueError(f"combine {combine} not supported by ConvE")
        batch_size = p_emb.shape[0]
        out = self._features(s_emb, p_emb, ctx)
        if combine == "sp_":
            out, o_emb = promoted(out, o_emb)
            out = out @ o_emb[:, 1:].T
        else:
            out = torch.sum(out * o_emb[:, 1:], dim=-1)
        out = out + o_emb[:, 0]
        return out.reshape(batch_size, -1)


class ConvE(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        self._init_configuration(config, configuration_key)
        # embedding dim 0 is the entity bias term: the embedders are built
        # at dim + 1, and the option is restored afterwards
        for key in ("entity_embedder.dim", "relation_embedder.dim"):
            self.set_option(key, self.get_option(key) + 1, create=True)
        super().__init__(
            config, dataset,
            ConvEScorer(config, dataset, self.configuration_key, **kwargs),
            configuration_key=self.configuration_key, **kwargs,
        )
        for key in ("entity_embedder.dim", "relation_embedder.dim"):
            self.set_option(key, self.get_option(key) - 1)

    def score_spo(self, s, p, o, direction=None, ctx=None):
        if direction == "o":
            return super().score_spo(s, p, o, direction, ctx)
        raise ValueError("ConvE can only score objects")
