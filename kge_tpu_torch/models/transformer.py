"""Transformer ("no context" HittER) scorer (counterpart of
``kge_tpu/models/transformer.py``; reference: kge/model/transformer.py).

A 3-token sequence [CLS, s + type_s, p + type_p] runs through a post-norm
transformer encoder; the transformed CLS embedding is dotted with the
object embeddings. The weights are the scorer's parameters in
``kge_tpu``'s tree: ``cls``, ``sub_type``, ``rel_type`` and a list of
``layers`` (``scorer.layers.<i>.qkv_w``, ...). The encoder is written in
plain tensor operations in ``kge_tpu``'s order (no ``nn.MultiheadAttention``
or fused attention), so its numerics are ``kge_tpu``'s; softmax and
layer norm in float32. Scores sp_ and spo only: use it wrapped in the
reciprocal relations model.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kge_tpu_torch.models.api import Ctx, KgeModel, RelationalScorer, promoted


def _layer_norm(x, scale, bias, eps=1e-5):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


class _EncoderLayer(nn.Module):
    """One post-norm encoder layer's parameters (``kge_tpu``'s names)."""

    def __init__(self, d: int, ff: int, init_w, device):
        super().__init__()
        zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=device)
        ones = lambda n: torch.ones(n, dtype=torch.float32, device=device)
        values = {
            "qkv_w": init_w((3 * d, d)), "qkv_b": zeros(3 * d),
            "out_w": init_w((d, d)), "out_b": zeros(d),
            "lin1_w": init_w((ff, d)), "lin1_b": zeros(ff),
            "lin2_w": init_w((d, ff)), "lin2_b": zeros(d),
            "ln1_scale": ones(d), "ln1_bias": zeros(d),
            "ln2_scale": ones(d), "ln2_bias": zeros(d),
        }
        for name, value in values.items():
            setattr(self, name, nn.Parameter(value, requires_grad=False))


class TransformerScorer(RelationalScorer):
    def __init__(self, config, dataset, configuration_key=None, *,
                 device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 init_for_load_only: bool = False):
        super().__init__(config, dataset, configuration_key, device=device)
        self.emb_dim = self.get_option("entity_embedder.dim")
        self.nhead = self.get_option("encoder.nhead")
        self.ff_dim = self.get_option("encoder.dim_feedforward")
        self.num_layers = self.get_option("encoder.num_layers")
        self.activation = self.check_option("encoder.activation",
                                            ["relu", "gelu"])
        self.dropout_rate = self.get_option("encoder.dropout")
        if self.dropout_rate < 0.0:
            if config.get("train.auto_correct"):
                config.log(
                    f"Setting {configuration_key}.encoder.dropout to 0 "
                    f"(was {self.dropout_rate})."
                )
                self.dropout_rate = 0.0
        if self.emb_dim % self.nhead != 0:
            raise ValueError("entity_embedder.dim must be divisible by nhead")

        def init_w(shape):
            if init_for_load_only:
                return torch.empty(shape, dtype=torch.float32, device=device)
            return self.initialize(generator, shape).to(device)

        d = self.emb_dim
        for name in ("cls", "sub_type", "rel_type"):
            setattr(self, name, nn.Parameter(init_w((d,)),
                                             requires_grad=False))
        self.layers = nn.ModuleList(
            _EncoderLayer(d, self.ff_dim, init_w, device)
            for _ in range(self.num_layers))

    def _encoder(self, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        """Post-norm transformer encoder over x: [batch, seq, d]."""
        d, h = self.emb_dim, self.nhead
        dk = d // h
        if self.activation == "relu":
            act = torch.relu
        else:  # jax.nn.gelu's default is the tanh approximation
            act = lambda t: F.gelu(t, approximate="tanh")
        rate = self.dropout_rate

        def heads(t):  # [b, s, d] -> [b, h, s, dk]
            return t.reshape(t.shape[0], t.shape[1], h, dk).transpose(1, 2)

        for layer in self.layers:
            qkv = x @ layer.qkv_w.T + layer.qkv_b                 # [b, s, 3d]
            q, k, v = (heads(t) for t in torch.split(qkv, d, dim=-1))
            logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dk)
            attn = torch.softmax(logits, dim=-1)
            attn = ctx.dropout(attn, rate)
            out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
            out = out.transpose(1, 2).reshape(x.shape)
            out = out @ layer.out_w.T + layer.out_b
            x = _layer_norm(x + ctx.dropout(out, rate),
                            layer.ln1_scale, layer.ln1_bias)
            ff = act(x @ layer.lin1_w.T + layer.lin1_b)
            ff = ctx.dropout(ff, rate)
            ff = ff @ layer.lin2_w.T + layer.lin2_b
            x = _layer_norm(x + ctx.dropout(ff, rate),
                            layer.ln2_scale, layer.ln2_bias)
        return x

    def _cls_out(self, s_emb, p_emb, ctx: Ctx) -> torch.Tensor:
        """The transformed CLS embedding of each (s, p) row."""
        x = torch.stack([
            self.cls[None, :].expand(s_emb.shape),
            s_emb + self.sub_type[None, :],
            p_emb + self.rel_type[None, :],
        ], dim=1)                                                 # [b, 3, d]
        return self._encoder(x, ctx)[:, 0, :]

    # dot form: score = encoded-CLS . e_o with raw candidates; like ConvE
    # sp_-only, which the reciprocal wrapper uses for both ranking sides
    supports_dot_form = True
    dot_combines = ("sp_",)

    def query_vec(self, a_emb, p_emb, combine, ctx):
        if combine != "sp_":
            raise ValueError(
                "Transformer has no _po dot form (wrap in "
                "reciprocal_relations_model, which queries sp_ both ways)"
            )
        return self._cls_out(a_emb, p_emb, ctx)

    def candidate_vec(self, cand_emb, combine, ctx):
        return cand_emb

    def score_emb(self, s_emb, p_emb, o_emb, combine, ctx: Ctx):
        if combine not in ("sp_", "spo"):
            raise ValueError(
                f"combine {combine} not supported by Transformer")
        batch_size = s_emb.shape[0]
        out = self._cls_out(s_emb, p_emb, ctx)
        if combine == "sp_":
            out, o_emb = promoted(out, o_emb)
            out = out @ o_emb.T
        else:
            out = torch.sum(out * o_emb, dim=-1)
        return out.reshape(batch_size, -1)


class Transformer(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        self._init_configuration(config, configuration_key)
        super().__init__(
            config, dataset,
            TransformerScorer(config, dataset, self.configuration_key,
                              **kwargs),
            configuration_key=self.configuration_key, **kwargs,
        )

    def score_spo(self, s, p, o, direction=None, ctx=None):
        if direction == "o":
            return super().score_spo(s, p, o, direction, ctx)
        raise ValueError("Transformer can only score objects")
