"""Bilinear / factorization scorers: ComplEx, DistMult, CP, SimplE,
RESCAL, RelationalTucker3 (counterpart of
``kge_tpu/models/factorization.py``; reference scorer math:
kge/model/{complex,distmult,cp,simple,rescal,relational_tucker3}.py).

The ``sp_``/``_po`` combines are one [n, d] x [d, m] matmul; the other
combines take the generic cross-product form
(``RelationalScorer._generic_combine``)."""

from __future__ import annotations

import torch

from kge_tpu_torch.models.api import Ctx, KgeModel, RelationalScorer, promoted
from kge_tpu_torch.models.embedder.projection import (
    rescal_set_relation_embedder_dim,
)


class DistMultScorer(RelationalScorer):
    """score = <s, p, o> (ternary dot product)."""

    supports_dot_form = True

    def query_vec(self, a_emb, p_emb, combine, ctx):
        return a_emb * p_emb

    def candidate_vec(self, cand_emb, combine, ctx):
        return cand_emb

    def score_emb(self, s_emb, p_emb, o_emb, combine, ctx: Ctx):
        n = p_emb.shape[0]
        if combine == "spo":
            out = torch.sum(s_emb * p_emb * o_emb, dim=1)
        elif combine == "sp_":
            out = (s_emb * p_emb) @ o_emb.T
        elif combine == "_po":
            out = (o_emb * p_emb) @ s_emb.T
        else:
            return self._generic_combine(s_emb, p_emb, o_emb, combine, ctx)
        return out.reshape(n, -1)


class ComplExScorer(RelationalScorer):
    """ComplEx via the Hadamard column-block trick (Trouillon et al. 2016,
    Eq. 11): stack (re, im, re, im) blocks so the score is one real
    elementwise product + reduction/matmul."""

    supports_dot_form = True

    def query_vec(self, a_emb, p_emb, combine, ctx):
        # fold the complex product into the QUERY so candidates stay the
        # RAW [C, d] embedding rows: score = Re((s.p) conj(e)) =
        # [q_re || q_im] . [e_re || e_im]
        half = a_emb.shape[1] // 2
        a_re, a_im = a_emb[:, :half], a_emb[:, half:]
        p_re, p_im = p_emb[:, :half], p_emb[:, half:]
        if combine == "sp_":
            q_re = a_re * p_re - a_im * p_im
            q_im = a_re * p_im + a_im * p_re
        else:  # "_po": candidates are subjects; a_emb is o
            q_re = p_re * a_re + p_im * a_im
            q_im = p_re * a_im - p_im * a_re
        return torch.cat([q_re, q_im], dim=1)

    def candidate_vec(self, cand_emb, combine, ctx):
        return cand_emb

    def score_emb(self, s_emb, p_emb, o_emb, combine, ctx: Ctx):
        n = p_emb.shape[0]
        half = p_emb.shape[1] // 2
        p_re, p_im = p_emb[:, :half], p_emb[:, half:]
        o_re, o_im = o_emb[:, :half], o_emb[:, half:]
        s_all = torch.cat([s_emb, s_emb], dim=1)          # re im re im
        r_all = torch.cat([p_re, p_emb, -p_im], dim=1)    # re re im -im
        o_all = torch.cat([o_emb, o_im, o_re], dim=1)     # re im im re
        if combine == "spo":
            out = torch.sum(s_all * o_all * r_all, dim=1)
        elif combine == "sp_":
            out = (s_all * r_all) @ o_all.T
        elif combine == "_po":
            out = (r_all * o_all) @ s_all.T
        elif combine == "s_o":
            # one column per relation: score(s_i, p_j, o_i)
            out = (s_all * o_all) @ r_all.T
            n = s_emb.shape[0]
        else:
            raise ValueError(f"cannot handle combine={combine!r}")
        return out.reshape(n, -1)


class CPScorer(RelationalScorer):
    """Canonical Polyadic: subject uses the first embedding half, object
    the second."""

    supports_dot_form = True

    def query_vec(self, a_emb, p_emb, combine, ctx):
        half = a_emb.shape[1] // 2
        if combine == "sp_":
            return a_emb[:, :half] * p_emb
        return a_emb[:, half:] * p_emb

    def candidate_vec(self, cand_emb, combine, ctx):
        half = cand_emb.shape[-1] // 2
        if combine == "sp_":
            return cand_emb[..., half:]
        return cand_emb[..., :half]

    def score_emb(self, s_emb, p_emb, o_emb, combine, ctx: Ctx):
        n = p_emb.shape[0]
        half = s_emb.shape[1] // 2
        s_h = s_emb[:, :half]
        o_t = o_emb[:, half:]
        if combine == "spo":
            out = torch.sum(s_h * p_emb * o_t, dim=1)
        elif combine == "sp_":
            out = (s_h * p_emb) @ o_t.T
        elif combine == "_po":
            out = (o_t * p_emb) @ s_h.T
        else:
            return self._generic_combine(s_emb, p_emb, o_emb, combine, ctx)
        return out.reshape(n, -1)


class SimplEScorer(RelationalScorer):
    """SimplE: average of forward (head-half) and backward (tail-half)
    CP scores."""

    supports_dot_form = True

    def query_vec(self, a_emb, p_emb, combine, ctx):
        half = a_emb.shape[1] // 2
        a_h, a_t = a_emb[:, :half], a_emb[:, half:]
        p_f, p_b = p_emb[:, :half], p_emb[:, half:]
        if combine == "sp_":
            return torch.cat([a_h * p_f, a_t * p_b], dim=1) / 2.0
        return torch.cat([a_t * p_f, a_h * p_b], dim=1) / 2.0

    def candidate_vec(self, cand_emb, combine, ctx):
        half = cand_emb.shape[-1] // 2
        c_h, c_t = cand_emb[..., :half], cand_emb[..., half:]
        if combine == "sp_":
            return torch.cat([c_t, c_h], dim=-1)
        return torch.cat([c_h, c_t], dim=-1)

    def score_emb(self, s_emb, p_emb, o_emb, combine, ctx: Ctx):
        n = p_emb.shape[0]
        half = s_emb.shape[1] // 2
        s_h, s_t = s_emb[:, :half], s_emb[:, half:]
        p_f, p_b = p_emb[:, :half], p_emb[:, half:]
        o_h, o_t = o_emb[:, :half], o_emb[:, half:]
        if combine == "spo":
            out1 = torch.sum(s_h * p_f * o_t, dim=1)
            out2 = torch.sum(s_t * p_b * o_h, dim=1)
        elif combine == "sp_":
            out1 = (s_h * p_f) @ o_t.T
            out2 = (s_t * p_b) @ o_h.T
        elif combine == "_po":
            out1 = (o_t * p_f) @ s_h.T
            out2 = (o_h * p_b) @ s_t.T
        else:
            return self._generic_combine(s_emb, p_emb, o_emb, combine, ctx)
        return ((out1 + out2) / 2.0).reshape(n, -1)


class RescalScorer(RelationalScorer):
    """score = s^T M_p o with per-relation mixing matrix M_p."""

    supports_dot_form = True

    def query_vec(self, a_emb, p_emb, combine, ctx):
        # RelationalTucker3's projected relations are float32 while bf16
        # entities (tpu.compute_dtype) meet them: jnp's promotion
        a_emb, p_emb = promoted(a_emb, p_emb)
        dim = a_emb.shape[-1]
        p_mix = p_emb.reshape(-1, dim, dim)
        if combine == "sp_":
            return torch.einsum("nd,nde->ne", a_emb, p_mix)
        return torch.einsum("nde,ne->nd", p_mix, a_emb)

    def candidate_vec(self, cand_emb, combine, ctx):
        return cand_emb

    def score_emb(self, s_emb, p_emb, o_emb, combine, ctx: Ctx):
        n = p_emb.shape[0]
        dim = s_emb.shape[-1]
        s_emb, p_emb, o_emb = promoted(s_emb, p_emb, o_emb)
        p_mix = p_emb.reshape(-1, dim, dim)
        if combine == "spo":
            out = torch.sum(
                torch.einsum("nd,nde->ne", s_emb, p_mix) * o_emb, dim=-1)
        elif combine == "sp_":
            out = torch.einsum("nd,nde->ne", s_emb, p_mix) @ o_emb.T
        elif combine == "_po":
            out = torch.einsum("nde,ne->nd", p_mix, o_emb) @ s_emb.T
        else:
            return self._generic_combine(s_emb, p_emb, o_emb, combine, ctx)
        return out.reshape(n, -1)


class DistMult(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        super().__init__(config, dataset, DistMultScorer,
                         configuration_key=configuration_key, **kwargs)


class ComplEx(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        super().__init__(config, dataset, ComplExScorer,
                         configuration_key=configuration_key, **kwargs)


class CP(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        self._init_configuration(config, configuration_key)
        if self.get_option("entity_embedder.dim") % 2 != 0:
            raise ValueError("CP requires even entity embedding dimension")
        if self.get_option("relation_embedder.dim") < 0:
            self.set_option(
                "relation_embedder.dim",
                self.get_option("entity_embedder.dim") // 2,
                create=True, log=True,
            )
        super().__init__(config, dataset, CPScorer,
                         configuration_key=self.configuration_key, **kwargs)


class SimplE(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        self._init_configuration(config, configuration_key)
        if self.get_option("entity_embedder.dim") % 2 != 0:
            raise ValueError("SimplE requires even entity embedding dimension")
        super().__init__(config, dataset, SimplEScorer,
                         configuration_key=self.configuration_key, **kwargs)


class Rescal(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        self._init_configuration(config, configuration_key)
        rescal_set_relation_embedder_dim(
            config, dataset, self.configuration_key + ".relation_embedder"
        )
        super().__init__(config, dataset, RescalScorer,
                         configuration_key=self.configuration_key, **kwargs)


class RelationalTucker3(KgeModel):
    """RESCAL scorer over a Tucker3-projected relation embedder
    (reference: kge/model/relational_tucker3.py)."""

    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        self._init_configuration(config, configuration_key)
        # the tucker3 relation embedder expands its dim to entity_dim^2
        super().__init__(config, dataset, RescalScorer,
                         configuration_key=self.configuration_key, **kwargs)
