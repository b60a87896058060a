"""Bilinear / factorization scorers (counterpart of
``kge_tpu/models/factorization.py``). ComplEx only so far.

The ``sp_``/``_po`` combines are one [n, d] x [d, m] matmul (reference
scorer math: kge/model/complex.py)."""

from __future__ import annotations

import torch

from kge_tpu_torch.models.api import Ctx, KgeModel, RelationalScorer


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


class ComplEx(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        super().__init__(config, dataset, ComplExScorer,
                         configuration_key=configuration_key, **kwargs)
