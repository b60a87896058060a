"""Distance-based scorers: TransE, RotatE, TransH (counterpart of
``kge_tpu/models/translation.py``; reference math:
kge/model/{transe,rotate,transh}.py).

The pairwise combines materialize [n, m, d] difference tensors;
evaluation chunking bounds m. For L2 (TransE and RotatE with ``l_norm``
2) the scorers also expose a *monotone dot form*: ||q - c||^2 = ||q||^2 +
||c||^2 - 2 q.c, so ranking reduces to q~ . c~ with q~ = [2q, -1] and
c~ = [c, ||c||^2], which evaluation ranks through the rank-count kernel
with no [B, C, d] tensor (see ``RelationalScorer.dot_score_space`` for
the tie-tolerance caveat). TransH's candidate projection depends on the
query row's relation, so it has no shared candidate matrix and ranks
through the generic path; so does L1."""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from kge_tpu_torch.models.api import Ctx, KgeModel, RelationalScorer


def _lp_norm(x: torch.Tensor, p: float, dim: int) -> torch.Tensor:
    if p == 1.0:
        return torch.sum(x.abs(), dim=dim)
    if p == 2.0:
        # +1e-30 under the root, as in kge_tpu: a finite gradient at 0
        return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-30)
    return torch.sum(x.abs() ** p, dim=dim) ** (1.0 / p)


def _lp_norm_nonneg(x: torch.Tensor, p: float, dim: int) -> torch.Tensor:
    """Lp norm when inputs are known non-negative (skips abs for p=1)."""
    if p == 1.0:
        return torch.sum(x, dim=dim)
    return _lp_norm(x, p, dim)


def _l2_dot_query(q: torch.Tensor) -> torch.Tensor:
    """[2q, -1]: paired with _l2_dot_candidate this yields
    q~ . c~ = 2 q.c - ||c||^2 = ||q||^2 - ||q-c||^2, a per-row monotone
    transform of the negative L2 distance score."""
    return torch.cat([2.0 * q, -torch.ones_like(q[..., :1])], dim=-1)


def _l2_dot_candidate(c: torch.Tensor) -> torch.Tensor:
    """[c, ||c||^2]: the candidate side of the L2 expansion."""
    sq = torch.sum(c * c, dim=-1, keepdim=True)
    return torch.cat([c, sq], dim=-1)


class TransEScorer(RelationalScorer):
    """score = -||s + p - o||_p."""

    dot_score_space = "monotone"

    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        super().__init__(config, dataset, configuration_key, **kwargs)
        self._norm = float(self.get_option("l_norm"))

    @property
    def supports_dot_form(self) -> bool:
        return self._norm == 2.0

    def query_vec(self, a_emb, p_emb, combine, ctx):
        q = a_emb + p_emb if combine == "sp_" else a_emb - p_emb
        return _l2_dot_query(q)

    def candidate_vec(self, cand_emb, combine, ctx):
        return _l2_dot_candidate(cand_emb)

    def score_emb(self, s_emb, p_emb, o_emb, combine, ctx: Ctx):
        n = p_emb.shape[0]
        if combine == "spo":
            out = -_lp_norm(s_emb + p_emb - o_emb, self._norm, dim=1)
        elif combine == "sp_":
            out = -_lp_norm((s_emb + p_emb)[:, None, :] - o_emb[None, :, :],
                            self._norm, dim=2)
        elif combine == "_po":
            out = -_lp_norm((o_emb - p_emb)[:, None, :] - s_emb[None, :, :],
                            self._norm, dim=2)
        else:
            return self._generic_combine(s_emb, p_emb, o_emb, combine, ctx)
        return out.reshape(n, -1)


class TransE(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        super().__init__(config, dataset, TransEScorer,
                         configuration_key=configuration_key, **kwargs)

    def prepare_job(self, job, **kwargs):
        super().prepare_job(job, **kwargs)
        # batchwise negative scoring of TransE materializes large
        # difference tensors; prefer triple-wise (reference: transe.py:57-69)
        if (job.config.get("train.type") == "negative_sampling"
                and job.config.get("negative_sampling.implementation")
                == "auto"):
            job.config.set("negative_sampling.implementation", "triple",
                           log=True)


class RotatEScorer(RelationalScorer):
    """Relations are per-dimension rotations on the complex plane:
    score = -||s*p - o||, with the conjugate trick for _po."""

    dot_score_space = "monotone"

    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        super().__init__(config, dataset, configuration_key, **kwargs)
        self._norm = float(self.get_option("l_norm"))

    @property
    def supports_dot_form(self) -> bool:
        # the per-dim complex modulus collapses into one euclidean norm
        # over the stored [re || im] layout only for l_norm = 2
        return self._norm == 2.0

    def query_vec(self, a_emb, p_emb, combine, ctx):
        half = a_emb.shape[-1] // 2
        a_re, a_im = a_emb[..., :half], a_emb[..., half:]
        p_re, p_im = torch.cos(p_emb), torch.sin(p_emb)
        if combine == "sp_":
            q_re = a_re * p_re - a_im * p_im
            q_im = a_re * p_im + a_im * p_re
        else:  # "_po": || s*p - o || = || s - conj(p)*o ||
            q_re = p_re * a_re + p_im * a_im
            q_im = p_re * a_im - p_im * a_re
        return _l2_dot_query(torch.cat([q_re, q_im], dim=-1))

    def candidate_vec(self, cand_emb, combine, ctx):
        return _l2_dot_candidate(cand_emb)

    def score_emb(self, s_emb, p_emb, o_emb, combine, ctx: Ctx):
        n = p_emb.shape[0]
        half = s_emb.shape[1] // 2
        s_re, s_im = s_emb[:, :half], s_emb[:, half:]
        o_re, o_im = o_emb[:, :half], o_emb[:, half:]
        p_re, p_im = torch.cos(p_emb), torch.sin(p_emb)
        if combine == "spo":
            sp_re = s_re * p_re - s_im * p_im
            sp_im = s_re * p_im + s_im * p_re
            diff_abs = torch.sqrt((sp_re - o_re) ** 2 + (sp_im - o_im) ** 2)
            out = -_lp_norm_nonneg(diff_abs, self._norm, dim=1)
        elif combine == "sp_":
            sp_re = s_re * p_re - s_im * p_im
            sp_im = s_re * p_im + s_im * p_re
            d_re = sp_re[:, None, :] - o_re[None, :, :]
            d_im = sp_im[:, None, :] - o_im[None, :, :]
            out = -_lp_norm_nonneg(torch.sqrt(d_re ** 2 + d_im ** 2),
                                   self._norm, dim=2)
        elif combine == "_po":
            # || s*p - o || = || s - conj(p)*o || for unit rotations p
            po_re = p_re * o_re + p_im * o_im
            po_im = p_re * o_im - p_im * o_re
            d_re = po_re[:, None, :] - s_re[None, :, :]
            d_im = po_im[:, None, :] - s_im[None, :, :]
            out = -_lp_norm_nonneg(torch.sqrt(d_re ** 2 + d_im ** 2),
                                   self._norm, dim=2)
        else:
            return self._generic_combine(s_emb, p_emb, o_emb, combine, ctx)
        return out.reshape(n, -1)


class RotatE(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        self._init_configuration(config, configuration_key)
        if self.get_option("entity_embedder.dim") % 2 != 0:
            raise ValueError("RotatE requires even entity embedding dimension")
        if self.get_option("relation_embedder.dim") < 0:
            self.set_option(
                "relation_embedder.dim",
                self.get_option("entity_embedder.dim") // 2,
                create=True, log=True,
            )
        super().__init__(config, dataset, RotatEScorer,
                         configuration_key=self.configuration_key, **kwargs)
        self._normalize_phases = self.get_option("normalize_phases")

    @torch.no_grad()
    def normalize_params(self):
        super().normalize_params()
        if self._normalize_phases:
            # wrap relation phases into [-pi, pi) without changing scores
            # (jnp.remainder and torch.remainder both take the sign of
            # the divisor)
            phases = self.get_p_embedder().weights
            phases.copy_(torch.remainder(phases + math.pi, 2.0 * math.pi)
                         - math.pi)


class TransHScorer(RelationalScorer):
    """TransE on a per-relation hyperplane: entities are projected onto
    the plane with normal w_p before translation."""

    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        super().__init__(config, dataset, configuration_key, **kwargs)
        self._norm = float(self.get_option("l_norm"))

    @staticmethod
    def _transfer(ent: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
        normal = normal / torch.clamp(
            torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-12
        )
        return ent - torch.sum(ent * normal, dim=-1, keepdim=True) * normal

    def score_emb(self, s_emb, p_emb, o_emb, combine, ctx: Ctx):
        n = p_emb.shape[0]
        half = p_emb.shape[1] // 2
        rel, normal = p_emb[:, :half], p_emb[:, half:]
        if combine == "spo":
            out = -_lp_norm(
                self._transfer(s_emb, normal) + rel
                - self._transfer(o_emb, normal),
                self._norm, dim=1,
            )
        elif combine == "sp_":
            s_t = self._transfer(s_emb, normal) + rel                  # [n, d]
            o_t = self._transfer(o_emb[None, :, :], normal[:, None, :])
            out = -_lp_norm(s_t[:, None, :] - o_t, self._norm, dim=2)
        elif combine == "_po":
            o_t = self._transfer(o_emb, normal) - rel                  # [n, d]
            s_t = self._transfer(s_emb[None, :, :], normal[:, None, :])
            out = -_lp_norm(o_t[:, None, :] - s_t, self._norm, dim=2)
        else:
            return self._generic_combine(s_emb, p_emb, o_emb, combine, ctx)
        return out.reshape(n, -1)


class TransH(KgeModel):
    def __init__(self, config, dataset, configuration_key=None, **kwargs):
        self._init_configuration(config, configuration_key)
        # relation embedding holds [translation || hyperplane normal]
        dim = config.get_default(
            self.configuration_key + ".relation_embedder.dim")
        if dim < 0:
            ent_dim = config.get_default(
                self.configuration_key + ".entity_embedder.dim"
            )
            config.set(
                self.configuration_key + ".relation_embedder.dim",
                ent_dim * 2, create=True, log=True,
            )
        super().__init__(config, dataset, TransHScorer,
                         configuration_key=self.configuration_key, **kwargs)
        self.soft_constraint_weight = float(self.get_option("C"))

    def penalties(self, ctx: Ctx, batch=None, **kwargs
                  ) -> List[Tuple[str, torch.Tensor]]:
        """The embedders' penalties and, with ``C`` > 0, TransH's
        soft constraints over the whole tables."""
        result = super().penalties(ctx, batch=batch, **kwargs)
        if self.soft_constraint_weight > 0.0:
            ent = self.get_s_embedder().embed_all(ctx)
            zero = torch.zeros((), device=ent.device)
            # torch.maximum splits a tie's gradient, as jnp.maximum does
            p_ent = torch.sum(torch.maximum(
                torch.sum(ent * ent, dim=1) - 1.0, zero))
            rel_all = self.get_p_embedder().embed_all(ctx)
            half = rel_all.shape[1] // 2
            rel, normal = rel_all[:, :half], rel_all[:, half:]
            eps = 1e-6
            ratio = torch.sum(rel * normal, dim=-1) / (
                torch.linalg.vector_norm(rel, dim=1) + eps
            )
            p_rel = torch.sum(torch.maximum(ratio ** 2 - eps ** 2, zero))
            result += [
                ("transh.soft_constraints_ent",
                 self.soft_constraint_weight * p_ent),
                ("transh.soft_constraints_rel",
                 self.soft_constraint_weight * p_rel),
            ]
        return result
