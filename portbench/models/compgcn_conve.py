"""Plain reference of CompGCN (Vashishth et al. 2020, arXiv:1911.03082)
in front of a reciprocal ConvE decoder (Dettmers et al. 2018,
arXiv:1707.01476), as ``examples/recipes/fb15k237-compgcn.yaml`` sets it:
one message-passing layer over the whole training graph with direction
propagation (in, out and self-loop weights, each mode's aggregate over
3), ``ccorr`` composition, the symmetric degree norm, batch norm with a
scale and a bias, tanh, and a linear relation transform; KvsAll with
label smoothing and the summed binary cross entropy; Adam.

Departures from the paper that the recipe's reference (LibKGE's R-GNN
fork) makes and this file follows: ``ccorr`` keeps the lower half of the
spectrum only (the fork inverts ``rfft`` through the deprecated
``torch.irfft`` port, which cuts the spectrum to ``n // 2 + 1`` bins a
second time); the degree norm of an edge reads both ends' degrees as
aggregation nodes of its mode (a node that is never one gets weight 0);
ConvE's input is the last ``dim`` entries of a ``dim + 1`` embedding whose
first entry is the candidate's bias. The reference draws each dropout
mask itself, at the configuration's rate, from the state the program's
dropout generator held at that site (a uniform below the keep rate, the
law ``kge_tpu`` draws by), and applies it where the published model
applies dropout.

Plain torch and numpy, float32, no kernel of the program."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from models.common import Products, adam

#: per step, the dropout sites in the order the published model applies
#: them (in-mode aggregate, out-mode aggregate, the entity
#: output, ConvE's feature maps, ConvE's projection)
MASK_SITES = ("prop_in", "prop_out", "entity", "feature_map", "projection")


class Model:
    """The recipe's sizes and rates; ``params`` by the leaf names of the
    benchmark's weights."""

    def __init__(self, triples: np.ndarray, num_entities: int,
                 num_relations: int, rates: Dict[str, float],
                 height: int = 10, width: int = 20, channels: int = 32,
                 label_smoothing: float = 0.1, lr: float = 0.001):
        self.N, self.R = num_entities, num_relations
        self.rates = rates
        self.height, self.width, self.channels = height, width, channels
        self.label_smoothing = label_smoothing
        self.lr = lr
        self.triples = triples
        self.device = None

    def to(self, device):
        """The graph's edges and norms on ``device``."""
        self.device = device
        t = torch.as_tensor(self.triples, dtype=torch.int64, device=device)
        s, p, o = t[:, 0], t[:, 1], t[:, 2]
        N = self.N
        self.modes = []
        for agg, nbr, typ in ((s, o, p), (o, s, p + self.R)):
            deg = torch.bincount(agg, minlength=N).to(torch.float32)
            inv = torch.where(deg > 0, deg.clamp(min=1).rsqrt(),
                              torch.zeros_like(deg))
            self.modes.append((agg, nbr, typ, inv[agg] * inv[nbr]))
        return self

    # ----------------------------------------------------------- encoder

    @staticmethod
    def ccorr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        n = a.shape[-1]
        spec = torch.conj(torch.fft.rfft(a, dim=-1)) * torch.fft.rfft(b, dim=-1)
        keep = spec.shape[-1] // 2 + 1
        spec = torch.cat([spec[..., :keep],
                          torch.zeros_like(spec[..., keep:])], dim=-1)
        return torch.fft.irfft(spec, n=n, dim=-1)

    def masks(self, draws: List[Dict]) -> Dict[str, torch.Tensor]:
        """A step's dropout masks by site: at each, a uniform of the site's
        shape from the generator state recorded there, kept where below
        ``1 - rate``."""
        out = {}
        for site, d in zip(MASK_SITES, draws):
            gen = torch.Generator(device=d["device"])
            gen.set_state(d["state"])
            u = torch.rand(d["shape"], generator=gen, dtype=d["dtype"],
                           device=d["device"])
            out[site] = u < 1.0 - self.rates[site]
        return out

    def _drop(self, x, mask, site):
        if mask is None:
            return x
        keep = 1.0 - self.rates[site]
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def encode(self, P, ops: Products, masks: Dict, block: int = 1 << 17):
        """(entities [N, d + 1], relations [2R, d + 1]) in training: batch
        statistics, dropout where ``masks`` has a mask."""
        N, R = self.N, self.R
        layer = "encoder.layers.0."
        x = P["entity_embedder.weights"][:N]
        r = P["relation_embedder.weights"][:2 * R]
        loop = P[layer + "loop_rel"]
        r_full = torch.cat([r, loop], dim=0)
        out = None
        for (agg, nbr, typ, norm), site, w in zip(
                self.modes, ("prop_in", "prop_out"), ("w_in_h0", "w_out_h0")):
            acc = torch.zeros(N, P[layer + w].shape[1], device=x.device)
            for lo in range(0, agg.shape[0], block):
                sl = slice(lo, lo + block)
                msg = ops.mm(self.ccorr(x[nbr[sl]], r_full[typ[sl]]),
                             P[layer + w]) * norm[sl, None]
                acc = acc.index_add(0, agg[sl], msg)
            acc = self._drop(acc, masks.get(site), site) / 3.0
            out = acc if out is None else out + acc
        out = out + ops.mm(self.ccorr(x, loop), P[layer + "w_loop_h0"]) / 3.0
        mean = out.mean(dim=0)
        var = out.var(dim=0, correction=0)
        out = ((out - mean) / torch.sqrt(var + 1e-5) * P[layer + "bn_scale"]
               + P[layer + "bn_bias"])
        x = self._drop(torch.tanh(out), masks.get("entity"), "entity")
        rel = ops.mm(r_full, P[layer + "w_rel"])[:-1]
        return x, rel

    # ----------------------------------------------------------- decoder

    def features(self, P, s_emb, p_emb, ops: Products,
                 masks: Dict) -> torch.Tensor:
        """ConvE's hidden vector of each (subject, relation) pair."""
        B, h, w = s_emb.shape[0], self.height, self.width
        stacked = torch.cat([s_emb[:, 1:].reshape(B, 1, h, w),
                             p_emb[:, 1:].reshape(B, 1, h, w)], dim=2)
        out = ops.conv2d(stacked, P["scorer.conv_w"])
        out = out + P["scorer.conv_b"][None, :, None, None]
        out = self._bn(out, (0, 2, 3))
        out = self._drop(torch.relu(out), masks.get("feature_map"),
                         "feature_map")
        out = ops.mm(out.reshape(B, -1), P["scorer.proj_w"].T) + P["scorer.proj_b"]
        out = self._drop(out, masks.get("projection"), "projection")
        out = self._bn(out, (0,))
        return torch.relu(out)

    @staticmethod
    def _bn(x, axes):
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, correction=0, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5)

    def scores(self, P, x, rel, heads, rels, ops, masks):
        """[B, N] scores of (head, relation, every entity); a (?, p, o)
        query is (o, p + R, ?) of the reciprocal relation."""
        feats = self.features(P, x[heads], rel[rels], ops, masks)
        return ops.mm(feats, x[:, 1:].T) + x[:, 0]

    # ----------------------------------------------------------- training

    def labels(self, queries: np.ndarray, side: str) -> torch.Tensor:
        """[B, N] 0/1 answers of each query in the training split: the
        objects of (s, p, ?) or the subjects of (?, p, o)."""
        t = self.triples
        if side == "sp":
            keys, vals = t[:, 0] * self.R + t[:, 1], t[:, 2]
            q = queries[:, 0] * self.R + queries[:, 1]
        else:
            keys, vals = t[:, 2] * self.R + t[:, 1], t[:, 0]
            q = queries[:, 1] * self.R + queries[:, 0]
        order = np.argsort(keys, kind="stable")
        keys, vals = keys[order], vals[order]
        lo = np.searchsorted(keys, q, side="left")
        hi = np.searchsorted(keys, q, side="right")
        out = np.zeros((len(q), self.N), dtype=np.float32)
        for i in range(len(q)):
            np.add.at(out[i], vals[lo[i]:hi[i]], 1.0)
        return torch.as_tensor(out, device=self.device)

    def step_loss(self, P, step: Dict, ops: Products) -> torch.Tensor:
        """KvsAll's loss of one batch: the smoothed bce summed over the
        real rows' N labels, over the batch's true size."""
        masks = self.masks(step["draws"])
        x, rel = self.encode(P, ops, masks)
        q = torch.as_tensor(step["queries"], dtype=torch.int64,
                            device=self.device)
        if step["side"] == "sp":
            scores = self.scores(P, x, rel, q[:, 0], q[:, 1], ops, masks)
        else:
            scores = self.scores(P, x, rel, q[:, 1], q[:, 0] + self.R, ops,
                                 masks)
        y = self.labels(step["queries"], step["side"])
        y = (1.0 - self.label_smoothing) * y + 1.0 / self.N
        bce = (torch.clamp(scores, min=0) - scores * y
               + torch.log1p(torch.exp(-scores.abs())))
        w = torch.as_tensor(step["weights"], dtype=torch.float32,
                            device=self.device)
        return (bce * w[:, None]).sum() / float(step["size"])

    def input_faults(self, steps: List[Dict]) -> Optional[int]:
        """Real queries without an answer in the training split (KvsAll
        draws its queries from the split's answer sets)."""
        faults = 0
        for step in steps:
            real = step["weights"] > 0
            y = self.labels(step["queries"][real], step["side"])
            faults += int((y.sum(1) == 0).sum())
        return faults

    def train(self, params0: Dict[str, torch.Tensor], steps: List[Dict],
              ops: Products):
        """Follow ``steps`` from ``params0``: each step's loss, the first
        step's gradient of every leaf, the leaves after the first step and
        after the last."""
        P = {k: v.detach().clone() for k, v in params0.items()}
        state: Dict = {}
        losses, first, after_first = [], None, None
        for i, step in enumerate(steps):
            leaves = {k: v.requires_grad_() for k, v in P.items()}
            loss = self.step_loss(leaves, step, ops)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()), allow_unused=True)))
            grads = {k: g for k, g in grads.items() if g is not None}
            P = {k: v.detach() for k, v in leaves.items()}
            if first is None:
                first = grads
            losses.append(float(loss.detach()))
            with torch.no_grad():
                adam(P, grads, state, i + 1, self.lr)
            if after_first is None:
                after_first = {k: v.clone() for k, v in P.items()}
        return losses, first, after_first, P


def build(config: Dict, splits: Dict[str, np.ndarray]) -> Model:
    """The reference of a configuration file (its ``graph`` sizes and its
    ``reference`` settings) over the benchmark's splits."""
    ref, graph = config["reference"], config["graph"]
    return Model(splits["train"], graph["entities"], graph["relations"],
                 rates=ref["dropout"], lr=ref["lr"],
                 label_smoothing=ref["label_smoothing"])


def reference_steps(record) -> List[Dict]:
    """The check steps as the reference takes them: each host batch's
    queries, row weights and true size, its side, and the generator's
    state at each of its dropout sites (five, in the published model's
    order)."""
    steps = []
    for batch, draws in zip(record.batches, record.draws):
        if len(draws) != len(MASK_SITES):
            raise ValueError(f"a step drew {len(draws)} dropout masks, the "
                             f"model has {len(MASK_SITES)} dropout sites")
        steps.append(dict(
            queries=batch["queries"].astype(np.int64),
            weights=batch["weights"].astype(np.float32),
            size=float(batch["size"]),
            side="sp" if "qtype_sp" in batch else "po",
            draws=draws))
    return steps


# ------------------------------------------------------------- FLOPs


def fft_flops(n: int) -> float:
    """A real FFT of length n: 2.5 n log2 n (half of a complex one's
    5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def ccorr_bins(d: int) -> int:
    """The spectrum bins ``ccorr`` keeps of a width ``d``: the lower half
    of ``rfft``'s ``d // 2 + 1``, plus one (``Model.ccorr``)."""
    return (d // 2 + 1) // 2 + 1


def encoder_flops(N: int, R: int, edges: int, d_in: int, d_out: int) -> float:
    """One forward of the layer, as the least work its math needs,
    whichever route the program takes: the real FFTs of the node table
    and of the 2R + 1 relation rows (with the self-loop's); per edge and
    per self-loop the complex product over the bins ``ccorr`` keeps and
    its addition into the node's sum (8 operations a bin; each edge's
    norm is a product of a node factor on either side, so it needs no
    operation of the edge's own); per node and mode (in, out, self-loop)
    one inverse FFT and a [d_in, d_out] product; the relation transform;
    the sums, norm and activation (a few operations per output entry)."""
    fft = fft_flops(d_in)
    return ((N + 2 * R + 1) * fft
            + (edges + N) * 8 * ccorr_bins(d_in)
            + 3 * N * (fft + 2 * d_in * d_out)
            + 2 * (2 * R + 1) * d_in * d_out + 10 * N * d_out)


def conve_flops(B: int, C: int, h: int, w: int, channels: int, d: int,
                filt: int = 3) -> float:
    """ConvE's features of B queries and their scores against C
    candidates: the 3x3 convolution, the projection, the candidate
    products."""
    oh, ow = 2 * h - filt + 1, w - filt + 1
    conv = 2 * B * channels * oh * ow * filt * filt
    proj = 2 * B * channels * oh * ow * d
    return conv + proj + 2 * B * d * C


def train_step_flops(config: Dict, batch: int, d: int = 200,
                     height: int = 10, width: int = 20) -> float:
    """A KvsAll step: the encoder over the whole graph and the decoder over
    the batch against every entity, forward, and twice that backward."""
    sizes = config["graph"]
    N, R = sizes["entities"], sizes["relations"]
    edges = 2 * sizes["splits"]["train"]
    forward = (encoder_flops(N, R, edges, d, d + 1)
               + conve_flops(batch, N, height, width, 32, d))
    return 3.0 * forward

