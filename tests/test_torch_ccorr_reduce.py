"""The spectral route of the port's ccorr messages
(kge_tpu_torch/ops/ccorr_reduce.py, ``MessagePassingLayer.spectral``).

- A CompGCN layer with ``ccorr`` or ``ccorr_true`` on the spectral route
  gives the per-edge route's outputs and every parameter's gradient, for
  each propagation it takes, with and without the edge norm, with edge,
  self-edge and propagation dropout on (one generator seed for both
  routes: the same masks), at widths whose kept bins are odd (a padding
  bin) and even. Tolerances: float32 sums in another order (the sum over
  a node's edges taken before the inverse FFT and the weight).
- The orders the kernel reads (``build_orders``): every edge once, grouped
  by its output row, each row's run cut into pieces of at most
  ``PIECE_EDGES`` edges, on a graph with a hub node and a dominant
  relation.
- The plain version's backward equals autograd through the per-edge
  formula.
- The layers the route leaves alone (a message weight, attention, a
  learned relation weight, per-relation weights) do not take it: no
  orders are built, nothing of the route runs, and their outputs and
  gradients are bit-equal with the route's functions made to raise.
- On a CUDA card (``cuda`` marker): the kernel against its plain version
  at FB15k-237's sizes on a Zipf-skewed graph with a node of at least
  5,000 edges and a relation of at least a tenth of the edges, forward and
  both backward reductions, against float64; two calls bit-identical; one
  launch counted a call; the hub's and the big relation's rows summed by
  the second pass's blocks for heavy rows.

This file imports no JAX: its ``cuda`` test runs on the card's machine.
"""

import os

import numpy as np
import pytest
import torch

from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.models import Ctx, KgeModel
from kge_tpu_torch.models.rgnn import layers as rgnn_layers
from kge_tpu_torch.ops import ccorr_reduce as cr
from kge_tpu_torch.ops.segment import ccorr, ccorr_true

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(REPO, "data", "toy")
CPU = torch.device("cpu")
#: the encoder's outputs: float32 sums of a few dozen terms a node
TOL = dict(rtol=1e-5, atol=1e-5)
#: gradients: sums over every edge of the toy graph
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

DROPOUT = {"edge_dropout": 0.2, "self_edge_dropout": 0.1,
           "emb_entity_dropout": 0.1,
           "message_passing_args.emb_propagation_dropout": 0.3}


def build(preset, encoder, dim=8, seed=2):
    config = Config()
    config.set("model", preset)
    config._import(preset)
    config.set("job.device", "cpu")
    config.set("dataset.name", "toy")
    config.set("console.quiet", True)
    for key in ("entity_embedder", "relation_embedder"):
        config.set(f"{preset}.{key}.dim", dim, create=True)
    config.set(f"{preset}.decoder.model", "distmult")
    config.set(f"{preset}.decoder.type", "distmult")
    for key, value in {**DROPOUT, **encoder}.items():
        config.set(f"{preset}.encoder.{key}", value, create=True)
    model = KgeModel.create(config, Dataset.create(config, TOY), device=CPU,
                            generator=torch.Generator().manual_seed(seed))
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def encode_and_grads(model, seed=0):
    """The encoder's training forward (dropout drawn from ``seed``) and
    the gradient of a fixed projection of its outputs for every
    parameter."""
    model.zero_grad(set_to_none=True)
    ctx = Ctx(train=True, generator=torch.Generator().manual_seed(seed),
              state=model.model_state)
    x, r = model.encoder.encode(ctx)
    g = torch.Generator().manual_seed(1)
    wx, wr = (torch.randn(t.shape, generator=g) for t in (x, r))
    (torch.sum(x * wx) + torch.sum(r * wr)).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return x.detach(), r.detach(), grads, ctx.updates


def spy(monkeypatch):
    """Counts the route's autograd applications and wrapper calls."""
    calls = {"apply": 0, "reduce": 0}
    apply, reduce = cr.CcorrReduce.apply, cr.ccorr_reduce

    def counted_apply(*args):
        calls["apply"] += 1
        return apply(*args)

    def counted_reduce(*args, **kwargs):
        calls["reduce"] += 1
        return reduce(*args, **kwargs)

    monkeypatch.setattr(cr.CcorrReduce, "apply", staticmethod(counted_apply))
    monkeypatch.setattr(cr, "ccorr_reduce", counted_reduce)
    return calls


#: propagation -> the spectral reduces of one forward (one an edge mode)
PROPAGATIONS = {"direction": 2, "single": 1,
                "single_with_self_edge_weight": 1}


@pytest.mark.parametrize("dim", [8, 10])
@pytest.mark.parametrize("edge_norm", [True, False])
@pytest.mark.parametrize("propagation", list(PROPAGATIONS))
@pytest.mark.parametrize("composition", ["ccorr", "ccorr_true"])
def test_spectral_route_equals_per_edge_route(composition, propagation,
                                              edge_norm, dim, monkeypatch):
    model = build("compgcn", {
        "num_layers": 2, "message_passing_args.composition": composition,
        "message_passing_args.propagation": propagation,
        "message_passing_args.edge_norm": edge_norm}, dim=dim)
    layers = model.encoder.rgnn.layers
    assert all(layer.spectral for layer in layers)
    graph = model.encoder.graph()
    assert set(graph["spectral"]) == set(model.encoder.rgnn.spectral_sets)
    calls = spy(monkeypatch)
    x, r, grads, updates = encode_and_grads(model)
    reduces = PROPAGATIONS[propagation] * len(layers)
    # a forward a reduce, the backward two (by neighbour, by relation)
    assert calls == {"apply": reduces, "reduce": 3 * reduces}
    for layer in layers:
        layer.spectral = False
    x0, r0, grads0, updates0 = encode_and_grads(model)
    assert calls["apply"] == reduces  # the per-edge route: none
    torch.testing.assert_close(x, x0, **TOL)
    torch.testing.assert_close(r, r0, **TOL)
    assert set(grads) == set(grads0) and grads
    for name in grads0:
        torch.testing.assert_close(grads[name], grads0[name], **GRAD_TOL,
                                   msg=name)
    for key in updates0:
        for stat in ("mean", "var"):
            torch.testing.assert_close(updates[key][stat],
                                       updates0[key][stat], **TOL)


def test_evaluation_forward_takes_the_route(monkeypatch):
    """An evaluation forward (no spans, no dropout) reduces spectrally and
    gives the per-edge route's scores."""
    model = build("compgcn", {"message_passing_args.composition": "ccorr"})
    layers = model.encoder.rgnn.layers
    calls = spy(monkeypatch)
    s, p = torch.arange(10), torch.arange(10) % 9
    with torch.no_grad():
        got = model.score_sp(s, p)
        assert calls == {"apply": 2 * len(layers), "reduce": 2 * len(layers)}
        for layer in layers:
            layer.spectral = False
        want = model.score_sp(s, p)
    torch.testing.assert_close(got, want, **TOL)


def skewed_graph(num_nodes, num_types, edges, rng, hub, hub_edges,
                 big_type, big_share):
    """(src sorted, nbr, types) of ``edges`` edges, Zipf-skewed, with node
    ``hub`` of at least ``hub_edges`` edges and relation ``big_type`` of at
    least ``big_share`` of them."""
    nbr = np.minimum(rng.zipf(1.3, edges) - 1, num_nodes - 1)
    src = np.sort(rng.integers(0, num_nodes, edges))
    types = np.minimum(rng.zipf(1.5, edges) - 1, num_types - 1)
    nbr[:hub_edges] = hub
    types[rng.random(edges) < big_share] = big_type
    return src, nbr, types


def test_orders_cover_each_row_in_pieces():
    rng = np.random.default_rng(0)
    N, R, E = 300, 11, 5000
    src, nbr, types = skewed_graph(N, R, E, rng, hub=7, hub_edges=800,
                                   big_type=3, big_share=0.3)
    orders = cr.build_orders(src, nbr, types, N, R)
    by = {"src": (src, nbr, types, N), "nbr": (nbr, src, types, N),
          "type": (types, src, nbr, R)}
    for name, order in orders.items():
        key, ia, ib, rows = by[name]
        edge = np.arange(E) if order.edge is None else order.edge
        assert sorted(edge) == list(range(E)), name
        np.testing.assert_array_equal(order.key, key[edge])
        np.testing.assert_array_equal(order.ia, ia[edge])
        np.testing.assert_array_equal(order.ib, ib[edge])
        assert np.all(np.diff(order.key) >= 0)
        assert order.rows == rows and len(order.row_pieces) == rows + 1
        begin = order.piece_begin
        assert begin[0] == 0 and begin[-1] == E
        assert np.all(np.diff(begin) >= 1)
        assert np.all(np.diff(begin) <= cr.PIECE_EDGES)
        np.testing.assert_array_equal(order.heavy_rows, np.flatnonzero(
            np.diff(order.row_pieces) > cr.HEAVY_PIECES))
        for row in range(rows):
            first, last = order.row_pieces[row], order.row_pieces[row + 1]
            members = np.flatnonzero(order.key == row)
            if not len(members):
                assert first == last
                continue
            assert begin[first] == members[0]
            assert begin[last] == members[-1] + 1
    # the source order of an edge set sorted by its aggregation node is
    # the set's own; the hub's and the big relation's runs span pieces
    assert orders["src"].edge is None
    hub_run = np.diff(orders["nbr"].row_pieces)[7]
    assert hub_run >= 800 // cr.PIECE_EDGES
    assert 7 in orders["nbr"].heavy_rows and 3 in orders["type"].heavy_rows
    with pytest.raises(ValueError, match="outside"):
        cr.build_orders(src, nbr, types, N, 3)


@pytest.mark.parametrize("bins,dim", [(3, 8), (4, 10), (6, 10)])
def test_plain_backward_matches_autograd_per_edge(bins, dim):
    """``CcorrReduce`` with the plain version forward and backward against
    autograd through the per-edge product and ``index_add``; and through
    ``from_spectra`` the per-edge ``ccorr``."""
    rng = np.random.default_rng(bins)
    N, R, E = 40, 5, 600
    src, nbr, types = skewed_graph(N, R, E, rng, hub=3, hub_edges=90,
                                   big_type=1, big_share=0.4)
    orders = {k: v.to(CPU) for k, v in
              cr.build_orders(src, nbr, types, N, R).items()}
    g = torch.Generator().manual_seed(bins)
    xh = torch.randn((N, bins + bins % 2, 2), generator=g, requires_grad=True)
    rh = torch.randn((R, bins + bins % 2, 2), generator=g, requires_grad=True)
    scale = torch.rand(E, generator=g)
    w = torch.randn((N, bins + bins % 2, 2), generator=g)
    got = cr.CcorrReduce.apply(xh, rh, scale, orders)
    got_grads = torch.autograd.grad(torch.sum(got * w), (xh, rh))
    x = torch.view_as_complex(xh)
    prod = torch.conj(x[torch.from_numpy(nbr)]) * torch.view_as_complex(rh)[
        torch.from_numpy(types)] * scale[:, None]
    want = torch.view_as_real(torch.zeros_like(x).index_add(
        0, torch.from_numpy(src), prod))
    want_grads = torch.autograd.grad(torch.sum(want * w), (xh, rh))
    torch.testing.assert_close(got, want, **TOL)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a, b, **TOL)
    # the composition itself: ccorr (cut spectrum) or ccorr_true
    composition = ccorr if bins < dim // 2 + 1 else ccorr_true
    assert cr.spectrum_bins("ccorr" if composition is ccorr else
                            "ccorr_true", dim) == bins
    h, hr = torch.randn((N, dim), generator=g), torch.randn((R, dim),
                                                             generator=g)
    reduced = cr.from_spectra(cr.CcorrReduce.apply(
        cr.spectra(h, bins), cr.spectra(hr, bins), scale, orders), bins, dim)
    per_edge = torch.zeros(N, dim).index_add(0, torch.from_numpy(src), (
        composition(h[torch.from_numpy(nbr)], hr[torch.from_numpy(types)])
        * scale[:, None]))
    torch.testing.assert_close(reduced, per_edge, **TOL)


#: layers the route leaves alone: (preset, encoder options)
LEFT_ALONE = {
    "ccorr-weighted": ("compgcn", {
        "message_passing_args.composition": "ccorr",
        "message_passing_args.message_weight": True}),
    "ccorr-true-weighted": ("compgcn", {
        "message_passing_args.composition": "ccorr_true_weighted"}),
    "attention-ccorr": ("ragat", {
        "message_passing_args.composition": "ccorr",
        "message_passing_args.message_weight": False}),
    "learned-relation-weight": ("compgcn", {
        "message_passing_args.composition": "ccorr",
        "message_passing_args.learned_relation_weight": True}),
    "per-relation-block": ("compgcn", {
        "weight_decomposition": "block", "num_blocks_or_bases": 4,
        "message_passing_args.propagation": "per_relation",
        "message_passing_args.composition": "ccorr"}),
}


@pytest.mark.parametrize("name", list(LEFT_ALONE))
def test_other_layers_leave_the_route_alone(name, monkeypatch):
    preset, encoder = LEFT_ALONE[name]
    model = build(preset, encoder)
    assert not any(layer.spectral for layer in model.encoder.rgnn.layers)
    assert "spectral" not in model.encoder.graph()
    assert model.encoder.rgnn.spectral_sets == ()
    want = encode_and_grads(model)

    def refuse(*args, **kwargs):
        raise AssertionError("the spectral route ran")

    for fn in ("spectra", "from_spectra", "loop_spectra"):
        monkeypatch.setattr(rgnn_layers, fn, refuse)
    monkeypatch.setattr(rgnn_layers.CcorrReduce, "apply", refuse)
    got = encode_and_grads(model)
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    assert set(got[2]) == set(want[2])
    for key in want[2]:
        assert torch.equal(got[2][key], want[2][key]), key


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """At FB15k-237's sizes (14,541 nodes, 475 relation rows, one half of
    272,115 edges), K = 51 bins (ccorr at d = 200, Kp = 52) and 101
    (ccorr_true, Kp = 102, two rounds of lanes): the forward and both
    backward reductions against float64, relative to the largest float64
    value; two calls bit-identical; one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(19)
    N, R, E = 14541, 475, 272115
    src, nbr, types = skewed_graph(N, R, E, rng, hub=5, hub_edges=5000,
                                   big_type=11, big_share=0.12)
    assert np.bincount(nbr)[5] >= 5000
    assert np.bincount(types).max() >= E // 10
    cuda = torch.device("cuda")
    orders = {k: v.to(cuda) for k, v in
              cr.build_orders(src, nbr, types, N, R).items()}
    # the hub and the big relation are summed by the heavy rows' blocks
    assert 5 in orders["nbr"].heavy_rows.tolist()
    assert 11 in orders["type"].heavy_rows.tolist()
    g = torch.Generator(device=cuda).manual_seed(0)
    scale = torch.rand(E, device=cuda, generator=g)
    for kp in (52, 102):
        xh = torch.randn((N, kp, 2), device=cuda, generator=g)
        rh = torch.randn((R, kp, 2), device=cuda, generator=g)
        grad = torch.randn((N, kp, 2), device=cuda, generator=g)
        for name, a, b, conj in (("src", xh, rh, True),
                                 ("nbr", grad, rh, True),
                                 ("type", grad, xh, False)):
            order = orders[name]
            before = cr.ccorr_reduce.launches
            got = cr.ccorr_reduce(a, b, order, scale, conj)
            again = cr.ccorr_reduce(a, b, order, scale, conj)
            assert cr.ccorr_reduce.launches == before + 2
            assert torch.equal(got, again), name
            want = cr.ccorr_reduce_reference(a.double(), b.double(), order,
                                             scale.double(), conj)
            err = (got.double() - want).abs().max() / want.abs().max()
            assert err < 1e-5, (name, kp, err.item())
