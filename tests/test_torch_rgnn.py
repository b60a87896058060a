"""The port's R-GNN encoders (kge_tpu_torch/models/rgnn) against
kge_tpu's on one carried params tree, on data/toy at small widths.

- Every layer type and every option kge_tpu accepts (each propagation
  and composition, message weight, learned relation weight, edge norm,
  attention with one and two heads, the basis/block/relation-basis
  decompositions, both relation transforms; R-GCN with block, basis and
  full weights; W-GCN): the encoder's entity and relation outputs in
  training mode, the gradient of every parameter, and the batch-norm
  updates, kge_tpu at its default row-block layout and at
  ``neighbor_block_size: 0`` (its message path).
- Every scoring entry point of the four presets, with a bare and a
  reciprocal decoder; an entry point one package refuses, the other
  refuses with the same error; a configuration one package rejects, the
  other rejects with the same error.
- Edge dropout: one draw a triple shared by its two edges, and a dropped
  edge leaves the degree norm and the attention softmax (the layer with
  the drawn mask equals the layer without dropout on the kept triples).

Dropout is 0 wherever both packages run (the torch and JAX PRNG streams
differ). Tolerances: ``TOL`` (float32 in both, sums in other orders: the
edge-list index_add_ against the row blocks, the batched buckets against
the bucket scan).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.models import Ctx as JaxCtx, KgeModel as JaxKgeModel
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.models import Ctx, KgeModel
from kge_tpu_torch.utils.params import state_dict_from_params
from tests.test_torch_train import TOY

# toy-size tensors: one torch thread (see tests/test_torch_model_zoo.py)
torch.set_num_threads(1)

CPU = torch.device("cpu")
#: scores and encoder outputs: float32 sums of up to a few dozen terms
TOL = dict(atol=3e-5, rtol=1e-5)
#: gradients: sums over every edge of the toy graph (1,048 + 120 loops)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

NO_DROPOUT = {"edge_dropout": 0.0, "self_edge_dropout": 0.0,
              "emb_entity_dropout": 0.0,
              "message_passing_args.emb_propagation_dropout": 0.0}


def _mp(**args):
    return {f"message_passing_args.{k}": v for k, v in args.items()}


#: name -> (preset, encoder options); decoder DistMult, dim 8
ENCODERS = {
    **{f"direction-{c}{'-mw' if mw else ''}": (
        "compgcn", _mp(composition=c, message_weight=mw))
       for c in ("neighbor", "sub", "mult", "cross", "ccorr", "ccorr_true")
       for mw in (False, True) if not (mw and c == "neighbor")},
    **{f"{p}-{c}": ("compgcn", _mp(propagation=p, composition=c))
       for p in ("single", "single_with_self_edge_weight")
       for c in ("sub", "ccorr")},
    "direction-sub-learned": ("compgcn", _mp(learned_relation_weight=True)),
    "single-mult-learned": ("compgcn", _mp(propagation="single",
                                           composition="mult",
                                           learned_relation_weight=True)),
    "direction-ccorr-no-norm": ("compgcn", _mp(composition="ccorr",
                                               edge_norm=False)),
    "rel-self-2-layers": ("compgcn", {"rel_transformation": "self",
                                      "num_layers": 2, "bias": True,
                                      "activation": "relu"}),
    "relation-basis": ("compgcn", {"weight_decomposition": "relation_basis",
                                   "num_blocks_or_bases": 3,
                                   "num_layers": 2}),
    "attention-cross-mw-2-heads": ("ragat", _mp(
        composition="cross", message_weight=True, num_heads=2)),
    "attention-single-mult-1-head": ("ragat", _mp(
        propagation="single", composition="mult", message_weight=False,
        num_heads=1)),
    "attention-self-weight-sub-2-heads": ("ragat", _mp(
        propagation="single_with_self_edge_weight", composition="sub",
        message_weight=False, num_heads=2)),
    "attention-ccorr-learned": ("ragat", _mp(
        composition="ccorr", message_weight=False, num_heads=1,
        learned_relation_weight=True)),
    **{f"per-relation-{d}-{c}": ("compgcn", {
        "weight_decomposition": d, "num_blocks_or_bases": 4,
        **_mp(propagation="per_relation", composition=c)})
       for d, c in (("block", "neighbor"), ("block", "ccorr"),
                    ("basis", "sub"), ("basis", "mult"))},
    "per-relation-block-learned-no-norm": ("compgcn", {
        "weight_decomposition": "block", "num_blocks_or_bases": 2,
        **_mp(propagation="per_relation", composition="sub",
              learned_relation_weight=True, edge_norm=False)}),
    "rgcn-block": ("rgcn", {"num_layers": 2, "num_blocks_or_bases": 4}),
    "rgcn-basis": ("rgcn", {"num_layers": 2, "weight_decomposition": "basis",
                            "num_blocks_or_bases": 3}),
    "rgcn-full": ("rgcn", {"weight_decomposition": "None",
                           "weight_init": "xavier_uniform_"}),
    "wgcn": ("wgcn", {"num_layers": 2}),
}

#: kge_tpu layouts the port is held against: its default padded-CSR row
#: blocks, and its message path
LAYOUTS = {"row-blocks": 16, "messages": 0}


def make_config(cls, preset, encoder=None, decoder="distmult",
                dim=8, **options):
    config = cls()
    config.set("model", preset)
    config._import(preset)
    config.set("job.device", "cpu")
    config.set("dataset.name", "toy")
    config.set("console.quiet", True)
    for key in ("entity_embedder", "relation_embedder"):
        config.set(f"{preset}.{key}.dim", dim, create=True)
    if decoder == "reciprocal-conve":
        for key in ("entity_embedder", "relation_embedder"):
            config.set(f"{preset}.decoder.base_model.{key}.dim", 8,
                       create=True)
        config.set(f"{preset}.decoder.base_model.feature_map_dropout", 0.0,
                   create=True)
        config.set(f"{preset}.decoder.base_model.projection_dropout", 0.0,
                   create=True)
    else:
        config.set(f"{preset}.decoder.model", decoder)
        config.set(f"{preset}.decoder.type", decoder)
    for key, value in {**NO_DROPOUT, **(encoder or {})}.items():
        config.set(f"{preset}.encoder.{key}", value, create=True)
    for key, value in options.items():
        config.set(key, value, create=True)
    return config


@functools.lru_cache(maxsize=None)
def datasets():
    return (JaxDataset.create(make_config(JaxConfig, "compgcn"), TOY),
            Dataset.create(make_config(Config, "compgcn"), TOY))


def build(preset, encoder=None, seed=11, **kwargs):
    """(kge_tpu model, its params, port model with those weights)."""
    jds, pds = datasets()
    jconfig = make_config(JaxConfig, preset, encoder, **kwargs)
    jax_model = JaxKgeModel.create(jconfig, jds)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(seed)))
    pconfig = make_config(Config, preset, encoder, **kwargs)
    port = KgeModel.create(pconfig, pds, device=CPU,
                           init_for_load_only=True)
    port.load_params(tree)
    return jax_model, tree, port


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def assert_state_close(got, want):
    assert set(got) == set(want)
    for key in want:
        for stat in ("mean", "var"):
            np.testing.assert_allclose(_np(got[key][stat]),
                                       _np(want[key][stat]),
                                       err_msg=f"{key}.{stat}", **TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches_kge_tpu(name, layout):
    """The encoder in training mode: outputs, the gradient of a random
    projection of them with respect to every parameter, and the
    batch-norm updates."""
    preset, encoder = ENCODERS[name]
    encoder = {**encoder, "neighbor_block_size": LAYOUTS[layout]}
    jax_model, tree, port = build(preset, encoder)
    state = jax_model.init_state()
    rng = np.random.default_rng(3)
    x_shape = (port.dataset.num_entities(),
               port.encoder.rgnn.layers[-1].out_dim)
    wx = rng.standard_normal(x_shape).astype(np.float32)

    def jax_loss(params):
        ctx = JaxCtx(train=True, rng=jax.random.PRNGKey(0), state=state)
        x, r = jax_model._encoder.encode(params, ctx)
        wr = jnp.asarray(rng_r[: r.size].reshape(r.shape))
        return jnp.sum(x * wx) + jnp.sum(r * wr), (x, r, ctx.updates)

    rng_r = rng.standard_normal(10 ** 5).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    grads, (jx, jr, jupdates) = jax.grad(jax_loss, has_aux=True)(params)

    for p in port.parameters():
        p.requires_grad_(True)
    ctx = Ctx(train=True, generator=torch.Generator().manual_seed(0),
              state=port.model_state)
    x, r = port.encoder.encode(ctx)
    wr = torch.from_numpy(rng_r[: r.numel()].reshape(r.shape))
    (torch.sum(x * torch.from_numpy(wx)) + torch.sum(r * wr)).backward()
    np.testing.assert_allclose(_np(x), np.asarray(jx), **TOL)
    np.testing.assert_allclose(_np(r), np.asarray(jr), **TOL)
    assert_state_close(ctx.updates, jupdates)
    want = state_dict_from_params(jax.tree_util.tree_map(np.asarray, grads))
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    for key, value in want.items():
        grad = got[key].grad
        grad = np.zeros(value.shape, np.float32) if grad is None else _np(
            grad)
        np.testing.assert_allclose(grad, value.numpy(), err_msg=key,
                                   **GRAD_TOL)


#: preset -> decoder; and the toy-transe-compgcn example's
PRESETS = {
    "rgcn": ("rgcn", "distmult", {"num_blocks_or_bases": 4}),
    "wgcn": ("wgcn", "reciprocal-conve", {}),
    "compgcn": ("compgcn", "reciprocal-conve", {}),
    "ragat": ("ragat", "reciprocal-conve", {}),
    "compgcn-ccorr-recipe": ("compgcn", "reciprocal-conve", {
        "num_layers": 1, "activation": "tanh",
        **_mp(composition="ccorr")}),
    "compgcn-distmult": ("compgcn", "distmult", {}),
    "wgcn-distmult": ("wgcn", "distmult", {}),
    "ragat-distmult": ("ragat", "distmult", {}),
    "compgcn-transe": ("compgcn", "transe", {"num_layers": 2,
                                             "activation": "tanh"}),
}

#: entry point -> (kge_tpu call, port call)
CALLS = {
    "spo_o": (lambda m, pr, c, s, p, o, u: m.score_spo(pr, s, p, o, "o", c),
              lambda m, c, s, p, o, u: m.score_spo(s, p, o, "o", c)),
    "spo_s": (lambda m, pr, c, s, p, o, u: m.score_spo(pr, s, p, o, "s", c),
              lambda m, c, s, p, o, u: m.score_spo(s, p, o, "s", c)),
    "spo": (lambda m, pr, c, s, p, o, u: m.score_spo(pr, s, p, o, None, c),
            lambda m, c, s, p, o, u: m.score_spo(s, p, o, None, c)),
    "sp_": (lambda m, pr, c, s, p, o, u: m.score_sp(pr, s, p, ctx=c),
            lambda m, c, s, p, o, u: m.score_sp(s, p, ctx=c)),
    "sp_subset": (lambda m, pr, c, s, p, o, u: m.score_sp(pr, s, p, u, ctx=c),
                  lambda m, c, s, p, o, u: m.score_sp(s, p, u, ctx=c)),
    "_po": (lambda m, pr, c, s, p, o, u: m.score_po(pr, p, o, ctx=c),
            lambda m, c, s, p, o, u: m.score_po(p, o, ctx=c)),
    "_po_subset": (
        lambda m, pr, c, s, p, o, u: m.score_po(pr, p, o, u, ctx=c),
        lambda m, c, s, p, o, u: m.score_po(p, o, u, ctx=c)),
    "s_o": (lambda m, pr, c, s, p, o, u: m.score_so(pr, s, o, ctx=c),
            lambda m, c, s, p, o, u: m.score_so(s, o, ctx=c)),
    "s_o_subset": (
        lambda m, pr, c, s, p, o, u: m.score_so(pr, s, o, u[:3] % 9, ctx=c),
        lambda m, c, s, p, o, u: m.score_so(s, o, u[:3] % 9, ctx=c)),
    "sp_po": (lambda m, pr, c, s, p, o, u: m.score_sp_po(pr, s, p, o, ctx=c),
              lambda m, c, s, p, o, u: m.score_sp_po(s, p, o, ctx=c)),
    "sp_po_subset": (
        lambda m, pr, c, s, p, o, u: m.score_sp_po(pr, s, p, o, u, ctx=c),
        lambda m, c, s, p, o, u: m.score_sp_po(s, p, o, u, ctx=c)),
}


@pytest.mark.parametrize("name", list(PRESETS))
def test_score_entry_points_match_kge_tpu(name):
    """Every entry point in eval mode (the running batch-norm statistics
    of the encoder and of ConvE): the same scores, or the same error."""
    preset, decoder, encoder = PRESETS[name]
    jax_model, tree, port = build(preset, encoder, decoder=decoder)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(5)
    E, R = 120, 9
    s, o = rng.integers(0, E, 10), rng.integers(0, E, 10)
    p = rng.integers(0, R, 10)
    u = np.asarray([0, 3, 7, 119])
    refused = 0
    for call, (jax_call, port_call) in CALLS.items():
        jctx = JaxCtx(state=jax_model.init_state())
        try:
            want = jax_call(jax_model, params, jctx, *map(jnp.asarray,
                                                          (s, p, o, u)))
        except (ValueError, NotImplementedError) as e:
            with pytest.raises(type(e)) as info:
                port_call(port, None, *map(torch.as_tensor, (s, p, o, u)))
            assert str(info.value) == str(e), call
            refused += 1
            continue
        with torch.no_grad():
            got = port_call(port, None, *map(torch.as_tensor, (s, p, o, u)))
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   err_msg=call, **TOL)
    # reciprocal decoders refuse undirected spo and the s_o forms
    assert refused == (3 if decoder == "reciprocal-conve" else 0)
    assert not port.supports_dot_ranking()


def test_params_and_state_trees_match_kge_tpu():
    """The params tree and the model state of each preset have kge_tpu's
    structure, the encoder layers a list, both ways."""
    for preset, decoder, encoder in (("compgcn", "reciprocal-conve", {}),
                                     ("rgcn", "distmult",
                                      {"num_blocks_or_bases": 4}),
                                     ("wgcn", "reciprocal-conve", {}),
                                     ("ragat", "reciprocal-conve", {})):
        jax_model, tree, port = build(preset, encoder, decoder=decoder)
        got = port.params()
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(tree))
        assert isinstance(got["encoder"]["layers"], list)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)
        want_state = jax.tree_util.tree_map(np.asarray,
                                            jax_model.init_state())
        state = port.state()
        assert set(state) == set(want_state)
        assert_state_close(state, want_state)


@pytest.mark.parametrize("options,error", [
    (_mp(propagation="per_relation"), NotImplementedError),
    ({"weight_decomposition": "block", "num_blocks_or_bases": 3,
      **_mp(propagation="per_relation")}, RuntimeError),
    ({"weight_decomposition": "basis", "num_blocks_or_bases": 3},
     RuntimeError),
    ({"weight_decomposition": "basis", "num_blocks_or_bases": 3,
      **_mp(propagation="per_relation", message_weight=True)},
     NotImplementedError),
    (_mp(composition="rotate"), NotImplementedError),
    (_mp(composition="neighbor", message_weight=True), NotImplementedError),
    (_mp(propagation="both"), NotImplementedError),
    ({"weight_decomposition": "relation_basis", "num_blocks_or_bases": 0},
     ValueError),
    ({"activation": "softplus"}, ValueError),
    ({"layer_type": "gat"}, ValueError),
], ids=["per-relation-bare", "block-indivisible", "basis-no-per-relation",
        "per-relation-message-weight", "unknown-composition",
        "neighbor-weighted",
        "unknown-propagation", "relation-basis-0", "unknown-activation",
        "unknown-layer-type"])
def test_configuration_errors_match_kge_tpu(options, error):
    errors = []
    for cls, dataset, create in (
            # kge_tpu checks the weight shapes when it draws them
            (JaxConfig, datasets()[0], lambda c, d: JaxKgeModel.create(
                c, d).init_params(jax.random.PRNGKey(0))),
            (Config, datasets()[1], lambda c, d: KgeModel.create(
                c, d, device=CPU, generator=torch.Generator()))):
        with pytest.raises(error) as info:
            create(make_config(cls, "compgcn", options), dataset)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("options,error", [
    ({"tpu.gnn_dense_adjacency": "always",
      "compgcn.encoder.message_passing_args.composition": "ccorr"},
     ValueError),
    ({"tpu.gnn_dense_adjacency": "always",
      "tpu.gnn_dense_adjacency_dtype": "bfloat16",
      "compgcn.encoder.message_passing_args.composition": "neighbor"},
     None),
], ids=["dense-always-inapplicable", "dense-bf16"])
def test_dense_adjacency_options(options, error):
    """``always`` where kge_tpu finds the dense adjacency inapplicable
    raises kge_tpu's error; where it applies the model stores it, in
    bf16 too (tests/test_torch_rgnn_mesh.py holds its scores to
    kge_tpu's)."""
    config = make_config(Config, "compgcn",
                         {"emb_entity_dropout": 0.0}, **options)
    if error is None:
        model = KgeModel.create(config, datasets()[1], device=CPU,
                                generator=torch.Generator())
        dense = model.encoder.graph()
        assert {k: v.dtype for k, v in dense.items()
                if k.startswith("dense_")} == {
            "dense_in": torch.bfloat16, "dense_out": torch.bfloat16}
        return
    with pytest.raises(error) as info:
        KgeModel.create(config, datasets()[1], device=CPU,
                        generator=torch.Generator())
    jconfig = make_config(JaxConfig, "compgcn",
                          {"emb_entity_dropout": 0.0}, **options)
    with pytest.raises(ValueError) as jinfo:
        JaxKgeModel.create(jconfig, datasets()[0])
    assert str(jinfo.value) == str(info.value)
    # float32 where it applies: the same numbers, so the port goes on
    KgeModel.create(make_config(Config, "compgcn", {}, **{
        "tpu.gnn_dense_adjacency": "always"}), datasets()[1], device=CPU,
        generator=torch.Generator())


def test_stale_embeddings_run_the_encoder_once_a_ctx():
    """With use_stale_embeddings every score call of a Ctx reads one
    encoder forward; without, each call runs it again."""
    for stale, runs in ((True, 1), (False, 3)):
        _, _, port = build("compgcn", {"use_stale_embeddings": stale})
        calls = []
        port.encoder.rgnn.register_forward_hook(
            lambda *a: calls.append(1))
        ctx = Ctx(state=port.model_state)
        s = p = o = torch.tensor([0, 1])
        with torch.no_grad():
            port.score_sp(s, p, ctx=ctx)
            port.score_po(p, o, ctx=ctx)
            port.score_spo(s, p, o, "o", ctx=ctx)
        assert len(calls) == runs


def test_edge_dropout_keeps_triples_whole():
    """One Bernoulli a triple: each edge's keep-mask equals its inverse
    edge's (the halves are sorted apart), the kept share is near 1 -
    rate, and the self-loop mask is drawn apart."""
    _, _, port = build("compgcn", {"edge_dropout": 0.4,
                                   "self_edge_dropout": 0.3})
    layer = port.encoder.rgnn.layers[0]
    graph = port.encoder.graph()
    orig = graph["edge_orig"]
    E = orig.shape[0]
    shares = []
    for seed in range(20):
        ctx = Ctx(train=True, generator=torch.Generator().manual_seed(seed))
        mask, self_mask = layer._edge_masks(
            ctx, E, torch.zeros(1), orig)
        by_triple = torch.zeros(E // 2).index_put_((orig,), mask)
        np.testing.assert_array_equal(mask.numpy(), by_triple[orig].numpy())
        assert not torch.equal(mask[: E // 2], mask[E // 2:])
        shares.append((mask.mean().item(), self_mask.mean().item()))
    kept, self_kept = np.mean(shares, axis=0)
    # 20 draws of 524 triples (120 loops): within 5 sigma
    assert abs(kept - 0.6) < 5 * np.sqrt(0.24 / (20 * 524))
    assert abs(self_kept - 0.7) < 5 * np.sqrt(0.21 / (20 * 120))


@pytest.mark.parametrize("name", ["direction-sub", "attention-2-heads",
                                  "rgcn"])
def test_dropped_edges_leave_norm_and_softmax(name):
    """A training forward with edge dropout equals the forward without
    dropout over the kept triples alone: a dropped edge leaves the degree
    norm (CompGCN), the attention softmax's denominator (RAGAT) and the
    per-(relation, node) mean (R-GCN), as the reference removes it from
    edge_index."""
    preset, encoder = {
        "direction-sub": ("compgcn", {}),
        "attention-2-heads": ("ragat", _mp(num_heads=2)),
        "rgcn": ("rgcn", {"num_blocks_or_bases": 4}),
    }[name]
    _, _, port = build(preset, {**encoder, "edge_dropout": 0.5})
    triples = port.encoder.dataset.split("train")
    layer = port.encoder.rgnn.layers[0]
    x = port.entity_embedder.embed_all(Ctx())
    r = port.relation_embedder.embed_all(Ctx())

    def run(graph, seed):
        ctx = Ctx(train=True, generator=torch.Generator().manual_seed(seed),
                  state=port.model_state)
        with torch.no_grad():
            return layer(x, r, graph, ctx)[0]

    dropped = run(port.encoder.graph(), 7)
    # the same draw: the layer's first, one a triple
    half = torch.rand(len(triples),
                      generator=torch.Generator().manual_seed(7)) < 0.5
    port.encoder.set_graph(triples[half.numpy()])
    layer.edge_dropout = 0.0
    kept = run(port.encoder.graph(), 7)
    np.testing.assert_allclose(dropped.numpy(), kept.numpy(), **TOL)
    assert 0.3 < half.float().mean().item() < 0.7


def test_edge_indexes_match_kge_tpu():
    """``dataset.index("edge_index")`` and ``"edge_type"``: the train
    triples' (subject, object) edges followed by their reversed copies,
    whose relation ids are offset by the relation count."""
    jds, pds = datasets()
    for key in ("edge_index", "edge_type"):
        got, want = pds.index(key), jds.index(key)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    E = len(pds.split("train"))
    edge_index, edge_type = pds.index("edge_index"), pds.index("edge_type")
    np.testing.assert_array_equal(edge_index[:, E:], edge_index[::-1, :E])
    np.testing.assert_array_equal(edge_type[E:], edge_type[:E] + 9)


@pytest.mark.parametrize("name", ["direction-sub", "attention-2-heads",
                                  "per-relation-block"])
def test_propagation_dropout_is_unbiased(name, monkeypatch):
    """By its statistics: the mean of 800 training forwards with
    propagation dropout 0.4 (the batch norm taken out) is the forward
    without it, within 5 standard errors, over a sparse subgraph (40
    triples: most nodes have one edge besides their loop). For RAGAT this
    holds only if the dropout falls on the softmax's numerator alone; the
    per-relation path draws one mask per (relation, aggregation node)."""
    from kge_tpu_torch.models.rgnn import layers as rgnn_layers

    preset, encoder = {
        "direction-sub": ("compgcn", {}),
        "attention-2-heads": ("ragat", _mp(num_heads=2)),
        "per-relation-block": ("compgcn", {
            "weight_decomposition": "block", "num_blocks_or_bases": 4,
            **_mp(propagation="per_relation", composition="mult")}),
    }[name]
    _, _, port = build(preset, {
        **encoder, "message_passing_args.emb_propagation_dropout": 0.4})
    monkeypatch.setattr(rgnn_layers, "batch_norm_affine",
                        lambda x, *args: x)
    layer = port.encoder.rgnn.layers[0]
    port.encoder.set_graph(port.encoder.dataset.split("train")[:40])
    graph = port.encoder.graph()
    x = port.entity_embedder.embed_all(Ctx())
    r = port.relation_embedder.embed_all(Ctx())
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        want = layer(x, r, graph, Ctx())[0]
        runs = torch.stack([layer(x, r, graph, Ctx(train=True,
                                                   generator=g))[0]
                            for _ in range(800)])
    assert not torch.allclose(runs[0], want)
    err = (runs.mean(0) - want).abs()
    se = runs.std(0) / np.sqrt(len(runs))
    assert (err <= 5 * se + 1e-6).float().mean() > 0.999
