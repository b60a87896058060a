"""The port's scorers (kge_tpu_torch/models) against kge_tpu's on one
carried param tree, on data/toy: DistMult, ComplEx, CP, SimplE, RESCAL,
RelationalTucker3, TransE, RotatE (L1 and L2), TransH, ConvE and the
Transformer, bare and reciprocal. Every scoring entry point (score_spo
both ways, score_sp, score_po, score_so, score_sp_po, over all entities
and over a subset) and the dot forms within TOL (float32 in both,
summed in different orders); an entry point that one package refuses,
the other refuses with the same error. Also: the params tree both ways
(a list of layers included), ConvE's batch-norm updates against
``kge_tpu``'s ``ctx.updates``, the config side effects of each model,
dropout and the initializers by their statistics, and
``utils/params.py`` on a tree with a list of 12 entries.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu import Config as JaxConfig, Dataset as JaxDataset
from kge_tpu.models import Ctx as JaxCtx, KgeModel as JaxKgeModel
from kge_tpu.models.init import initialize as jax_initialize
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.models import Ctx, KgeModel
from kge_tpu_torch.models.init import initialize
from kge_tpu_torch.utils.params import (
    params_from_state_dict, state_dict_from_params, tree_leaves,
)
from tests.test_torch_train import TOY

# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)

CPU = torch.device("cpu")
#: absolute and relative: the scores are float32 sums of up to 16 x 16
#: products (RESCAL, RelationalTucker3) in different orders
TOL = dict(atol=3e-5, rtol=1e-5)

#: name -> (model type, reciprocal?, options)
MODELS = {
    "distmult": ("distmult", False, {}),
    "complex": ("complex", False, {}),
    "cp": ("cp", False, {}),
    "simple": ("simple", False, {}),
    "rescal": ("rescal", False, {"lookup_embedder.dim": 8}),
    "relational_tucker3": ("relational_tucker3", False,
                           {"lookup_embedder.dim": 8,
                            "tucker3_relation_embedder.base_embedder.dim":
                                12}),
    "transe": ("transe", False, {}),
    "transe-l2": ("transe", False, {"transe.l_norm": 2.0}),
    "rotate": ("rotate", False, {}),
    "rotate-l2": ("rotate", False, {"rotate.l_norm": 2.0}),
    "transh": ("transh", False, {"transh.C": 0.1}),
    "conve": ("conve", False, {"lookup_embedder.dim": 8}),
    "transformer": ("transformer", False,
                    {"transformer.encoder.nhead": 2,
                     "transformer.encoder.dim_feedforward": 24,
                     "transformer.encoder.num_layers": 2}),
    "reciprocal-distmult": ("distmult", True, {}),
    "reciprocal-conve": ("conve", True, {"lookup_embedder.dim": 8}),
    "reciprocal-transformer": ("transformer", True,
                               {"transformer.encoder.nhead": 2,
                                "transformer.encoder.dim_feedforward": 24,
                                "transformer.encoder.num_layers": 2}),
}


def model_config(cls, model, reciprocal, options):
    config = cls()
    if reciprocal:
        config.set("model", "reciprocal_relations_model")
        config._import("reciprocal_relations_model")
        config.set("reciprocal_relations_model.base_model.type", model)
    else:
        config.set("model", model)
    config._import(model)
    config.set("job.device", "cpu")
    config.set("dataset.name", "toy")
    config.set("console.quiet", True)
    config.set("lookup_embedder.dim", 16)
    for key, value in options.items():
        config.set(key, value)
    return config


@functools.lru_cache(maxsize=None)
def pair(name):
    """(kge_tpu model, its params, its state, port model with those
    weights)."""
    model, reciprocal, options = MODELS[name]
    jconfig = model_config(JaxConfig, model, reciprocal, options)
    jax_model = JaxKgeModel.create(jconfig, JaxDataset.create(jconfig, TOY))
    tree = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(11)))
    pconfig = model_config(Config, model, reciprocal, options)
    port = KgeModel.create(pconfig, Dataset.create(pconfig, TOY),
                           device=CPU, init_for_load_only=True)
    port.load_params(tree)
    return jax_model, jax.tree_util.tree_map(jnp.asarray, tree), \
        jax_model.init_state(), port


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _inputs(port):
    rng = np.random.default_rng(5)
    E, R = port.dataset.num_entities(), port.dataset.num_relations()
    s, o = rng.integers(0, E, 10), rng.integers(0, E, 10)
    p = rng.integers(0, R, 10)
    return s, p, o, np.asarray([0, 3, 7, 119])


#: entry point -> (kge_tpu call, port call) on (model, params, ctx, s, p,
#: o, subset)
CALLS = {
    "spo_o": (lambda m, pr, c, s, p, o, u: m.score_spo(pr, s, p, o, "o", c),
              lambda m, c, s, p, o, u: m.score_spo(s, p, o, "o", c)),
    "spo_s": (lambda m, pr, c, s, p, o, u: m.score_spo(pr, s, p, o, "s", c),
              lambda m, c, s, p, o, u: m.score_spo(s, p, o, "s", c)),
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
    "sp_po": (lambda m, pr, c, s, p, o, u: m.score_sp_po(pr, s, p, o, ctx=c),
              lambda m, c, s, p, o, u: m.score_sp_po(s, p, o, ctx=c)),
    "sp_po_subset": (
        lambda m, pr, c, s, p, o, u: m.score_sp_po(pr, s, p, o, u, ctx=c),
        lambda m, c, s, p, o, u: m.score_sp_po(s, p, o, u, ctx=c)),
    "dot_queries": (
        lambda m, pr, c, s, p, o, u: m.dot_queries(pr, s, p, o, c),
        lambda m, c, s, p, o, u: m.dot_queries(s, p, o, c)),
    "dot_candidates": (
        lambda m, pr, c, s, p, o, u: m.dot_candidates(pr, u, c),
        lambda m, c, s, p, o, u: m.dot_candidates(u, c)),
    "dot_candidates_all": (
        lambda m, pr, c, s, p, o, u: m.dot_candidates_all(pr, c),
        lambda m, c, s, p, o, u: m.dot_candidates_all(c)),
}


def _outcome(fn):
    try:
        return fn(), None
    except (ValueError, NotImplementedError) as e:
        return None, e


@pytest.mark.parametrize("call", list(CALLS))
@pytest.mark.parametrize("name", list(MODELS))
def test_scores_equal_kge_tpu(name, call):
    jax_model, params, state, port = pair(name)
    s, p, o, subset = _inputs(port)
    jax_call, port_call = CALLS[call]
    want, want_error = _outcome(lambda: jax_call(
        jax_model, params, JaxCtx(state=state), s, p, o, subset))
    with torch.no_grad():
        got, got_error = _outcome(lambda: port_call(
            port, port.default_ctx(), _t(s), _t(p), _t(o), _t(subset)))
    if want_error is not None or got_error is not None:
        assert type(got_error) is type(want_error), (got_error, want_error)
        assert str(got_error) == str(want_error)
        return
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for mine, ref in zip(got, want):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_params_tree_both_ways(name):
    """load_params(kge_tpu's tree) then params() gives the same tree:
    the same structure (lists stay lists) and the same arrays; the
    dot-ranking properties agree."""
    jax_model, params, _, port = pair(name)
    tree = port.params()
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(params))
    for mine, ref in zip(jax.tree_util.tree_leaves(tree),
                         jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(mine, np.asarray(ref))
    assert port.supports_dot_ranking() == jax_model.supports_dot_ranking()
    assert port.dot_score_space() == jax_model.dot_score_space()


def test_reciprocal_keys_have_no_base_model_level():
    _, params, _, port = pair("reciprocal-conve")
    keys = set(port.state_dict())
    assert "entity_embedder.weights" in keys and "scorer.conv_w" in keys
    assert not any(k.startswith("_base_model") for k in keys)
    assert set(params) == {"entity_embedder", "relation_embedder", "scorer"}
    # the doubled relation vocabulary, padded to 8 rows
    assert port.relation_embedder.weights.shape[0] == 24
    assert port.relation_embedder.vocab_size == 18


def test_conve_batch_norm_updates_equal_kge_tpu():
    """Training mode at dropout 0: ConvE normalizes with the batch
    statistics and writes the running ones (momentum 0.1, unbiased
    variance) into ctx.updates, as kge_tpu does; eval mode reads the
    running statistics."""
    jax_model, params, state, port = pair("reciprocal-conve")
    scorer = port.get_scorer()
    rates = (scorer.feature_map_dropout, scorer.projection_dropout,
             port.get_s_embedder().dropout_rate)
    scorer.feature_map_dropout = scorer.projection_dropout = 0.0
    jscorer = jax_model.get_scorer()
    jscorer.feature_map_dropout = jscorer.projection_dropout = 0.0
    for emb in (port.get_s_embedder(), port.get_p_embedder()):
        emb.dropout_rate = 0.0
    for emb in (jax_model.get_s_embedder(), jax_model.get_p_embedder()):
        emb.dropout_rate = 0.0
    try:
        s, p, o, _ = _inputs(port)
        jctx = JaxCtx(train=True, rng=jax.random.PRNGKey(0), state=state)
        want = jax_model.score_sp(params, s, p, ctx=jctx)
        ctx = Ctx(train=True, generator=torch.Generator(),
                  state=port.model_state)
        with torch.no_grad():
            got = port.score_sp(_t(s), _t(p), ctx=ctx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert set(ctx.updates) == set(jctx.updates) == {"bn1", "bn2"}
        for key in ("bn1", "bn2"):
            for stat in ("mean", "var"):
                np.testing.assert_allclose(
                    ctx.updates[key][stat].numpy(),
                    np.asarray(jctx.updates[key][stat]), rtol=1e-5,
                    atol=1e-6, err_msg=f"{key}.{stat}")
        # eval mode reads the (updated) running statistics
        new_state = jax.tree_util.tree_map(jnp.asarray, jctx.updates)
        want = jax_model.score_sp(params, s, p, ctx=JaxCtx(state=new_state))
        port.model_state = ctx.updates
        with torch.no_grad():
            got = port.score_sp(_t(s), _t(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(port.state()["bn2"]["var"],
                                   np.asarray(jctx.updates["bn2"]["var"]),
                                   rtol=1e-5)
    finally:
        port.model_state = port.init_state()
        scorer.feature_map_dropout, scorer.projection_dropout, rate = rates
        for emb in (port.get_s_embedder(), port.get_p_embedder()):
            emb.dropout_rate = rate
        pair.cache_clear()


@pytest.mark.parametrize("model,options,key,want", [
    # CP: relation dim -1 -> half the entity dim
    ("cp", {}, "cp.relation_embedder.dim", 8),
    # RESCAL: relation dim -1 -> entity dim squared
    ("rescal", {"lookup_embedder.dim": 6}, "rescal.relation_embedder.dim",
     36),
    # RotatE: relation dim -1 -> half (phases)
    ("rotate", {}, "rotate.relation_embedder.dim", 8),
    # TransH: relation dim -1 -> double (translation + normal)
    ("transh", {}, "transh.relation_embedder.dim", 32),
    # RelationalTucker3: the projection's output dim -> entity dim squared
    ("relational_tucker3", {"lookup_embedder.dim": 5},
     "relational_tucker3.relation_embedder.dim", 25),
    # ConvE: dims restored after the embedders were built at dim + 1
    ("conve", {"lookup_embedder.dim": 8}, "conve.entity_embedder.dim", 8),
    # ConvE round_dim: 10 is no 2:1 rectangle, rounds to 3 x 6 = 18
    ("conve", {"lookup_embedder.dim": 10, "conve.round_dim": True},
     "conve.entity_embedder.dim", 18),
])
def test_config_side_effects_equal_kge_tpu(model, options, key, want):
    for cls, dataset_cls, model_cls, kwargs in (
        (JaxConfig, JaxDataset, JaxKgeModel, {}),
        (Config, Dataset, KgeModel, dict(device=CPU,
                                         init_for_load_only=True)),
    ):
        config = model_config(cls, model, False, options)
        m = model_cls.create(config, dataset_cls.create(config, TOY),
                             **kwargs)
        assert config.get_default(key) == want, (cls, key)
        if model == "conve":
            assert m.get_s_embedder().dim == want + 1


@pytest.mark.parametrize("model,options,match", [
    ("simple", {"lookup_embedder.dim": 15}, "SimplE requires even"),
    ("cp", {"lookup_embedder.dim": 15}, "CP requires even"),
    ("rotate", {"lookup_embedder.dim": 15}, "RotatE requires even"),
    ("conve", {"lookup_embedder.dim": 10}, "incompatible with aspect ratio"),
    ("transformer", {"transformer.encoder.nhead": 3}, "divisible by nhead"),
])
def test_invalid_configs_raise_as_kge_tpu(model, options, match):
    for cls, dataset_cls, model_cls, kwargs in (
        (JaxConfig, JaxDataset, JaxKgeModel, {}),
        (Config, Dataset, KgeModel, dict(device=CPU,
                                         init_for_load_only=True)),
    ):
        config = model_config(cls, model, False, options)
        with pytest.raises(ValueError, match=match):
            model_cls.create(config, dataset_cls.create(config, TOY),
                             **kwargs)


# ------------------------------------------------------------------ dropout


def test_dropout_by_its_statistics():
    """kge_tpu's formula where(bernoulli(keep), x / keep, 0): the kept
    share of a 10^6 mask within 5 sigma of 1 - rate, kept values scaled
    by 1 / keep, the same mask for the same seed, the identity in eval
    mode or at rate 0, and an error without a generator."""
    x = torch.full((1000, 1000), 3.0)
    rate, keep = 0.3, 0.7
    out = Ctx(train=True, generator=torch.Generator().manual_seed(1)
              ).dropout(x, rate)
    kept = out != 0
    n = x.numel()
    share = kept.double().mean().item()
    assert abs(share - keep) <= 5 * math.sqrt(keep * (1 - keep) / n)
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          3.0 / keep))
    again = Ctx(train=True, generator=torch.Generator().manual_seed(1)
                ).dropout(x, rate)
    assert torch.equal(out, again)
    assert Ctx().dropout(x, rate) is x
    assert Ctx(train=True, generator=torch.Generator()).dropout(x, 0.0) is x
    with pytest.raises(ValueError, match="needs a generator"):
        Ctx(train=True).dropout(x, rate)
    # the gradient flows through kept entries only, scaled by 1 / keep
    y = x.clone().requires_grad_()
    Ctx(train=True, generator=torch.Generator().manual_seed(1)).dropout(
        y, rate).sum().backward()
    torch.testing.assert_close(y.grad, kept.float() / keep)


def test_embedder_dropout_in_training_only():
    """The lookup embedder drops out in a training Ctx (kge_tpu's place,
    after the lookup) and is exact in eval mode."""
    _, _, _, port = pair("reciprocal-conve")
    emb = port.get_s_embedder()
    assert emb.dropout_rate == 0.2
    idx = torch.arange(100)
    with torch.no_grad():
        plain = emb.embed(idx, Ctx())
        dropped = emb.embed(idx, Ctx(train=True,
                                     generator=torch.Generator()))
    torch.testing.assert_close(plain, emb.weights[:100])
    zero = dropped == 0
    assert 0.1 < zero.double().mean().item() < 0.3
    torch.testing.assert_close(dropped[~zero], plain[~zero] / 0.8)


# ------------------------------------------------------------------ initializers


#: name, args, shape, (mean, std, lower bound, upper bound) of the draw
INITS = [
    ("kaiming_uniform_", {"a": math.sqrt(5.0)}, (32, 1, 3, 3),
     lambda: (0.0, (1 / 3) / math.sqrt(3), -1 / 3, 1 / 3)),
    ("kaiming_uniform_", {"nonlinearity": "relu", "mode": "fan_out"},
     (300, 400), lambda: (0.0, math.sqrt(2 / 300), -math.sqrt(6 / 300),
                          math.sqrt(6 / 300))),
    ("kaiming_normal_", {"nonlinearity": "relu"}, (300, 400),
     lambda: (0.0, math.sqrt(2 / 400), -math.inf, math.inf)),
    ("trunc_normal_", {"mean": 0.5, "std": 1.0, "a": -1.0, "b": 2.0},
     (400, 400), None),
    ("normal_", {"mean": 1.0, "std": 0.02}, (400, 400),
     lambda: (1.0, 0.02, -math.inf, math.inf)),
    ("constant_", {"val": 0.25}, (3, 5), lambda: (0.25, 0.0, 0.25, 0.25)),
    ("ones_", {}, (3, 5), lambda: (1.0, 0.0, 1.0, 1.0)),
    ("zeros_", {}, (3, 5), lambda: (0.0, 0.0, 0.0, 0.0)),
]


def _truncated_normal_moments(mean, std, a, b):
    from scipy.stats import truncnorm

    dist = truncnorm((a - mean) / std, (b - mean) / std, loc=mean, scale=std)
    return dist.mean(), dist.std(), a, b


@pytest.mark.parametrize("name,args,shape,moments", INITS,
                         ids=[f"{n}-{i}" for i, (n, *_) in enumerate(INITS)])
def test_initializers_by_their_statistics(name, args, shape, moments):
    """Each initializer's draw, in the port and in kge_tpu, has the
    distribution's mean and standard deviation (within 5 standard errors)
    and stays within its bounds."""
    if moments is None:
        moments = lambda: _truncated_normal_moments(
            args["mean"], args["std"], args["a"], args["b"])
    mean, std, lo, hi = moments()
    draws = {
        "port": initialize(torch.Generator().manual_seed(0), shape, name,
                           args).numpy().astype(np.float64),
        "kge_tpu": np.asarray(jax_initialize(
            jax.random.PRNGKey(0), shape, name, args), dtype=np.float64),
    }
    n = math.prod(shape)
    for label, x in draws.items():
        assert x.shape == tuple(shape)
        assert x.min() >= lo - 1e-6 and x.max() <= hi + 1e-6, label
        assert abs(x.mean() - mean) <= 5 * std / math.sqrt(n) + 1e-7, label
        if std > 0:
            assert abs(x.std() - std) <= 5 * std * math.sqrt(2 / n), label


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 3, 2)])
def test_orthogonal_initializer(shape):
    """torch.nn.init.orthogonal_'s layout: rows orthonormal when fewer
    than the flattened columns, columns orthonormal otherwise; the gain
    scales it."""
    q = initialize(torch.Generator().manual_seed(0), shape, "orthogonal_",
                   {"gain": 2.0}).double()
    flat = q.reshape(shape[0], -1) / 2.0
    rows, cols = flat.shape
    gram = flat @ flat.T if rows < cols else flat.T @ flat
    torch.testing.assert_close(gram, torch.eye(min(rows, cols),
                                               dtype=torch.float64),
                               atol=1e-5, rtol=0)


# ------------------------------------------------------------------ params trees


def test_params_with_a_list_round_trip_in_jax_order():
    """A tree with a 12-entry list (index 10 sorts before 2 as a string)
    flattens to ``layers.<i>.<name>`` keys, nests back to the same
    structure (lists stay lists), and ``tree_leaves`` gives
    ``jax.tree_util.tree_leaves``'s order."""
    rng = np.random.default_rng(0)
    tree = {
        "entity_embedder": {"weights": rng.normal(size=(3, 2))},
        "scorer": {
            "cls": rng.normal(size=2),
            "layers": [{"w": rng.normal(size=(2, 2)) + i,
                        "b": rng.normal(size=2) + i} for i in range(12)],
        },
    }
    flat = state_dict_from_params(tree)
    assert "scorer.layers.10.w" in flat and len(flat) == 2 + 24
    back = params_from_state_dict(flat)
    assert isinstance(back["scorer"]["layers"], list)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    want = jax.tree_util.tree_leaves(tree)
    for leaves in (tree_leaves(back), tree_leaves(tree)):
        assert len(leaves) == len(want)
        for mine, ref in zip(leaves, want):
            np.testing.assert_array_equal(mine, ref)
