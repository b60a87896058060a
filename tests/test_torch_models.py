"""The port's ComplEx (kge_tpu_torch/models) against kge_tpu's on one
shared param tree: every scoring entry point and dot form within
atol=rtol=1e-5 (float32 in both, summed in different orders), the
score-form consistency family of tests/test_models.py run on the port,
and parameter trees carried across in both directions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kge_tpu import Dataset as JaxDataset
from kge_tpu.models import Ctx as JaxCtx, KgeModel as JaxKgeModel
from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.models import Ctx, KgeModel
from kge_tpu_torch.utils.params import (
    params_from_state_dict, state_dict_from_params
)

from tests.util import create_config, get_dataset_folder

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)


def port_config(dataset_name: str, dim: int) -> Config:
    config = Config()
    config.set("model", "complex")
    config._import("complex")
    config.set("job.device", "cpu")
    config.set("dataset.name", dataset_name)
    config.set("lookup_embedder.dim", dim)
    return config


def make_pair(dim=32, seed=42):
    """(jax model, jax params as numpy tree, port model with those
    weights) on tests/data/dataset_test."""
    config = create_config("dataset_test", model="complex")
    config.set("lookup_embedder.dim", dim)
    dataset = JaxDataset.create(config, get_dataset_folder("dataset_test"))
    jax_model = JaxKgeModel.create(config, dataset)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(seed))
    )
    pconfig = port_config("dataset_test", dim)
    pdataset = Dataset.create(pconfig, get_dataset_folder("dataset_test"))
    model = KgeModel.create(pconfig, pdataset, device=CPU,
                            init_for_load_only=True)
    model.load_params(tree)
    return jax_model, tree, model


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_scores_equal_jax():
    jax_model, tree, model = make_pair()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    E = model.dataset.num_entities()
    R = model.dataset.num_relations()
    rng = np.random.default_rng(0)
    s, o = rng.integers(0, E, 12), rng.integers(0, E, 12)
    p = rng.integers(0, R, 12)
    sub = np.asarray([0, 2, 3])
    ctx, jctx = Ctx(), JaxCtx()
    with torch.no_grad():
        pairs = [
            (model.score_spo(_t(s), _t(p), _t(o)),
             jax_model.score_spo(params, s, p, o)),
            (model.score_sp(_t(s), _t(p)), jax_model.score_sp(params, s, p)),
            (model.score_sp(_t(s), _t(p), _t(sub)),
             jax_model.score_sp(params, s, p, sub)),
            (model.score_po(_t(p), _t(o)), jax_model.score_po(params, p, o)),
            (model.score_po(_t(p), _t(o), _t(sub)),
             jax_model.score_po(params, p, o, sub)),
            (model.score_so(_t(s), _t(o)), jax_model.score_so(params, s, o)),
            (model.score_sp_po(_t(s), _t(p), _t(o)),
             jax_model.score_sp_po(params, s, p, o)),
            (model.score_sp_po(_t(s), _t(p), _t(o), _t(sub)),
             jax_model.score_sp_po(params, s, p, o, sub)),
            *zip(model.dot_queries(_t(s), _t(p), _t(o), ctx),
                 jax_model.dot_queries(params, s, p, o, jctx)),
            *zip(model.dot_candidates(_t(sub), ctx),
                 jax_model.dot_candidates(params, sub, jctx)),
            *zip(model.dot_candidates_all(ctx),
                 jax_model.dot_candidates_all(params, jctx)),
            *zip(model.dot_candidates_all(ctx, padded=True),
                 jax_model.dot_candidates_all(params, jctx, padded=True)),
        ]
    for i, (mine, ref) in enumerate(pairs):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"pair {i}")
    cand_sp, cand_po = model.dot_candidates(_t(sub), ctx, sides=("po",))
    assert cand_sp is None and cand_po is not None
    assert model.supports_dot_ranking() and model.dot_score_space() == "native"


def test_embed_all_is_a_view_of_the_table():
    _, tree, model = make_pair()
    emb = model.get_s_embedder().embed_all(Ctx())
    weights = model.entity_embedder.weights
    assert emb.data_ptr() == weights.data_ptr()
    assert emb.shape[0] == model.dataset.num_entities() < weights.shape[0]
    assert emb.is_contiguous()


def _all_triples(E, R):
    s, p, o = np.meshgrid(np.arange(E), np.arange(R), np.arange(E),
                          indexing="ij")
    return s.reshape(-1), p.reshape(-1), o.reshape(-1)


def test_score_form_consistency():
    """tests/test_models.py::test_score_form_consistency on the port:
    score_spo over E x R x E equals the score_sp/_po/_so matrix forms."""
    _, _, model = make_pair()
    E = model.dataset.num_entities()
    R = model.dataset.num_relations()
    s, p, o = _all_triples(E, R)
    tol = dict(rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        spo = model.score_spo(_t(s), _t(p), _t(o)).numpy().reshape(E, R, E)
        ss, pp = np.meshgrid(np.arange(E), np.arange(R), indexing="ij")
        sp = model.score_sp(_t(ss.reshape(-1)), _t(pp.reshape(-1)))
        np.testing.assert_allclose(spo, sp.numpy().reshape(E, R, E), **tol)
        pp2, oo = np.meshgrid(np.arange(R), np.arange(E), indexing="ij")
        po = model.score_po(_t(pp2.reshape(-1)), _t(oo.reshape(-1)))
        np.testing.assert_allclose(np.transpose(spo, (1, 2, 0)),
                                   po.numpy().reshape(R, E, E), **tol)
        ss2, oo2 = np.meshgrid(np.arange(E), np.arange(E), indexing="ij")
        so = model.score_so(_t(ss2.reshape(-1)), _t(oo2.reshape(-1)))
        np.testing.assert_allclose(np.transpose(spo, (0, 2, 1)),
                                   so.numpy().reshape(E, E, R), **tol)


def test_param_tree_round_trip():
    _, tree, model = make_pair()
    sd = state_dict_from_params(tree)
    assert set(sd) == {"entity_embedder.weights", "relation_embedder.weights"}
    assert set(sd) == set(model.state_dict())
    back = params_from_state_dict(sd)
    for name in ("entity_embedder", "relation_embedder"):
        np.testing.assert_array_equal(back[name]["weights"],
                                      tree[name]["weights"])
    # the model's tree has kge_tpu's layout, empty scorer subtree included
    out = model.params()
    assert set(out) == set(tree) == {"entity_embedder", "relation_embedder",
                                     "scorer"}
    assert out["scorer"] == {} == dict(tree["scorer"])
    for name in ("entity_embedder", "relation_embedder"):
        np.testing.assert_array_equal(out[name]["weights"],
                                      tree[name]["weights"])
        assert out[name]["weights"].dtype == np.float32


@pytest.mark.parametrize("mesh_model", [1, 3])
def test_padded_table_layout_equals_jax(mesh_model):
    config = create_config("dataset_test", model="complex")
    config.set("lookup_embedder.dim", 8)
    config.set("tpu.mesh.model", mesh_model)
    dataset = JaxDataset.create(config, get_dataset_folder("dataset_test"))
    jax_tree = JaxKgeModel.create(config, dataset).init_params(
        jax.random.PRNGKey(0))
    pconfig = port_config("dataset_test", 8)
    pconfig.set("tpu.mesh.model", mesh_model)
    pdataset = Dataset.create(pconfig, get_dataset_folder("dataset_test"))
    model = KgeModel.create(pconfig, pdataset, device=CPU,
                            generator=torch.Generator().manual_seed(0))
    for name in ("entity_embedder", "relation_embedder"):
        mine = getattr(model, name).weights
        assert tuple(mine.shape) == jax_tree[name]["weights"].shape
        vocab = getattr(model, name).vocab_size
        assert torch.count_nonzero(mine[vocab:]) == 0
        assert torch.count_nonzero(mine[:vocab]) > 0


def test_fresh_init_is_seeded_by_generator():
    def make(seed):
        pconfig = port_config("dataset_test", 16)
        pconfig.set("lookup_embedder.initialize", "xavier_uniform_")
        pdataset = Dataset.create(pconfig,
                                  get_dataset_folder("dataset_test"))
        return KgeModel.create(pconfig, pdataset, device=CPU,
                               generator=torch.Generator().manual_seed(seed))

    a, b, c = make(1), make(1), make(2)
    wa, wb, wc = (m.entity_embedder.weights for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    with pytest.raises(ValueError):
        pconfig = port_config("dataset_test", 16)
        KgeModel.create(pconfig, Dataset.create(
            pconfig, get_dataset_folder("dataset_test")), device=CPU)
