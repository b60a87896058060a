"""The port's R-GNN encoders on a device mesh beyond the halo route's
agreement with ``kge_tpu`` (tests/test_torch_rgnn_mesh.py), on data/toy:

- dropout on the halo route, a mesh checkpoint evaluated on one device
  by both packages and resumed under the mesh;
- the gathered route (CompGCN with ``ccorr``, R-GCN, W-GCN) and graph
  sampling on a 2x2 mesh, against one process (1e-5);
- the halo layout (``build_halo_layout``) against ``kge_tpu``'s
  ``build_halo_structures`` (the same ``send`` sets, ``rmax`` and
  ``S``), a host simulation of the exchange and aggregation against the
  unsharded sum, and the exchange's volume on a graph with locality;
- the dense adjacency (``tpu.gnn_dense_adjacency``): ``always`` in
  float32 and bf16 against ``kge_tpu``'s on the CPU, its eligibility
  errors, ``auto`` off on the host, the byte limit, none under a model
  axis above 1.
"""

import os

import jax
import numpy as np
import pytest
import torch

from kge_tpu.models import Ctx as JaxCtx
from kge_tpu.models.rgnn.encoder import (
    build_graph_buffers as jax_build_graph_buffers, build_halo_structures,
)
from kge_tpu_torch import Config
from kge_tpu_torch.models import Ctx, KgeModel
from kge_tpu_torch.models.rgnn.encoder import (
    build_graph_buffers, build_halo_layout, mode_edge_set,
)
from kge_tpu_torch.parallel import mesh as mesh_lib
from tests.test_torch_distributed import eval_mrr
from tests.test_torch_mesh import single_process, write_config
from tests.test_torch_rgnn import build, datasets, make_config
from tests.test_torch_rgnn_mesh import (
    HALO_CASES, TOY, mesh_run, rgnn_config,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")


# ------------------------------------------------------------ on a mesh


def test_ragat_dropout_on_a_mesh_matches_one_process(tmp_path):
    """Entity dropout 0.3 and propagation dropout 0.4 on the halo route:
    each mask is drawn over the whole graph from the generator every rank
    shares and taken at the block's rows or edges, so the mesh computes
    one process's epoch (kge_tpu draws per-shard masks instead, which
    only its statistics can hold)."""
    config_file = write_config(tmp_path, rgnn_config("ragat", {
        "emb_entity_dropout": 0.3, "message_passing_args": {
            "composition": "mult_weighted", "num_heads": 2,
            "emb_propagation_dropout": 0.4}}))
    want, _, _ = single_process(config_file, {}, dataset=TOY)
    results = mesh_run(tmp_path, "ragat-dropout", config_file, "2x2")
    assert results[0]["halo_exchanges"] > 0
    np.testing.assert_allclose(results[0]["losses"], want, rtol=1e-5)


@pytest.fixture(scope="module")
def checkpointed(tmp_path_factory):
    """CompGCN with ``sub`` on 2x2 with a validation and a checkpoint
    each epoch, and the same job on one process."""
    root = tmp_path_factory.mktemp("checkpointed")
    config = rgnn_config("compgcn", HALO_CASES["compgcn-sub"][1])
    config["valid"] = {**config["valid"], "every": 1}
    config["train"] = {**config["train"], "checkpoint": {"every": 1}}
    config_file = write_config(root, config)
    want, _, _ = single_process(config_file, {"valid.every": 0},
                                dataset=TOY)
    folder = str(root / "run")
    results = mesh_run(root, "checkpointed", config_file, "2x2",
                       folder=folder)
    return dict(root=root, folder=folder, config_file=config_file,
                single=want, results=results)


@pytest.mark.parametrize("jax", [True, False], ids=["kge_tpu", "port"])
def test_rgnn_mesh_checkpoint_evaluates_on_one_device(checkpointed, jax):
    """The 2x2 run's checkpoint (whole tables, the encoder's weights and
    its batch-norm state) evaluates on one device in either package to
    the mesh's validation MRR."""
    folder = checkpointed["folder"]
    mrr = eval_mrr(folder, os.path.join(folder, "checkpoint_00002.pt"),
                   jax, dataset=TOY)
    want = checkpointed["results"][0]["valid"][-1]
    assert 0.0 < want <= 1.0
    assert mrr == pytest.approx(want, abs=1e-6)


def test_rgnn_mesh_checkpoint_resumes_under_the_mesh(checkpointed):
    """Epoch 1's checkpoint resumed on 2x2 trains epoch 2 as the
    uninterrupted mesh run and one process do."""
    results = mesh_run(
        checkpointed["root"], "resumed", checkpointed["config_file"], "2x2",
        resume=os.path.join(checkpointed["folder"], "checkpoint_00001.pt"))
    assert len(results[0]["losses"]) == 1
    np.testing.assert_allclose(results[0]["losses"][0],
                               checkpointed["results"][0]["losses"][1],
                               rtol=1e-6)
    np.testing.assert_allclose(results[0]["losses"][0],
                               checkpointed["single"][1], rtol=1e-5)


GATHERED = {
    "compgcn-ccorr": ("compgcn", {"message_passing_args": {
        "composition": "ccorr"}}),
    "rgcn": ("rgcn", {"num_layers": 2, "num_blocks_or_bases": 4}),
    "wgcn": ("wgcn", {"num_layers": 2}),
    "compgcn-sub-no-blocks": ("compgcn", {"neighbor_block_size": 0}),
}


@pytest.mark.parametrize("name", list(GATHERED))
def test_gathered_route_matches_one_process(tmp_path, name):
    """Layers off the halo route (non-hoistable compositions, R-GCN,
    W-GCN, and every layer at ``neighbor_block_size: 0``) run on the
    whole tables on every rank: no exchange, one process's losses."""
    preset, encoder = GATHERED[name]
    config_file = write_config(tmp_path, rgnn_config(preset, encoder))
    want, _, _ = single_process(config_file, {}, dataset=TOY)
    results = mesh_run(tmp_path, name, config_file, "2x2")
    for result in results:
        assert result["halo_exchanges"] == 0
        assert result["losses"] == results[0]["losses"]
    np.testing.assert_allclose(results[0]["losses"], want, rtol=1e-5)


def test_graph_sampling_on_a_mesh_matches_one_process(tmp_path):
    """Graph sampling draws one subgraph an epoch on every rank, and the
    halo layout is rebuilt for it: the ranks agree and the losses are
    one process's."""
    config = rgnn_config("compgcn", HALO_CASES["compgcn-sub"][1])
    config["negative_sampling"] = {**config["negative_sampling"],
                                   "graph_sampling": "uniform",
                                   "graph_sampling_size": 300}
    config_file = write_config(tmp_path, config)
    want, _, _ = single_process(config_file, {}, dataset=TOY)
    results = mesh_run(tmp_path, "graph-sampling", config_file, "2x2")
    for result in results:
        assert result["halo_exchanges"] > 0
        assert result["losses"] == results[0]["losses"]
    np.testing.assert_allclose(results[0]["losses"], want, rtol=1e-5)


# ------------------------------------------------------------ halo layout


def random_graph(seed=7, V=60, R=5, E=300):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, V, E), rng.integers(0, R, E),
                     rng.integers(0, V, E)], axis=1).astype(np.int64), V, R


def toy_graph():
    dataset = datasets()[1]
    return (dataset.split("train").astype(np.int64),
            dataset.num_entities(), dataset.num_relations())


KEY_SETS = [("in", "out"), ("single",), ("single_with_loops",)]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("graph", ["random", "toy"])
def test_halo_layout_matches_kge_tpu(graph, P):
    """The send sets, rmax and S of the port's layout on the edge list
    are kge_tpu's on its row blocks (the remote neighbors depend only on
    the (node, neighbor) pairs)."""
    triples, V, R = random_graph() if graph == "random" else toy_graph()
    padded = -(-V // 8) * 8
    port_graph = build_graph_buffers(triples, R, False, num_entities=V)
    for keys in KEY_SETS:
        want = build_halo_structures(jax_build_graph_buffers(
            triples, R, per_relation=False, row_block_modes=keys,
            block_size=16, num_entities=V), keys, P, padded)
        got = build_halo_layout(port_graph, keys, P, padded, V)
        assert got["S"] == want["halo_shard_size"] == padded // P
        for key in keys:
            np.testing.assert_array_equal(got[f"{key}_send"],
                                          want[f"halo_{key}_send"])


@pytest.mark.parametrize("P", [2, 4])
def test_halo_layout_aggregates_exactly(P):
    """A host simulation of the halo route (the block's rows ++ the rows
    the other blocks send, gathered at ``slot``, summed at ``src``)
    reproduces the unsharded sum over each edge set."""
    triples, V, R = random_graph()
    padded, d = 64, 8
    graph = build_graph_buffers(triples, R, False, num_entities=V)
    rng = np.random.default_rng(1)
    xw = rng.normal(size=(V, d))
    xw_pad = np.concatenate([xw, np.zeros((padded - V, d))])
    for keys in KEY_SETS:
        layout = build_halo_layout(graph, keys, P, padded, V)
        S = layout["S"]
        for key in keys:
            src, nbr = mode_edge_set(graph["edge_index"], key, V)
            scale = rng.normal(size=len(src))
            ref = np.zeros((V, d))
            np.add.at(ref, src, scale[:, None] * xw[nbr])
            send = layout[f"{key}_send"]
            out = np.zeros((padded, d))
            for p in range(P):
                tab = np.concatenate([xw_pad[p * S:(p + 1) * S]] + [
                    xw_pad[q * S + send[q, p]] for q in range(P)])
                pos = layout[f"{key}_pos"][p]
                np.add.at(out, p * S + layout[f"{key}_src"][p],
                          scale[pos][:, None] * tab[layout[f"{key}_slot"][p]])
            np.testing.assert_allclose(out[:V], ref, rtol=1e-12, atol=1e-12)
            assert not out[V:].any()


def test_halo_exchange_volume_bounded():
    """On a graph with locality the exchange is a small part of the
    table: (P-1) * rmax rows a block, not the V rows a gather moves."""
    rng = np.random.default_rng(11)
    V, R, P, E = 256, 4, 4, 6000
    S = V // P
    dst = rng.integers(0, V, E)
    local = (dst // S) * S + rng.integers(0, S, E)
    src = np.where(rng.random(E) < 0.98, local, rng.integers(0, V, E))
    triples = np.stack([src, rng.integers(0, R, E), dst], axis=1)
    graph = build_graph_buffers(triples, R, False, num_entities=V)
    layout = build_halo_layout(graph, ("in",), P, V, V)
    assert P * layout["in_send"].shape[2] < V // 4


# ------------------------------------------------------------ dense adjacency


def dense_options(dtype):
    return {"tpu.gnn_dense_adjacency": "always",
            "tpu.gnn_dense_adjacency_dtype": dtype}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("composition", ["sub", "neighbor"])
def test_dense_adjacency_matches_kge_tpu(composition, dtype):
    """``always`` in either storage type: the port's scores (its dense
    product in row chunks, ``sub``'s relation term as C @ (r @ W)) are
    kge_tpu's dense path's on one params tree, in training mode's
    encoder output and in evaluation's scores."""
    encoder = {"message_passing_args.composition": composition,
               "num_layers": 2}
    jax_model, tree, port = build("compgcn", encoder,
                                  **dense_options(dtype))
    graph = port.encoder.graph()
    want_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    assert {k: v.dtype for k, v in graph.items() if k.startswith("dense_")
            } == {"dense_in": want_dtype, "dense_out": want_dtype}
    assert any(k.startswith("dense_") for k in jax_model._encoder.graph())
    params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    state = jax_model.init_state()
    s = p = np.arange(6)
    want = np.asarray(jax_model.score_sp(params, s, p,
                                         ctx=JaxCtx(state=state)))
    with torch.no_grad():
        got = port.score_sp(torch.from_numpy(s), torch.from_numpy(p),
                            ctx=Ctx(state=port.model_state)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jx, _ = jax_model._encoder.encode(params, JaxCtx(
        train=True, rng=jax.random.PRNGKey(0), state=state))
    with torch.no_grad():
        x, _ = port.encoder.encode(Ctx(
            train=True, generator=torch.Generator().manual_seed(0),
            state=port.model_state))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("preset,encoder", [
    ("ragat", {}),
    ("compgcn", {"message_passing_args.learned_relation_weight": True}),
    ("compgcn", {"edge_dropout": 0.1}),
    ("compgcn", {"weight_decomposition": "basis", "num_blocks_or_bases": 2,
                 "message_passing_args.propagation": "per_relation"}),
    ("rgcn", {"num_blocks_or_bases": 4}),
], ids=["attention", "learned-weight", "edge-dropout", "per-relation",
        "rgcn"])
def test_dense_adjacency_always_errors_match_kge_tpu(preset, encoder):
    """``always`` where the dense adjacency does not apply: kge_tpu's
    error, word for word."""
    from kge_tpu import Config as JaxConfig
    from kge_tpu.models import KgeModel as JaxKgeModel

    errors = []
    for cls, dataset, create in (
            (JaxConfig, datasets()[0], JaxKgeModel.create),
            (Config, datasets()[1], lambda c, d: KgeModel.create(
                c, d, device=CPU, generator=torch.Generator()))):
        with pytest.raises(ValueError) as info:
            create(make_config(cls, preset, encoder,
                               **dense_options("float32")), dataset)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "tpu.gnn_dense_adjacency=always is not applicable" in errors[1]


def test_dense_adjacency_auto_and_byte_limit():
    """``auto``: never on the host; on the card while N^2 times the
    storage type's size is within the limit (bf16 halves it)."""
    N = datasets()[1].num_entities()
    _, _, port = build("compgcn", {}, **{"tpu.gnn_dense_adjacency": "auto"})
    assert not any(k.startswith("dense_") for k in port.encoder.graph())
    rgnn, config = port.encoder.rgnn, port.config
    assert rgnn.dense_adjacency_modes("cpu") == ()
    assert rgnn.dense_adjacency_modes("cuda") == ("in", "out")
    config.set("tpu.gnn_dense_adjacency_limit_bytes", N * N * 4 - 1)
    assert rgnn.dense_adjacency_modes("cuda") == ()
    config.set("tpu.gnn_dense_adjacency_dtype", "bfloat16")
    assert rgnn.dense_adjacency_modes("cuda") == ("in", "out")
    config.set("tpu.gnn_dense_adjacency", "never")
    assert rgnn.dense_adjacency_modes("cuda") == ()


def test_dense_adjacency_not_built_under_a_model_axis():
    """Under a mesh with a model axis above 1 the halo route scales
    instead: no dense adjacency, even with ``always``."""
    config = make_config(Config, "compgcn", {}, **dense_options("float32"))
    config.set("tpu.mesh.model", 2)
    mesh_lib.set_active(mesh_lib.Mesh(1, 2, 0))
    try:
        model = KgeModel.create(config, datasets()[1], device=CPU,
                                generator=torch.Generator())
    finally:
        mesh_lib.set_active(None)
    assert not any(k.startswith("dense_") for k in model.encoder.graph())
