"""The port's g++ host ops (``kge_tpu_torch/native``): the triple parser
against ``np.loadtxt`` on every split under ``data/`` and the test
fixtures, the stable counting sort against ``np.argsort(kind="stable")``
(empty input, one bucket, skewed keys), the numpy fallback where g++ is
missing (logged, the same arrays), the library's place in
``kge_tpu_torch/_build/``, and the R-GNN graph buffers built through it
against ``kge_tpu``'s."""

import glob
import logging
import os

import numpy as np
import pytest

from kge_tpu.models.rgnn.encoder import (
    build_graph_buffers as jax_build_graph_buffers,
)
from kge_tpu_torch import native
from kge_tpu_torch.models.rgnn.encoder import build_graph_buffers
from tests.torch_mesh_launch import REPO

SPLITS = sorted(
    glob.glob(os.path.join(REPO, "data", "*", "*.del"))
    + glob.glob(os.path.join(REPO, "tests", "data", "*", "*.del")))
SPLITS = [p for p in SPLITS if os.path.basename(p) in (
    "train.del", "valid.del", "test.del")]


def loadtxt(path):
    return np.loadtxt(path, dtype=np.int64, usecols=(0, 1, 2),
                      ndmin=2).astype(np.int32)


@pytest.fixture
def without_gxx(monkeypatch, tmp_path):
    """No g++ on PATH and no library built yet: the fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    yield
    native._LIB = None  # the next caller builds or loads it again


def test_library_builds_into_the_build_folder():
    lib = native.library()
    assert lib is not None
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert str(path).startswith(os.path.join(REPO, "kge_tpu_torch",
                                             "_build"))
    assert path.exists()


@pytest.mark.parametrize("path", SPLITS,
                         ids=[os.path.relpath(p, REPO) for p in SPLITS])
def test_parse_triples_matches_loadtxt(path):
    got = native.parse_triples(path)
    assert got.dtype == np.int32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, loadtxt(path))


def test_parse_triples_extra_fields_and_blank_lines(tmp_path):
    path = tmp_path / "t.del"
    path.write_text("1\t2\t3\textra\n\n4 5 6\r\n7\t8\t9")
    np.testing.assert_array_equal(native.parse_triples(str(path)),
                                  [[1, 2, 3], [4, 5, 6], [7, 8, 9]])


@pytest.mark.parametrize("keys,buckets", [
    (np.zeros(0, np.int32), 5),
    (np.zeros(0, np.int32), 0),
    (np.zeros(17, np.int32), 1),
    (np.random.default_rng(0).integers(0, 50, 1000), 50),
    (np.random.default_rng(1).zipf(1.5, 5000) % 300, 300),
], ids=["empty", "empty-no-buckets", "one-bucket", "uniform", "skewed"])
def test_counting_argsort_matches_stable_argsort(keys, buckets):
    got = native.counting_argsort(keys, buckets)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


def test_counting_argsort_rejects_keys_outside_the_buckets():
    with pytest.raises(ValueError):
        native.counting_argsort(np.array([0, 3], np.int32), 3)


def test_numpy_fallback_without_gxx(without_gxx, caplog):
    """Without g++ the host ops log their fallback once and return
    numpy's arrays."""
    keys = np.random.default_rng(2).integers(0, 9, 200)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        order = native.counting_argsort(keys, 9)
        triples = native.parse_triples(SPLITS[0])
    assert native.library() is None
    assert [r.getMessage() for r in caplog.records].count(
        next(r.getMessage() for r in caplog.records)) == 1
    assert "falling back to numpy" in caplog.records[0].getMessage()
    np.testing.assert_array_equal(order, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(triples, loadtxt(SPLITS[0]))


@pytest.mark.parametrize("per_relation", [False, True])
def test_graph_buffers_match_kge_tpu(per_relation):
    """The R-GNN edge buffers, sorted by the counting sort, are
    kge_tpu's."""
    triples = native.parse_triples(os.path.join(REPO, "data", "toy",
                                                "train.del"))
    want = jax_build_graph_buffers(triples, 9, per_relation,
                                   num_entities=120)
    got = build_graph_buffers(triples, 9, per_relation, num_entities=120)
    for key in ("edge_index", "edge_type", "edge_orig", "rel_buckets",
                "rel_bucket_ids", "rgcn_groups_vert"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key])
