"""K3, the row-sparse Adagrad and SGD updates (kge_tpu_torch/ops/
row_update.py), against kge_tpu's: on CPU tensors the port's wrappers
(their plain versions) match ``adagrad_row_update`` / ``sgd_row_update``
in interpret mode and the XLA form of ``KgeOptimizer.sparse_row_update``
on the same seeded inputs, including a run of equal ids carrying its
gradient at its last position and the ids 0 and V-1.

Tolerance rtol 1e-6 / atol 1e-7 on the touched rows: the Pallas form
(``table - lr * g / (sqrt(s) + eps)``) and the XLA form (``table +
(-lr * u)``) round differently, by up to one ulp of a unit-scale entry
(1.19e-7). The untouched rows must be exactly equal. The kernel itself
runs only on a card (the ``cuda`` test here, and ``chip_smoke.py``),
where it gives the plain version's bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu import Config as JaxConfig
from kge_tpu.ops.pallas.row_update import (
    adagrad_row_update as jax_adagrad_row_update,
    sgd_row_update as jax_sgd_row_update,
)
from kge_tpu.train.optimizer import KgeOptimizer as JaxKgeOptimizer
from kge_tpu_torch.ops import row_update as ru

# toy-size tensors: one torch thread, since the test workers share the
# cores and an oversubscribed thread pool slows small ops many times over
torch.set_num_threads(1)

V, R, D = 64, 24, 16
LR, EPS = 0.2, 1e-10
TOL = dict(rtol=1e-6, atol=1e-7)


def make_inputs(seed, v=V, r=R, d=D):
    """(table, sum, uniq, rows_g): sorted ids with 0 and v-1 and a run of
    three equal ids whose first two positions carry zero gradient rows;
    one touched row with a zero gradient; sums of an Adagrad state."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ssum = rng.uniform(0.0, 2.0, (v, d)).astype(np.float32)
    inner = rng.choice(np.arange(1, v - 1), r - 4, replace=False)
    dup = inner[0]
    uniq = np.sort(np.concatenate([[0, v - 1, dup, dup], inner])).astype(
        np.int32)
    rows_g = rng.standard_normal((r, d)).astype(np.float32)
    run = np.flatnonzero(uniq == dup)
    assert len(run) == 3
    rows_g[run[:-1]] = 0.0  # only the last position of the run carries
    rows_g[np.flatnonzero(uniq == inner[1])] = 0.0  # a zero-gradient row
    return table, ssum, uniq, rows_g


def port_update(optimizer, table, ssum, uniq, rows_g, ids=torch.int64):
    t, s = torch.tensor(table), torch.tensor(ssum)
    u, g = torch.tensor(uniq, dtype=ids), torch.tensor(rows_g)
    if optimizer == "adagrad":
        ru.adagrad_row_update(t, s, u, g, LR, EPS)
    else:
        ru.sgd_row_update(t, u, g, LR)
    return t.numpy(), s.numpy()


def jax_kernel_update(optimizer, table, ssum, uniq, rows_g):
    lr = jnp.float32(LR)
    if optimizer == "adagrad":
        t, s = jax_adagrad_row_update(jnp.asarray(table), jnp.asarray(ssum),
                                      jnp.asarray(uniq), jnp.asarray(rows_g),
                                      lr, EPS, interpret=True)
        return np.asarray(t), np.asarray(s)
    t = jax_sgd_row_update(jnp.asarray(table), jnp.asarray(uniq),
                           jnp.asarray(rows_g), lr, interpret=True)
    return np.asarray(t), ssum


def jax_xla_update(optimizer, table, ssum, uniq, rows_g):
    config = JaxConfig()
    config.set("console.quiet", True)
    config.set("train.optimizer.default.type",
               "Adagrad" if optimizer == "adagrad" else "SGD")
    config.set("train.optimizer.default.args.lr", LR, create=True)
    config.set("train.optimizer.default.args.eps", EPS, create=True)
    params = {"table": jnp.asarray(table)}
    opt = JaxKgeOptimizer(config, params, sparse_paths=("table",))
    state = {"sum": jnp.asarray(ssum)} if optimizer == "adagrad" else {}
    t, new_state = opt.sparse_row_update(
        "table", params["table"], state, jnp.asarray(uniq),
        jnp.asarray(rows_g), {"default": jnp.float32(LR)}, in_place=False)
    return np.asarray(t), np.asarray(new_state.get("sum", ssum))


def assert_update_close(got, want, table, ssum, uniq):
    touched = np.zeros(len(table), dtype=bool)
    touched[uniq] = True
    for name, g, w, before in zip(("table", "sum"), got, want,
                                  (table, ssum)):
        np.testing.assert_allclose(g[touched], w[touched], err_msg=name,
                                   **TOL)
        np.testing.assert_array_equal(g[~touched], w[~touched],
                                      err_msg=name)
        np.testing.assert_array_equal(g[~touched], before[~touched],
                                      err_msg=name)


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_form"])
def test_plain_version_matches_kge_tpu(optimizer, reference):
    inputs = make_inputs(seed=0)
    want = (jax_kernel_update if reference == "pallas_interpret"
            else jax_xla_update)(optimizer, *inputs)
    got = port_update(optimizer, *inputs)
    assert_update_close(got, want, inputs[0], inputs[1], inputs[2])
    if optimizer == "sgd":  # SGD keeps no accumulator
        np.testing.assert_array_equal(got[1], inputs[1])


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_duplicate_run_and_zero_rows(optimizer):
    """A run of equal ids updates its row once, from the last position's
    gradient and the pre-update row; a zero gradient leaves a row's bits
    as they were; int32 and int64 ids agree bit for bit."""
    table, ssum, uniq, rows_g = make_inputs(seed=1)
    got = port_update(optimizer, table, ssum, uniq, rows_g)
    assert all(np.array_equal(a, b) for a, b in zip(
        got, port_update(optimizer, table, ssum, uniq, rows_g, torch.int32)))
    run = np.flatnonzero(uniq == uniq[np.flatnonzero(
        np.diff(uniq) == 0)[0]])
    single = port_update(optimizer, table, ssum, uniq[run[-1:]],
                         rows_g[run[-1:]])
    row = uniq[run[-1]]
    for a, b in zip(got, single):
        np.testing.assert_array_equal(a[row], b[row])
    zero = np.flatnonzero(~rows_g.any(axis=1) & (np.r_[np.diff(uniq), 1] != 0))
    assert len(zero) == 1
    np.testing.assert_array_equal(got[0][uniq[zero]], table[uniq[zero]])


def test_nan_gradient_stays_in_its_element():
    table, ssum, uniq, rows_g = make_inputs(seed=2)
    rows_g[5, 3] = np.nan
    t, s = port_update("adagrad", table, ssum, uniq, rows_g)
    nan = np.zeros_like(t, dtype=bool)
    nan[uniq[5], 3] = True
    np.testing.assert_array_equal(np.isnan(t), nan)
    np.testing.assert_array_equal(np.isnan(s), nan)


def test_cpu_tensors_take_the_plain_version():
    before = (ru.adagrad_row_update.launches, ru.sgd_row_update.launches)
    for optimizer in ("adagrad", "sgd"):
        port_update(optimizer, *make_inputs(seed=3))
    assert (ru.adagrad_row_update.launches,
            ru.sgd_row_update.launches) == before == (0, 0)


def _bad_inputs(case):
    table, ssum, uniq, rows_g = (torch.tensor(x) for x in make_inputs(4))
    uniq = uniq.long()
    if case == "float64 table":
        table = table.double()
    elif case == "float uniq":
        uniq = uniq.float()
    elif case == "rows_g width":
        rows_g = rows_g[:, :-1].contiguous()
    elif case == "uniq length":
        uniq = uniq[:-1]
    elif case == "sum shape":
        ssum = ssum[:-8]
    elif case == "strided rows_g":
        rows_g = torch.cat([rows_g, rows_g], dim=1)[:, ::2]
    elif case == "meta device":
        table, ssum, uniq, rows_g = (x.to("meta")
                                     for x in (table, ssum, uniq, rows_g))
    return table, ssum, uniq, rows_g


@pytest.mark.parametrize("case", [
    "float64 table", "float uniq", "rows_g width", "uniq length",
    "sum shape", "strided rows_g", "meta device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    table, ssum, uniq, rows_g = _bad_inputs(case)
    with pytest.raises((TypeError, ValueError)):
        ru.adagrad_row_update(table, ssum, uniq, rows_g, LR, EPS)
    if case != "sum shape":
        with pytest.raises((TypeError, ValueError)):
            ru.sgd_row_update(table, uniq, rows_g, LR)


@pytest.mark.cuda
def test_row_update_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    table, ssum, uniq, rows_g = (
        torch.from_numpy(x).cuda()
        for x in make_inputs(seed=0, v=4096, r=700, d=128))
    uniq = uniq.long()
    for optimizer in ("adagrad", "sgd"):
        got = [table.clone(), ssum.clone()]
        want = [table.clone(), ssum.clone()]
        if optimizer == "adagrad":
            before = ru.adagrad_row_update.launches
            ru.adagrad_row_update(*got, uniq, rows_g, LR, EPS)
            assert ru.adagrad_row_update.launches == before + 1
            ru.adagrad_row_update_reference(*want, uniq, rows_g, LR, EPS)
        else:
            before = ru.sgd_row_update.launches
            ru.sgd_row_update(got[0], uniq, rows_g, LR)
            assert ru.sgd_row_update.launches == before + 1
            ru.sgd_row_update_reference(want[0], uniq, rows_g, LR)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
