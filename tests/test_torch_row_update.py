"""K3, the row-sparse Adagrad and SGD updates (kge_tpu_torch/ops/
row_update.py), against kge_tpu's: on CPU tensors the port's wrappers
(their plain versions) match ``adagrad_row_update`` / ``sgd_row_update``
in interpret mode and the XLA form of ``KgeOptimizer.sparse_row_update``
on the same seeded inputs, including a run of equal ids carrying its
gradient at its last position and the ids 0 and V-1. The grouped entry
``row_update_groups`` (several tables, each with its own lr and eps, in
one launch on a card) is held against them one table at a time.

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


def jax_kernel_update(optimizer, table, ssum, uniq, rows_g, lr=LR, eps=EPS):
    lr = jnp.float32(lr)
    if optimizer == "adagrad":
        t, s = jax_adagrad_row_update(jnp.asarray(table), jnp.asarray(ssum),
                                      jnp.asarray(uniq), jnp.asarray(rows_g),
                                      lr, eps, interpret=True)
        return np.asarray(t), np.asarray(s)
    t = jax_sgd_row_update(jnp.asarray(table), jnp.asarray(uniq),
                           jnp.asarray(rows_g), lr, interpret=True)
    return np.asarray(t), ssum


def jax_xla_update(optimizer, table, ssum, uniq, rows_g, lr=LR, eps=EPS):
    config = JaxConfig()
    config.set("console.quiet", True)
    config.set("train.optimizer.default.type",
               "Adagrad" if optimizer == "adagrad" else "SGD")
    config.set("train.optimizer.default.args.lr", lr, create=True)
    config.set("train.optimizer.default.args.eps", eps, create=True)
    params = {"table": jnp.asarray(table)}
    opt = JaxKgeOptimizer(config, params, sparse_paths=("table",))
    state = {"sum": jnp.asarray(ssum)} if optimizer == "adagrad" else {}
    t, new_state = opt.sparse_row_update(
        "table", params["table"], state, jnp.asarray(uniq),
        jnp.asarray(rows_g), {"default": jnp.float32(lr)}, in_place=False)
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


#: groups of a grouped call: (V, R, D, lr, eps, ids dtype); R = 0 is a
#: table the step did not touch
GROUPS = {
    "one": [(V, R, D, LR, EPS, torch.int64)],
    "two": [(V, R, D, LR, EPS, torch.int32),
            (48, 12, 12, 0.05, 1e-6, torch.int64)],
    "two-and-empty": [(V, R, D, LR, EPS, torch.int64),
                      (48, 12, 12, 0.05, 1e-6, torch.int32),
                      (16, 0, D, 0.3, 1e-8, torch.int64)],
}


def make_groups(case, seed):
    """[(table, sum, uniq, rows_g, lr, eps, ids dtype)] as numpy arrays,
    each from make_inputs (a run of equal ids, a zero-gradient row, the
    ids 0 and V-1) or, for R = 0, an untouched table."""
    groups = []
    for k, (v, r, d, lr, eps, ids) in enumerate(GROUPS[case]):
        if r == 0:
            rng = np.random.default_rng(seed + k)
            inputs = (rng.standard_normal((v, d)).astype(np.float32),
                      rng.uniform(0.0, 2.0, (v, d)).astype(np.float32),
                      np.zeros(0, np.int32), np.zeros((0, d), np.float32))
        else:
            inputs = make_inputs(seed + k, v, r, d)
        groups.append((*inputs, lr, eps, ids))
    return groups


def port_groups(optimizer, groups):
    """The port's grouped call on CPU tensors; returns [(table, sum)]."""
    tensors = [(torch.tensor(t), torch.tensor(s), torch.tensor(u, dtype=ids),
                torch.tensor(g), lr, eps)
               for t, s, u, g, lr, eps, ids in groups]
    ru.row_update_groups(optimizer, [
        (t, s if optimizer == "adagrad" else None, u, g, lr, eps)
        for t, s, u, g, lr, eps in tensors])
    return [(t.numpy(), s.numpy()) for t, s, *_ in tensors]


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
@pytest.mark.parametrize("case", list(GROUPS))
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_form"])
def test_grouped_plain_version_matches_kge_tpu(optimizer, case, reference):
    """One grouped call against kge_tpu's functions one table at a time,
    each with its own lr and eps; a group with R = 0 stays as it was."""
    groups = make_groups(case, seed=5)
    got = port_groups(optimizer, groups)
    update = (jax_kernel_update if reference == "pallas_interpret"
              else jax_xla_update)
    for (table, ssum, uniq, rows_g, lr, eps, _), out in zip(groups, got):
        if len(uniq) == 0:
            np.testing.assert_array_equal(out[0], table)
            np.testing.assert_array_equal(out[1], ssum)
            continue
        want = update(optimizer, table, ssum, uniq, rows_g, lr=lr, eps=eps)
        assert_update_close(out, want, table, ssum, uniq)
        if optimizer == "sgd":
            np.testing.assert_array_equal(out[1], ssum)


def test_grouped_call_equals_one_table_calls():
    """A grouped call gives each table the bits of its own one-table call,
    with int32 and int64 ids alike."""
    for optimizer in ("adagrad", "sgd"):
        groups = make_groups("two-and-empty", seed=6)
        got = port_groups(optimizer, groups)
        for (table, ssum, uniq, rows_g, lr, eps, ids), out in zip(groups,
                                                                   got):
            t, s = torch.tensor(table), torch.tensor(ssum)
            u, g = torch.tensor(uniq, dtype=ids), torch.tensor(rows_g)
            if optimizer == "adagrad":
                ru.adagrad_row_update(t, s, u, g, lr, eps)
            else:
                ru.sgd_row_update(t, u, g, lr)
            np.testing.assert_array_equal(out[0], t.numpy())
            np.testing.assert_array_equal(out[1], s.numpy())
    assert (ru.adagrad_row_update.launches,
            ru.sgd_row_update.launches) == (0, 0)


def _bad_groups(case):
    """Two Adagrad groups on the CPU, with one fault."""
    groups = [[torch.tensor(x) for x in make_inputs(7 + k)] + [LR, EPS]
              for k in range(2)]
    if case == "mixed devices":
        groups[1][:4] = [x.to("meta") for x in groups[1][:4]]
    elif case == "too many groups":
        groups = groups * 3
    elif case == "float64 rows_g":
        groups[1][3] = groups[1][3].double()
    elif case == "strided table":
        groups[1][0] = torch.cat([groups[1][0]] * 2, dim=1)[:, ::2]
    elif case == "non-contiguous uniq":
        groups[1][2] = torch.stack([groups[1][2]] * 2, dim=1)[:, 0]
    elif case == "no sum":
        groups[1][1] = None
    return [tuple(g) for g in groups]


@pytest.mark.parametrize("case", [
    "mixed devices", "too many groups", "float64 rows_g", "strided table",
    "non-contiguous uniq", "no sum"])
def test_grouped_entry_refuses_what_the_kernel_does_not_take(case):
    groups = _bad_groups(case)
    before = [t.clone() for t, *_ in groups]
    with pytest.raises((TypeError, ValueError)):
        ru.row_update_groups("adagrad", groups)
    if case != "mixed devices":  # nothing was written before the refusal
        assert all(torch.equal(t, b) for (t, *_), b in zip(groups, before))


@pytest.mark.cuda
def test_grouped_kernel_matches_reference_on_card():
    """Two tables in one launch (int32 and int64 ids, D = 128 on float4
    lanes and D = 37 one element a lane, a leading-row view at 4 bytes
    past 16) against the plain version, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    shapes = ((4096, 700, 128, torch.int32), (512, 300, 37, torch.int64))
    for optimizer in ("adagrad", "sgd"):
        got, want = [], []
        for k, (v, r, d, ids) in enumerate(shapes):
            table, ssum, uniq, rows_g = (
                torch.from_numpy(x).cuda()
                for x in make_inputs(seed=k, v=v, r=r, d=d))
            view = table.clone()
            if d % 4:  # the table at 4 bytes past a 16-byte boundary
                flat = torch.empty(v * d + 1, device="cuda")
                flat[1:] = table.flatten()
                view = flat[1:].view(v, d)
            lr, eps = LR / (k + 1), EPS * (k + 1)
            adagrad = optimizer == "adagrad"
            got.append((view, ssum.clone() if adagrad else None,
                        uniq.to(ids), rows_g, lr, eps))
            want.append((table.clone(), ssum.clone() if adagrad else None,
                         uniq.long(), rows_g, lr, eps))
        counter = (ru.adagrad_row_update if optimizer == "adagrad"
                   else ru.sgd_row_update)
        before = counter.launches
        ru.row_update_groups(optimizer, got)
        assert counter.launches == before + 1
        ru.row_update_groups_reference(optimizer, want)
        for a, b in zip(got, want):
            assert torch.equal(a[0], b[0])
            if a[1] is not None:
                assert torch.equal(a[1], b[1])


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
