"""Ranks of the port's mesh runs as subprocesses, for the CPU tests.

``launch(n, args)`` starts ``n`` processes of ``python <args>`` with a
``gloo`` rendezvous on a free local port (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), retrying on
another port when the one picked was taken meanwhile, and kills every
rank when one hangs past the timeout (no rank may cost the suite its
time limit). ``python -m tests.torch_mesh_launch <mode> <json>`` is a
rank of this module's own jobs: ``train`` (a training job on a dataset
folder, its epochs, validations and tables written per rank) and
``collectives`` (the collectives with autograd, the R-GNN halo route's
among them, and the sharded kernel routes against their unsharded
results). Nothing here imports JAX.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180
#: how long the other ranks get to end on their own after one fails
GRACE = 10


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(n, args, port, env, logs):
    procs = []
    for rank in range(n):
        rank_env = {**os.environ, **(env or {}),
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "WORLD_SIZE": str(n), "RANK": str(rank),
                    "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, *args], cwd=REPO, env=rank_env,
            stdout=logs[rank], stderr=subprocess.STDOUT, text=True))
    return procs


def launch(n, args, env=None, timeout=TIMEOUT, attempts=3):
    """(return codes, outputs) of ``n`` ranks of ``python <args>``. Once
    a rank fails the others are killed (they would wait for it in a
    collective); a port taken meanwhile starts them again on another."""
    for attempt in range(attempts):
        logs = [tempfile.TemporaryFile("w+") for _ in range(n)]
        procs = _start(n, args, free_port(), env, logs)
        deadline = time.time() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    # the others may fail on their own in a moment
                    deadline = min(deadline, time.time() + GRACE)
                if time.time() > deadline:
                    if all(p.poll() in (None, 0) for p in procs):
                        raise subprocess.TimeoutExpired(args, timeout)
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
        taken = any("EADDRINUSE" in o or "address already in use" in
                    o.lower() for o in outs)
        if not taken or attempt == attempts - 1:
            return [p.returncode for p in procs], outs
    raise AssertionError("unreachable")


def launch_ok(n, args, **kwargs):
    """Outputs of ``launch``; every rank must succeed."""
    rcs, outs = launch(n, args, **kwargs)
    for rank, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


def run_job(n, spec, **kwargs):
    """Each rank's result of the ``train`` mode with ``spec``."""
    launch_ok(n, ["-m", "tests.torch_mesh_launch", "train",
                  json.dumps(spec)], **kwargs)
    results = []
    for rank in range(n):
        with open(os.path.join(spec["out"], f"rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


# ---------------------------------------------------------------- rank side


def _train(spec):
    """One rank of a training job: ``config`` (a YAML file), ``options``
    set over it, ``dataset`` (a folder), ``folder`` (the job's, or
    None), ``resume`` (a checkpoint file). Writes the epochs' losses and
    the validations' metrics, the final model state and, from
    ``tables``, the whole tables (every rank gathers; rank 0 writes)."""
    import numpy as np
    import torch

    from kge_tpu_torch import Config, Dataset
    from kge_tpu_torch.ops.negsamp_loss import shared_ce_loss
    from kge_tpu_torch.ops.rank_count import rank_counts
    from kge_tpu_torch.ops.row_update import (
        adagrad_row_update, sgd_row_update,
    )
    from kge_tpu_torch.parallel import distributed as dist
    from kge_tpu_torch.parallel.collectives import halo_exchange
    from kge_tpu_torch.train.job import Job
    from kge_tpu_torch.utils.io import load_checkpoint
    from kge_tpu_torch.utils.params import state_dict_from_params

    torch.set_num_threads(1)
    folder = spec.get("folder")
    if spec.get("folder_on_rank0_only") and os.environ["RANK"] != "0":
        folder = None
    config = Config(folder=folder)
    config.load(spec["config"], create=True)
    for key, value in spec.get("options", {}).items():
        config.set(key, value, create=True)
    dist.maybe_init_from_config(config)
    if folder and dist.is_primary():
        config.init_folder()
    dist.barrier()
    dataset = Dataset.create(config, spec["dataset"])
    if spec.get("resume"):
        checkpoint = load_checkpoint(spec["resume"])
        checkpoint["folder"] = folder  # this run's, not the checkpoint's
        job = Job.create_from(checkpoint, new_config=config, dataset=dataset)
    else:
        job = Job.create(config, dataset)
    losses = []
    job.post_epoch_hooks.append(lambda j: losses.append(
        [j.current_trace["epoch"][k] for k in ("avg_loss", "avg_cost")]))
    job.run()
    result = {
        "rank": dist.process_index(),
        "losses": losses,
        "valid": [t.get("mean_reciprocal_rank_filtered")
                  for t in job.valid_trace],
        "state": job.model.state() and {
            k: {s: np.asarray(v).tolist() for s, v in stats.items()}
            for k, stats in job.model.state().items()},
        "launches": {"shared_ce_loss": shared_ce_loss.launches,
                     "rank_counts": rank_counts.launches,
                     "row_update": adagrad_row_update.launches
                     + sgd_row_update.launches},
        "log_folder": job.config.log_folder,
        "param_sums": {name: float(p.detach().double().sum())
                       for name, p in job.model.named_parameters()},
        "halo_exchanges": halo_exchange.calls,
    }
    os.makedirs(spec["out"], exist_ok=True)
    if spec.get("tables"):
        params = job.model.params()  # collective: every rank gathers
        if dist.is_primary():
            np.savez(os.path.join(spec["out"], "tables.npz"),
                     **state_dict_from_params(params))
    with open(os.path.join(spec["out"],
                           f"rank{dist.process_index()}.json"), "w") as f:
        json.dump(result, f)


def _collectives(spec):
    """The collectives with autograd and the sharded K1 and K2 routes on
    2 ranks, against plain indexing and the unsharded results; writes
    each check's largest difference."""
    import numpy as np
    import torch

    from kge_tpu_torch import Config
    from kge_tpu_torch.ops.negsamp_loss import (
        shared_ce_loss, shared_ce_loss_reference,
    )
    from kge_tpu_torch.ops.rank_count import rank_counts
    from kge_tpu_torch.parallel import distributed as dist
    from kge_tpu_torch.parallel.collectives import (
        enter_blocks, gather_table, halo_exchange, model_sum, vocab_lookup,
    )
    from kge_tpu_torch.parallel.mesh import build_mesh

    torch.set_num_threads(1)
    config = Config()
    config.set("job.device", "cpu")
    dist.maybe_init_from_config(config)
    rng = np.random.default_rng(0)  # one draw on every rank
    out = {}

    def diff(a, b):
        return float((a.double() - b.double()).abs().max())

    # vocab-parallel lookup and table gather over a model axis of 2
    config.set("tpu.mesh.data", 1)
    config.set("tpu.mesh.model", 2)
    mesh = build_mesh(config)
    group = mesh.group("model")
    table = torch.from_numpy(rng.standard_normal((16, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 16, (3, 7)))
    g = torch.from_numpy(rng.standard_normal((3, 7, 5)).astype(np.float32))
    lo, hi = mesh.rows(16)
    shard = table[lo:hi].clone().requires_grad_()
    rows = vocab_lookup(shard, idx, lo, group)
    rows.backward(g)
    want = torch.zeros_like(table).index_add_(0, idx.reshape(-1),
                                              g.reshape(-1, 5))
    out["lookup"] = diff(rows, table[idx])
    out["lookup_grad"] = diff(shard.grad, want[lo:hi])
    shard.grad = None
    full = gather_table(shard, group, mesh.model_index)
    gt = torch.from_numpy(rng.standard_normal((16, 5)).astype(np.float32))
    (full * gt).sum().backward()
    out["gather"] = diff(full, table)
    out["gather_grad"] = diff(shard.grad, gt[lo:hi])
    shard.grad = None
    total = model_sum((shard ** 2).sum(), group)
    total.backward()
    out["model_sum"] = diff(total, (table ** 2).sum())
    out["model_sum_grad"] = diff(shard.grad, 2 * table[lo:hi])

    # the R-GNN halo route's collectives: the exchange of 3 rows a pair
    # of blocks (send[q, p]: the rows block q sends to block p), the
    # replicated weights entering the blocks
    me, S = mesh.model_index, 8
    send = torch.from_numpy(rng.integers(0, S, (2, 2, 3)))
    g_halo = torch.from_numpy(rng.standard_normal((2, 6, 5)).astype(
        np.float32))
    local = table[lo:hi].clone().requires_grad_()
    got = halo_exchange(local, send[me], group)
    (got * g_halo[me]).sum().backward()
    out["halo"] = diff(got, torch.cat([table[q * S + send[q, me]]
                                       for q in range(2)]))
    want = torch.zeros(S, 5)
    for p in range(2):
        want.index_add_(0, send[me, p], g_halo[p][3 * me:3 * me + 3])
    out["halo_grad"] = diff(local.grad, want)
    w = torch.from_numpy(rng.standard_normal((5, 2)).astype(
        np.float32)).requires_grad_()
    (entered,) = enter_blocks([w], group)
    (table[lo:hi] @ entered).sum().backward()
    out["enter_grad"] = diff(w.grad, table.sum(0)[:, None].expand(5, 2))

    # K2 sharded: C = 13 candidates (not a multiple of the model axis),
    # padded to 16 rows; each model rank counts against its block
    C, B, D = 13, 9, 6
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    cand = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32))
    cand[4] = cand[2]  # exact ties
    true = (q @ cand.T)[torch.arange(B), torch.arange(B) % C]
    padded = torch.zeros(16, D)
    padded[:C] = cand
    valid = (torch.arange(16) < C).to(torch.float32)
    r, t = rank_counts(q, padded[lo:hi], true, valid[lo:hi], 1e-5, 1e-4)
    counts = torch.stack([r, t])
    torch.distributed.all_reduce(counts, group=group)
    r0, t0 = rank_counts(q, cand, true, torch.ones(C), 1e-5, 1e-4)
    out["k2"] = diff(counts, torch.stack([r0, t0]))

    # K1 sharded at a ragged batch (B = 7 over a data axis of 2): each
    # data rank's rows, the partial losses and gradients summed
    config.set("tpu.mesh.data", 2)
    config.set("tpu.mesh.model", 1)
    dmesh = build_mesh(config)
    dgroup = dmesh.group("data")
    B, N = 7, 5
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    cand = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    pos = torch.from_numpy(rng.standard_normal(B).astype(np.float32))
    counts = torch.from_numpy(rng.integers(0, 3, (B, N)).astype(np.float32))
    w = torch.ones(B)
    w[-1] = 0.0
    part_lo = B * dmesh.data_index // 2
    part_hi = B * (dmesh.data_index + 1) // 2
    ql = q[part_lo:part_hi].clone().requires_grad_()
    cl = cand.clone().requires_grad_()
    loss = shared_ce_loss(ql, cl, pos[part_lo:part_hi],
                          counts[part_lo:part_hi], w[part_lo:part_hi])
    loss.backward()
    summed = loss.detach().clone()
    torch.distributed.all_reduce(summed, group=dgroup)
    torch.distributed.all_reduce(cl.grad, group=dgroup)
    qr, cr = q.clone().requires_grad_(), cand.clone().requires_grad_()
    ref, _ = shared_ce_loss_reference(qr, cr, pos, counts, w)
    ref.backward()
    out["k1"] = diff(summed, ref)
    out["k1_grad_q"] = diff(ql.grad, qr.grad[part_lo:part_hi])
    out["k1_grad_cand"] = diff(cl.grad, cr.grad)
    with open(os.path.join(spec["out"],
                           f"rank{dist.process_index()}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    mode, raw = sys.argv[1:3]
    {"train": _train, "collectives": _collectives}[mode](json.loads(raw))
