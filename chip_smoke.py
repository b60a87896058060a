#!/usr/bin/env python3
"""Drive kge_tpu_torch on one CUDA card and hold its kernels against
their plain PyTorch versions.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of the port from ``kge_tpu_torch/csrc`` (one nvcc
   process per source, all started together);
3. kernel phase: ``rank_counts`` (``csrc/rank_count.cu``) against
   ``rank_counts_reference`` on the card, at the evaluation shape
   (B=100, C=14,541, D=128), at the last batch of that run (B=66) and at
   a Wikidata5M-size table (B=1024, C=4,818,679, D=128), on seeded normal
   inputs plus constructed cases (duplicate candidate rows, +-inf and
   NaN true scores, NaN candidate rows, cand_valid holes, a ragged tail).
   Counts must be equal; the only pairs allowed to differ are those whose
   float64 score lies within 1e-6*|t| of the tie boundary. Times are
   medians over CUDA-event-timed runs after warm-up;
4. eval phase: a synthetic dataset with FB15k-237's sizes (14,541
   entities, 237 relations, 272,115 / 17,535 / 20,466 triples, skewed
   degrees) and a ComplEx dim-128 checkpoint with seeded random weights
   are written to a temporary folder; ``python -m kge_tpu_torch test``'s
   entry point evaluates it on the card, which must launch the kernel
   twice per batch (410 launches); the metrics must be finite and agree
   with the same evaluation on the host (plain version); a last run
   under torch.profiler prints where the eval's time goes;
5. K1 kernel phase: ``shared_ce_loss`` (``csrc/negsamp_loss.cu``) against
   ``shared_ce_loss_reference`` on the card, at the training shape
   (B=1024 rows, N=129 candidates, D=128), at a ragged one (B=1000,
   N=37) and on constructed cases (a row with no drawn candidate, rows of
   weight 0, an undrawn candidate scoring 1600, a NaN score with a
   positive count): loss and lse within rtol 1e-5, the gradients (kernel
   forward + torch backward vs autograd through the plain version)
   within rtol 1e-4, atol 1e-6, and the loss bit-identical over 10 runs;
6. train phase: ``python -m kge_tpu_torch start``'s entry point trains
   ComplEx dim 128 on the same synthetic graph with the hyperparameters
   of ``examples/wikidata5m-complex-train.yaml`` (shared negative
   sampling 128 + 128, ``batch`` scoring, ``kl`` loss, Adagrad lr 0.2,
   batch 1024) for 2 epochs with validation after each; every loss goes
   through K1 (2 launches per step, 1064 in all) and every validation
   through K2; the losses must be finite and fall; ``resume`` continues
   to epoch 3; epoch 1 is re-run from ``checkpoint_00000.pt`` on the card
   and on the host (plain K1) and the losses compared; a last epoch
   under torch.profiler prints where a training epoch's time goes.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero when no CUDA device is present or the package
is missing.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

FB15K237 = dict(entities=14541, relations=237,
                splits=dict(train=272115, valid=17535, test=20466))
EVAL_BATCH = 100
DIM = 128
W5M_ENTITIES = 4818679
ATOL, RTOL = 1e-5, 1e-4
# the training main path (examples/wikidata5m-complex-train.yaml)
TRAIN_BATCH, NEGATIVES, VALID_BATCH = 1024, 128, 256
TRAIN_STEPS = math.ceil(FB15K237["splits"]["train"] / TRAIN_BATCH)


def fail(message: str):
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# ----------------------------------------------------------------- kernel


def make_rank_inputs(B, C, D, seed, device):
    """Seeded normal q/cand plus constructed cases; returns
    (q, cand, true, cand_valid)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, D, generator=g, device=device)
    cand = torch.randn(C, D, generator=g, device=device)
    n_dup = 25
    cand[C - 2 * n_dup:C - n_dup] = cand[:n_dup]  # exact duplicate rows
    cand[n_dup + 5] = float("nan")  # a NaN-scoring candidate
    cand_valid = torch.ones(C, device=device)
    cand_valid[n_dup + 7::53] = 0.0  # holes
    # true scores: high in the score distribution, as for the true answer
    # of a trained model (std of a score is sqrt(D) here)
    true = math.sqrt(D) * (1.5 + torch.randn(B, generator=g,
                                             device=device).abs())
    # rows 3..: tie exactly with a duplicated candidate pair (the
    # highest-scoring of the duplicated rows, float64, rounded to float32)
    n_tie = min(10, max(0, B - 3))
    if n_tie:
        s64 = q[3:3 + n_tie].double() @ cand[:n_dup].double().T
        true[3:3 + n_tie] = s64.max(dim=1).values.float()
    specials = [float("inf"), float("-inf"), float("nan")][:B]
    true[:len(specials)] = torch.tensor(specials, device=device)
    return q.contiguous(), cand.contiguous(), true.contiguous(), cand_valid


def boundary_pairs(q, cand, true, valid, chunk=1 << 18):
    """Per row of ``q``: the valid candidates whose float64 score lies
    within 1e-6*|t| of the tie boundary |s - t| = atol + rtol*|t| (the
    tolerance formed in float32, as the kernel forms it). Rows with a
    non-finite true score have no boundary."""
    t = true.double()
    tol = (ATOL + RTOL * true.abs()).double()  # float32 ops, then widened
    counts = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    q64 = q.double()
    for c0 in range(0, cand.shape[0], chunk):
        s = cand[c0:c0 + chunk].double() @ q64.T  # [chunk, rows]
        near = ((s - t).abs() - tol).abs() <= 1e-6 * t.abs()
        near &= valid[c0:c0 + chunk, None] > 0
        counts += near.sum(dim=0)
    return torch.where(torch.isfinite(t), counts, torch.zeros_like(counts))


def check_rank_counts(rc, label, q, cand, true, valid) -> dict:
    r_k, t_k = rc.rank_counts(q, cand, true, valid, ATOL, RTOL)
    torch.cuda.synchronize()
    r_p, t_p = rc.rank_counts_reference(q, cand, true, valid, ATOL, RTOL)
    torch.cuda.synchronize()
    d_rank = (r_k.long() - r_p.long()).abs()
    d_ties = (t_k.long() - t_p.long()).abs()
    rows = ((d_rank > 0) | (d_ties > 0)).nonzero().flatten()
    n_boundary = 0
    if len(rows):
        near = boundary_pairs(q[rows], cand, true[rows], valid)
        n_boundary = int(near.sum())
        for r, n in zip(rows.tolist(), near.tolist()):
            if int(d_rank[r]) > n or int(d_ties[r]) > n:
                fail(f"rank_counts {label}: row {r} kernel ({int(r_k[r])}, "
                     f"{int(t_k[r])}) vs plain ({int(r_p[r])}, "
                     f"{int(t_p[r])}), only {n} pairs at the tie boundary")
    if int(t_k[1]) == 0 and float(true[1]) == float("-inf"):
        fail(f"rank_counts {label}: NaN candidate did not tie with -inf")
    max_err = max(int(d_rank.max()), int(d_ties.max()))
    print(f"rank_counts {label}: B={q.shape[0]} C={cand.shape[0]} "
          f"D={q.shape[1]} equal on {q.shape[0] - len(rows)}/{q.shape[0]} "
          f"rows; differing rows {len(rows)}, max_abs_err {max_err}, "
          f"boundary pairs in them {n_boundary}; ties sum "
          f"{int(t_k.sum())}, rank sum {int(r_k.sum())}", flush=True)
    return dict(max_abs_err=max_err, boundary_pairs=n_boundary)


def kernel_phase(rc, seed, device) -> dict:
    B, C, D = EVAL_BATCH, FB15K237["entities"], DIM
    q, cand, true, valid = make_rank_inputs(B, C, D, seed, device)
    main = check_rank_counts(rc, "eval shape", q, cand, true, valid)
    tail = FB15K237["splits"]["test"] % EVAL_BATCH
    check_rank_counts(rc, "last batch", q[:tail].contiguous(), cand,
                      true[:tail].contiguous(), valid)

    ms = cuda_ms(lambda: rc.rank_counts(q, cand, true, valid, ATOL,
                                               RTOL), reps=50)
    plain_ms = cuda_ms(lambda: rc.rank_counts_reference(
        q, cand, true, valid, ATOL, RTOL), reps=20)
    library_ms = cuda_ms(lambda: torch.matmul(q, cand.T), reps=50)
    flops = 2.0 * B * C * D
    moved = 4.0 * (B * D + C * D + B + C) + 2 * 4.0 * B
    bound_ms = max(flops / PEAK_FP32_FLOPS, moved / PEAK_BYTES_PER_S) * 1e3
    bound_by = ("operations" if flops / PEAK_FP32_FLOPS
                >= moved / PEAK_BYTES_PER_S else "bytes")
    print(f"rank_counts eval shape: kernel_ms {ms} plain_ms {plain_ms} "
          f"library_ms (matmul q @ cand.T) {library_ms} bound_ms {bound_ms} "
          f"({bound_by}; {flops / 1e9} GFLOP, {moved / 1e6} MB)", flush=True)

    # Wikidata5M-size table: correctness, and one timing for the record
    Bw = 1024
    qw, cw, tw, vw = make_rank_inputs(Bw, W5M_ENTITIES, D, seed + 1,
                                      device)
    w5m = check_rank_counts(rc, "wikidata5m size", qw, cw, tw, vw)
    w_ms = cuda_ms(lambda: rc.rank_counts(qw, cw, tw, vw, ATOL, RTOL),
                   reps=5, warmup=1)
    w_plain = cuda_ms(lambda: rc.rank_counts_reference(
        qw, cw, tw, vw, ATOL, RTOL), reps=3, warmup=1)
    w_flops = 2.0 * Bw * W5M_ENTITIES * D
    w_bytes = 4.0 * (Bw * D + W5M_ENTITIES * D + Bw + W5M_ENTITIES) + 8.0 * Bw
    w_bound = max(w_flops / PEAK_FP32_FLOPS, w_bytes / PEAK_BYTES_PER_S) * 1e3
    print(f"rank_counts wikidata5m size: kernel_ms {w_ms} plain_ms {w_plain} "
          f"bound_ms {w_bound} ({w_flops / 1e9} GFLOP, {w_bytes / 1e9} GB)",
          flush=True)
    del qw, cw, tw, vw
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(main["max_abs_err"], w5m["max_abs_err"]),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


# ----------------------------------------------------------------- eval


def write_dataset(folder: str, seed: int):
    """A synthetic knowledge graph with FB15k-237's sizes: distinct
    triples, entity and relation frequencies Zipf-skewed (exponent 1),
    so some queries have hundreds of filtered answers as in the real
    graph."""
    rng = np.random.default_rng(seed)
    E, R = FB15K237["entities"], FB15K237["relations"]
    total = sum(FB15K237["splits"].values())
    pe = 1.0 / np.arange(1, E + 1)
    pr = 1.0 / np.arange(1, R + 1)
    ent = rng.permutation(E)
    triples = np.zeros((0, 3), dtype=np.int64)
    while len(triples) < total:
        n = int(1.3 * total)
        drawn = np.stack([
            ent[rng.choice(E, n, p=pe / pe.sum())],
            rng.choice(R, n, p=pr / pr.sum()),
            ent[rng.choice(E, n, p=pe / pe.sum())],
        ], axis=1)
        triples = np.unique(np.concatenate([triples, drawn]), axis=0)
    triples = triples[rng.permutation(len(triples))[:total]]
    os.makedirs(folder)
    start = 0
    for split, n in FB15K237["splits"].items():
        np.savetxt(os.path.join(folder, f"{split}.del"),
                   triples[start:start + n], fmt="%d", delimiter="\t")
        start += n
    for name, count in (("entity_ids", E), ("relation_ids", R)):
        with open(os.path.join(folder, f"{name}.del"), "w") as f:
            f.writelines(f"{i}\t/synthetic/{name}/{i}\n" for i in range(count))


def write_checkpoint(run_folder: str, dataset_folder: str, seed: int,
                     device):
    """config.yaml + checkpoint_best.pt of a ComplEx dim-128 model with
    weights drawn by the port's initializer, in the shared format."""
    from kge_tpu_torch import Config, Dataset
    from kge_tpu_torch.models import KgeModel
    from kge_tpu_torch.utils.io import save_checkpoint

    config = Config(folder=run_folder)
    config.set("model", "complex")
    config._import("complex")
    config.set("lookup_embedder.dim", DIM)
    config.set("dataset.name", dataset_folder)
    config.set("eval.batch_size", EVAL_BATCH)
    config.set("random_seed.default", seed)
    config.set("valid.metric", "mean_reciprocal_rank_filtered")
    config.set("console.quiet", True)
    config.init_folder()
    dataset = Dataset.create(config)
    generator = torch.Generator(device=device).manual_seed(seed)
    model = KgeModel.create(config, dataset, device=device,
                            generator=generator)
    checkpoint = {"type": "train", "epoch": 0, "job_id": "chip-smoke"}
    model.save_to(checkpoint)
    config.save_to(checkpoint)
    dataset.save_to(checkpoint)
    save_checkpoint(config.checkpoint_file("best"), checkpoint)


def eval_phase(rc, seed, device, scratch) -> dict:
    from kge_tpu_torch import cli

    t0 = time.perf_counter()
    dataset_folder = os.path.join(scratch, "fb15k237-synthetic")
    run_folder = os.path.join(scratch, "complex-run")
    write_dataset(dataset_folder, seed)
    write_checkpoint(run_folder, dataset_folder, seed, device)
    print(f"eval setup (dataset + checkpoint): "
          f"{time.perf_counter() - t0} s", flush=True)

    rc.rank_counts.launches = 0
    t0 = time.perf_counter()
    trace = cli.main(["test", run_folder])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = rc.rank_counts.launches

    n_test = FB15K237["splits"]["test"]
    expected = 2 * math.ceil(n_test / EVAL_BATCH)
    metrics = {k: v for k, v in trace.items()
               if k.startswith(("mean_", "hits_"))}
    epoch_time = trace["epoch_time"]
    print("eval on the card: " + json.dumps(dict(
        seconds_cli=seconds, seconds_eval_epoch=epoch_time,
        queries_per_s=2 * n_test / epoch_time,
        rank_counts_launches=launches, **metrics)), flush=True)
    if launches != expected:
        fail(f"eval launched rank_counts {launches} times, "
             f"expected {expected}")
    if not metrics or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"eval metrics missing or not finite: {metrics}")
    if not 0.0 < metrics["mean_reciprocal_rank_filtered"] <= 1.0:
        fail("mean_reciprocal_rank_filtered out of range")

    # the same evaluation on the host (plain version) as the reference
    t0 = time.perf_counter()
    host = cli.main(["test", run_folder, "--job.device", "cpu"])
    print(f"eval on the host (reference): {time.perf_counter() - t0} s",
          flush=True)
    worst = 0.0
    for key, value in metrics.items():
        diff = abs(value - host[key]) / max(1.0, abs(host[key]))
        worst = max(worst, diff)
        if diff > 1e-4:
            fail(f"eval metric {key}: card {value} vs host {host[key]}")
    print(f"eval metrics card vs host: largest relative difference {worst}",
          flush=True)
    profile_run("eval", "entity_ranking.",
                lambda: cli.main(["test", run_folder]))
    return dict(launches=launches, dataset_folder=dataset_folder)


def profile_run(label: str, span_prefix: str, run):
    """Where a run's time goes: ``run()`` (which returns a trace entry with
    ``epoch_time``) under torch.profiler; prints the host time of the
    ``record_function`` spans named ``span_prefix*``, the device time by
    kernel, and the device's busy share of the epoch (the profiler's own
    cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace = run()
        torch.cuda.synchronize()
    spans, device = {}, {}
    for e in prof.events():
        if e.name.startswith(span_prefix):
            if e.device_type == DeviceType.CPU:  # host side of a span
                spans[e.name] = spans.get(e.name, 0.0) + e.cpu_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:  # kernel, memcpy, memset
            ms, n = device.get(e.name[:90], (0.0, 0))
            device[e.name[:90]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    device_ms = sum(ms for ms, _ in device.values())
    epoch_ms = trace["epoch_time"] * 1e3
    top = sorted(device.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"{label} profile: " + json.dumps(dict(
        epoch_ms=epoch_ms, host_span_ms=spans, device_busy_ms=device_ms,
        device_busy_share_of_epoch=device_ms / epoch_ms,
        device_ms_by_kernel=[[name, ms, n] for name, (ms, n) in top],
    )), flush=True)
    if device_ms == 0:
        print(f"{label} profile: the profiler saw no device time; device "
              "busy share not measured", flush=True)


# ----------------------------------------------------------------- K1


def make_k1_inputs(B, N, D, seed, device):
    """Seeded inputs of the fused loss with scores of unit scale: q,
    cand, pos, counts (0-3 draws, a quarter of the columns undrawn), w."""
    g = torch.Generator(device=device).manual_seed(seed)
    scale = D ** -0.25
    q = scale * torch.randn(B, D, generator=g, device=device)
    cand = scale * torch.randn(N, D, generator=g, device=device)
    pos = torch.randn(B, generator=g, device=device)
    counts = torch.randint(0, 4, (B, N), generator=g, device=device).float()
    w = torch.ones(B, device=device)
    return [q, cand, pos, counts, w]


def constructed_k1_inputs(inputs):
    """Special rows: row 0 draws no candidate (lse = pos, adds 0), rows
    1-9 weigh 0, and row 10 did not draw candidate 5, which scores 1600
    for it (it must not enter the max, nor give 0 * inf in the
    gradient)."""
    q, cand, pos, counts, w = (x.clone() for x in inputs)
    counts[0] = 0.0
    w[1:10] = 0.0
    q[10] = 0.0
    q[10, 0] = 40.0
    cand[5] = 0.0
    cand[5, 0] = 40.0
    counts[10, 5] = 0.0
    return [q, cand, pos, counts, w]


def nan_k1_inputs(inputs):
    """Candidate 7 scores NaN for every row; only row 11 drew it, so only
    row 11's lse (and the loss) is NaN."""
    q, cand, pos, counts, w = (x.clone() for x in inputs)
    cand[7, 1] = float("nan")
    counts[:, 7] = 0.0
    counts[11, 7] = 1.0
    return [q, cand, pos, counts, w]


def assert_close(label, got, want, rtol, atol) -> float:
    """Fail unless |got - want| <= atol + rtol * |want| everywhere (NaN
    where the other is NaN); returns the largest absolute difference."""
    ok = torch.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
    diff = (got - want).abs().nan_to_num(0.0)
    if not bool(ok.all()):
        fail(f"{label}: {int((~ok).sum())} of {ok.numel()} values differ, "
             f"largest absolute difference {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def check_k1(nl, label, inputs) -> float:
    """Kernel vs plain version: loss and lse within rtol 1e-5, gradients
    of q, cand, pos within rtol 1e-4 / atol 1e-6; returns the largest
    absolute lse difference."""
    loss, lse = nl.shared_ce_forward(*inputs)
    ref_loss, ref_lse = nl.shared_ce_loss_reference(*inputs)
    err = assert_close(f"shared_ce_loss {label} lse", lse, ref_lse,
                       1e-5, 1e-6)
    assert_close(f"shared_ce_loss {label} loss", loss, ref_loss, 1e-5, 0.0)
    grads = []
    for fn in (nl.shared_ce_loss,
               lambda *x: nl.shared_ce_loss_reference(*x)[0]):
        leaves = [x.clone().requires_grad_() for x in inputs[:3]]
        fn(*leaves, *inputs[3:]).backward()
        grads.append([x.grad for x in leaves])
    if bool(torch.isfinite(ref_loss)):
        for name, got, want in zip(("d_q", "d_cand", "d_pos"), *grads):
            if not bool(torch.isfinite(got).all()):
                fail(f"shared_ce_loss {label}: {name} not finite")
            assert_close(f"shared_ce_loss {label} {name}", got, want,
                         1e-4, 1e-6)
    B, D = inputs[0].shape
    print(f"shared_ce_loss {label}: B={B} N={inputs[1].shape[0]} D={D} "
          f"loss {float(loss)} (plain {float(ref_loss)}, relative "
          f"difference {abs(float(loss - ref_loss)) / abs(float(ref_loss))}"
          f"), lse max_abs_err {err}", flush=True)
    return err


def k1_phase(nl, seed, device) -> dict:
    B, N, D = TRAIN_BATCH, NEGATIVES + 1, DIM
    main = make_k1_inputs(B, N, D, seed, device)
    err = check_k1(nl, "training shape", main)
    err = max(err, check_k1(nl, "ragged", make_k1_inputs(1000, 37, D,
                                                        seed + 1, device)))
    special = constructed_k1_inputs(main)
    err = max(err, check_k1(nl, "special rows", special))
    loss, lse = nl.shared_ce_forward(*special)
    if float(lse[0]) != float(special[2][0]) or not bool(torch.isfinite(loss)):
        fail("shared_ce_loss: a row with no drawn candidate must give "
             "lse = pos, and the loss must stay finite")
    nan = nan_k1_inputs(main)
    check_k1(nl, "NaN score", nan)
    loss, lse = nl.shared_ce_forward(*nan)
    if not (bool(torch.isnan(lse[11])) and bool(torch.isfinite(lse[12:]).all())
            and bool(torch.isnan(loss))):
        fail("shared_ce_loss: a NaN score with counts > 0 must give a NaN "
             "lse in its row only")
    bits = {float(nl.shared_ce_forward(*main)[0]) for _ in range(10)}
    if len(bits) != 1:
        fail(f"shared_ce_loss is not deterministic: {sorted(bits)}")

    q, cand = main[0], main[1]
    ms = cuda_ms(lambda: nl.shared_ce_forward(*main), reps=50)
    plain_ms = cuda_ms(lambda: nl.shared_ce_loss_reference(*main), reps=50)
    library_ms = cuda_ms(lambda: torch.matmul(q, cand.T), reps=50)
    flops = 2.0 * B * N * D
    moved = 4.0 * (B * D + N * D + B * N + 3 * B + 1)
    bound_ms = max(flops / PEAK_FP32_FLOPS, moved / PEAK_BYTES_PER_S) * 1e3
    bound_by = ("operations" if flops / PEAK_FP32_FLOPS
                >= moved / PEAK_BYTES_PER_S else "bytes")
    print(f"shared_ce_loss training shape: kernel_ms {ms} plain_ms "
          f"{plain_ms} library_ms (matmul q @ cand.T) {library_ms} bound_ms "
          f"{bound_ms} ({bound_by}; {flops / 1e6} MFLOP, {moved / 1e6} MB); "
          "loss bit-identical over 10 runs", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


# ----------------------------------------------------------------- train


def write_train_config(path: str, dataset_folder: str, seed: int):
    """The training main path: the hyperparameters of
    examples/wikidata5m-complex-train.yaml on the synthetic graph, 2
    epochs with validation after each."""
    config = {
        "job": {"type": "train"},
        "dataset": {"name": dataset_folder},
        "model": "complex",
        "lookup_embedder": {
            "dim": DIM, "initialize": "normal_",
            "initialize_args": {"normal_": {"std": 0.03}},
            "regularize_args": {"weighted": True},
        },
        "train": {
            "type": "negative_sampling", "loss": "kl", "max_epochs": 2,
            "batch_size": TRAIN_BATCH,
            "optimizer": {"default": {"type": "Adagrad",
                                      "args": {"lr": 0.2}}},
        },
        "negative_sampling": {
            "num_samples": {"s": NEGATIVES, "o": NEGATIVES},
            "shared": True, "implementation": "batch",
        },
        "valid": {"every": 1, "metric": "mean_reciprocal_rank_filtered",
                  "early_stopping": {"patience": 5}},
        "eval": {"batch_size": VALID_BATCH},
        "random_seed": {"default": seed},
        "console": {"quiet": True},
    }
    with open(path, "w") as f:
        yaml.safe_dump(config, f)


def read_trace(folder: str, **match):
    with open(os.path.join(folder, "trace.yaml")) as f:
        entries = [yaml.safe_load(line) for line in f]
    return [e for e in entries
            if all(e.get(k) == v for k, v in match.items())]


def copy_run(source: str, target: str, checkpoint: str):
    """A new run folder holding ``source``'s config and one checkpoint."""
    os.makedirs(target)
    for name in ("config.yaml", checkpoint):
        shutil.copy(os.path.join(source, name), target)


def train_phase(rc, nl, seed, scratch, dataset_folder) -> dict:
    from kge_tpu_torch import cli

    n_train = FB15K237["splits"]["train"]
    config_file = os.path.join(scratch, "complex-negsamp.yaml")
    write_train_config(config_file, dataset_folder, seed)
    run = os.path.join(scratch, "train-run")

    # the main path: start, 2 epochs, a validation after each
    rc.rank_counts.launches = 0
    nl.shared_ce_loss.launches = 0
    t0 = time.perf_counter()
    cli.main(["start", config_file, "--folder", run])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1, k2 = nl.shared_ce_loss.launches, rc.rank_counts.launches
    copy_run(run, os.path.join(scratch, "epoch1-cuda"), "checkpoint_00000.pt")
    copy_run(run, os.path.join(scratch, "epoch1-cpu"), "checkpoint_00000.pt")

    epochs = read_trace(run, event="epoch_completed", job="train")
    valids = read_trace(run, event="eval_completed", job="eval")
    for e in epochs:
        print("train epoch on the card: " + json.dumps(dict(
            epoch=e["epoch"], avg_loss=e["avg_loss"], batches=e["batches"],
            epoch_seconds=e["epoch_time"],
            triples_per_s=n_train / e["epoch_time"],
            ms_per_step=1e3 * e["epoch_time"] / e["batches"])), flush=True)
    print("train start on the card: " + json.dumps(dict(
        seconds_cli=seconds, shared_ce_loss_launches=k1,
        rank_counts_launches=k2,
        valid_mrr_filtered=[v["mean_reciprocal_rank_filtered"]
                            for v in valids])), flush=True)
    want_k1 = 2 * TRAIN_STEPS * 2
    want_k2 = 2 * 2 * math.ceil(FB15K237["splits"]["valid"] / VALID_BATCH)
    if k1 != want_k1:
        fail(f"training launched shared_ce_loss {k1} times, expected "
             f"{want_k1}")
    if k2 != want_k2:
        fail(f"validation launched rank_counts {k2} times, expected "
             f"{want_k2}")
    losses = [e["avg_loss"] for e in epochs]
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        fail(f"training losses missing or not finite: {losses}")
    if not losses[1] < losses[0]:
        fail(f"the epoch-2 loss {losses[1]} is not below epoch 1's "
             f"{losses[0]}")
    if len(valids) != 2 or not all(
            0.0 < v["mean_reciprocal_rank_filtered"] <= 1.0 for v in valids):
        fail("validation after each epoch missing or out of range")

    # resume to epoch 3
    nl.shared_ce_loss.launches = 0
    resumed = cli.main(["resume", run, "--train.max_epochs", "3"])
    torch.cuda.synchronize()
    print(f"train resume on the card: epoch {resumed['epoch']} avg_loss "
          f"{resumed['avg_loss']} epoch_seconds {resumed['epoch_time']}",
          flush=True)
    if resumed["epoch"] != 3 or not math.isfinite(resumed["avg_loss"]):
        fail(f"resume did not reach a finite epoch 3: {resumed}")
    if nl.shared_ce_loss.launches != 2 * TRAIN_STEPS:
        fail(f"the resumed epoch launched shared_ce_loss "
             f"{nl.shared_ce_loss.launches} times")

    # card vs host: epoch 1 again from the same initial weights
    runs = {}
    for device in ("cuda", "cpu"):
        folder = os.path.join(scratch, f"epoch1-{device}")
        t0 = time.perf_counter()
        entry = cli.main([
            "resume", folder, "--train.max_epochs", "1", "--valid.every",
            "0", "--train.trace_level", "batch", "--tpu.fused_negsamp_loss",
            "always", "--job.device", device])
        first = read_trace(folder, scope="batch")[0]["avg_loss"]
        runs[device] = dict(first_batch_loss=first,
                            avg_loss=entry["avg_loss"],
                            epoch_seconds=entry["epoch_time"],
                            seconds_cli=time.perf_counter() - t0)
    card, host = runs["cuda"], runs["cpu"]
    first_rel = abs(card["first_batch_loss"] - host["first_batch_loss"]) / abs(
        host["first_batch_loss"])
    epoch_rel = abs(card["avg_loss"] - host["avg_loss"]) / abs(
        host["avg_loss"])
    print("train epoch 1 card vs host (plain K1): " + json.dumps(dict(
        card=card, host=host, first_batch_relative_difference=first_rel,
        epoch_avg_loss_relative_difference=epoch_rel,
        start_run_epoch1_avg_loss=losses[0])), flush=True)
    if first_rel > 1e-5:
        fail(f"first batch loss: card {card['first_batch_loss']} vs host "
             f"{host['first_batch_loss']}")
    # the weights part after the first step: Adagrad's first update of an
    # element is about lr * sign(g), so a gradient at rounding-noise size
    # moves by 2 * lr in the other summation order; a few such elements
    # among 1.9M shift the epoch average slightly
    if epoch_rel > 1e-3:
        fail(f"epoch avg_loss: card {card['avg_loss']} vs host "
             f"{host['avg_loss']}")

    # one more epoch under the profiler, without validation
    folder = os.path.join(scratch, "profiled")
    copy_run(run, folder, "checkpoint_00003.pt")
    profile_run("train", "train.", lambda: cli.main([
        "resume", folder, "--train.max_epochs", "4", "--valid.every", "0"]))
    return dict(k1_launches=k1)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device available")
    if not os.path.isdir(os.path.join(REPO, "kge_tpu_torch")):
        fail(f"kge_tpu_torch not found next to {__file__}")
    sys.path.insert(0, REPO)
    from kge_tpu_torch.ops import native
    from kge_tpu_torch.ops import negsamp_loss as nl
    from kge_tpu_torch.ops import rank_count as rc

    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libraries = native.build()
    print(f"built {sorted(libraries)} in {time.perf_counter() - t0} s",
          flush=True)
    for name, path in libraries.items():
        log = path.with_suffix(".log")
        if log.exists():
            print(f"nvcc {name}: " + " | ".join(
                line.strip() for line in log.read_text().splitlines()
                if "registers" in line or "spill" in line), flush=True)

    k2 = kernel_phase(rc, args.seed, device)
    k1 = k1_phase(nl, args.seed, device)
    os.makedirs(os.path.join(REPO, "local"), exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="chip_smoke-",
                               dir=os.path.join(REPO, "local"))
    try:
        ev = eval_phase(rc, args.seed, device, scratch)
        tr = train_phase(rc, nl, args.seed, scratch, ev["dataset_folder"])
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    print(json.dumps({"kernels": [dict(
        name="rank_counts", route="cuda",
        source="kge_tpu_torch/csrc/rank_count.cu",
        replaces="kge_tpu/ops/pallas/rank_count.py:42",
        launches=ev["launches"], max_abs_err=k2["max_abs_err"],
        ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
        bound_by=k2["bound_by"], library_ms=k2["library_ms"],
    ), dict(
        name="shared_ce_loss", route="cuda",
        source="kge_tpu_torch/csrc/negsamp_loss.cu",
        replaces="kge_tpu/ops/pallas/negsamp_loss.py:44",
        launches=tr["k1_launches"], max_abs_err=k1["max_abs_err"],
        ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
        bound_by=k1["bound_by"], library_ms=k1["library_ms"],
    )]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
