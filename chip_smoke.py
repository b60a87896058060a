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
   under torch.profiler prints where the eval's time goes.

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
    profile_eval(cli, run_folder)
    return dict(launches=launches)


def profile_eval(cli, run_folder):
    """Where the card eval's time goes: one more run under torch.profiler;
    prints the host time of the eval loop's spans (record_function in
    entity_ranking.py), the device time by kernel, and the device's busy
    share of the eval epoch (the profiler's own cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace = cli.main(["test", run_folder])
        torch.cuda.synchronize()
    spans, device = {}, {}
    for e in prof.events():
        if e.name.startswith("entity_ranking."):
            if e.device_type == DeviceType.CPU:  # host side of a span
                spans[e.name] = spans.get(e.name, 0.0) + e.cpu_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:  # kernel, memcpy, memset
            ms, n = device.get(e.name[:90], (0.0, 0))
            device[e.name[:90]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    device_ms = sum(ms for ms, _ in device.values())
    epoch_ms = trace["epoch_time"] * 1e3
    top = sorted(device.items(), key=lambda kv: -kv[1][0])[:10]
    print("eval profile: " + json.dumps(dict(
        epoch_ms=epoch_ms, host_span_ms=spans, device_busy_ms=device_ms,
        device_busy_share_of_epoch=device_ms / epoch_ms,
        device_ms_by_kernel=[[name, ms, n] for name, (ms, n) in top],
    )), flush=True)
    if device_ms == 0:
        print("eval profile: the profiler saw no device time; device busy "
              "share not measured", flush=True)


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
    os.makedirs(os.path.join(REPO, "local"), exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="chip_smoke-",
                               dir=os.path.join(REPO, "local"))
    try:
        ev = eval_phase(rc, args.seed, device, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    print(json.dumps({"kernels": [dict(
        name="rank_counts", route="cuda",
        source="kge_tpu_torch/csrc/rank_count.cu",
        replaces="kge_tpu/ops/pallas/rank_count.py:42",
        launches=ev["launches"], max_abs_err=k2["max_abs_err"],
        ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
        bound_by=k2["bound_by"], library_ms=k2["library_ms"],
    )]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
