#!/usr/bin/env python3
"""Drive kge_tpu_torch on one CUDA card and hold its kernels against
their plain PyTorch versions.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N] [--phases k2,conve,...]

``--phases`` runs a subset (see ``PHASES``; the kernels line needs them
all). Phases, each of which fails the run (non-zero exit) when it fails
(they run in the order of ``PHASES``; each prints its seconds):

1. the card's name and power limit (nvidia-smi);
2. build every kernel of the port from ``kge_tpu_torch/csrc`` (one nvcc
   process per source, all started together);
3. kernel phase: ``rank_counts`` (``csrc/rank_count.cu``) against
   ``rank_counts_reference`` on the card, at the evaluation shape
   (B=100, C=14,541, D=128), at the last batch of that run (B=66) and at
   a Wikidata5M-size table (B=1024, C=4,818,679, D=128), on seeded normal
   inputs plus constructed cases (duplicate candidate rows, +-inf and
   NaN true scores, NaN candidate rows, cand_valid holes, a ragged tail),
   and at the kernel's tile edges, in both of its shapes (B in {1, 127,
   128, 129, 256} at 14,541 candidates, B in {127, 128, 129} at 20,000,
   D = 37, D = 416, cand as a leading-row view of a longer table, 16-byte
   aligned and not). Counts must be equal; the only pairs allowed to differ are
   those whose float64 score lies within 1e-6*|t| of the tie boundary.
   Times are medians over CUDA-event-timed runs after warm-up; beside them
   the device time of a call (torch.profiler), the host time to enqueue
   one, and the device time of ``torch.matmul(q, cand.T)``; at the
   Wikidata5M table the time, device time and host time of a call at
   B = 1024 and B = 256, each with its bound, its plain version's time and
   the time of ``torch.matmul(q, cand.T)`` into one preallocated [B, C]
   buffer;
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
   N=37), at the kernel's edges (N in {1, 8, 129, 520} by B in {1, 129,
   1000}, and D = 37) and on constructed cases (a row with no drawn
   candidate, rows of weight 0, an undrawn candidate scoring 1600, a NaN
   score with a positive count): loss and lse within rtol 1e-5, the
   gradients (kernel forward + torch backward vs autograd through the
   plain version) within rtol 1e-4, atol 1e-6, and the loss bit-identical
   over 10 runs; one kernel a call (torch.profiler), with the same three
   extra times as K2;
6. train phase: ``python -m kge_tpu_torch start``'s entry point trains
   ComplEx dim 128 on the same synthetic graph with the hyperparameters
   of ``examples/wikidata5m-complex-train.yaml`` (shared negative
   sampling 128 + 128, ``batch`` scoring, ``kl`` loss, Adagrad lr 0.2,
   batch 1024) for 2 epochs with validation after each; every loss goes
   through K1 (2 launches per step, 1064 in all) and every validation
   through K2; the losses must be finite and fall; ``resume`` continues
   to epoch 3; epoch 1 is re-run from ``checkpoint_00000.pt`` on the card
   and on the host (plain K1) and the losses compared. At
   this size ``tpu.sparse_updates: auto`` keeps the tables dense: K3 must
   not launch;
7. K3 kernel phase (run before the eval phase): ``adagrad_row_update``
   and ``sgd_row_update`` (``csrc/row_update.cu``, one-table calls) and
   ``row_update_groups`` (several tables in one launch) against their
   plain versions on the card, at the Wikidata5M training shape (a
   [4,818,680, 128] table and sum, 2,306 sorted distinct ids spread over
   it, 0 and V-1 among them; int64 and int32 ids), at the relation shape
   (832 rows, all touched), a training step's two tables in one launch,
   the triple phase's step in one launch (a [14,544, 128] entity table
   with 8,192 of its rows and the [240, 128] relation table, int32 ids),
   on constructed cases (a run of equal ids with its gradient at the last
   position, zero-gradient rows, a NaN gradient element) and at the
   kernel's edges (R in {1, 2, 3, 5, 33, 257, 1031, 4099}, runs of equal
   ids of lengths 2-9 and 40 across warps and blocks, D = 37, leading-row
   views 16-byte aligned and not, four groups in one launch): table and
   sum bit for bit (at most 1 ulp, with the count printed), every
   untouched row unchanged; then at the entity shape, the relation shape
   and the two-table step the time of a call, its device and host time,
   and for SGD ``index_add_``'s (one a table), each with its bound; each
   call must be one launch. The learning rate is a float32 scalar on the
   card, which the kernel reads there (a captured training step's form;
   the timed calls take it so), or a host float; at the two training
   steps' shapes the kernel reading it on the card must give the plain
   version's tables and sums (host float) bit for bit;
8. SGD phase: one epoch of plain SGD with row-sparse updates
   (``tpu.sparse_updates always``) on the FB15k-237-size graph, one K3
   SGD launch a step for both tables (266), against the same epoch with
   dense SGD on the card (first batch within 1e-6 relative, epoch within
   1e-5);
9. Wikidata5M phase, the row-sparse path: a synthetic graph with
   Wikidata5M's sizes (4,818,679 entities, 828 relations, its train split
   cut to 500,000 triples, its 5,163 / 5,133 valid and test triples) and
   ``start`` of ``examples/wikidata5m-complex-train.yaml`` as it is for
   one epoch, then ``valid``: row-sparse updates must be on, the steps in
   groups of 4 replayed as CUDA graphs (121 replays: the first group is
   the warm-up, a 1-step tail), K3 Adagrad launched once a step for both
   tables (489 times, counted through the replays), K1 978 times, K2 42
   times, the loss finite and the MRR in (0, 1]. From the same
   ``checkpoint_00000.pt``, one epoch each row-sparse on the card, dense
   on the card and row-sparse on the host (plain K1 and K3): first batch within 1e-5 relative and
   epoch within 1e-3. Prints ms per step, triples/s, set-up and
   checkpoint-save seconds and peak device memory. Then, in jobs built
   without a folder: under ``torch.use_deterministic_algorithms`` the
   first 200 batches of 2 epochs captured against one step a dispatch
   and against 1 epoch saved, loaded and run on (losses, tables and
   Adagrad sums bit for bit, K1 and K3 counted through the replays equal
   to the per-batch run's), and 200-step windows of epoch 2 profiled,
   captured and eager (ms a step, triples/s, device busy share, peak
   memory). It needs about 10 GB of disk under ``local/`` (two 4.9 GB
   checkpoints at a time);
10. losses and optimizers (run after the K3 kernel phase), the card
   against the host on the same inputs: each of the eight losses, value
   and gradient, at the KvsAll shape ([128, 14,541] scores, smoothed
   matrix labels) and a negative-sampling one ([1024, 4], index labels),
   rtol 1e-5 and gradient atol 1e-6; each optimizer type (Adagrad, Adam,
   AdamW, Adamax, RMSprop, Adadelta, SGD plain, with momentum, with
   Nesterov) for 5 steps on ComplEx's two tables in two groups,
   parameters and state rtol 1e-5, atol 1e-7;
11. KvsAll phase, the main path of the trainers' slice (run after the
   SGD phase, on the FB15k-237-size graph): ``start`` with the train
   block of ``examples/recipes/fb15k237-compgcn.yaml`` (KvsAll, bce,
   label smoothing 0.1, Adam lr 0.001, batch 128, the sp_ and _po query
   types, tpu.steps_per_dispatch at its default 4, so the batch order is
   regrouped) on ComplEx dim 128 in place of CompGCN, 1 epoch with a
   validation (K2 138 times, K1 and K3 never), ``resume`` to epoch 2 (K2
   138 times); losses finite, MRR in (0, 1];
   epoch 1 again from ``checkpoint_00000.pt`` on the card and on the
   host, its first 50 batches (a host epoch takes minutes): the first
   batch within 1e-5 relative, their avg_loss within 1e-3 (the ConvE
   phase profiles the KvsAll path);
12. 1vsAll phase: one epoch with kl, Adagrad lr 0.2, batch 1024 and a
   validation (K2 138 times); its first batch on the card and the host
   within 1e-5;
13. triple phase: the negative sampler at its defaults (not shared, 3 +
   3 negatives, so ``auto`` scoring resolves to ``triple``) with
   filtering of o, bce, Adagrad lr 0.2, batch 1024,
   ``tpu.sparse_updates: always`` and weighted regularization, one
   epoch (K3 once a step for both tables, 266 times; K1 never), against
   the same epoch dense on the card: first batch within 1e-5, epoch
   within 1e-3 (phases 6, 9, 12 and 13 profile no epoch, to keep the
   run's time: the ConvE phase profiles the main path, and PERF.md keeps
   their last profiles);
14. K2 at this slice's query widths (run after the K2 kernel phase):
   D in {129, 201, 2,001} at B in {100, 256} over the 14,541-row table,
   the candidates a leading-row view of the 8-row-padded table (804-byte
   rows at D = 201: the 4-byte-copy path): counts as in phase 3, each
   shape's time, device and host time, bound, plain version's and
   ``torch.matmul``'s time;
15. ConvE phase, the main path of this slice (run after the eval
   phase): reciprocal ConvE by KvsAll at its published widths (dim 200
   as 20 x 10, 32 3 x 3 filters, dropout 0.2/0.2/0.3, label smoothing
   0.1, batch 128, Adam lr 0.003, ExponentialLR 0.995) on the
   FB15k-237-size graph, 1 epoch with a validation (K2 138 times, K1 and
   K3 never), ``resume`` to epoch 2, both in groups of 4 steps replayed
   as CUDA graphs with dropout and the batch-norm state inside (the log
   line, the replays: every group but the first of each batch shape);
   the first 50 batches of epoch 1 card vs host at dropout 0 (first
   batch within 1e-5, their avg_loss within 1e-3); dropout on the card
   by its statistics; under ``torch.use_deterministic_algorithms`` the
   first 200 batches of 2 epochs captured against one step a dispatch
   (in the grouped batch order) and against 1 epoch resumed to 2 (epoch
   losses and every checkpoint array bit for bit); windows of 200 steps
   of epoch 2 profiled, captured and eager (ms a step, device busy share,
   peak memory, top kernels);
16. scorer phase: DistMult, CP, SimplE, RESCAL, RelationalTucker3,
   TransE and RotatE (L1 and L2), TransH and the reciprocal Transformer
   at HittER's widths (``SCORERS``), each trained 20 steps on the card
   and from the same initial checkpoint on the host (first batch within
   1e-5, every batch within 1e-3), then its card-trained checkpoint
   evaluated on the first 500 test triples on the card and on the host
   (metrics within 1e-4, rank and tie counts equal but for pairs at the
   tie boundary within the float32 rounding of their scores, found in
   float64); each run asserts its route by the launches: K2
   10 in a fused evaluation and 0 in a generic one, K1 40 for the native
   dot forms' shared ``kl`` training, K3 20 for TransE-L1 row-sparse;
17. CompGCN phase, the main path of this slice (run after the eval
   phase): first the spectral route's kernel ``ccorr_reduce``
   (``csrc/ccorr_reduce.cu``) against its plain version at FB15k-237's
   sizes (14,541 nodes, 475 relation rows, 272,115 edges) on a
   Zipf-skewed graph with a node of 5,000 edges and a relation of 12% of
   the edges, the forward and the backward's two reductions at Kp 52 and
   102, within 1e-5 of float64, two calls bit-identical, one launch
   counted a call, and at Kp 52 each one's time, device and host time,
   plain version's time and bound; then ``start`` of
   ``examples/recipes/fb15k237-compgcn.yaml`` as it
   is (one message-passing layer, direction propagation, ccorr, edge
   norm, tanh, dropout 0.3 and 0.1, a linear relation transform,
   reciprocal ConvE at dim 200, KvsAll with bce and label smoothing 0.1,
   batch 128, Adam lr 0.001) on the FB15k-237-size graph, 1 epoch with a
   validation, ``resume`` for 1 more; its groups of 4 steps captured as
   CUDA graphs (the log's "Capturing groups of 4 steps as CUDA graphs."
   and each epoch's replayed batches, at least 90% of the epoch); K1, K2
   and K3 never launched (the generic eval route, dense training),
   ``ccorr_reduce`` 6 times a training step, counted through the
   replays, and twice an evaluation batch; the first 5 batches of
   epoch 1 card vs host at dropout 0 (first batch within 1e-5, their avg_loss
   within 1e-3; a host step runs the encoder over the whole graph); a
   window of 200 steps profiled (ms a step, queries/s, the
   ``train.*`` spans, device busy share, top kernels, peak memory);
18. R-GNN encoders phase: the FB15k-237 recipes of R-GCN (dim 500, 100
   blocks, a new 30,000-triple edge-neighbourhood subgraph an epoch, bce
   negative sampling), W-GCN (2 layers, ConvE) and RAGAT (2 heads,
   ``cross_weighted``, message weight) and the toy CompGCN + TransE
   example's configuration, at dropout 0: 3 steps card vs host (first
   batch within 1e-5, each within 1e-2: Adam's sign trap), then an
   evaluation of the first
   2,000 test triples card vs host on the generic route (metrics within
   1e-4, counts as in phase 16); K1, K2 and K3 never launched;
19. bf16 phase, the main path of this slice (run after the SGD phase):
   the train phase's ``start`` with ``--tpu.compute_dtype bfloat16``:
   ComplEx dim 128 with examples/wikidata5m-complex-train.yaml's
   hyperparameters, 2 epochs with a validation after each; K1 reads bf16
   operands twice a step (1,064), K2 ranks each validation in float32
   (276), K3 never; losses finite and falling; the checkpoint's
   parameters and Adagrad state float32; the first batch card vs host
   (plain K1) within 1e-2; epoch 1 within 2e-2 of the float32 run's;
   then ``valid --eval.type training_loss`` (a forward-only epoch of the
   valid split, K1 36 times) card vs host within 1e-5; a window of 200
   steps profiled (ms a step, triples/s, device busy share, peak memory);
20. utils phase, in a subprocess that must load no module of JAX or of
   the JAX package: ``package`` of the bf16 run's best checkpoint, a
   1-epoch float32 ``start`` from it by ``lookup_embedder.pretrain``
   (initial rows the package's bit for bit; K1 532, K2 138), ``dump
   checkpoint`` of the package and of both runs, ``dump trace`` of both
   runs;
21. pair ranking phase: ``test --eval.type entity_pair_ranking`` of the
   train phase's best float32 ComplEx checkpoint on the first 20 test
   triples (each against all 14,541^2 pairs under its relation), card
   and host: raw and filtered counts equal but for pairs at the tie
   boundary within the float32 rounding of their scores (found in
   float64 on the card), metrics within 1e-4; prints queries/s;
22. search phase: a ``grid_search`` (Adagrad lr {0.1, 0.2} x
   negative_sampling.num_samples.o {64, 128}) and an ``ax_search`` on the
   native backend (4 trials: 2 scrambled-Sobol, then the GP-EI phase),
   each trial 1 epoch of the train phase's config on ``cuda:0``
   (``search.device_pool``) validated through K2 (K1 532 and K2 138 a
   trial); ``resume`` of the finished ``ax_search`` launches nothing and
   finds the same best trial; prints the seconds per trial.

23. device_epoch phase, the main path of this slice (run after the
   train phase): the train phase's ``start`` at kge_tpu's defaults
   (``tpu.on_device_sampling: auto`` samples the shared negatives on the
   card, ``tpu.steps_per_dispatch: 4``): the epoch's positives uploaded
   once, each group of 4 steps a CUDA graph replay (the job's first group
   eagerly, its warm-up), a 2-step eager tail; 2 epochs with a validation
   after each (K1 1,064: 2 a step, counted through the replays; K2 276;
   131 replays), then
   ``resume`` to epoch 3 (K1 532, K2 138, 65 replays); the log must say
   that negatives are sampled on the device and groups captured; a
   ``training_loss`` validation drawn on the card in captured groups (K1
   36, 3 replays); epoch 1
   again captured and eagerly with the host's draws (``on_device_sampling
   never``, ``steps_per_dispatch 1``): ms a step, triples/s, host µs a
   dispatch; a 200-step window profiled (device busy share, leading
   kernels, peak memory with the graph pool); host µs and device ms of a
   replay; under ``torch.use_deterministic_algorithms`` the captured run
   against ``steps_per_dispatch 1`` (epoch losses and tables within
   1e-6) and epoch 3 after ``resume`` bit for bit a fresh 3-epoch run's;
   10,000 draws of ``device_shared_sample`` at the recipe's shape (num
   128, 14,541 entities) against their exact distributions (chi-square p
   >= 1e-3; nu's mean within 3 standard errors). Phases 6, 8, 16, 19-22
   and 9's comparisons pin ``tpu.on_device_sampling: never``: they hold
   the card against the host, whose draws cannot be Philox's.

24. mesh phase, the main path of this slice (run after the train
   phase): the train phase's job (the fused loss forced, host draws) for
   1 epoch with a validation on 4 ranks of ``python -m kge_tpu_torch
   start`` as a 2x2 mesh (sharing one card over gloo; a card each over
   NCCL on a machine with four), against one process on the card: epoch
   loss within rtol 1e-5; the mesh's validation against one process's
   ``valid`` of the mesh run's checkpoint: MRR within 1e-6, rank and tie
   counts equal; K1 532 and K2 138 on each rank (its rows, its block of
   the table) and in the one process; a 50-step window of every rank
   under torch.profiler (ms a step, the ``comm.*`` collectives' share);
   which collectives take CUDA tensors in the 4-rank group; then a
   row-sparse ``triple`` epoch on a 1x2 mesh, K3 266 times on each rank,
   its checkpoint equal to one process's under deterministic algorithms;
   a 1-rank NCCL group initialised and reduced on the card.
25. rgnn_mesh phase, the main path of this slice (run after the mesh
   phase): three R-GNN jobs at their recipes' widths on the
   FB15k-237-size graph, each for RGNN_MESH_STEPS steps on 4 ranks
   sharing the card as a 2x2 mesh, against the same steps in one
   process on the card: CompGCN's recipe (``ccorr``: the gathered
   route, no exchange), CompGCN with ``sub`` (the halo route) and
   RAGAT's recipe (halo attention), their dropout as the recipes set it
   (the masks are drawn over the whole graph on every rank). Checked:
   the route (exchanges counted on every rank, or none), the ranks'
   losses equal, the first step within 1e-5 of one process's, every
   step within 1e-2 (Adam's sign trap), K1, K2 and K3 never launched;
   printed: the halo bytes a layer against the whole-table gather's, ms
   a step in a profiled window and the ``comm.*`` share of it. Then
   CompGCN with ``sub`` in one process, the edge list against the dense
   adjacency (``always``) in float32 and bf16: ms a step and the losses
   (float32's first step within 1e-5 of the edge list's, bf16's within
   1e-2). The Wikidata5M-size phase prints the g++ host ops' seconds
   against numpy's on its split.

Prints a ``{"kernels": [...]}`` line (each kernel with its launches in
every run that drives a path, ``launches_by_phase``; K1's and K2's
``launches`` are the device_epoch main path's, K2's ``widths`` phase
14's shapes) and, last,
``{"ok": true, "device": {...}}``. Exits non-zero when no CUDA device is
present, the package is missing, or a module of JAX or of ``kge_tpu``
was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
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

# cuBLAS is deterministic under torch.use_deterministic_algorithms (the
# device_epoch phase's bit-for-bit checks) only with a fixed workspace
# configuration, read when its first handle is made; this is the size
# PyTorch gives a Hopper card anyway
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402
import yaml  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet (dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

FB15K237 = dict(entities=14541, relations=237,
                splits=dict(train=272115, valid=17535, test=20466))
EVAL_BATCH = 100
DIM = 128
W5M_ENTITIES = 4818679
# Wikidata5M's sizes (bench.py section_w5m, benchmarks/probe_real_w5m.py),
# its train split cut from 20.6M to 500,000 triples, its own valid and
# test splits
WIKIDATA5M = dict(entities=W5M_ENTITIES, relations=828,
                  splits=dict(train=500000, valid=5163, test=5133))
W5M_RECIPE = os.path.join("examples", "wikidata5m-complex-train.yaml")
ATOL, RTOL = 1e-5, 1e-4
# the training main path (examples/wikidata5m-complex-train.yaml)
TRAIN_BATCH, NEGATIVES, VALID_BATCH = 1024, 128, 256
TRAIN_STEPS = math.ceil(FB15K237["splits"]["train"] / TRAIN_BATCH)
# K2 launches of one validation at the FB15k-237 size: two sides a batch
VALID_LAUNCHES = 2 * math.ceil(FB15K237["splits"]["valid"] / VALID_BATCH)
# KvsAll's batch (examples/recipes/fb15k237-compgcn.yaml); the host
# compares this many of its batches with the card
KVSALL_BATCH, HOST_BATCHES = 128, 50
W5M_STEPS = math.ceil(WIKIDATA5M["splits"]["train"] / TRAIN_BATCH)
# rows a step touches: 2 per triple and 128 + 1 shared negatives per
# entity slot; every relation row (828, padded to 832)
W5M_ENTITY_ROWS = 2 * TRAIN_BATCH + 2 * (NEGATIVES + 1)
W5M_RELATION_ROWS = 832
# K3's inputs: the recipe's learning rate, Adagrad's default eps
K3_LR, K3_EPS = 0.2, 1e-10
# the triple phase's row-sparse step: 2 entity rows a triple and 3 + 3
# per-row negatives (the sampler's defaults), int32 ids into the tables
# padded to a multiple of 8 (every relation row is touched)
TRIPLE_ENTITY_ROWS = 2 * TRAIN_BATCH + 2 * 3 * TRAIN_BATCH
FB_ENTITY_ROWS = -(-FB15K237["entities"] // 8) * 8
FB_RELATION_ROWS = -(-FB15K237["relations"] // 8) * 8
# K2's query widths on this slice's paths: TransE with L2 at dim 128
# ([2q, -1]), reciprocal ConvE ([1 || features], dim 200 + 1) and a wide
# query past K2's shared-memory depth slices
SLICE_WIDTHS = (129, 201, 2001)
# ConvE's published FB15k-237 settings (Dettmers et al. 2018)
CONVE_DIM, CONVE_LR = 200, 0.003
_BASE = "--reciprocal_relations_model.base_model."
CONVE_NO_DROPOUT = [
    _BASE + "feature_map_dropout", "0.0", _BASE + "projection_dropout", "0.0",
    _BASE + "entity_embedder.dropout", "0.0",
    _BASE + "relation_embedder.dropout", "0.0"]
# every other scorer: steps trained card vs host, test triples evaluated
SCORER_STEPS, SCORER_TEST = 20, 500
# the KvsAll main paths' profiles hold a window of this many steps (the
# profiler's records of a whole epoch take minutes to collect)
PROFILE_STEPS = 200
# batches of each epoch in the bit-for-bit runs of captured groups,
# per-batch steps and a resume (ConvE's and Wikidata5M's)
DET_BATCHES = 200
# the R-GNN main path: CompGCN's FB15k-237 recipe (Vashishth et al.,
# ICLR 2020, arXiv:1911.03082); the host compares its first batches (a
# host step runs the encoder over the whole graph)
COMPGCN_RECIPE = os.path.join("examples", "recipes", "fb15k237-compgcn.yaml")
COMPGCN_HOST_BATCHES = 5
COMPGCN_NO_DROPOUT = [
    "--compgcn.encoder.emb_entity_dropout", "0.0",
    "--compgcn.encoder.message_passing_args.emb_propagation_dropout", "0.0",
    "--conve.feature_map_dropout", "0.0", "--conve.projection_dropout", "0.0"]
# the other encoders: their FB15k-237 recipes and the toy CompGCN + TransE
# example at its widths, each with its dropout at 0 (card vs host), its
# epochs (R-GCN's recipe takes one full-batch step an epoch over a new
# 30,000-triple subgraph) cut to RGNN_STEPS steps
_RECIPES = os.path.join("examples", "recipes")
RGNN_ENCODERS = {
    "rgcn": dict(recipe=os.path.join(_RECIPES, "fb15k237-rgcn.yaml"),
                 epochs=3, options={"rgcn.encoder.edge_dropout": 0.0,
                                    "rgcn.encoder.self_edge_dropout": 0.0}),
    "wgcn": dict(recipe=os.path.join(_RECIPES, "fb15k237-wgcn.yaml"),
                 epochs=1, options={
                     "wgcn.encoder.emb_entity_dropout": 0.0,
                     "wgcn.decoder.base_model.feature_map_dropout": 0.0,
                     "wgcn.decoder.base_model.projection_dropout": 0.0,
                     # rel_transformation self: the relations are ConvE's
                     # own embedder's, with its dropout
                     "wgcn.decoder.base_model.relation_embedder.dropout":
                         0.0}),
    "ragat": dict(recipe=os.path.join(_RECIPES, "fb15k237-ragat.yaml"),
                  epochs=1, options={
                      "ragat.encoder.emb_entity_dropout": 0.0,
                      "ragat.encoder.message_passing_args."
                      "emb_propagation_dropout": 0.0,
                      "conve.feature_map_dropout": 0.0,
                      "conve.projection_dropout": 0.0}),
    "transe-compgcn": dict(
        recipe=os.path.join("examples", "toy-transe-compgcn-train.yaml"),
        epochs=1, options={"compgcn.encoder.emb_entity_dropout": 0.0}),
}
RGNN_STEPS, RGNN_TEST, RGNN_EVAL_BATCH = 3, 2000, 500
# the spectral route's kernel at FB15k-237's sizes: the nodes, the relation
# rows (inverse relations and the loop relation), one half's edges
CCORR_NODES, CCORR_TYPES, CCORR_EDGES = 14541, 2 * 237 + 1, 272115
#: the launches of a run that takes no kernel's path (the R-GNN paths:
#: the generic eval route, dense training, no fused loss)
NO_KERNELS = dict(rank_counts=0, shared_ce_loss=0, adagrad_row_update=0,
                  sgd_row_update=0)
# Adagrad with an initial accumulator: its update is smooth in the
# gradient, so the card and the host stay on one trajectory (from a zero
# accumulator, Adagrad's and Adam's first update of an element is about
# lr * sign(g), which sends a rounding-noise gradient either way: PERF.md
# section 2; RelationalTucker3's projection then drifts 2% in 20 steps)
_ADAGRAD = {"default": {"type": "Adagrad", "args": {
    "lr": 0.1, "initial_accumulator_value": 0.1}}}
# shared kl, the training main path's sampler: K1 on a native dot form
_SHARED_KL = dict(
    train={"type": "negative_sampling", "loss": "kl", "optimizer": _ADAGRAD},
    sections={"negative_sampling": {
        "num_samples": {"s": NEGATIVES, "o": NEGATIVES}, "shared": True,
        "implementation": "batch"},
        # card vs host: the host's draws on both
        "tpu": {"fused_negsamp_loss": "always",
                "on_device_sampling": "never"}},
    k1=True, k3=False, route="fused")
# the toy-transe example's margin ranking over 8 + 8 negatives (auto
# scoring resolves to triple)
_MARGIN = dict(
    train={"type": "negative_sampling", "loss": "margin_ranking",
           "loss_arg": 4.0, "optimizer": _ADAGRAD},
    sections={"negative_sampling": {"num_samples": {"s": 8, "o": 8}}},
    k1=False, k3=False)
# the toy-rotate example's self-adversarial bce over shared negatives
_SELF_ADVERSARIAL = dict(
    train={"type": "negative_sampling", "loss": "bce_self_adversarial",
           "optimizer": _ADAGRAD},
    sections={"negative_sampling": {"num_samples": {"s": 64, "o": 64},
                                    "shared": True}},
    k1=False, k3=False)
SCORERS = {
    "distmult": dict(model="distmult", **_SHARED_KL),
    "cp": dict(model="cp", **_SHARED_KL),
    "simple": dict(model="simple", **_SHARED_KL),
    "rescal": dict(model="rescal", **_SHARED_KL),
    "relational_tucker3": dict(model="relational_tucker3", **_SHARED_KL),
    # row-sparse through K3
    "transe-l1": dict(model="transe", route="generic", **{
        **_MARGIN, "k3": True, "sections": {
            **_MARGIN["sections"], "tpu": {"sparse_updates": "always"}}}),
    "transe-l2": dict(model="transe", options={"l_norm": 2.0},
                      route="fused", **_MARGIN),
    "rotate-l1": dict(model="rotate", route="generic", **_SELF_ADVERSARIAL),
    "rotate-l2": dict(model="rotate", options={"l_norm": 2.0},
                      route="fused", **_SELF_ADVERSARIAL),
    "transh": dict(model="transh", route="generic", **_MARGIN),
    # HittER's widths (kge_tpu/models/transformer.yaml), dropout 0 for the
    # card vs host comparison
    "reciprocal-transformer": dict(
        model="transformer", reciprocal=True, options={
            "entity_embedder": {"dim": 320, "initialize": "xavier_uniform_"},
            "relation_embedder": {"dim": 320,
                                  "initialize": "xavier_uniform_"},
            "encoder": {"dropout": 0.0}},
        **_SHARED_KL),
}


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
    if (q.shape[0] > 1 and int(t_k[1]) == 0
            and float(true[1]) == float("-inf")):
        fail(f"rank_counts {label}: NaN candidate did not tie with -inf")
    max_err = max(int(d_rank.max()), int(d_ties.max()))
    print(f"rank_counts {label}: B={q.shape[0]} C={cand.shape[0]} "
          f"D={q.shape[1]} equal on {q.shape[0] - len(rows)}/{q.shape[0]} "
          f"rows; differing rows {len(rows)}, max_abs_err {max_err}, "
          f"boundary pairs in them {n_boundary}; ties sum "
          f"{int(t_k.sum())}, rank sum {int(r_k.sum())}", flush=True)
    return dict(max_abs_err=max_err, boundary_pairs=n_boundary)


def rank_edge_cases(rc, seed, device) -> int:
    """K2 at its tile edges, in both of its shapes (Narrow when the block
    tiles are at most two an SM or D > 400, Wide otherwise): B around
    Narrow's 112-row tiles (B <= 129 at 14,541 candidates) and Wide's
    128-row tiles (B = 127, 128, 129 at 20,000 candidates; 256 and 300 at
    14,541), a ragged last candidate tile, D = 37 (4-byte copies), D = 416
    (Narrow at either B), and cand as a leading-row view of a longer
    table, 16-byte aligned and not. Returns the largest count error."""
    C, D = FB15K237["entities"], DIM
    cases = [(f"B={B}", make_rank_inputs(B, C, D, seed + B, device))
             for B in (1, 127, 128, 129, 256)]
    cases += [(f"B={B} C=20000 (Wide)",
               make_rank_inputs(B, 20000, D, seed + 3 * B, device))
              for B in (127, 128, 129)]
    for B in (100, 300):
        cases.append((f"B={B} D=37 (4-byte copies)",
                      make_rank_inputs(B, C, 37, seed + B, device)))
        cases.append((f"B={B} D=416 (Narrow, q in the ring)",
                      make_rank_inputs(B, C, 416, seed + B, device)))
    for B in (100, 300):
        q, cand, true, valid = make_rank_inputs(B, C, D, seed + 7, device)
        table = torch.cat([cand, torch.randn(40, D, device=device)])
        cases.append((f"B={B} leading-row view", (q, table[:C], true, valid)))
        flat = torch.empty(C * D + 1, device=device)
        flat[1:] = cand.flatten()
        cases.append((f"B={B} leading-row view at 4 bytes past 16 (4-byte "
                      "copies)", (q, flat[1:].view(C, D), true, valid)))
    return max(check_rank_counts(rc, label, *inputs)["max_abs_err"]
               for label, inputs in cases)


def rank_bound(B, C, D):
    """(bound_ms, bound_by, flops, bytes) of one rank_counts call."""
    flops = 2.0 * B * C * D
    moved = 4.0 * (B * D + C * D + B + C) + 2 * 4.0 * B
    by = ("operations" if flops / PEAK_FP32_FLOPS >= moved / PEAK_BYTES_PER_S
          else "bytes")
    return (max(flops / PEAK_FP32_FLOPS, moved / PEAK_BYTES_PER_S) * 1e3, by,
            flops, moved)


def kernel_phase(rc, seed, device) -> dict:
    B, C, D = EVAL_BATCH, FB15K237["entities"], DIM
    q, cand, true, valid = make_rank_inputs(B, C, D, seed, device)
    main = check_rank_counts(rc, "eval shape", q, cand, true, valid)
    tail = FB15K237["splits"]["test"] % EVAL_BATCH
    check_rank_counts(rc, "last batch", q[:tail].contiguous(), cand,
                      true[:tail].contiguous(), valid)
    edge_err = rank_edge_cases(rc, seed, device)

    call = lambda: rc.rank_counts(q, cand, true, valid, ATOL, RTOL)
    library = lambda: torch.matmul(q, cand.T)
    ms = cuda_ms(call, reps=50)
    plain_ms = cuda_ms(lambda: rc.rank_counts_reference(
        q, cand, true, valid, ATOL, RTOL), reps=20)
    library_ms = cuda_ms(library, reps=50)
    prof = call_profile("rank_counts eval shape", call, library)
    bound_ms, bound_by, flops, moved = rank_bound(B, C, D)
    print(f"rank_counts eval shape: kernel_ms {ms} plain_ms {plain_ms} "
          f"library_ms (matmul q @ cand.T) {library_ms} bound_ms {bound_ms} "
          f"({bound_by}; {flops / 1e9} GFLOP, {moved / 1e6} MB)", flush=True)

    # Wikidata5M-size table: correctness at B = 1024 and at the
    # validation's B = 256 (each shape the path uses is checked before it
    # is timed), then the time of a call at both
    qw, cw, tw, vw = make_rank_inputs(1024, W5M_ENTITIES, D, seed + 1,
                                      device)
    w5m = check_rank_counts(rc, "wikidata5m size", qw, cw, tw, vw)
    w5m_valid = check_rank_counts(
        rc, f"wikidata5m size B={VALID_BATCH}",
        qw[:VALID_BATCH].contiguous(), cw, tw[:VALID_BATCH].contiguous(), vw)
    for Bw in (1024, VALID_BATCH):
        qb, tb = qw[:Bw].contiguous(), tw[:Bw].contiguous()
        call_w = lambda: rc.rank_counts(qb, cw, tb, vw, ATOL, RTOL)
        w_ms = cuda_ms(call_w, reps=5, warmup=1)
        w_us = kernel_device_ms(call_w, 3, "rank_count") * 1e3
        w_host_us = host_us(call_w, reps=5)
        w_plain = cuda_ms(lambda: rc.rank_counts_reference(
            qb, cw, tb, vw, ATOL, RTOL), reps=3, warmup=1)
        # the library call: the whole [B, C] score matrix (19.7 GB at
        # B = 1024), written into one buffer allocated once
        scores = torch.empty(Bw, W5M_ENTITIES, device=device)
        library_w = lambda: torch.matmul(qb, cw.T, out=scores)
        w_library_ms = cuda_ms(library_w, reps=5, warmup=1)
        w_library_us = sum(
            us for us, _ in device_us_by_name(library_w, 3).values())
        del scores
        w_bound, _, w_flops, w_bytes = rank_bound(Bw, W5M_ENTITIES, D)
        print(f"rank_counts wikidata5m size B={Bw}: kernel_ms {w_ms} "
              f"kernel_us {w_us} host_us {w_host_us} library_ms (matmul q "
              f"@ cand.T) {w_library_ms} library_kernel_us {w_library_us} "
              f"bound_ms {w_bound} (operations; {w_flops / 1e9} GFLOP, "
              f"{w_bytes / 1e9} GB); share of the bound "
              f"{w_bound / (w_us / 1e3)}; plain_ms {w_plain}", flush=True)
    del qw, cw, tw, vw
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(main["max_abs_err"], w5m["max_abs_err"],
                                w5m_valid["max_abs_err"], edge_err),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                kernel_us=prof["kernel_us"], host_us=prof["host_us"],
                library_kernel_us=prof["library_kernel_us"])


# ----------------------------------------------------------------- eval


def write_dataset(folder: str, seed: int, sizes=FB15K237):
    """A synthetic knowledge graph with the given sizes (FB15k-237's by
    default): distinct triples, entity and relation frequencies
    Zipf-skewed (exponent 1), so some queries have hundreds of filtered
    answers as in the real graph."""
    rng = np.random.default_rng(seed)
    E, R = sizes["entities"], sizes["relations"]
    total = sum(sizes["splits"].values())
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
    for split, n in sizes["splits"].items():
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


def eval_phase(rc, kernels, seed, device, scratch) -> dict:
    from kge_tpu_torch import cli

    t0 = time.perf_counter()
    dataset_folder = os.path.join(scratch, "fb15k237-synthetic")
    run_folder = os.path.join(scratch, "complex-run")
    write_dataset(dataset_folder, seed)
    write_checkpoint(run_folder, dataset_folder, seed, device)
    print(f"eval setup (dataset + checkpoint): "
          f"{time.perf_counter() - t0} s", flush=True)

    reset_counts(kernels)
    t0 = time.perf_counter()
    trace = cli.main(["test", run_folder])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = rc.rank_counts.launches
    eval_counts = counts(kernels)
    expect_counts("the eval", eval_counts, dict(
        shared_ce_loss=0, adagrad_row_update=0, sgd_row_update=0))

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
    return dict(launches=launches, dataset_folder=dataset_folder,
                counts=eval_counts)


def profile_run(label: str, span_prefix: str, run, epoch_only=False,
                epoch=None):
    """Where a run's time goes: ``run()`` (which returns a trace entry with
    ``epoch_time``) under torch.profiler; prints the host time of the
    ``record_function`` spans named ``span_prefix*``, the device time by
    kernel, and the device's busy share of the epoch (the profiler's own
    cost included). With ``epoch_only`` the profiler records the training
    epoch alone (started and stopped by the job's epoch hooks), not the
    checkpoint loads and saves around it; with ``epoch`` too, that epoch
    only (the run's last). Returns the trace entry and the device time by
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kge_tpu_torch.train.job import Job
    from kge_tpu_torch.train.train import TrainingJob

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if epoch_only:
        def window(job):
            def inside(j):
                return epoch is None or j.epoch == epoch

            if isinstance(job, TrainingJob):
                job.pre_epoch_hooks.append(
                    lambda j: prof.start() if inside(j) else None)
                job.post_epoch_hooks.append(
                    lambda j: (torch.cuda.synchronize(), prof.stop())
                    if inside(j) else None)

        Job.job_created_hooks.append(window)
        try:
            trace = run()
        finally:
            Job.job_created_hooks.remove(window)
    else:
        with prof:
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
    return trace, device


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
          f"difference {relative(float(loss), float(ref_loss))}"
          f"), lse max_abs_err {err}", flush=True)
    return err


def k1_phase(nl, seed, device) -> dict:
    B, N, D = TRAIN_BATCH, NEGATIVES + 1, DIM
    main = make_k1_inputs(B, N, D, seed, device)
    err = check_k1(nl, "training shape", main)
    err = max(err, check_k1(nl, "ragged", make_k1_inputs(1000, 37, D,
                                                        seed + 1, device)))
    # the kernel's edges: one candidate to 520 (past one staged block: the
    # chunked ring), one row to a ragged last block, D = 37 (4-byte copies)
    for N_edge in (1, 8, 129, 520):
        for B_edge in (1, 129, 1000):
            err = max(err, check_k1(
                nl, f"B={B_edge} N={N_edge}",
                make_k1_inputs(B_edge, N_edge, D, seed + N_edge + B_edge,
                               device)))
    err = max(err, check_k1(nl, "D=37 (4-byte copies)",
                            make_k1_inputs(B, N, 37, seed + 2, device)))
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
    call = lambda: nl.shared_ce_forward(*main)
    library = lambda: torch.matmul(q, cand.T)
    ms = cuda_ms(call, reps=50)
    plain_ms = cuda_ms(lambda: nl.shared_ce_loss_reference(*main), reps=50)
    library_ms = cuda_ms(library, reps=50)
    prof = call_profile("shared_ce_loss training shape", call, library)
    kernels = sum(n for name, (_, n) in prof["by_name"].items()
                  if "memset" not in name.lower())
    if kernels != 1:
        fail(f"shared_ce_loss launched {kernels} kernels a call, expected 1")
    flops = 2.0 * B * N * D
    moved = 4.0 * (B * D + N * D + B * N + 3 * B + 1)
    bound_ms = max(flops / PEAK_FP32_FLOPS, moved / PEAK_BYTES_PER_S) * 1e3
    bound_by = ("operations" if flops / PEAK_FP32_FLOPS
                >= moved / PEAK_BYTES_PER_S else "bytes")
    print(f"shared_ce_loss training shape: kernel_ms {ms} plain_ms "
          f"{plain_ms} library_ms (matmul q @ cand.T) {library_ms} bound_ms "
          f"{bound_ms} ({bound_by}; {flops / 1e6} MFLOP, {moved / 1e6} MB); "
          "loss bit-identical over 10 runs", flush=True)
    bf16 = check_k1_bf16(nl, main)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                kernel_us=prof["kernel_us"], host_us=prof["host_us"],
                library_kernel_us=prof["library_kernel_us"], **bf16)


def check_k1_bf16(nl, inputs) -> dict:
    """K1's wrapper on the bf16 operands of ``tpu.compute_dtype:
    bfloat16`` (q, cand, pos rounded to bf16) at the training shape: the
    loss within rtol 1e-5 of the plain version on the same values in
    float32, the gradients (kernel forward, torch backward) bf16 and
    within one bf16 rounding of autograd through the plain version; the
    time of a forward call with its casts, and its device time by
    kernel."""
    q, cand, pos, counts_, w = inputs
    leaves = [x.to(torch.bfloat16).requires_grad_() for x in (q, cand, pos)]
    loss = nl.shared_ce_loss(*leaves, counts_, w)
    loss.backward()
    exact = [x.detach().float().requires_grad_() for x in leaves]
    want, _ = nl.shared_ce_loss_reference(*exact, counts_, w)
    want.backward()
    assert_close("shared_ce_loss bf16 operands loss", loss.detach(),
                 want.detach(), 1e-5, 0.0)
    for name, got, ref in zip(("q", "cand", "pos"), leaves, exact):
        if got.grad.dtype != torch.bfloat16:
            fail(f"shared_ce_loss bf16: d{name} came back {got.grad.dtype}")
        assert_close(f"shared_ce_loss bf16 operands d{name}",
                     got.grad.float(), ref.grad, 2 ** -7, 1e-6)
    operands = [x.detach() for x in leaves]
    call = lambda: nl.shared_ce_loss(*operands, counts_, w)
    ms = cuda_ms(call, reps=50)
    prof = call_profile("shared_ce_loss bf16 operands", call, None)
    print(f"shared_ce_loss bf16 operands: ms {ms} (the casts to float32 "
          "and the kernel)", flush=True)
    return dict(bf16_ms=ms, bf16_kernel_us=prof["kernel_us"],
                bf16_host_us=prof["host_us"])


# ----------------------------------------------------------------- K3


def make_k3_inputs(V, R, D, seed, device):
    """Seeded inputs of a row update: a table of unit-scale entries,
    Adagrad sums in [0, 2), R sorted distinct ids spread over the table
    (0 and V-1 among them; every row when R == V) and unit-scale gradient
    rows. Returns [table, sum, uniq (int64), rows_g]."""
    g = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn(V, D, generator=g, device=device)
    ssum = 2.0 * torch.rand(V, D, generator=g, device=device)
    if R == V:
        uniq = torch.arange(V, device=device)
    else:
        inner = torch.randperm(V - 2, generator=g, device=device)[:R - 2] + 1
        ends = torch.tensor([0, V - 1], device=device)
        uniq = torch.sort(torch.cat([ends, inner])).values
    rows_g = torch.randn(R, D, generator=g, device=device)
    return [table, ssum, uniq.contiguous(), rows_g]


def constructed_k3_inputs(inputs):
    """Positions 10-12 become a run of one id whose gradient sits at its
    last position only; rows 20-22 have zero gradients; one element of
    row 30 is NaN (it must stay in its element)."""
    table, ssum, uniq, rows_g = (x.clone() for x in inputs)
    uniq[11:13] = uniq[10]
    rows_g[10:12] = 0.0
    rows_g[20:23] = 0.0
    rows_g[30, 5] = float("nan")
    return [table, ssum, uniq, rows_g]


def ulp_distance(a, b):
    """Elementwise distance in units in the last place (two NaNs: 0)."""
    ia, ib = (x.view(torch.int32).long() for x in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    both_nan = torch.isnan(a) & torch.isnan(b)
    return torch.where(both_nan, torch.zeros_like(ia), (ia - ib).abs())


def device_us_by_name(fn, reps: int) -> dict:
    """Device microseconds and launches per call of ``fn`` for each
    kernel, memset and copy it runs on the card, from torch.profiler:
    {name: (us, launches)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler at times loses records: a kernel counted 13 times over
    # 50 calls that each launch it once, no record at all, or one or two
    # of 50 (seen on a cuBLAS GEMM in three windows running). A kernel's
    # launches a call are its count over the calls, rounded; a count
    # further than a tenth of the calls from that whole number, or an
    # empty window, profiles the window again (after a pause: a K3
    # window lost its records three times running, proof run of PR 9),
    # and a fifth such window fails the run rather than under-count. The
    # time of a call is the mean time of a recorded launch times the
    # launches a call.
    for attempt in range(5):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us, n = out.get(e.name, (0.0, 0))
                out[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        per_call = {name: round(n / reps) for name, (_, n) in out.items()}
        lost = [name for name, (_, n) in out.items()
                if not per_call[name]
                or abs(n - per_call[name] * reps) > reps // 10]
        if not out:
            lost = ["every record"]
        if not lost:
            return {name: (us / n * per_call[name], per_call[name])
                    for name, (us, n) in out.items()}
        print(f"profiler lost records of {lost} (attempt {attempt + 1}): "
              f"{[out.get(name, (0, 0))[1] for name in lost]} over {reps} "
              "calls", flush=True)
    fail(f"torch.profiler lost device records in 5 windows of {reps} calls")


def kernel_device_ms(fn, reps: int, name_part: str) -> float:
    """Mean device milliseconds of the kernels named ``*name_part*`` per
    call of ``fn``, from torch.profiler (a wrapper call's CUDA-event time
    also holds the host's launch work when that is the longer)."""
    return sum(us for name, (us, _) in device_us_by_name(fn, reps).items()
               if name_part in name) / 1e3


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds to enqueue one call of ``fn``: a host clock over
    ``reps`` calls with one synchronize after them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def call_profile(label, fn, library, reps=50) -> dict:
    """kernel_us (the device time of every kernel and memset of one call
    of ``fn``), host_us and library_kernel_us (the device time of
    ``library``, None without one); prints the device time by name."""
    by_name = device_us_by_name(fn, reps)
    library_us = None if library is None else sum(
        us for us, _ in device_us_by_name(library, reps).values())
    out = dict(kernel_us=sum(us for us, _ in by_name.values()),
               host_us=host_us(fn), library_kernel_us=library_us)
    print(f"{label}: device us per call by name "
          + json.dumps({name[:80]: [us, n] for name, (us, n) in by_name.items()})
          + f"; kernel_us {out['kernel_us']} host_us {out['host_us']} "
          f"library_kernel_us {library_us}", flush=True)
    return dict(out, by_name=by_name)


def clone_like(x):
    """A copy of ``x`` at the same offset from a fresh allocation (so a
    leading-row view at 4 bytes past 16 stays unaligned)."""
    offset = x.storage_offset()
    flat = torch.empty(offset + x.numel(), dtype=x.dtype, device=x.device)
    y = flat[offset:].view(x.shape)
    y.copy_(x)
    return y


def device_lrs(n: int, device) -> list:
    """K3_LR / (k + 1) for k < n as the trainer hands learning rates to a
    captured step: 0-d views of one float32 device buffer."""
    buffer = torch.tensor([K3_LR / (k + 1) for k in range(n)],
                          dtype=torch.float32, device=device)
    return [buffer[k] for k in range(n)]


def k3_group_args(optimizer, copies, on_device: bool = False):
    """(table, sum, uniq, rows_g, lr, eps) of each group: the k-th group
    has its own lr and eps (K3_LR / (k + 1), K3_EPS * (k + 1)); the lr a
    host float, or with ``on_device`` a float32 scalar on the card."""
    lrs = (device_lrs(len(copies), copies[0][0].device) if on_device
           else [K3_LR / (k + 1) for k in range(len(copies))])
    return [(t, s if optimizer == "adagrad" else None, u, g, lr,
             K3_EPS * (k + 1))
            for k, ((t, s, u, g), lr) in enumerate(zip(copies, lrs))]


def run_k3(ru, optimizer, groups, kernel: bool, on_device: bool = False):
    """One update of fresh copies of each group's inputs: the kernel (one
    launch for all groups; the one-table wrapper for one group) or its
    plain version, the learning rates host floats or (``on_device``)
    float32 scalars on the card; returns [(table, sum)]."""
    copies = [[clone_like(x) for x in inputs] for inputs in groups]
    args = k3_group_args(optimizer, copies, on_device)
    if not kernel:
        ru.row_update_groups_reference(optimizer, args)
    elif len(args) > 1:
        ru.row_update_groups(optimizer, args)
    elif optimizer == "adagrad":
        ru.adagrad_row_update(*args[0])
    else:
        table, _, uniq, rows_g, lr, _ = args[0]
        ru.sgd_row_update(table, uniq, rows_g, lr)
    torch.cuda.synchronize()
    return [(t, s) for t, s, _, _ in copies]


def check_k3(ru, optimizer, label, groups) -> int:
    """Kernel vs plain version, for one table or several in one launch:
    table and sum bit for bit (or within one ulp, with the count
    printed); every row outside uniq bit-unchanged. Returns the largest
    ulp distance."""
    got_all = run_k3(ru, optimizer, groups, kernel=True)
    want_all = run_k3(ru, optimizer, groups, kernel=False)
    worst = 0
    for k, (inputs, got, want) in enumerate(zip(groups, got_all, want_all)):
        table, ssum, uniq, rows_g = inputs
        where = f"{label} (group {k})" if len(groups) > 1 else label
        touched = torch.zeros(table.shape[0], dtype=torch.bool,
                              device=table.device)
        touched[uniq] = True
        for name, g, w, before in zip(("table", "sum"), got, want,
                                      (table, ssum)):
            # the touched rows against the plain version; the others
            # against the input (the plain version writes only uniq's rows)
            ulps = ulp_distance(g[uniq], w[uniq])
            n_diff = int((ulps > 0).sum())
            largest = int(ulps.max()) if ulps.numel() else 0
            worst = max(worst, largest)
            if n_diff:
                print(f"row_update {optimizer} {where}: {name} differs from "
                      f"the plain version in {n_diff} elements, by at most "
                      f"{largest} ulp", flush=True)
            if largest > 1:
                fail(f"row_update {optimizer} {where}: {name} more than one "
                     "ulp from the plain version")
            moved = (g.view(torch.int32) != before.view(torch.int32)).any(
                dim=1)
            if bool((moved & ~touched).any()):
                fail(f"row_update {optimizer} {where}: {name} changed a row "
                     "outside uniq")
        nan_rows = torch.isnan(rows_g).any(dim=1)
        if bool(nan_rows.any()):
            expect = torch.zeros_like(got[0], dtype=torch.bool)
            expect[uniq[nan_rows]] = torch.isnan(rows_g[nan_rows])
            if not torch.equal(torch.isnan(got[0]), expect):
                fail(f"row_update {optimizer} {where}: a NaN gradient left "
                     "its element")
    shapes = ", ".join(
        f"V={t.shape[0]} R={u.shape[0]} D={t.shape[1]} {u.dtype} "
        f"{'16-byte aligned' if t.data_ptr() % 16 == 0 else 'unaligned'}"
        for t, _, u, _ in groups)
    print(f"row_update {optimizer} {label}: {len(groups)} group(s) [{shapes}]"
          f": table and sum {'bit-equal to' if worst == 0 else 'within 1 ulp of'}"
          " the plain version, untouched rows unchanged", flush=True)
    return worst


def check_k3_device_lr(ru, optimizer, label, groups):
    """The kernel reading its learning rates from the card (as a captured
    training step does) against the plain version with host floats:
    table and sum bit for bit."""
    got_all = run_k3(ru, optimizer, groups, kernel=True, on_device=True)
    want_all = run_k3(ru, optimizer, groups, kernel=False)
    for k, (got, want) in enumerate(zip(got_all, want_all)):
        for name, g, w in zip(("table", "sum"), got, want):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                fail(f"row_update {optimizer} {label} (group {k}): {name} "
                     "with the lr read on the card is not the plain "
                     "version's bit for bit")
    print(f"row_update {optimizer} {label}: lr read on the card, table and "
          "sum bit-equal to the plain version with host floats", flush=True)


def k3_runs(V, R, D, seed, device):
    """Inputs whose ids come in runs of equal ids of lengths 2-9 and one
    of 40, each carrying its gradient at its last position: at one
    position a warp and 8 warps a block, runs cross warp and block
    boundaries."""
    table, ssum, _, rows_g = make_k3_inputs(V, R, D, seed, device)
    lengths = [2 + i % 8 for i in range(R)]
    lengths[3] = 40
    reps = torch.tensor(lengths, device=device)
    reps = reps[:int((reps.cumsum(0) <= R).sum())]
    distinct = make_k3_inputs(V, len(reps), D, seed + 1, device)[2]
    uniq = torch.repeat_interleave(distinct, reps)
    rows_g = rows_g[:len(uniq)].clone()
    last = torch.ones(len(uniq), dtype=torch.bool, device=device)
    last[:-1] = uniq[1:] != uniq[:-1]
    rows_g[~last] = 0.0
    return [table, ssum, uniq.contiguous(), rows_g]


def k3_edge_cases(seed, device):
    """[(label, groups)]: position counts that are no multiple of a warp
    task or a block, runs of equal ids across warps and blocks, D = 37
    (one element a lane), leading-row views 16-byte aligned and not, int32
    ids and a launch of four groups."""
    V, D = 65536, DIM
    table, ssum, uniq, rows_g = make_k3_inputs(V, 2, D, seed, device)
    one_row = [table, ssum, uniq[:1], rows_g[:1]]
    cases = [("R=1", [one_row])]
    cases += [(f"R={R}", [make_k3_inputs(V, R, D, seed + R, device)])
              for R in (2, 3, 5, 33, 257, 1031, 4099)]
    cases.append(("runs of equal ids across warps and blocks",
                  [k3_runs(V, 3000, D, seed + 3, device)]))
    cases.append(("D=37 (one element a lane)",
                  [make_k3_inputs(V, 3001, 37, seed + 4, device)]))
    for offset, what in ((0, "16-byte aligned"), (1, "at 4 bytes past 16")):
        table, ssum, uniq, rows_g = make_k3_inputs(V + 8, 2306, D, seed + 5,
                                                   device)
        uniq = uniq[uniq < V].contiguous()
        rows_g = rows_g[:len(uniq)].contiguous()
        views = []
        for x in (table, ssum):
            flat = torch.empty(x.numel() + offset, device=device)
            flat[offset:] = x.flatten()
            views.append(flat[offset:offset + V * D].view(V, D))
        cases.append((f"leading-row view, {what}",
                      [[views[0], views[1], uniq, rows_g]]))
    cases.append(("four groups, int32 and int64 ids", [
        make_k3_inputs(V, 2306, D, seed + 6, device),
        [*make_k3_inputs(W5M_RELATION_ROWS, W5M_RELATION_ROWS, D, seed + 7,
                         device)[:2],
         torch.arange(W5M_RELATION_ROWS, device=device, dtype=torch.int32),
         torch.randn(W5M_RELATION_ROWS, D, device=device)],
        k3_runs(4096, 500, 37, seed + 8, device),
        one_row]))
    return cases


def triple_step_inputs(seed, device):
    """The two groups of the triple phase's row-sparse step: the
    FB15k-237-size entity table ([14,544, 128], 8,192 distinct rows with
    the padding rows' last among them) and the relation table ([240,
    128], every row), int32 ids as the trainer gives them."""
    groups = [make_k3_inputs(FB_ENTITY_ROWS, TRIPLE_ENTITY_ROWS, DIM, seed,
                             device),
              make_k3_inputs(FB_RELATION_ROWS, FB_RELATION_ROWS, DIM,
                             seed + 1, device)]
    for group in groups:
        group[2] = group[2].int()
    return groups


def k3_bound(optimizer, rows, D):
    """(bound_ms, bytes) of one update of ``rows`` touched rows: the
    gradient, table and (Adagrad) sum rows read, the table and sum rows
    written, an 8-byte id; 7 (Adagrad) or 2 (SGD) flops an element."""
    moved = 4.0 * ((5 if optimizer == "adagrad" else 3) * rows * D) + 8.0 * rows
    flops = (7 if optimizer == "adagrad" else 2) * rows * D
    return max(moved / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS) * 1e3, moved


def k3_phase(ru, seed, device) -> dict:
    """K3 on the card: the Wikidata5M entity shape (int64 and int32 ids),
    the relation shape, a training step's two tables in one launch, the
    triple phase's step (FB15k-237-size tables) in one launch,
    constructed cases and the kernel's edges, Adagrad and SGD; then times
    at the entity shape, the relation shape and the two-table step, each
    launch on another 2,306 entity rows (20 sets: 118 MB, beyond the 50 MB
    L2, as a training step finds the sum rows)."""
    D = DIM
    V = W5M_ENTITIES + 1  # padded to a multiple of 8
    main = make_k3_inputs(V, W5M_ENTITY_ROWS, D, seed, device)
    relations = make_k3_inputs(W5M_RELATION_ROWS, W5M_RELATION_ROWS, D,
                               seed + 1, device)
    # the training steps' shapes: both tables in one launch
    steps = [
        ("training step: entity and relation tables in one launch",
         [main, relations]),
        ("triple phase step: entity and relation tables in one launch",
         triple_step_inputs(seed + 9, device)),
    ]
    cases = [
        ("wikidata5m entity shape", [main]),
        ("relation shape", [relations]),
        ("constructed cases", [constructed_k3_inputs(main)]),
        ("wikidata5m entity shape, int32 ids",
         [main[:2] + [main[2].int(), main[3]]]),
        *steps,
        *k3_edge_cases(seed, device),
    ]
    out = {}
    for optimizer in ("adagrad", "sgd"):
        out[optimizer] = dict(max_abs_err=max(
            check_k3(ru, optimizer, label, groups) for label, groups in cases))
        # with the lr on the card, the captured step's form
        for label, groups in steps:
            check_k3_device_lr(ru, optimizer, label, groups)
    del cases, steps

    table, ssum, _, rows_g = main
    rel_table, rel_sum, rel_uniq, rel_g = relations
    R = W5M_ENTITY_ROWS
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    id_sets = [torch.sort(torch.randperm(V, generator=gen, device=device)[:R]
                          ).values for _ in range(20)]

    def cycling(fn):
        sets = itertools.cycle(id_sets)
        return lambda: fn(next(sets))

    # the kernel reads its lr from the card, as on the training path (a
    # host float would add a fill kernel a call)
    lr = device_lrs(1, device)[0]
    for optimizer in ("adagrad", "sgd"):
        adagrad = optimizer == "adagrad"

        def groups(u):
            return [(table, ssum if adagrad else None, u, rows_g, lr,
                     K3_EPS),
                    (rel_table, rel_sum if adagrad else None, rel_uniq,
                     rel_g, lr, K3_EPS)]

        def one_table(group):
            t, s, u, g, lr, eps = group
            if adagrad:
                ru.adagrad_row_update(t, s, u, g, lr, eps)
            else:
                ru.sgd_row_update(t, u, g, lr)

        def library(group):
            t, _, u, g, _, _ = group
            t.index_add_(0, u, g, alpha=-K3_LR)

        # (key, label, rows, kernel, plain, library): one wrapper call on the
        # entity table, on the relation table, and the step's one launch
        # for both
        shapes = [
            ("entity", f"wikidata5m entity shape (R={R}, D={D}, V={V})", R,
             lambda u: one_table(groups(u)[0]),
             lambda u: ru.row_update_groups_reference(optimizer,
                                                      groups(u)[:1]),
             lambda u: library(groups(u)[0])),
            ("relation", f"relation shape (R={W5M_RELATION_ROWS}, D={D})",
             W5M_RELATION_ROWS,
             lambda u: one_table(groups(u)[1]),
             lambda u: ru.row_update_groups_reference(optimizer,
                                                      groups(u)[1:]),
             lambda u: library(groups(u)[1])),
            ("step", "training step, both tables in one launch "
             f"(R={R} + {W5M_RELATION_ROWS})", R + W5M_RELATION_ROWS,
             lambda u: ru.row_update_groups(optimizer, groups(u)),
             lambda u: ru.row_update_groups_reference(optimizer, groups(u)),
             lambda u: [library(g) for g in groups(u)]),
        ]
        for key, label, rows, kernel, plain, lib in shapes:
            label = f"row_update {optimizer} {label}"
            bound_ms, moved = k3_bound(optimizer, rows, D)
            ms = cuda_ms(cycling(kernel), reps=200)
            plain_ms = cuda_ms(cycling(plain), reps=100)
            # one PyTorch call computes SGD's update (index_add_ per
            # table); none computes Adagrad's
            library_ms = None if adagrad else cuda_ms(cycling(lib), reps=200)
            prof = call_profile(label, cycling(kernel),
                                None if adagrad else cycling(lib))
            launches = sum(n for name, (_, n) in prof["by_name"].items()
                           if f"{optimizer}_rows" in name)
            if launches != 1:
                fail(f"{label}: {launches} kernel launches a call, expected 1")
            print(f"{label}: kernel_ms {ms} kernel_us {prof['kernel_us']} "
                  f"host_us {prof['host_us']} plain_ms {plain_ms} library_ms "
                  f"{library_ms} library_kernel_us "
                  f"{prof['library_kernel_us']} bound_ms {bound_ms} (bytes; "
                  f"{moved / 1e6} MB); share of the bound "
                  f"{bound_ms * 1e3 / prof['kernel_us']}", flush=True)
            numbers = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by="bytes", library_ms=library_ms,
                           kernel_us=prof["kernel_us"],
                           host_us=prof["host_us"],
                           library_kernel_us=prof["library_kernel_us"])
            if key == "entity":  # the main path's shape
                out[optimizer].update(numbers)
            else:
                out[optimizer][key] = numbers
    del main, relations, table, ssum, rows_g, id_sets
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- train


def write_train_config(path: str, dataset_folder: str, seed: int,
                       host_sampling: bool = True):
    """The training main path: the hyperparameters of
    examples/wikidata5m-complex-train.yaml on the synthetic graph, 2
    epochs with validation after each. With ``host_sampling`` the
    negatives are drawn on the host (``tpu.on_device_sampling: never``):
    the phases that hold the card's trajectory against the host's need
    the host's draws on both (CUDA's Philox stream and the CPU's cannot
    match); the device_epoch phase runs the config at kge_tpu's
    defaults."""
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
    if host_sampling:
        config["tpu"] = {"on_device_sampling": "never"}
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


def fresh_device_memory() -> int:
    """Free what earlier runs left (a finished job is kept alive by the
    reference cycles of its hooks until the collector runs), restart the
    peak counter, and return the device bytes still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def reset_counts(kernels):
    for wrapper in kernels:
        wrapper.launches = 0


def counts(kernels) -> dict:
    return {wrapper.__name__: wrapper.launches for wrapper in kernels}


def expect_counts(label: str, got: dict, want: dict):
    for name, n in want.items():
        if got[name] != n:
            fail(f"{label} launched {name} {got[name]} times, expected {n}")


def train_phase(kernels, seed, scratch, dataset_folder) -> dict:
    from kge_tpu_torch import cli

    n_train = FB15K237["splits"]["train"]
    config_file = os.path.join(scratch, "complex-negsamp.yaml")
    write_train_config(config_file, dataset_folder, seed)
    run = os.path.join(scratch, "train-run")

    # the main path: start, 2 epochs, a validation after each; at this
    # size tpu.sparse_updates auto keeps the tables dense (no K3)
    reset_counts(kernels)
    t0 = time.perf_counter()
    cli.main(["start", config_file, "--folder", run])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts(kernels)
    k1, k2 = launched["shared_ce_loss"], launched["rank_counts"]
    expect_counts("the FB15k-237-size training", launched,
                  dict(adagrad_row_update=0, sgd_row_update=0))

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
    want_k2 = 2 * VALID_LAUNCHES
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
    reset_counts(kernels)
    resumed = cli.main(["resume", run, "--train.max_epochs", "3"])
    torch.cuda.synchronize()
    print(f"train resume on the card: epoch {resumed['epoch']} avg_loss "
          f"{resumed['avg_loss']} epoch_seconds {resumed['epoch_time']}",
          flush=True)
    if resumed["epoch"] != 3 or not math.isfinite(resumed["avg_loss"]):
        fail(f"resume did not reach a finite epoch 3: {resumed}")
    expect_counts("the resumed epoch", counts(kernels),
                  dict(shared_ce_loss=2 * TRAIN_STEPS))

    # card vs host: epoch 1 again from the same initial weights
    compared = card_vs_host("negsamp", run, scratch,
                            flags=["--tpu.fused_negsamp_loss", "always"])
    if compared["first_batch_relative_difference"] > 1e-5:
        fail(f"first batch loss, card vs host: {compared}")
    # the weights part after the first step: Adagrad's first update of an
    # element is about lr * sign(g), so a gradient at rounding-noise size
    # moves by 2 * lr in the other summation order; a few such elements
    # among 1.9M shift the epoch average slightly
    if compared["avg_loss_relative_difference"] > 1e-3:
        fail(f"epoch avg_loss, card vs host: {compared}")
    return dict(k1_launches=k1, config_file=config_file, counts=launched,
                first_epoch_avg_loss=losses[0],
                best=os.path.join(run, "checkpoint_best.pt"))


def batch_losses(folder: str) -> list:
    return [e["avg_loss"] for e in read_trace(folder, scope="batch")]


def first_batch_loss(folder: str) -> float:
    return batch_losses(folder)[0]


def relative(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def sgd_phase(kernels, scratch, config_file) -> dict:
    """K3's SGD half on its path: one epoch of plain SGD with row-sparse
    updates on the FB15k-237-size graph (tpu.sparse_updates always), held
    against the same epoch with dense SGD; both on the card, from the
    same seeded initial weights."""
    from kge_tpu_torch import cli

    runs = {}
    for mode in ("always", "never"):
        folder = os.path.join(scratch, f"sgd-{mode}")
        reset_counts(kernels)
        entry = cli.main([
            "start", config_file, "--folder", folder, "--train.max_epochs",
            "1", "--valid.every", "0", "--train.trace_level", "batch",
            "--train.optimizer.default.type", "SGD",
            "--tpu.sparse_updates", mode])
        torch.cuda.synchronize()
        runs[mode] = dict(first_batch_loss=first_batch_loss(folder),
                          avg_loss=entry["avg_loss"],
                          epoch_seconds=entry["epoch_time"],
                          launches=counts(kernels))
        shutil.rmtree(folder)
    sparse, dense = runs["always"], runs["never"]
    first_rel = relative(sparse["first_batch_loss"],
                         dense["first_batch_loss"])
    epoch_rel = relative(sparse["avg_loss"], dense["avg_loss"])
    print("train sgd sparse vs dense on the card: " + json.dumps(dict(
        sparse=sparse, dense=dense, first_batch_relative_difference=first_rel,
        epoch_avg_loss_relative_difference=epoch_rel)), flush=True)
    expect_counts("the row-sparse SGD epoch", sparse["launches"],
                  dict(sgd_row_update=TRAIN_STEPS, adagrad_row_update=0,
                       shared_ce_loss=2 * TRAIN_STEPS))
    expect_counts("the dense SGD epoch", dense["launches"],
                  dict(sgd_row_update=0, adagrad_row_update=0))
    if not math.isfinite(sparse["avg_loss"]):
        fail(f"the SGD epoch's loss is not finite: {sparse['avg_loss']}")
    if first_rel > 1e-6 or epoch_rel > 1e-5:
        fail("row-sparse and dense SGD disagree: first batch "
             f"{first_rel}, epoch {epoch_rel}")
    return dict(launches=sparse["launches"]["sgd_row_update"],
                counts=sparse["launches"])


# ----------------------------------------------------------------- strategies


def write_strategy_config(path: str, dataset_folder: str, seed: int,
                          train: dict, **sections):
    """ComplEx dim 128 on the FB15k-237-size graph with the given train
    block (and sections), a validation after each epoch."""
    config = {
        "job": {"type": "train"},
        "dataset": {"name": dataset_folder},
        "model": "complex",
        "lookup_embedder": {
            "dim": DIM, "initialize": "normal_",
            "initialize_args": {"normal_": {"std": 0.03}},
        },
        "train": {"max_epochs": 1, **train},
        "valid": {"every": 1, "metric": "mean_reciprocal_rank_filtered"},
        "eval": {"batch_size": VALID_BATCH},
        "random_seed": {"default": seed},
        "console": {"quiet": True},
    }
    for key, value in sections.items():
        config[key] = {**config.get(key, {}), **value}
    with open(path, "w") as f:
        yaml.safe_dump(config, f)


@contextlib.contextmanager
def first_batches(n: int, epochs=None):
    """Every training job created inside stops its epochs (those in
    ``epochs`` when given) after their first ``n`` batches, in the
    epoch's own order."""
    def cut(job):
        generate = job._generate_batches
        job._generate_batches = lambda epoch: (
            itertools.islice(generate(epoch), n)
            if epochs is None or epoch in epochs else generate(epoch))

    with on_created_jobs(cut):
        yield


@contextlib.contextmanager
def on_created_jobs(change):
    """``change(job)`` on every training job created inside."""
    from kge_tpu_torch.train.job import Job
    from kge_tpu_torch.train.train import TrainingJob

    def hook(job):
        if isinstance(job, TrainingJob):
            change(job)

    Job.job_created_hooks.append(hook)
    try:
        yield
    finally:
        Job.job_created_hooks.remove(hook)


def eager_groups(job):
    """The job runs its groups of steps eagerly, in the same order, with
    the same math (the per-batch steps its graphs replay)."""
    job._capture = False


def in_group_order(k: int):
    """A change for ``on_created_jobs``: a KvsAll job at one step a
    dispatch takes its batches in the order groups of ``k`` take them
    (KvsAll regroups its batches by the group size, as kge_tpu does), so
    its steps compare one for one with a grouped run's."""
    from kge_tpu_torch.train.train_kvsall import TrainingJobKvsAll

    def change(job):
        if not isinstance(job, TrainingJobKvsAll):
            return
        generate = job._generate_batches

        def regrouped(epoch):
            job._steps_per_dispatch = lambda: k  # read by the regrouping
            try:
                yield from generate(epoch)
            finally:
                del job._steps_per_dispatch

        job._generate_batches = regrouped

    return change


def check_replays(label: str, job, dispatches: int) -> dict:
    """A captured job's groups: the first group of each shape ran eagerly
    (its capture's warm-up), every later one was a replay."""
    out = dict(group_dispatches=dispatches, graphs=len(job._graphs),
               graph_replays=job.graph_replays)
    if (not job._capture or not job._graphs
            or job.graph_replays != dispatches - len(job._graphs)):
        fail(f"{label}: the groups were not replayed as captured: {out}")
    return out


def card_vs_host(label: str, run: str, scratch: str, flags=(),
                 batches=None) -> dict:
    """Epoch 1 again from ``run``'s checkpoint_00000.pt on the card and on
    the host (the first ``batches`` batches of it when given), with a
    batch-level trace: the first batch's loss, the epoch's (or the
    batches') avg_loss and the largest relative difference of a batch."""
    from kge_tpu_torch import cli

    runs = {}
    for device in ("cuda", "cpu"):
        folder = os.path.join(scratch, f"{label}-epoch1-{device}")
        copy_run(run, folder, "checkpoint_00000.pt")
        t0 = time.perf_counter()
        argv = ["resume", folder, "--train.max_epochs", "1", "--valid.every",
                "0", "--train.trace_level", "batch", "--job.device", device,
                *flags]
        if batches:
            with first_batches(batches):
                entry = cli.main(argv)
        else:
            entry = cli.main(argv)
        losses = batch_losses(folder)
        runs[device] = dict(first_batch_loss=losses[0],
                            avg_loss=entry["avg_loss"],
                            batches=entry["batches"],
                            epoch_seconds=entry["epoch_time"],
                            seconds_cli=time.perf_counter() - t0,
                            losses=losses)
        shutil.rmtree(folder)
    card, host = runs["cuda"], runs["cpu"]
    worst = max(relative(a, b) for a, b in zip(card.pop("losses"),
                                               host.pop("losses")))
    out = dict(card=card, host=host, batches_compared=batches or "epoch",
               first_batch_relative_difference=relative(
                   card["first_batch_loss"], host["first_batch_loss"]),
               avg_loss_relative_difference=relative(card["avg_loss"],
                                                     host["avg_loss"]),
               largest_batch_relative_difference=worst)
    print(f"train {label} card vs host: " + json.dumps(out), flush=True)
    return out


def profiled_window(label: str, run: str, scratch: str, epoch: int,
                    batch: int = KVSALL_BATCH, unit: str = "queries",
                    flags=()):
    """The first PROFILE_STEPS steps of epoch ``epoch`` of ``run`` (from
    its checkpoint of the epoch before), without validation, under
    torch.profiler: ms a step, ``unit``/s (``batch`` of them a step: a
    KvsAll batch's queries by default), the device's busy share and peak
    memory."""
    from kge_tpu_torch import cli

    folder = os.path.join(scratch, f"{label}-profiled")
    copy_run(run, folder, f"checkpoint_{epoch - 1:05d}.pt")
    base = fresh_device_memory()
    with first_batches(PROFILE_STEPS):
        entry, device = profile_run(
            f"train {label}", "train.", lambda: cli.main([
                "resume", folder, "--train.max_epochs", str(epoch),
                "--valid.every", "0", *flags]), epoch_only=True)
    print(f"train {label} profiled window: " + json.dumps(
        window_numbers(entry, device, batch, unit, base)), flush=True)
    shutil.rmtree(folder)


def check_start(label: str, run: str, launched: dict, want: dict,
                epochs_wanted: int):
    """The epochs of a ``start``: finite losses, falling from epoch to
    epoch, a validation MRR in (0, 1] after each, the kernel counts."""
    epochs = read_trace(run, event="epoch_completed", job="train")
    valids = read_trace(run, event="eval_completed", job="eval")
    for e in epochs:
        print(f"train {label} epoch on the card: " + json.dumps(dict(
            epoch=e["epoch"], avg_loss=e["avg_loss"], batches=e["batches"],
            examples=e["size"], epoch_seconds=e["epoch_time"],
            examples_per_s=e["size"] / e["epoch_time"],
            ms_per_step=1e3 * e["epoch_time"] / e["batches"])), flush=True)
    print(f"train {label} start on the card: " + json.dumps(dict(
        launches=launched, valid_mrr_filtered=[
            v["mean_reciprocal_rank_filtered"] for v in valids])),
        flush=True)
    expect_counts(f"the {label} training", launched, want)
    losses = [e["avg_loss"] for e in epochs]
    if len(losses) != epochs_wanted or not all(map(math.isfinite, losses)):
        fail(f"{label}: losses missing or not finite: {losses}")
    if any(b >= a for a, b in zip(losses, losses[1:])):
        fail(f"{label}: the losses do not fall: {losses}")
    if len(valids) != epochs_wanted or not all(
            0.0 < v["mean_reciprocal_rank_filtered"] <= 1.0 for v in valids):
        fail(f"{label}: a validation is missing or out of range")
    return epochs


def kvsall_phase(kernels, seed, scratch, dataset_folder) -> dict:
    """The slice's main path: ``start`` of KvsAll with the train block of
    examples/recipes/fb15k237-compgcn.yaml (bce, label smoothing 0.1, Adam
    lr 0.001, batch 128, the sp_ and _po query types, the default
    tpu.steps_per_dispatch, so the batch order is regrouped) on ComplEx
    dim 128 in place of CompGCN, 1 epoch with a validation, ``resume`` to
    epoch 2, card vs host."""
    from kge_tpu_torch import cli

    config_file = os.path.join(scratch, "complex-kvsall.yaml")
    write_strategy_config(
        config_file, dataset_folder, seed,
        dict(type="KvsAll", loss="bce", max_epochs=1,
             batch_size=KVSALL_BATCH,
             optimizer={"default": {"type": "Adam", "args": {"lr": 0.001}}}),
        KvsAll={"label_smoothing": 0.1})
    run = os.path.join(scratch, "kvsall-run")
    reset_counts(kernels)
    t0 = time.perf_counter()
    cli.main(["start", config_file, "--folder", run])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    start_counts = counts(kernels)
    with open(os.path.join(run, "kge.log")) as f:
        log = f.read()
    # its batches come in kge_tpu's regrouped order (runs of one query
    # type and label width), each run of 4 a captured group
    if "Capturing groups of 4 steps as CUDA graphs." not in log:
        fail("the KvsAll run did not dispatch its batches in captured "
             "groups")
    epochs = check_start("kvsall", run, start_counts, dict(
        rank_counts=VALID_LAUNCHES, shared_ce_loss=0,
        adagrad_row_update=0, sgd_row_update=0), 1)
    print(f"train kvsall start seconds_cli {seconds}", flush=True)

    reset_counts(kernels)
    resumed = cli.main(["resume", run, "--train.max_epochs", "2"])
    torch.cuda.synchronize()
    resume_counts = counts(kernels)
    print("train kvsall resume on the card: " + json.dumps(dict(
        epoch=resumed["epoch"], avg_loss=resumed["avg_loss"],
        epoch_seconds=resumed["epoch_time"], launches=resume_counts)),
        flush=True)
    if resumed["epoch"] != 2 or not math.isfinite(resumed["avg_loss"]):
        fail(f"the KvsAll resume did not reach a finite epoch 2: {resumed}")
    expect_counts("the resumed KvsAll epoch", resume_counts, dict(
        rank_counts=VALID_LAUNCHES, shared_ce_loss=0, adagrad_row_update=0))

    # a host epoch of KvsAll at this size takes minutes: compare the
    # first HOST_BATCHES batches of epoch 1
    compared = card_vs_host("kvsall", run, scratch, batches=HOST_BATCHES)
    if compared["first_batch_relative_difference"] > 1e-5:
        fail(f"KvsAll first batch, card vs host: {compared}")
    # Adam's first update of an element is about lr * sign(g), the same
    # trap as Adagrad's (PERF.md section 2)
    if compared["avg_loss_relative_difference"] > 1e-3:
        fail(f"KvsAll first {HOST_BATCHES} batches, card vs host: "
             f"{compared}")
    # no profiled epoch here: the ConvE phase profiles the KvsAll path
    return dict(start=start_counts, resume=resume_counts,
                queries_per_s=[e["size"] / e["epoch_time"] for e in epochs])


def onevsall_phase(kernels, seed, scratch, dataset_folder) -> dict:
    """1vsAll: one epoch with kl, Adagrad lr 0.2, batch 1024 and one
    validation; the first batch card vs host."""
    from kge_tpu_torch import cli

    config_file = os.path.join(scratch, "complex-1vsall.yaml")
    write_strategy_config(
        config_file, dataset_folder, seed,
        dict(type="1vsAll", loss="kl", batch_size=TRAIN_BATCH,
             optimizer={"default": {"type": "Adagrad", "args": {"lr": 0.2}}}))
    run = os.path.join(scratch, "1vsall-run")
    reset_counts(kernels)
    cli.main(["start", config_file, "--folder", run])
    torch.cuda.synchronize()
    launched = counts(kernels)
    check_start("1vsall", run, launched, dict(
        rank_counts=VALID_LAUNCHES, shared_ce_loss=0, adagrad_row_update=0,
        sgd_row_update=0), 1)
    compared = card_vs_host("1vsall", run, scratch, batches=1)
    if compared["first_batch_relative_difference"] > 1e-5:
        fail(f"1vsAll first batch, card vs host: {compared}")
    return dict(start=launched)


def triple_phase(kernels, seed, scratch, dataset_folder) -> dict:
    """Default negative sampling, row-sparse: the sampler at its defaults
    (not shared, 3 + 3 negatives, so ``auto`` scoring is ``triple``) with
    the objects of the positives filtered out, bce, Adagrad lr 0.2, batch
    1024, tpu.sparse_updates always and weighted regularization; K3 once
    a step for both tables. The same epoch dense on the card."""
    from kge_tpu_torch import cli

    config_file = os.path.join(scratch, "complex-triple.yaml")
    write_strategy_config(
        config_file, dataset_folder, seed,
        dict(type="negative_sampling", loss="bce", batch_size=TRAIN_BATCH,
             optimizer={"default": {"type": "Adagrad", "args": {"lr": 0.2}}},
             trace_level="batch"),
        negative_sampling={"filtering": {"o": True}},
        lookup_embedder={"regularize_weight": 1e-5,
                         "regularize_args": {"weighted": True}},
        valid={"every": 0}, tpu={"sparse_updates": "always"})
    runs = {}
    run = os.path.join(scratch, "triple-run")
    for mode in ("always", "never"):
        reset_counts(kernels)
        if mode == "always":
            folder = run
            entry = cli.main(["start", config_file, "--folder", run])
        else:
            folder = os.path.join(scratch, "triple-dense")
            copy_run(run, folder, "checkpoint_00000.pt")
            entry = cli.main(["resume", folder, "--train.max_epochs", "1",
                              "--tpu.sparse_updates", "never"])
        torch.cuda.synchronize()
        with open(os.path.join(folder, "kge.log")) as f:
            log = f.read()
        losses = batch_losses(folder)
        runs[mode] = dict(
            first_batch_loss=losses[0], losses=losses,
            avg_loss=entry["avg_loss"], epoch_seconds=entry["epoch_time"],
            ms_per_step=1e3 * entry["epoch_time"] / entry["batches"],
            triples_per_s=entry["size"] / entry["epoch_time"],
            triple="with 'triple' scoring" in log,
            sparse="Using row-sparse embedding updates." in log,
            launches=counts(kernels))
    shutil.rmtree(os.path.join(scratch, "triple-dense"))
    sparse, dense = runs["always"], runs["never"]
    first_rel = relative(dense["first_batch_loss"], sparse["first_batch_loss"])
    epoch_rel = relative(dense["avg_loss"], sparse["avg_loss"])
    sparse_losses, dense_losses = sparse.pop("losses"), dense.pop("losses")
    if len(sparse_losses) != TRAIN_STEPS or len(dense_losses) != TRAIN_STEPS:
        fail(f"the triple epochs traced {len(sparse_losses)} and "
             f"{len(dense_losses)} batches, expected {TRAIN_STEPS}")
    batch_rel = max(relative(d, s) for s, d in zip(sparse_losses,
                                                   dense_losses))
    print("train triple sparse vs dense on the card: " + json.dumps(dict(
        sparse=sparse, dense=dense, first_batch_relative_difference=first_rel,
        epoch_avg_loss_relative_difference=epoch_rel,
        largest_batch_relative_difference=batch_rel)), flush=True)
    if not (sparse["triple"] and dense["triple"]):
        fail("the default sampler did not resolve to 'triple' scoring")
    if not sparse["sparse"] or dense["sparse"]:
        fail("the triple epochs: row-sparse and dense updates mixed up")
    expect_counts("the row-sparse triple epoch", sparse["launches"], dict(
        adagrad_row_update=TRAIN_STEPS, sgd_row_update=0, shared_ce_loss=0,
        rank_counts=0))
    expect_counts("the dense triple epoch", dense["launches"], dict(
        adagrad_row_update=0, shared_ce_loss=0))
    if not math.isfinite(sparse["avg_loss"]):
        fail(f"the triple epoch's loss is not finite: {sparse['avg_loss']}")
    # Adagrad's sign trap, as for the other sparse vs dense comparisons;
    # every batch is held to the epoch's tolerance (K3 itself is held bit
    # for bit at this step's shapes in the K3 kernel phase)
    if first_rel > 1e-5 or epoch_rel > 1e-3 or batch_rel > 1e-3:
        fail(f"row-sparse and dense triple epochs disagree: first batch "
             f"{first_rel}, epoch {epoch_rel}, largest of a batch "
             f"{batch_rel}")
    return dict(start=sparse["launches"])


LOSSES = ("kl", "ce", "bce", "bce_mean", "bce_self_adversarial",
          "margin_ranking", "soft_margin", "se")
OPTIMIZERS = {
    "Adagrad": {"lr": 0.2}, "Adam": {"lr": 0.001}, "AdamW": {"lr": 0.001},
    "Adamax": {"lr": 0.002}, "RMSprop": {"lr": 0.001},
    "Adadelta": {"lr": 1.0}, "SGD": {"lr": 0.1},
    "SGD-momentum": {"lr": 0.1, "momentum": 0.9},
    "SGD-nesterov": {"lr": 0.1, "momentum": 0.9, "nesterov": True},
}


def losses_optimizers_phase(seed, device) -> dict:
    """Every loss, value and gradient, at the KvsAll shape ([128, 14,541],
    smoothed matrix labels) and a negative-sampling shape ([1024, 4],
    index labels), and every optimizer type for 5 steps on ComplEx's two
    tables in two groups: the card against the host on the same inputs."""
    from kge_tpu_torch import Config
    from kge_tpu_torch.train.loss import KgeLoss
    from kge_tpu_torch.train.optimizer import KgeOptimizer
    from kge_tpu_torch.utils.params import tree_leaves

    def config(**options):
        c = Config()
        c.folder = None
        c.set("console.quiet", True)
        c.set("train.type", "negative_sampling")
        for key, value in options.items():
            c.set(key, value, create=True)
        return c

    rng = np.random.default_rng(seed)
    E = FB15K237["entities"]
    shapes = {}
    scores = (3 * rng.standard_normal((KVSALL_BATCH, E))).astype(np.float32)
    labels = (rng.random((KVSALL_BATCH, E)) < 2e-3).astype(np.float32)
    labels[np.arange(KVSALL_BATCH), rng.integers(0, E, KVSALL_BATCH)] = 1.0
    shapes["kvsall"] = (scores, 0.9 * labels + 1.0 / E)
    scores = (3 * rng.standard_normal((TRAIN_BATCH, 4))).astype(np.float32)
    shapes["negsamp"] = (scores, np.zeros(TRAIN_BATCH, dtype=np.int64))
    worst = {}
    for name in LOSSES:
        loss = KgeLoss.create(config(**{"train.loss": name}))
        for shape, (s, y) in shapes.items():
            w = np.ones(len(s), dtype=np.float32)
            w[-len(s) // 8:] = 0.0  # the padding rows of a last batch
            out = []
            for dev in (device, torch.device("cpu")):
                x = torch.tensor(s, device=dev, requires_grad=True)
                value = loss(x, torch.tensor(y, device=dev),
                             row_weights=torch.tensor(w, device=dev))
                value.backward()
                out.append((float(value.detach()), x.grad.cpu().numpy()))
            (v_card, g_card), (v_host, g_host) = out
            v_rel = relative(v_card, v_host)
            g_err = np.abs(g_card - g_host) - 1e-5 * np.abs(g_host)
            worst[f"{name}@{shape}"] = dict(
                value_relative_difference=v_rel,
                gradient_max_abs_difference=float(
                    np.abs(g_card - g_host).max()))
            if v_rel > 1e-5 or g_err.max() > 1e-6:
                fail(f"loss {name} at the {shape} shape, card vs host: "
                     f"{worst[f'{name}@{shape}']}")
    print("losses card vs host: " + json.dumps(worst), flush=True)

    tables = {"entity_embedder.weights": (E, DIM),
              "relation_embedder.weights": (FB15K237["relations"], DIM)}
    init = {name: 0.1 * rng.standard_normal(shape).astype(np.float32)
            for name, shape in tables.items()}
    grads = [{name: rng.standard_normal(shape).astype(np.float32)
              for name, shape in tables.items()} for _ in range(5)]
    worst = {}
    for opt_name, args in OPTIMIZERS.items():
        c = config(**{
            "train.optimizer.default.type": opt_name.split("-")[0],
            **{f"train.optimizer.default.args.{k}": v
               for k, v in args.items()},
            "train.optimizer.relation": {
                "regex": ".*relation_embedder.*",
                "args": {"lr": args["lr"] / 2}}})
        out = []
        for dev in (device, torch.device("cpu")):
            params = {name: torch.tensor(a, device=dev, requires_grad=True)
                      for name, a in init.items()}
            optimizer = KgeOptimizer(c, params)
            state = optimizer.init()
            for step, g in enumerate(grads):
                for name, p in params.items():
                    p.grad = torch.tensor(g[name], device=dev)
                scale = (1.0, 0.5, 1.5, 0.25, 1.0)[step]
                optimizer.step(state, {
                    group: base * scale
                    for group, base in optimizer.base_lrs.items()})
            out.append([p.detach().cpu().numpy() for p in params.values()]
                       + [np.asarray(x) for x in tree_leaves(
                           optimizer.state_to_checkpoint(state))])
        err = 0.0
        for a, b in zip(*out):
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"optimizer {opt_name}: state layouts differ")
            a, b = a.astype(np.float64), b.astype(np.float64)
            err = max(err, float(np.abs(a - b).max()))
            if not np.allclose(a, b, rtol=1e-5, atol=1e-7):
                fail(f"optimizer {opt_name}: card vs host differ beyond rtol "
                     f"1e-5, atol 1e-7 (max abs difference {err})")
        worst[opt_name] = dict(leaves=len(out[0]), max_abs_difference=err)
    print("optimizers card vs host after 5 steps: " + json.dumps(worst),
          flush=True)
    return dict(losses=len(LOSSES), optimizers=len(OPTIMIZERS))


# ----------------------------------------------------------------- wikidata5m


def host_ops_phase(dataset_folder: str) -> dict:
    """The g++ host ops (``kge_tpu_torch/native``) against numpy on the
    split in ``dataset_folder``: the triple parser against ``np.loadtxt``
    and the stable counting sort of the subjects against
    ``np.argsort(kind="stable")`` (the R-GNN graph builders' sort), the
    library's build included in its first call; the arrays must be
    equal."""
    from kge_tpu_torch import native

    path = os.path.join(dataset_folder, "train.del")
    t0 = time.perf_counter()
    lib = native.library()
    build = time.perf_counter() - t0
    if lib is None:
        fail("the g++ host ops did not build on this machine")
    t0 = time.perf_counter()
    triples = native.parse_triples(path)
    parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = np.loadtxt(path, dtype=np.int64, usecols=(0, 1, 2),
                      ndmin=2).astype(np.int32)
    loadtxt = time.perf_counter() - t0
    keys = triples[:, 0]
    t0 = time.perf_counter()
    order = native.counting_argsort(keys, W5M_ENTITIES)
    sort = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_order = np.argsort(keys, kind="stable")
    argsort = time.perf_counter() - t0
    out = dict(triples=len(triples), build_or_load_seconds=build,
               parse_seconds=parse, loadtxt_seconds=loadtxt,
               counting_argsort_seconds=sort, argsort_seconds=argsort)
    print("host ops on the Wikidata5M-size split: " + json.dumps(out),
          flush=True)
    if not (np.array_equal(triples, want)
            and np.array_equal(order, want_order)):
        fail("the g++ host ops differ from numpy's arrays")
    return out


def w5m_job(config_yaml: str, dataset, **options):
    """A training job of the Wikidata5M run's config (``config_yaml``)
    with ``options``, sharing ``dataset``, without a folder: it writes no
    4.9 GB checkpoint."""
    from kge_tpu_torch import Config
    from kge_tpu_torch.train.train import TrainingJob

    config = Config()
    config.load(config_yaml, create=True)
    for key, value in {"valid.every": 0, **options}.items():
        config.set(key, value)
    return TrainingJob.create(config, dataset)


def trained_arrays(job) -> dict:
    """Copies, on the card, of the job's parameters and optimizer state."""
    out = {name: p.detach().clone()
           for name, p in job.model.named_parameters()}
    for slot, tensors in job.opt_state.items():
        out.update({f"{slot}/{k}": v.clone() for k, v in tensors.items()})
    return out


def w5m_deterministic(config_yaml: str, dataset, scratch: str,
                      kernels) -> dict:
    """``deterministic_runs`` of the Wikidata5M run, its jobs built in
    this process without a folder: captured groups of 4, one step a
    dispatch, and 1 epoch saved, loaded (``Job.create_from``) and run to
    epoch 2, the first DET_BATCHES batches of each epoch. The epoch
    losses, tables and Adagrad sums must be equal bit for bit, and the
    kernel launches counted through the replays the per-batch run's."""
    from kge_tpu_torch import Config
    from kge_tpu_torch.train.job import Job
    from kge_tpu_torch.utils.io import load_checkpoint

    def epoch_losses(job):
        losses = []
        job.post_epoch_hooks.append(lambda j: losses.append(
            j.current_trace["epoch"]["avg_loss"]))
        return losses

    runs, grouped = {}, None

    def compare(name, job, losses, **extra):
        nonlocal grouped
        arrays = trained_arrays(job)
        runs[name] = dict(losses=losses, **extra)
        if grouped is None:
            grouped = arrays
        elif set(arrays) != set(grouped) or not all(
                torch.equal(arrays[k], grouped[k]) for k in arrays):
            fail(f"wikidata5m: the {name} run's tables are not the "
                 f"captured run's bit for bit: {runs}")

    folder = os.path.join(scratch, "w5m-det-resumed")
    torch.use_deterministic_algorithms(True)
    try:
        with first_batches(DET_BATCHES):
            for name, options in (
                    ("grouped", {}),
                    ("per_batch", {"tpu.steps_per_dispatch": 1})):
                reset_counts(kernels)
                dispatches = []
                job = w5m_job(config_yaml, dataset, **options,
                              **{"train.max_epochs": 2})
                timed_dispatches(job, dispatches)
                losses = epoch_losses(job)
                job.run()
                compare(name, job, losses, launches=counts(kernels),
                        dispatches=len(dispatches),
                        graph_replays=job.graph_replays,
                        captured=bool(job._capture))
                del job
                fresh_device_memory()
            job = w5m_job(config_yaml, dataset, **{"train.max_epochs": 1})
            job.run()
            os.makedirs(folder)
            job.config.folder = folder
            job._save(job.config.checkpoint_file(1))
            del job
            fresh_device_memory()
            config = Config()
            config.load(config_yaml, create=True)
            config.set("train.max_epochs", 2)
            config.set("valid.every", 0)
            job = Job.create_from(
                load_checkpoint(os.path.join(folder, "checkpoint_00001.pt")),
                new_config=config, dataset=dataset)
            losses = epoch_losses(job)
            job.run()
            compare("resumed", job, losses)
            del job
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(folder, ignore_errors=True)
    del grouped
    fresh_device_memory()
    print("wikidata5m deterministic checks: " + json.dumps(dict(
        runs, batches_an_epoch=DET_BATCHES)), flush=True)
    want = dict(adagrad_row_update=2 * DET_BATCHES,
                shared_ce_loss=4 * DET_BATCHES)
    for name in ("grouped", "per_batch"):
        expect_counts(f"the Wikidata5M {name} run", runs[name]["launches"],
                      want)
    if (runs["per_batch"]["losses"] != runs["grouped"]["losses"]
            or runs["resumed"]["losses"] != runs["grouped"]["losses"][1:]):
        fail(f"wikidata5m: epoch losses not equal bit for bit: {runs}")
    if (not runs["grouped"]["captured"] or runs["grouped"]["graph_replays"]
            != 2 * DET_BATCHES // GROUP - 1 or runs["per_batch"]["dispatches"]):
        fail(f"wikidata5m: the grouped run was not replayed, or the "
             f"per-batch run was grouped: {runs}")
    return runs


def w5m_window(config_yaml: str, dataset, eager: bool) -> dict:
    """Epoch 2 of a Wikidata5M job, the first PROFILE_STEPS steps of each
    epoch: captured (its one group shape captured in epoch 1) or with
    ``eager`` the same groups eagerly; once without a profiler
    (``ms_per_step_unprofiled``), once under torch.profiler. Returns
    ``window_numbers``."""
    label = f"wikidata5m {'eager' if eager else 'captured'}"

    def run():
        job = w5m_job(config_yaml, dataset, **{"train.max_epochs": 2})
        if eager:
            eager_groups(job)
        return job.run()

    with first_batches(PROFILE_STEPS):
        plain = run()
        base = fresh_device_memory()
        entry, device = profile_run(f"train {label}", "train.", run,
                                    epoch_only=True, epoch=2)
    out = dict(window_numbers(entry, device, TRAIN_BATCH, "triples", base),
               ms_per_step_unprofiled=1e3 * plain["epoch_time"]
               / plain["batches"])
    print(f"train {label} profiled window: " + json.dumps(out), flush=True)
    return out


def w5m_phase(kernels, seed, scratch) -> dict:
    """The slice's path: ``start`` of examples/wikidata5m-complex-train.yaml
    as it is (tpu.sparse_updates auto) on a synthetic graph with
    Wikidata5M's sizes for one epoch, then ``valid``; K3 must update both
    tables every step, in groups of 4 steps replayed as CUDA graphs. From
    the same checkpoint_00000.pt, one epoch each row-sparse on the card,
    dense on the card, and row-sparse on the host (plain K1 and K3),
    compared. Each run folder goes as soon as it has been read: two
    checkpoints of 4.9 GB at most are on disk at once. Then, in jobs
    without a folder, ``w5m_deterministic`` and ``w5m_window`` captured
    and eager."""
    from kge_tpu_torch import Config, Dataset, cli
    from kge_tpu_torch.train.train import TrainingJob

    n_train = WIKIDATA5M["splits"]["train"]
    t0 = time.perf_counter()
    dataset_folder = os.path.join(scratch, "wikidata5m-synthetic")
    write_dataset(dataset_folder, seed, WIKIDATA5M)
    dataset_seconds = time.perf_counter() - t0
    host_ops_phase(dataset_folder)

    saves = []  # seconds of each checkpoint save (host copy + pickle)
    writes = [True]  # False: a checkpoint that nothing reads is not saved
    save = TrainingJob._save

    def timed_save(job, filename):
        if not writes[0]:
            return
        t = time.perf_counter()
        save(job, filename)
        saves.append(time.perf_counter() - t)

    TrainingJob._save = timed_save
    try:
        run = os.path.join(scratch, "w5m-run")
        common = ["--dataset.name", dataset_folder, "--random_seed.default",
                  str(seed), "--console.quiet", "true"]
        reset_counts(kernels)
        start_base = fresh_device_memory()
        jobs, dispatches = [], []
        t0 = time.perf_counter()
        with captured_run(jobs, dispatches):
            cli.main(["start", os.path.join(REPO, W5M_RECIPE), "--folder",
                      run, "--train.max_epochs", "1", *common])
        torch.cuda.synchronize()
        start_seconds = time.perf_counter() - t0
        start_counts = counts(kernels)
        start_peak = torch.cuda.max_memory_allocated()
        start_saves = list(saves)
        with open(os.path.join(run, "kge.log")) as f:
            sparse_logged = "Using row-sparse embedding updates." in f.read()
        (epoch,) = read_trace(run, event="epoch_completed", job="train")
        # one group shape: its first group is the warm-up, a 1-step tail
        start_groups = started_captured("the Wikidata5M-size start", run,
                                        jobs[0], len(dispatches))
        if start_groups["graph_replays"] != W5M_STEPS // GROUP - 1:
            fail(f"the Wikidata5M-size start: {start_groups}, expected "
                 f"{W5M_STEPS // GROUP - 1} replays")
        del jobs[:]

        reset_counts(kernels)
        t0 = time.perf_counter()
        valid = cli.main(["valid", run])
        torch.cuda.synchronize()
        valid_seconds = time.perf_counter() - t0
        valid_counts = counts(kernels)

        steps = epoch["batches"]
        setup = start_seconds - epoch["epoch_time"] - sum(start_saves)
        print("train wikidata5m start on the card: " + json.dumps(dict(
            epoch=epoch["epoch"], avg_loss=epoch["avg_loss"], batches=steps,
            epoch_seconds=epoch["epoch_time"],
            ms_per_step=1e3 * epoch["epoch_time"] / steps,
            triples_per_s=n_train / epoch["epoch_time"],
            groups=start_groups, seconds_cli=start_seconds,
            dataset_write_seconds=dataset_seconds,
            setup_seconds=setup, checkpoint_save_seconds=start_saves,
            peak_device_memory_bytes=start_peak,
            device_memory_before_bytes=start_base, launches=start_counts,
            valid_seconds_cli=valid_seconds,
            valid_epoch_seconds=valid["epoch_time"],
            valid_launches=valid_counts,
            valid_mrr_filtered=valid["mean_reciprocal_rank_filtered"],
        )), flush=True)
        if not sparse_logged:
            fail("the Wikidata5M-size run did not use row-sparse updates")
        expect_counts("the Wikidata5M-size epoch", start_counts, dict(
            adagrad_row_update=W5M_STEPS, sgd_row_update=0,
            shared_ce_loss=2 * W5M_STEPS, rank_counts=0))
        expect_counts("the Wikidata5M-size validation", valid_counts, dict(
            rank_counts=2 * math.ceil(WIKIDATA5M["splits"]["valid"]
                                      / VALID_BATCH)))
        if steps != W5M_STEPS or not math.isfinite(epoch["avg_loss"]):
            fail(f"the Wikidata5M-size epoch: {epoch}")
        if not 0.0 < valid["mean_reciprocal_rank_filtered"] <= 1.0:
            fail("the Wikidata5M-size validation MRR is out of range")

        # the same epoch from checkpoint_00000.pt: sparse on the card,
        # dense on the card, sparse on the host
        variants = {
            "sparse-card": [],
            "dense-card": ["--tpu.sparse_updates", "never"],
            "sparse-host": ["--job.device", "cpu"],
        }
        # one copy of checkpoint_00000.pt moves from run to run; the
        # runs save no checkpoint (none is read, and a save of 4.9 GB
        # takes 5-9 s: the start timed them)
        writes[0] = False
        init = os.path.join(scratch, "w5m-checkpoint_00000.pt")
        config_yaml = os.path.join(scratch, "w5m-config.yaml")
        os.replace(os.path.join(run, "checkpoint_00000.pt"), init)
        shutil.copy(os.path.join(run, "config.yaml"), config_yaml)
        shutil.rmtree(run)
        runs = {}
        for name, flags in variants.items():
            folder = os.path.join(scratch, f"w5m-{name}")
            os.makedirs(folder)
            shutil.copy(config_yaml, os.path.join(folder, "config.yaml"))
            os.replace(init, os.path.join(folder, "checkpoint_00000.pt"))
            # the dense run would sample on the card by default: the
            # host's draws on every run
            argv = ["resume", folder, "--train.max_epochs", "1",
                    "--valid.every", "0", "--train.trace_level", "batch",
                    "--tpu.fused_negsamp_loss", "always",
                    "--tpu.on_device_sampling", "never", *flags]
            reset_counts(kernels)
            base = fresh_device_memory()
            t0 = time.perf_counter()
            entry = cli.main(argv)
            torch.cuda.synchronize()
            with open(os.path.join(folder, "kge.log")) as f:
                log = f.read()
            runs[name] = dict(
                first_batch_loss=first_batch_loss(folder),
                avg_loss=entry["avg_loss"], epoch_seconds=entry["epoch_time"],
                ms_per_step=1e3 * entry["epoch_time"] / entry["batches"],
                triples_per_s=n_train / entry["epoch_time"],
                seconds_cli=time.perf_counter() - t0,
                peak_device_memory_bytes=torch.cuda.max_memory_allocated(),
                device_memory_before_bytes=base,
                sparse="Using row-sparse embedding updates." in log,
                launches=counts(kernels))
            os.replace(os.path.join(folder, "checkpoint_00000.pt"), init)
            shutil.rmtree(folder)
            print(f"train wikidata5m {name}: " + json.dumps(runs[name]),
                  flush=True)
    finally:
        TrainingJob._save = save
    os.remove(init)

    # captured against per-batch and resumed, then the profiled windows
    config = Config()
    config.load(config_yaml, create=True)
    dataset = Dataset.create(config)
    deterministic = w5m_deterministic(config_yaml, dataset, scratch, kernels)
    windows = {name: w5m_window(config_yaml, dataset, eager)
               for name, eager in (("captured", False), ("eager", True))}
    print("train wikidata5m captured vs eager windows: " + json.dumps(dict(
        windows, speedup=windows["eager"]["ms_per_step_unprofiled"]
        / windows["captured"]["ms_per_step_unprofiled"])), flush=True)
    del dataset
    fresh_device_memory()
    shutil.rmtree(dataset_folder)

    card, dense, host = (runs[k] for k in
                         ("sparse-card", "dense-card", "sparse-host"))
    expect_counts("the sparse epoch", card["launches"],
                  dict(adagrad_row_update=W5M_STEPS))
    expect_counts("the dense epoch", dense["launches"],
                  dict(adagrad_row_update=0, shared_ce_loss=2 * W5M_STEPS))
    expect_counts("the host epoch", host["launches"],
                  dict(adagrad_row_update=0, shared_ce_loss=0))
    if not (card["sparse"] and host["sparse"]) or dense["sparse"]:
        fail("sparse-card and sparse-host must update rows sparsely, "
             "dense-card densely")
    compared = {}
    for name, other in (("dense-card", dense), ("sparse-host", host)):
        first_rel = relative(other["first_batch_loss"],
                             card["first_batch_loss"])
        epoch_rel = relative(other["avg_loss"], card["avg_loss"])
        compared[name] = dict(first_batch_relative_difference=first_rel,
                              epoch_avg_loss_relative_difference=epoch_rel)
        # the epoch: Adagrad's sign trap (its first update of an element
        # is about lr * sign(g)), as for the FB15k-237-size comparison
        if first_rel > 1e-5 or epoch_rel > 1e-3:
            fail(f"the Wikidata5M-size epoch, {name} vs sparse-card: first "
                 f"batch {first_rel}, epoch {epoch_rel}")
    print("train wikidata5m sparse-card vs: " + json.dumps(dict(
        compared, sparse_card_ms_per_step=card["ms_per_step"],
        start_ms_per_step=1e3 * epoch["epoch_time"] / steps,
        dense_card_ms_per_step=dense["ms_per_step"],
        dense_over_sparse=dense["ms_per_step"]
        / (1e3 * epoch["epoch_time"] / steps))), flush=True)
    return dict(launches=start_counts["adagrad_row_update"],
                counts=start_counts, valid_counts=valid_counts,
                groups=start_groups, deterministic=deterministic,
                windows=windows)


# ----------------------------------------------------------------- K2 widths


def rank_widths_phase(rc, seed, device) -> list:
    """K2 at this slice's query widths (SLICE_WIDTHS) against its plain
    version, at the eval batch and the validation's (B = 100, 256) over
    the FB15k-237-size entity table, the candidates a leading-row view of
    a table padded to 8 rows as the lookup embedder keeps it (rows of 4*D
    bytes: not 16-byte aligned for odd D, K2's 4-byte-copy path); each
    shape's time, device and host time, bound, plain version's and
    ``torch.matmul(q, cand.T)``'s time."""
    C = FB15K237["entities"]
    out = []
    for D in SLICE_WIDTHS:
        for B in (EVAL_BATCH, VALID_BATCH):
            q, cand, true, valid = make_rank_inputs(B, C, D, seed + D + B,
                                                    device)
            table = torch.zeros(FB_ENTITY_ROWS, D, device=device)
            table[:C] = cand
            cand = table[:C]
            label = f"B={B} D={D}"
            check = check_rank_counts(rc, label, q, cand, true, valid)
            call = lambda: rc.rank_counts(q, cand, true, valid, ATOL, RTOL)
            library = lambda: torch.matmul(q, cand.T)
            ms = cuda_ms(call, reps=50)
            plain_ms = cuda_ms(lambda: rc.rank_counts_reference(
                q, cand, true, valid, ATOL, RTOL), reps=10)
            library_ms = cuda_ms(library, reps=50)
            prof = call_profile(f"rank_counts {label}", call, library)
            bound_ms, bound_by, flops, moved = rank_bound(B, C, D)
            entry = dict(B=B, C=C, D=D, max_abs_err=check["max_abs_err"],
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms,
                         kernel_us=prof["kernel_us"],
                         host_us=prof["host_us"],
                         library_kernel_us=prof["library_kernel_us"])
            print(f"rank_counts {label}: " + json.dumps(entry), flush=True)
            out.append(entry)
    return out


# ----------------------------------------------------------------- ConvE


def write_conve_config(path: str, dataset_folder: str, seed: int):
    """The slice's main path: reciprocal ConvE by KvsAll with ConvE's
    published FB15k-237 settings (Dettmers et al. 2018; the released
    code's README): embedding dim 200 as a 20 x 10 image, 32 3 x 3
    filters, input/feature-map/projection dropout 0.2/0.2/0.3, label
    smoothing 0.1, batch 128, Adam lr 0.003, ExponentialLR gamma 0.995;
    1 epoch with a validation."""
    config = {
        "job": {"type": "train"},
        "dataset": {"name": dataset_folder},
        "model": "reciprocal_relations_model",
        "reciprocal_relations_model": {"base_model": {"type": "conve"}},
        "conve": {
            "entity_embedder": {"dim": CONVE_DIM,
                                "initialize": "xavier_normal_"},
            "relation_embedder": {"dim": CONVE_DIM,
                                  "initialize": "xavier_normal_"},
        },
        "train": {
            "type": "KvsAll", "loss": "bce", "max_epochs": 1,
            "batch_size": KVSALL_BATCH,
            "optimizer": {"default": {"type": "Adam",
                                      "args": {"lr": CONVE_LR}}},
            "lr_scheduler": "ExponentialLR",
            "lr_scheduler_args": {"gamma": 0.995},
        },
        "KvsAll": {"label_smoothing": 0.1},
        "valid": {"every": 1, "metric": "mean_reciprocal_rank_filtered"},
        "eval": {"batch_size": VALID_BATCH},
        "random_seed": {"default": seed},
        "console": {"quiet": True},
    }
    with open(path, "w") as f:
        yaml.safe_dump(config, f)


@contextlib.contextmanager
def launches_per_validation(rc, record: list):
    """Appends to ``record`` the K2 launches of each validation of every
    training job created inside (the count at each post-validation hook,
    less the count at the one before; no K2 launch happens in a KvsAll
    step)."""
    from kge_tpu_torch.train.job import Job
    from kge_tpu_torch.train.train import TrainingJob

    def hook(job):
        if isinstance(job, TrainingJob):
            seen = [rc.rank_counts.launches]

            def after_valid(_):
                record.append(rc.rank_counts.launches - seen[0])
                seen[0] = rc.rank_counts.launches

            job.post_valid_hooks.append(after_valid)

    Job.job_created_hooks.append(hook)
    try:
        yield
    finally:
        Job.job_created_hooks.remove(hook)


def dropout_statistics(device):
    """Ctx.dropout on the card, by its statistics: the kept share of a
    16.8M-element mask within 5 sigma of 1 - rate and the kept values
    scaled by 1 / keep, at ConvE's rates."""
    from kge_tpu_torch.models import Ctx

    x = torch.full((4096, 4096), 2.0, device=device)
    n = x.numel()
    out = {}
    for rate in (0.2, 0.3):
        keep = 1.0 - rate
        g = torch.Generator(device=device).manual_seed(int(rate * 10))
        y = Ctx(train=True, generator=g).dropout(x, rate)
        kept = y != 0
        share = kept.double().mean().item()
        sigma = math.sqrt(keep * (1 - keep) / n)
        scale_err = (y[kept] - 2.0 / keep).abs().max().item()
        out[rate] = dict(kept_share=share, sigmas=(share - keep) / sigma,
                         kept_value_max_abs_err=scale_err)
        if abs(share - keep) > 5 * sigma or scale_err > 1e-6:
            fail(f"dropout at rate {rate} on the card: {out[rate]}")
    print("dropout on the card: " + json.dumps(out), flush=True)


def started_captured(label: str, run: str, job, dispatches: int) -> dict:
    """A training run on the card that must have captured its groups:
    the log line and the replays (``check_replays``)."""
    with open(os.path.join(run, "kge.log")) as f:
        log = f.read()
    line = f"Capturing groups of {GROUP} steps as CUDA graphs."
    if line not in log:
        fail(f"{label}: the log does not say {line!r}")
    return check_replays(label, job, dispatches)


@contextlib.contextmanager
def captured_run(jobs: list, dispatches: list):
    """Appends to ``jobs`` every training job created inside, and to
    ``dispatches`` the host seconds of each of its group dispatches."""
    with created_jobs(jobs), on_created_jobs(
            lambda j: timed_dispatches(j, dispatches)):
        yield


def deterministic_runs(label: str, config_file: str, scratch: str,
                       regroup: bool) -> dict:
    """Under ``torch.use_deterministic_algorithms`` (the embedding
    gradients' ``index_add_`` otherwise sums in the atomics' order), the
    first DET_BATCHES batches of each epoch: 2 epochs captured in groups
    of 4, the same at one step a dispatch (in the grouped run's batch
    order where ``regroup``: KvsAll regroups by the group size), and 1
    epoch resumed to 2. The epoch losses and every array of the epoch-2
    checkpoints (parameters, model state, optimizer state) must be equal
    bit for bit."""
    from kge_tpu_torch import cli

    folders, jobs = {}, []
    torch.use_deterministic_algorithms(True)
    try:
        with first_batches(DET_BATCHES):
            for name, argv, change in (
                    ("grouped", ["--train.max_epochs", "2"], None),
                    ("per_batch", ["--train.max_epochs", "2",
                                   "--tpu.steps_per_dispatch", "1"],
                     in_group_order(GROUP) if regroup else None),
                    ("resumed", ["--train.max_epochs", "1"], None)):
                folders[name] = os.path.join(scratch, f"{label}-det-{name}")
                with on_created_jobs(change or (lambda job: None)), \
                        created_jobs(jobs):
                    cli.main(["start", config_file, "--folder",
                              folders[name], "--valid.every", "0", *argv])
            cli.main(["resume", folders["resumed"], "--train.max_epochs",
                      "2"])
    finally:
        torch.use_deterministic_algorithms(False)
    grouped, per_batch = jobs[0], jobs[1]
    if not grouped._capture or not grouped.graph_replays or (
            per_batch._steps_per_dispatch() != 1):
        fail(f"{label} deterministic runs: the grouped run was not "
             "replayed, or the per-batch run was grouped")
    del jobs[:], grouped, per_batch
    losses = {name: [e["avg_loss"] for e in read_trace(
        folder, event="epoch_completed", job="train")]
        for name, folder in folders.items()}
    arrays = {name: table_arrays(os.path.join(folder, "checkpoint_00002.pt"))
              for name, folder in folders.items()}
    checks = dict(
        batches_an_epoch=DET_BATCHES, losses=losses,
        per_batch_vs_grouped_max_abs=max_table_difference(
            arrays["per_batch"], arrays["grouped"]),
        resumed_vs_grouped_max_abs=max_table_difference(
            arrays["resumed"], arrays["grouped"]))
    print(f"{label} deterministic checks: " + json.dumps(checks), flush=True)
    if (losses["per_batch"] != losses["grouped"]
            or losses["resumed"] != losses["grouped"]
            or checks["per_batch_vs_grouped_max_abs"] != 0.0
            or checks["resumed_vs_grouped_max_abs"] != 0.0):
        fail(f"{label}: captured groups, per-batch steps and the resumed "
             f"run are not equal bit for bit: {checks}")
    for folder in folders.values():
        shutil.rmtree(folder)
    return checks


def window_numbers(entry: dict, device: dict, batch: int, unit: str,
                   base: int) -> dict:
    """ms a step, ``unit``/s (``batch`` a step), the device's busy share
    and peak memory of a profiled window (``profile_run``'s result)."""
    device_ms = sum(ms for ms, _ in device.values())
    return {"seconds": entry["epoch_time"], "batches": entry["batches"],
            "ms_per_step": 1e3 * entry["epoch_time"] / entry["batches"],
            f"{unit}_per_s": entry["batches"] * batch / entry["epoch_time"],
            "device_busy_share": device_ms / (1e3 * entry["epoch_time"]),
            "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
            "device_memory_before_bytes": base}


def epoch2_window(label: str, run: str, scratch: str, eager: bool,
                  batch: int = KVSALL_BATCH, unit: str = "queries") -> dict:
    """Epoch 2 again from ``run``'s checkpoint_00000.pt, its first
    PROFILE_STEPS steps: captured (epoch 1 whole before it, so every
    group shape is captured before the window) or with ``eager`` the
    same groups eagerly (epoch 1 cut to PROFILE_STEPS too); once without
    a profiler (``ms_per_step_unprofiled``), once under torch.profiler.
    Returns ``window_numbers``."""
    from kge_tpu_torch import cli

    def run_window(name, profiled):
        folder = os.path.join(scratch, f"{label}-window-{name}")
        copy_run(run, folder, "checkpoint_00000.pt")

        def resume():
            return cli.main(["resume", folder, "--train.max_epochs", "2",
                             "--valid.every", "0"])

        with first_batches(PROFILE_STEPS,
                           epochs=None if eager else (2,)), \
                on_created_jobs(eager_groups if eager
                                else (lambda job: None)):
            out = (profile_run(f"train {label}", "train.", resume,
                               epoch_only=True, epoch=2) if profiled
                   else resume())
        shutil.rmtree(folder)
        return out

    plain = run_window("unprofiled", False)
    base = fresh_device_memory()
    entry, device = run_window("profiled", True)
    out = dict(window_numbers(entry, device, batch, unit, base),
               ms_per_step_unprofiled=1e3 * plain["epoch_time"]
               / plain["batches"])
    print(f"train {label} profiled window: " + json.dumps(out), flush=True)
    return out


def conve_phase(kernels, seed, scratch, dataset_folder) -> dict:
    """The ConvE main path: reciprocal ConvE by KvsAll at its published
    widths (``write_conve_config``) on the FB15k-237-size graph, 1 epoch
    and a validation (through K2, 138 launches), resume to epoch 2, both
    in groups of 4 steps replayed as CUDA graphs (dropout and batch-norm
    state inside them); the first HOST_BATCHES batches of epoch 1 again on
    the card and on the host at dropout 0 (torch's CPU and CUDA
    generators draw other masks); dropout by its statistics; captured
    groups against per-batch steps and resume against an uninterrupted
    run, bit for bit (``deterministic_runs``); windows of PROFILE_STEPS
    steps profiled, captured and eager."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.ops import rank_count as rc

    config_file = os.path.join(scratch, "conve.yaml")
    write_conve_config(config_file, dataset_folder, seed)
    run = os.path.join(scratch, "conve-run")
    per_validation, jobs, dispatches = [], [], []
    reset_counts(kernels)
    t0 = time.perf_counter()
    with launches_per_validation(rc, per_validation), \
            captured_run(jobs, dispatches):
        cli.main(["start", config_file, "--folder", run])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    start_counts = counts(kernels)
    epochs = check_start("conve", run, start_counts, dict(
        rank_counts=VALID_LAUNCHES, shared_ce_loss=0,
        adagrad_row_update=0, sgd_row_update=0), 1)
    replays = {"start": started_captured("conve start", run, jobs[0],
                                         len(dispatches))}
    print(f"train conve start seconds_cli {seconds}; K2 launches per "
          f"validation {per_validation}; groups {replays['start']}",
          flush=True)
    if per_validation != [VALID_LAUNCHES]:
        fail(f"ConvE's validations launched K2 {per_validation} times, "
             f"expected {VALID_LAUNCHES} each")
    del jobs[:], dispatches[:]

    reset_counts(kernels)
    with captured_run(jobs, dispatches):
        resumed = cli.main(["resume", run, "--train.max_epochs", "2"])
    torch.cuda.synchronize()
    resume_counts = counts(kernels)
    replays["resume"] = check_replays("conve resume", jobs[0],
                                      len(dispatches))
    del jobs[:], dispatches[:]
    print("train conve resume on the card: " + json.dumps(dict(
        epoch=resumed["epoch"], avg_loss=resumed["avg_loss"],
        epoch_seconds=resumed["epoch_time"], launches=resume_counts,
        groups=replays["resume"])), flush=True)
    if resumed["epoch"] != 2 or not math.isfinite(resumed["avg_loss"]):
        fail(f"the ConvE resume did not reach a finite epoch 2: {resumed}")
    expect_counts("the resumed ConvE epoch", resume_counts, dict(
        rank_counts=VALID_LAUNCHES, shared_ce_loss=0, adagrad_row_update=0,
        sgd_row_update=0))

    dropout_statistics(torch.device("cuda:0"))
    compared = card_vs_host("conve", run, scratch, flags=CONVE_NO_DROPOUT,
                            batches=HOST_BATCHES)
    if compared["first_batch_relative_difference"] > 1e-5:
        fail(f"ConvE first batch, card vs host: {compared}")
    # Adam's first update of an element is about lr * sign(g) (PERF.md
    # section 2)
    if compared["avg_loss_relative_difference"] > 1e-3:
        fail(f"ConvE first {HOST_BATCHES} batches, card vs host: "
             f"{compared}")
    checks = deterministic_runs("conve", config_file, scratch, regroup=True)
    windows = {name: epoch2_window(f"conve {name}", run, scratch, eager)
               for name, eager in (("captured", False), ("eager", True))}
    print("train conve captured vs eager windows: " + json.dumps(dict(
        windows, speedup=windows["eager"]["ms_per_step_unprofiled"]
        / windows["captured"]["ms_per_step_unprofiled"])), flush=True)
    return dict(start=start_counts, resume=resume_counts,
                per_validation=per_validation, replays=replays,
                deterministic=checks, windows=windows,
                queries_per_s=[e["size"] / e["epoch_time"] for e in epochs])


# ----------------------------------------------------------------- scorers


def write_test_subset(dataset_folder: str, target: str, n: int):
    """A dataset folder sharing ``dataset_folder``'s files, with the first
    ``n`` test triples as its test split."""
    os.makedirs(target)
    for name in ("train.del", "valid.del", "entity_ids.del",
                 "relation_ids.del"):
        os.symlink(os.path.join(dataset_folder, name),
                   os.path.join(target, name))
    with open(os.path.join(dataset_folder, "test.del")) as f:
        lines = [next(f) for _ in range(n)]
    with open(os.path.join(target, "test.del"), "w") as f:
        f.writelines(lines)


def write_scorer_config(path: str, dataset_folder: str, seed: int,
                        spec: dict):
    """One scorer of SCORERS trained by its strategy (no validation;
    batch-level trace)."""
    model = spec["model"]
    config = {
        "job": {"type": "train"},
        "dataset": {"name": dataset_folder},
        "train": {"max_epochs": 1, "batch_size": TRAIN_BATCH,
                  "trace_level": "batch", **spec["train"]},
        "valid": {"every": 0, "metric": "mean_reciprocal_rank_filtered"},
        "eval": {"batch_size": EVAL_BATCH},
        "entity_ranking": {"chunk_size": 4096},
        "random_seed": {"default": seed},
        "console": {"quiet": True},
        **spec.get("sections", {}),
    }
    if spec.get("reciprocal"):
        config["model"] = "reciprocal_relations_model"
        config["reciprocal_relations_model"] = {"base_model": {"type": model}}
    else:
        config["model"] = model
        config["lookup_embedder"] = {"dim": DIM,
                                     "initialize": "xavier_uniform_"}
    if spec.get("options"):
        config[model] = spec["options"]
    with open(path, "w") as f:
        yaml.safe_dump(config, f)


@contextlib.contextmanager
def recorded_counts(record: list):
    """Appends to ``record`` the (triples, counts) of every batch that the
    entity-ranking jobs created inside evaluate: counts [rankings, 4, B]
    of (o rank, o ties, s rank, s ties) a ranking (raw, filtered, ...)."""
    from kge_tpu_torch.evaluation.entity_ranking import EntityRankingJob
    from kge_tpu_torch.train.job import Job

    def hook(job):
        if isinstance(job, EntityRankingJob):
            accumulate = job._accumulate_batch

            def recording(hists, rankings, totals, batch, *rest):
                record.append((batch.copy(), totals.copy()))
                return accumulate(hists, rankings, totals, batch, *rest)

            job._accumulate_batch = recording

    Job.job_created_hooks.append(hook)
    try:
        yield
    finally:
        Job.job_created_hooks.remove(hook)


def boundary_allowance(model64, route: str, entry: dict, side: str,
                       ctx, twins=None):
    """Candidates of one query whose float64 score lies at the tie
    boundary |s - t| = atol + rtol*|t| within the rounding of two float32
    computations of s and t, in the score space the evaluation ranks in
    (the dot form on the fused route, the native score on the generic
    one): such a pair may fall on either side on the card and on the
    host, and moves a final rank by at most one. The rounding bound of a
    float32 sum of D terms is D * 2^-24 times the sum of their absolute
    values: |q| . |c| for a dot form, |s| for the distances of the
    generic route (sums of non-negative terms). ``ctx`` is one eval Ctx
    for all of a model's queries (an R-GNN encoder runs once in it).

    ``twins`` ((model, ctx) on the card and on the host, float32): an
    R-GNN encoder sums a hub's thousands of messages in the order the
    card's atomics take, so its scores differ by more than the last
    product's rounding; the bound then adds twice the largest card vs
    host difference of the query's scores, which is returned too."""
    def scores_of(model, c):
        t = lambda i: torch.tensor([int(entry[i])], device=model.device)
        if side == "o":
            return model.score_sp(t("s"), t("p"), ctx=c)[0]
        return model.score_po(t("p"), t("o"), ctx=c)[0]

    with torch.no_grad():
        if route == "fused":
            t = lambda i: torch.tensor([int(entry[i])])
            q_sp, q_po = model64.dot_queries(t("s"), t("p"), t("o"), ctx)
            cand_sp, cand_po = model64.dot_candidates_all(ctx)
            q, cand = (q_sp, cand_sp) if side == "o" else (q_po, cand_po)
            scores = (q @ cand.T)[0]
            magnitude = (q.abs() @ cand.abs().T)[0]
            depth = q.shape[1]
        else:
            scores = scores_of(model64, ctx)
            magnitude = scores.abs()
            depth = model64.get_s_embedder().dim
        spread = 0.0
        if twins is not None:
            card, host = (scores_of(m, c).double().cpu() for m, c in twins)
            spread = float((card - host).abs().max())
    i = int(entry[side])
    true = scores[i]
    rounding = depth * 2.0 ** -24 * (magnitude + magnitude[i]) + 2 * spread
    tol = ATOL + RTOL * true.abs()
    near = (((scores - true).abs() - tol).abs() <= rounding).sum()
    return int(near), spread


def compare_counts(name: str, run: str, route: str, card: list,
                   host: list, checkpoint="checkpoint_00001.pt",
                   measured_spread=False) -> dict:
    """Card vs host rank and tie counts of every query and ranking:
    equal, or apart by at most the query's pairs at the tie boundary
    (``boundary_allowance``, in float64 on the host from the evaluated
    ``checkpoint``; with ``measured_spread``, widened by the card vs host
    difference of the query's float32 scores)."""
    from kge_tpu_torch.models import Ctx, KgeModel
    from kge_tpu_torch.utils.io import load_checkpoint

    if len(card) != len(host) or not card:
        fail(f"{name}: {len(card)} card and {len(host)} host batches")
    model64, queries, differing, allowed = None, 0, 0, 0
    largest_spread = 0.0
    for (triples, a), (triples_host, b) in zip(card, host):
        if not np.array_equal(triples, triples_host):
            fail(f"{name}: the card and the host ranked other triples")
        queries += 2 * len(triples)
        diff = np.abs(a - b)                      # [rankings, 4, B]
        for column in np.flatnonzero(diff.max(axis=(0, 1))):
            if model64 is None:
                stored = load_checkpoint(os.path.join(run, checkpoint))
                model64 = KgeModel.create_from(
                    stored, device=torch.device("cpu")).double()
                model64.model_state = {
                    k: {s: v.double() for s, v in st.items()}
                    for k, st in model64.model_state.items()}
                ctx = Ctx(state=model64.model_state)
                twins = None
                if measured_spread:
                    twins = [(m, Ctx(state=m.model_state)) for m in (
                        KgeModel.create_from(stored, device=torch.device(d))
                        for d in ("cuda:0", "cpu"))]
            entry = dict(zip("spo", triples[column]))
            for side, rows in (("o", slice(0, 2)), ("s", slice(2, 4))):
                worst = int(diff[:, rows, column].max())
                if not worst:
                    continue
                differing += 1
                near, spread = boundary_allowance(model64, route, entry,
                                                  side, ctx, twins)
                largest_spread = max(largest_spread, spread)
                allowed += near
                if worst > near:
                    query = tuple(map(int, triples[column]))
                    fail(f"{name}: {side} side of {query}: "
                         f"counts card {a[:, rows, column].tolist()} vs host "
                         f"{b[:, rows, column].tolist()}, {near} pairs at "
                         f"the tie boundary (score spread {spread})")
    return dict(queries=queries, rankings=len(card[0][1]),
                differing_queries=differing, boundary_pairs_in_them=allowed,
                largest_score_spread=largest_spread)


def card_vs_host_run(label: str, config_file: str, kernels, scratch, *,
                     epochs: int, steps: int, train_want: dict,
                     eval_want: dict, route: str, step_rtol: float,
                     measured_spread: bool = False) -> dict:
    """``start`` of ``config_file`` on the card for ``epochs`` epochs of
    at most ``steps`` batches each and, from the same initial checkpoint,
    on the host: ``steps`` batch losses in all, the first within 1e-5
    relative (identical weights), each within ``step_rtol`` (later steps
    see the sign trap of Adagrad's and Adam's first updates, PERF.md
    section 2); then the card-trained checkpoint evaluated on the
    dataset's test split on the card and on the host (metrics within
    1e-4, ranks by ``compare_counts`` on ``route``, ``measured_spread``
    passed on); the kernels each run launched against ``train_want`` and
    ``eval_want``."""
    from kge_tpu_torch import cli

    run = os.path.join(scratch, label.replace(" ", "-"))
    reset_counts(kernels)
    t0 = time.perf_counter()
    with first_batches(steps):
        cli.main(["start", config_file, "--folder", run])
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    train_counts = counts(kernels)
    expect_counts(f"{label}'s training", train_counts, train_want)
    card_losses = batch_losses(run)

    host_folder = run + "-host"
    copy_run(run, host_folder, "checkpoint_00000.pt")
    t0 = time.perf_counter()
    with first_batches(steps):
        cli.main(["resume", host_folder, "--train.max_epochs", str(epochs),
                  "--job.device", "cpu"])
    host_train_seconds = time.perf_counter() - t0
    host_losses = batch_losses(host_folder)
    shutil.rmtree(host_folder)
    n = steps if epochs == 1 else epochs
    if (len(card_losses) != n or len(host_losses) != n
            or not all(map(math.isfinite, card_losses))):
        fail(f"{label}: losses card {card_losses} host {host_losses}")
    first = relative(card_losses[0], host_losses[0])
    worst = max(relative(a, b) for a, b in zip(card_losses, host_losses))
    if first > 1e-5 or worst > step_rtol:
        fail(f"{label}: card vs host batch losses, first {first}, largest "
             f"{worst}: card {card_losses} host {host_losses}")

    reset_counts(kernels)
    card_counts, host_counts = [], []
    t0 = time.perf_counter()
    with recorded_counts(card_counts):
        card = cli.main(["test", run])
    torch.cuda.synchronize()
    eval_seconds = time.perf_counter() - t0
    eval_counts = counts(kernels)
    t0 = time.perf_counter()
    with recorded_counts(host_counts):
        host = cli.main(["test", run, "--job.device", "cpu"])
    host_eval_seconds = time.perf_counter() - t0
    expect_counts(f"{label}'s evaluation", eval_counts, eval_want)
    metrics = {k: v for k, v in card.items()
               if k.startswith(("mean_", "hits_"))}
    # relative to the value where it exceeds 1 (a mean rank moves by
    # 1 / 4,000 for one rank at the tie boundary), as in the eval phase
    worst_metric = max(abs(v - host[k]) / max(1.0, abs(host[k]))
                       for k, v in metrics.items())
    if not all(map(math.isfinite, metrics.values())) or worst_metric > 1e-4:
        fail(f"{label}: eval metrics card {metrics} vs host {host}")
    ranks = compare_counts(label, run, route, card_counts, host_counts,
                           checkpoint=f"checkpoint_{epochs:05d}.pt",
                           measured_spread=measured_spread)
    shutil.rmtree(run)
    out = dict(route=route, train_launches=train_counts,
               eval_launches=eval_counts, card_losses=card_losses,
               first_batch_relative_difference=first,
               largest_batch_relative_difference=worst,
               mrr_filtered=metrics["mean_reciprocal_rank_filtered"],
               host_mrr_filtered=host["mean_reciprocal_rank_filtered"],
               largest_metric_difference=worst_metric, ranks=ranks,
               card_train_seconds=train_seconds,
               host_train_seconds=host_train_seconds,
               card_eval_seconds=eval_seconds,
               host_eval_seconds=host_eval_seconds)
    print(f"{label} card vs host: " + json.dumps(out), flush=True)
    return out


def scorer_run(name: str, spec: dict, kernels, seed, scratch,
               dataset_folder) -> dict:
    """One scorer: SCORER_STEPS steps of its strategy and an evaluation,
    card vs host, its route asserted by the kernels each run launched."""
    config_file = os.path.join(scratch, f"scorer-{name}.yaml")
    write_scorer_config(config_file, dataset_folder, seed, spec)
    fused = spec["route"] == "fused"
    return card_vs_host_run(
        f"scorer {name}", config_file, kernels, scratch, epochs=1,
        steps=SCORER_STEPS, train_want=dict(
            NO_KERNELS, shared_ce_loss=2 * SCORER_STEPS if spec["k1"] else 0,
            adagrad_row_update=SCORER_STEPS if spec["k3"] else 0),
        eval_want=dict(NO_KERNELS, rank_counts=2 * math.ceil(
            SCORER_TEST / EVAL_BATCH) if fused else 0),
        route=spec["route"], step_rtol=1e-3)


def scorers_phase(kernels, seed, scratch, dataset_folder) -> dict:
    """Every other scorer of kge_tpu (SCORERS): trained for SCORER_STEPS
    steps and evaluated on the first SCORER_TEST test triples, card vs
    host, each run asserting its route by the kernels it launched."""
    subset = os.path.join(scratch, "fb15k237-test-subset")
    write_test_subset(dataset_folder, subset, SCORER_TEST)
    return {name: scorer_run(name, spec, kernels, seed, scratch, subset)
            for name, spec in SCORERS.items()}


# ----------------------------------------------------------------- R-GNN

def write_recipe_config(path: str, recipe: str, dataset_folder: str,
                        seed: int, options: dict):
    """The recipe's config as it is, over ``dataset_folder``, seeded from
    ``seed``, with ``options`` (dotted keys) on top."""
    with open(os.path.join(REPO, recipe)) as f:
        config = yaml.safe_load(f)
    config.pop("dataset.name", None)
    config.update({"dataset": {"name": dataset_folder},
                   "random_seed": {"default": seed},
                   "console": {"quiet": True}, **options})
    with open(path, "w") as f:
        yaml.safe_dump(config, f)


def skewed_ccorr_graph(rng):
    """(src sorted, nbr, types) of one half of FB15k-237's edges over its
    nodes and relation rows, Zipf-skewed, with node 5 the neighbour of
    5,000 edges and relation 11 on about 12% of them."""
    N, R, E = CCORR_NODES, CCORR_TYPES, CCORR_EDGES
    nbr = np.minimum(rng.zipf(1.3, E) - 1, N - 1)
    src = np.sort(rng.integers(0, N, E))
    types = np.minimum(rng.zipf(1.5, E) - 1, R - 1)
    nbr[:5000] = 5
    types[rng.random(E) < 0.12] = 11
    return src, nbr, types


def ccorr_reduce_check(cr, seed, device) -> dict:
    """The spectral route's kernel (``csrc/ccorr_reduce.cu``) against its
    plain version on ``skewed_ccorr_graph``: the forward by aggregation
    node and the backward's two reductions (by neighbour, by relation),
    at Kp 52 (ccorr at d = 200) and 102 (ccorr_true), each within 1e-5 of
    float64 relative to the largest float64 value, two calls
    bit-identical, one launch counted a call; then, at Kp 52, each
    reduction's CUDA-event ms, device and host us a call, the plain
    version's ms, its bound (the bytes read and written once, or the
    flops) and the rate of its row gathers."""
    src, nbr, types = skewed_ccorr_graph(np.random.default_rng(seed))
    N, R, E = CCORR_NODES, CCORR_TYPES, CCORR_EDGES
    if np.bincount(nbr).max() < 5000 or np.bincount(types).max() < E // 10:
        fail("the skewed ccorr graph lacks its hub or its big relation")
    orders = {name: order.to(device) for name, order in
              cr.build_orders(src, nbr, types, N, R).items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = torch.rand(E, device=device, generator=gen)
    out, worst = {}, 0.0
    for kp in (52, 102):
        xh, grad = (torch.randn((N, kp, 2), device=device, generator=gen)
                    for _ in range(2))
        rh = torch.randn((R, kp, 2), device=device, generator=gen)
        for name, a, b, conj in (("src", xh, rh, True),
                                 ("nbr", grad, rh, True),
                                 ("type", grad, xh, False)):
            order = orders[name]
            label = f"ccorr_reduce {name} order (Kp={kp})"
            before = cr.ccorr_reduce.launches
            got = cr.ccorr_reduce(a, b, order, scale, conj)
            again = cr.ccorr_reduce(a, b, order, scale, conj)
            torch.cuda.synchronize()
            if cr.ccorr_reduce.launches != before + 2:
                fail(f"{label}: {cr.ccorr_reduce.launches - before} launches "
                     "counted for 2 calls")
            if not torch.equal(got, again):
                fail(f"{label}: two calls differ")
            want = cr.ccorr_reduce_reference(a.double(), b.double(), order,
                                             scale.double(), conj)
            err = ((got.double() - want).abs().max()
                   / want.abs().max()).item()
            worst = max(worst, err)
            print(f"{label}: relative error against float64 {err}",
                  flush=True)
            if err > 1e-5:
                fail(f"{label}: relative error {err} against float64")
            del want, again, got
            if kp != 52:
                continue

            def kernel():
                cr.ccorr_reduce(a, b, order, scale, conj)

            ms = cuda_ms(kernel, reps=100)
            plain_ms = cuda_ms(lambda: cr.ccorr_reduce_reference(
                a, b, order, scale, conj), reps=10)
            prof = call_profile(label, kernel, None)
            by_name = prof["by_name"]
            heavy = order.heavy_rows.shape[0]
            passes = [sum(n for k, (_, n) in by_name.items()
                          if part in k and ("heavy" in k) == (part[0] == "h"))
                      for part in ("piece_sums", "row_sums", "heavy_row_sums")]
            if passes != [1, 1, int(heavy > 0)]:
                fail(f"{label}: {passes} launches of its passes a call "
                     f"({heavy} heavy rows)")
            pieces = order.piece_begin.shape[0] - 1
            moved = 4.0 * (a.numel() + b.numel() + order.rows * kp * 2
                           + E * (3 if order.edge is None else 4)
                           + pieces + 1 + order.rows + 1)
            # a complex product (6) and its scaled sum (4) a bin an edge
            flops = 10.0 * E * kp
            bound_ms = max(moved / PEAK_BYTES_PER_S,
                           flops / PEAK_FP32_FLOPS) * 1e3
            gathered = E * 2 * kp * 2 * 4.0
            numbers = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by="bytes", kernel_us=prof["kernel_us"],
                           host_us=prof["host_us"], pieces=pieces,
                           heavy_rows=heavy,
                           gathered_mb=gathered / 1e6,
                           gather_tb_per_s=gathered / (
                               prof["kernel_us"] * 1e-6) / 1e12)
            print(f"{label}: " + json.dumps(numbers), flush=True)
            out[name] = numbers
        del xh, grad, rh
    torch.cuda.empty_cache()
    return dict(out, max_rel_err=worst)


def replayed_batches(label: str, run: str, epochs) -> list:
    """Each epoch's batches replayed as CUDA graphs, from the log of a
    captured run: at least 90% of the epoch's batches (the first group
    of each key runs eagerly, its capture's warm-up)."""
    with open(os.path.join(run, "kge.log")) as f:
        log = f.read()
    if "Capturing groups of 4 steps as CUDA graphs." not in log:
        fail(f"{label}: the groups of steps were not captured")
    out = []
    for e in epochs:
        line = f"Epoch {e['epoch']}: "
        found = [text for text in log.splitlines() if line in text
                 and "batches replayed as CUDA graphs" in text]
        if not found:
            fail(f"{label}: no replayed batches logged for epoch "
                 f"{e['epoch']}")
        replayed = int(found[-1].split(line)[1].split()[0])
        if replayed < 0.9 * e["batches"]:
            fail(f"{label}: {replayed} of {e['batches']} batches of epoch "
                 f"{e['epoch']} replayed")
        out.append(replayed)
    print(f"train {label} replayed batches: {out}", flush=True)
    return out


def compgcn_phase(kernels, seed, scratch, dataset_folder) -> dict:
    """The slice's main path: ``start`` of CompGCN's FB15k-237 recipe as it
    is (one message-passing layer over the whole graph, ccorr, reciprocal
    ConvE, KvsAll with bce, batch 128, Adam lr 0.001) on the FB15k-237-size
    graph, 1 epoch and a validation, ``resume`` for 1 more, each epoch's
    groups of steps captured and replayed as CUDA graphs; of the
    kernels only the spectral route's ``ccorr_reduce`` (checked first
    against its plain version, ``ccorr_reduce_check``): 6 launches a
    training step, counted through the replays, and 2 an evaluation
    batch; the first
    COMPGCN_HOST_BATCHES batches of epoch 1 card vs host at dropout 0; a
    window of PROFILE_STEPS steps profiled."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.ops import ccorr_reduce as cr

    check = ccorr_reduce_check(cr, seed, torch.device("cuda:0"))
    valid_batches = math.ceil(FB15K237["splits"]["valid"] / VALID_BATCH)

    def expect_spectral(label, launched, epochs):
        want = 6 * sum(e["batches"] for e in epochs) + 2 * valid_batches
        if launched["ccorr_reduce"] != want:
            fail(f"{label} launched ccorr_reduce {launched['ccorr_reduce']} "
                 f"times, expected {want}")

    config_file = os.path.join(scratch, "compgcn.yaml")
    write_recipe_config(config_file, COMPGCN_RECIPE, dataset_folder, seed, {
        "train.max_epochs": 1, "valid.every": 1,
        "valid.metric": "mean_reciprocal_rank_filtered",
        "eval.batch_size": VALID_BATCH})
    run = os.path.join(scratch, "compgcn-run")
    reset_counts(kernels)
    t0 = time.perf_counter()
    cli.main(["start", config_file, "--folder", run])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    start_counts = counts(kernels)
    epochs = check_start("compgcn", run, start_counts, NO_KERNELS, 1)
    expect_spectral("the CompGCN start", start_counts, epochs)
    replayed = replayed_batches("compgcn", run, epochs)
    print(f"train compgcn start seconds_cli {seconds}", flush=True)

    reset_counts(kernels)
    resumed = cli.main(["resume", run, "--train.max_epochs", "2"])
    torch.cuda.synchronize()
    resume_counts = counts(kernels)
    valids = read_trace(run, event="eval_completed", job="eval")
    print("train compgcn resume on the card: " + json.dumps(dict(
        epoch=resumed["epoch"], avg_loss=resumed["avg_loss"],
        epoch_seconds=resumed["epoch_time"],
        ms_per_step=1e3 * resumed["epoch_time"] / resumed["batches"],
        queries_per_s=resumed["size"] / resumed["epoch_time"],
        launches=resume_counts, valid_mrr_filtered=[
            v["mean_reciprocal_rank_filtered"] for v in valids])),
        flush=True)
    if resumed["epoch"] != 2 or not math.isfinite(resumed["avg_loss"]):
        fail(f"the CompGCN resume did not reach a finite epoch 2: {resumed}")
    if len(valids) != 2 or not all(
            0.0 < v["mean_reciprocal_rank_filtered"] <= 1.0 for v in valids):
        fail("CompGCN: a validation is missing or out of range")
    expect_counts("the resumed CompGCN epoch", resume_counts, NO_KERNELS)
    expect_spectral("the resumed CompGCN epoch", resume_counts, [resumed])
    replayed += replayed_batches("compgcn_resume", run, [resumed])

    # a host step runs the encoder over the whole graph: the first batches
    compared = card_vs_host("compgcn", run, scratch,
                            flags=COMPGCN_NO_DROPOUT,
                            batches=COMPGCN_HOST_BATCHES)
    if compared["first_batch_relative_difference"] > 1e-5:
        fail(f"CompGCN first batch, card vs host: {compared}")
    # Adam's first update of an element is about lr * sign(g) (PERF.md
    # section 2)
    if compared["avg_loss_relative_difference"] > 1e-3:
        fail(f"CompGCN first {COMPGCN_HOST_BATCHES} batches, card vs host: "
             f"{compared}")
    profiled_window("compgcn", run, scratch, 3)
    return dict(start=start_counts, resume=resume_counts,
                ccorr_reduce=check, replayed_batches=replayed,
                losses=[e["avg_loss"] for e in epochs] + [
                    resumed["avg_loss"]],
                queries_per_s=[e["size"] / e["epoch_time"] for e in epochs]
                + [resumed["size"] / resumed["epoch_time"]])


def rgnn_run(name: str, spec: dict, kernels, seed, scratch,
             dataset_folder) -> dict:
    """One encoder's recipe at its widths, dropout 0: RGNN_STEPS steps and
    an evaluation through the generic route, card vs host, no kernel
    launched in either. Adam's first updates at the recipes' learning
    rates put W-GCN's third step 1.5e-3 apart (a ConvE batch has been
    3.6e-3 apart), so a step holds to 1e-2; the ranks' tie-boundary
    allowance takes the encoder's card vs host score spread in."""
    config_file = os.path.join(scratch, f"rgnn-{name}.yaml")
    write_recipe_config(config_file, spec["recipe"], dataset_folder, seed, {
        "train.max_epochs": spec["epochs"], "train.trace_level": "batch",
        "valid.every": 0, "valid.metric": "mean_reciprocal_rank_filtered",
        "eval.batch_size": RGNN_EVAL_BATCH, **spec["options"]})
    return card_vs_host_run(
        f"rgnn {name}", config_file, kernels, scratch, epochs=spec["epochs"],
        steps=RGNN_STEPS, train_want=NO_KERNELS, eval_want=NO_KERNELS,
        route="generic", step_rtol=1e-2, measured_spread=True)


def rgnn_encoders_phase(kernels, seed, scratch, dataset_folder) -> dict:
    """R-GCN, W-GCN and RAGAT by their FB15k-237 recipes and CompGCN with
    TransE (RGNN_ENCODERS) on the FB15k-237-size graph, each trained and
    evaluated on the first RGNN_TEST test triples card vs host."""
    subset = os.path.join(scratch, "fb15k237-rgnn-test-subset")
    write_test_subset(dataset_folder, subset, RGNN_TEST)
    return {name: rgnn_run(name, spec, kernels, seed, scratch, subset)
            for name, spec in RGNN_ENCODERS.items()}


#: the phases in the order they run
# ----------------------------------------------------------------- slice 9


BF16 = ["--tpu.compute_dtype", "bfloat16"]
# K1 launches of a forward-only (training_loss) epoch over the valid split
TRAINING_LOSS_LAUNCHES = 2 * math.ceil(FB15K237["splits"]["valid"]
                                       / TRAIN_BATCH)
# entity-pair ranking: test triples ranked against all E x E pairs
PAIR_QUERIES = 20
SEARCH_TRIALS = 4


def bf16_phase(kernels, seed, scratch, dataset_folder, tr) -> dict:
    """The main path of this slice: ``start`` of the training main path's
    config (examples/wikidata5m-complex-train.yaml's hyperparameters,
    ComplEx dim 128, 2 epochs with validation) with
    ``--tpu.compute_dtype bfloat16``: K1 reads bf16 operands (cast to
    float32 for the kernel) twice a step, K2 ranks each validation in
    float32; params and optimizer state stay float32. Then the card
    against the host on the first batch, epoch 1 against the float32
    run's, a ``training_loss`` validation card vs host, and a profiled
    window of 200 steps. ``tr`` is the train phase's result (its config
    and epoch 1), or None when that phase did not run."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.utils.io import load_checkpoint
    from kge_tpu_torch.utils.params import tree_leaves

    if tr is None:
        config_file = os.path.join(scratch, "complex-negsamp-bf16.yaml")
        write_train_config(config_file, dataset_folder, seed)
        f32_first_epoch = None
    else:
        config_file = tr["config_file"]
        f32_first_epoch = tr["first_epoch_avg_loss"]
    run = os.path.join(scratch, "bf16-run")
    fresh_device_memory()
    reset_counts(kernels)
    t0 = time.perf_counter()
    cli.main(["start", config_file, "--folder", run, *BF16])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launched = counts(kernels)
    epochs = check_start("bf16", run, launched, dict(
        shared_ce_loss=2 * 2 * TRAIN_STEPS, rank_counts=2 * VALID_LAUNCHES,
        adagrad_row_update=0, sgd_row_update=0), 2)
    print("train bf16 on the card: " + json.dumps(dict(
        seconds_cli=seconds, peak_device_memory_bytes=peak,
        k1_launches_per_step=launched["shared_ce_loss"]
        / sum(e["batches"] for e in epochs))), flush=True)

    stored = load_checkpoint(os.path.join(run, "checkpoint_00002.pt"))
    if stored["config"]["tpu"]["compute_dtype"] != "bfloat16":
        fail("the bf16 run's checkpoint does not record its compute dtype")
    dtypes = {str(np.asarray(x).dtype) for x in (
        tree_leaves(stored["model"]) + tree_leaves(stored["opt_state"]))}
    if dtypes != {"float32"}:
        fail(f"bf16 training stored parameters or optimizer state of "
             f"dtypes {sorted(dtypes)}, not float32 alone")

    # the host takes K1's plain version (fused_negsamp_loss auto is the
    # kernel's route on a card only)
    fused = ["--tpu.fused_negsamp_loss", "always"]
    compared = card_vs_host("bf16", run, scratch, batches=1,
                            flags=[*BF16, *fused])
    if compared["first_batch_relative_difference"] > 1e-2:
        fail(f"bf16 first batch loss, card vs host: {compared}")
    first = epochs[0]["avg_loss"]
    vs_f32 = None
    if f32_first_epoch is not None:
        vs_f32 = relative(first, f32_first_epoch)
        print("train bf16 epoch 1 vs float32: " + json.dumps(dict(
            bf16=first, float32=f32_first_epoch, relative_difference=vs_f32)),
            flush=True)
        if vs_f32 > 2e-2:
            fail(f"bf16 epoch 1 avg_loss {first} vs float32's "
                 f"{f32_first_epoch}: {vs_f32}")

    # training_loss: a forward-only epoch over the valid split, K1 forward
    reset_counts(kernels)
    t0 = time.perf_counter()
    card = cli.main(["valid", run, "--eval.type", "training_loss", *fused])
    torch.cuda.synchronize()
    card_seconds = time.perf_counter() - t0
    loss_counts = counts(kernels)
    t0 = time.perf_counter()
    host = cli.main(["valid", run, "--eval.type", "training_loss", *fused,
                     "--job.device", "cpu"])
    host_seconds = time.perf_counter() - t0
    loss_rel = relative(card["avg_loss"], host["avg_loss"])
    print("training_loss valid card vs host: " + json.dumps(dict(
        card=card["avg_loss"], host=host["avg_loss"], size=card["size"],
        relative_difference=loss_rel, card_seconds_cli=card_seconds,
        host_seconds_cli=host_seconds, launches=loss_counts)), flush=True)
    expect_counts("the training_loss validation", loss_counts, dict(
        shared_ce_loss=TRAINING_LOSS_LAUNCHES, rank_counts=0,
        adagrad_row_update=0, sgd_row_update=0))
    if card["type"] != "training_loss" or not math.isfinite(card["avg_loss"]):
        fail(f"training_loss validation: {card}")
    if loss_rel > 1e-5:
        fail(f"training_loss avg_loss card {card['avg_loss']} vs host "
             f"{host['avg_loss']}: {loss_rel}")

    profiled_window("bf16", run, scratch, 1, batch=TRAIN_BATCH,
                    unit="triples", flags=BF16)
    return dict(counts=launched, training_loss_counts=loss_counts,
                config_file=config_file,
                best=os.path.join(run, "checkpoint_best.pt"))


# ----------------------------------------------------------------- device epoch

# the main path's epoch: 66 groups of 4 steps (steps_per_dispatch at its
# default) and a 2-step tail
GROUP = 4
GROUPS_PER_EPOCH = TRAIN_STEPS // GROUP
# device_shared_sample on the card, by its statistics: draws at the
# recipe's shape (num 128 over the 14,541 entities, default sharing, with
# replacement), each for DRAW_ROWS positives
DRAWS, DRAW_ROWS = 10000, 64
# a chi-square statistic fails below this p-value (the draws are seeded)
CHI2_P_MIN = 1e-3


def distinct_count_pmf(draws: int, values: int) -> np.ndarray:
    """P(d distinct values among ``draws`` uniform draws over ``values``),
    d = 0..draws, by the occupancy recursion in float64."""
    p = np.zeros(draws + 1)
    p[0] = 1.0
    for _ in range(draws):
        d = np.arange(draws + 1)
        moved = np.zeros_like(p)
        moved[1:] = p[:-1] * (values - d[:-1]) / values
        p = p * d / values + moved
    return p


def chi2_p(observed: np.ndarray, expected: np.ndarray) -> float:
    """p-value of Pearson's chi-square, the bins with an expected count
    below 5 merged into their neighbours (in order)."""
    from scipy.stats import chi2

    obs, exp = [], []
    o_acc = e_acc = 0.0
    for o, e in zip(observed, expected):
        o_acc += o
        e_acc += e
        if e_acc >= 5:
            obs.append(o_acc)
            exp.append(e_acc)
            o_acc = e_acc = 0.0
    if e_acc and exp:
        obs[-1] += o_acc
        exp[-1] += e_acc
    obs, exp = np.asarray(obs), np.asarray(exp)
    stat = float(np.sum((obs - exp) ** 2 / exp))
    return float(chi2.sf(stat, len(obs) - 1))


def draw_statistics(seed, device) -> dict:
    """DRAWS shared samples of device_shared_sample at the recipe's shape
    on the card: the number of distinct negatives against its exact
    distribution (chi-square, and the mean within 3 standard errors of
    base_voc * (1 - (1 - 1/base_voc)^num)), the live uniques' ids against
    the uniform (chi-square over the entities), the dropped positions of
    the rows whose positive was not drawn against the uniform over
    [0, nu] (chi-square), and every drawn positive dropped at its
    position."""
    from kge_tpu_torch.train.sampler import device_shared_sample

    num, voc = NEGATIVES, FB15K237["entities"]
    base_voc = voc - 1
    gen = torch.Generator(device).manual_seed(seed)
    pos_gen = torch.Generator(device).manual_seed(seed + 1)
    nus = torch.empty(DRAWS, dtype=torch.int64, device=device)
    id_counts = torch.zeros(voc, dtype=torch.int64, device=device)
    drop_counts = torch.zeros(num + 1, dtype=torch.int64, device=device)
    free_rows = torch.empty(DRAWS, dtype=torch.int64, device=device)
    misdropped = torch.zeros((), dtype=torch.int64, device=device)
    idx = torch.arange(num + 1, device=device)
    t0 = time.perf_counter()
    for i in range(DRAWS):
        positives = torch.randint(0, voc, (DRAW_ROWS,), generator=pos_gen,
                                  device=device)
        unique, base, nu, drop = device_shared_sample(
            gen, num, voc, False, True, positives)
        # counted by index_add_ (no host sync a draw)
        nus[i] = nu
        live = idx < nu + 1
        id_counts.index_add_(0, unique, live.to(torch.int64))
        match = (unique[None, :] == positives[:, None]) & live[None, :]
        hit = match.any(dim=1)
        misdropped += torch.sum(hit & ~match.gather(1, drop[:, None])[:, 0])
        drop_counts.index_add_(0, drop, (~hit).to(torch.int64))
        free_rows[i] = torch.sum(~hit)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    nus_h, free_h = nus.cpu().numpy(), free_rows.cpu().numpy()
    pmf = distinct_count_pmf(num, base_voc)
    nu_hist = np.bincount(nus_h, minlength=num + 1)
    mean = float(np.sum(np.arange(num + 1) * pmf))
    sd = math.sqrt(float(np.sum((np.arange(num + 1) - mean) ** 2 * pmf)))
    want_mean = base_voc * (1 - (1 - 1 / base_voc) ** num)
    ids = id_counts.cpu().numpy()
    drops = drop_counts.cpu().numpy()
    # the free rows of a draw drop uniformly over [0, nu]
    expected_drops = np.zeros(num + 1)
    for nu_value, rows in zip(nus_h, free_h):
        expected_drops[:nu_value + 1] += rows / (nu_value + 1)
    out = dict(
        draws=DRAWS, rows_a_draw=DRAW_ROWS, seconds=seconds,
        nu_mean=float(nus_h.mean()), nu_mean_expected=want_mean,
        nu_mean_standard_errors=abs(float(nus_h.mean()) - want_mean)
        / (sd / math.sqrt(DRAWS)),
        nu_chi2_p=chi2_p(nu_hist, DRAWS * pmf),
        unique_ids_chi2_p=chi2_p(ids, np.full(voc, ids.sum() / voc)),
        drop_chi2_p=chi2_p(drops, expected_drops),
        drawn_positives_not_dropped=int(misdropped))
    print("device_shared_sample on the card: " + json.dumps(out), flush=True)
    if out["nu_mean_standard_errors"] > 3:
        fail(f"device draws: nu's mean is off: {out}")
    if min(out["nu_chi2_p"], out["unique_ids_chi2_p"],
           out["drop_chi2_p"]) < CHI2_P_MIN:
        fail(f"device draws fail a chi-square test: {out}")
    if out["drawn_positives_not_dropped"]:
        fail(f"device draws: a drawn positive was not dropped: {out}")
    return out


@contextlib.contextmanager
def created_jobs(jobs: list, forward_only: bool = False):
    """Appends every training job created inside to ``jobs`` (with
    ``forward_only``, every forward-only one: a ``training_loss``
    evaluation's)."""
    from kge_tpu_torch.train.job import Job
    from kge_tpu_torch.train.train import TrainingJob

    def record(job):
        if (isinstance(job, TrainingJob)
                and job.is_forward_only == forward_only):
            jobs.append(job)

    Job.job_created_hooks.append(record)
    try:
        yield jobs
    finally:
        Job.job_created_hooks.remove(record)


def timed_dispatches(job, record: list):
    """Wraps ``job``'s group dispatch: appends the host seconds of each
    call (the inputs' upload, the replay's enqueue, the output's copy;
    no synchronisation)."""
    dispatch = job._dispatch_group

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = dispatch(*args, **kwargs)
        record.append(time.perf_counter() - t0)
        return out

    job._dispatch_group = timed


def table_arrays(checkpoint_file: str) -> dict:
    from kge_tpu_torch.utils.io import load_checkpoint
    from kge_tpu_torch.utils.params import tree_leaves, tree_paths

    stored = load_checkpoint(checkpoint_file)
    out = {}
    for tree in ("model", "opt_state"):
        for path, leaf in zip(tree_paths(stored[tree]),
                              tree_leaves(stored[tree])):
            out[f"{tree}/{path}"] = np.asarray(leaf)
    return out


def max_table_difference(a: dict, b: dict) -> float:
    if set(a) != set(b):
        fail(f"checkpoints hold different arrays: {sorted(set(a) ^ set(b))}")
    return max(float(np.max(np.abs(a[k].astype(np.float64)
                                   - b[k].astype(np.float64))))
               if a[k].size else 0.0 for k in a)


# ----------------------------------------------------------------- mesh

#: one rank of a mesh run, as ``python -c``: ``python -m kge_tpu_torch``'s
#: entry point with the argv after its first two arguments, the rank's
#: kernel launches counted from 0, the evaluation's raw and filtered
#: (rank, tie) counts recorded (rank 0 saves them to ``<prefix>-totals.npy``);
#: the second argument's options: ``steps``, the batches of each training
#: epoch (the first ones, in order), ``window``, a (first, last) step window
#: run under torch.profiler (its seconds and the host time of the
#: ``comm.*`` (collectives) and ``train.*`` spans), ``deterministic``,
#: ``torch.use_deterministic_algorithms`` for the run, ``probe``, which
#: of the backend's other collectives take CUDA tensors in this process
#: group (every rank asks the same, so a refusal raises on all of them)
MESH_RANK_SCRIPT = r"""
import itertools, json, sys, time
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from kge_tpu_torch import cli
from kge_tpu_torch.parallel.collectives import halo_exchange
from kge_tpu_torch.evaluation.entity_ranking import EntityRankingJob
from kge_tpu_torch.ops import negsamp_loss as nl, rank_count as rc
from kge_tpu_torch.ops import row_update as ru
from kge_tpu_torch.parallel import distributed as dist
from kge_tpu_torch.train.job import Job
from kge_tpu_torch.train.train import TrainingJob

prefix, options, argv = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3:]
window = options.get("window")
torch.use_deterministic_algorithms(options.get("deterministic", False))
kernels = (rc.rank_counts, nl.shared_ce_loss, ru.adagrad_row_update,
           ru.sgd_row_update)
totals = []
accumulate = EntityRankingJob._accumulate_batch


def record(self, hists, rankings, t, *rest):
    totals.append(np.asarray(t[:2]))
    return accumulate(self, hists, rankings, t, *rest)


EntityRankingJob._accumulate_batch = record
prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
span = {"step": 0}


def hooks(job):
    if not isinstance(job, TrainingJob) or job.is_forward_only:
        return
    first, last = window

    def pre(j):
        if j.epoch == 1 and span["step"] == first:
            torch.cuda.synchronize()
            prof.start()
            span["t0"] = time.perf_counter()

    def post(j):
        span["step"] += 1
        if j.epoch == 1 and span["step"] == last:
            torch.cuda.synchronize()
            span["seconds"] = time.perf_counter() - span["t0"]
            prof.stop()

    job.pre_batch_hooks.append(pre)
    job.post_batch_hooks.append(post)


if window:
    Job.job_created_hooks.append(hooks)
jobs = []


def cut(job):
    if isinstance(job, TrainingJob) and not job.is_forward_only:
        jobs.append(job)
        if options.get("steps"):
            generate = job._generate_batches
            job._generate_batches = lambda epoch: itertools.islice(
                generate(epoch), options["steps"])


Job.job_created_hooks.append(cut)
probe = {}
if options.get("probe"):
    import torch.distributed as tdist
    dist.init_distributed(device_type="cuda")
    torch.cuda.set_device(dist.local_rank() % torch.cuda.device_count())
    x = torch.full((4,), float(dist.process_index()), device="cuda")
    n = dist.process_count()
    ops = {
        "all_gather": lambda: tdist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "reduce_scatter": lambda: tdist.reduce_scatter(
            torch.empty_like(x), [x.clone() for _ in range(n)]),
        "all_to_all": lambda: tdist.all_to_all(
            [torch.empty_like(x) for _ in range(n)],
            [x.clone() for _ in range(n)]),
    }
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            probe[name] = "takes CUDA tensors"
        except Exception as e:
            probe[name] = f"refuses them ({type(e).__name__})"
for k in kernels:
    k.launches = 0
cli.main(argv)
torch.cuda.synchronize()
spans = {}
if "seconds" in span:
    from torch.autograd import DeviceType
    for e in prof.events():  # the host side of each span
        if (e.name.startswith(("comm.", "train."))
                and e.device_type == DeviceType.CPU):
            spans[e.name] = spans.get(e.name, 0.0) + e.cpu_time_total / 1e3
if dist.is_primary() and totals:
    np.save(prefix + "-totals.npy", np.concatenate(totals, axis=-1))
halo = {}
encoder = getattr(jobs[0].model, "encoder", None) if jobs else None
if encoder is not None:
    layout = encoder.halo_layout or {}
    halo = dict(
        blocks=layout.get("P"), rows=layout.get("S"),
        rmax={k[:-5]: v.shape[2] for k, v in layout.items()
              if k.endswith("_send")},
        layers=[dict(name=l.name, halo="halo" in encoder.graph(),
                     attention=bool(getattr(l, "attention", False)),
                     heads=getattr(l, "num_heads", 1),
                     keys=[k for k in map(l.rb_key, l.modes) if k]
                     if hasattr(l, "rb_key") else [],
                     in_dim=l.in_dim, out_dim=l.out_dim)
                for l in encoder.layers])
print("MESH_RANK " + json.dumps(dict(
    halo_exchanges=halo_exchange.calls, halo=halo,
    rank=dist.process_index(), backend=dist.backend(),
    backend_reason=dist.backend_reason(),
    counts={k.__name__: k.launches for k in kernels},
    window_seconds=span.get("seconds"),
    window_steps=window[1] - window[0] if window else 0,
    span_ms=spans, cuda_collectives=probe)), flush=True)
"""
MESH_WINDOW = (10, 60)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(label: str, n: int, argv: list, scratch: str,
              timeout: float = 400.0, **options) -> list:
    """``n`` ranks of ``MESH_RANK_SCRIPT`` on this machine's cards (rank
    i on card i modulo their number), a rendezvous on a free local port,
    ``options`` those of
    ``MESH_RANK_SCRIPT``; each rank's report. A rank that fails or a run
    past ``timeout`` kills every rank and fails the phase."""
    procs, logs = [], []
    port = free_port()
    for rank in range(n):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "WORLD_SIZE": str(n),
               "RANK": str(rank), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": str(n)}
        log = open(os.path.join(scratch, f"{label}-rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MESH_RANK_SCRIPT,
             os.path.join(scratch, label), json.dumps(options), *argv],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    reports = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            fail(f"{label}: rank {rank} exited {p.returncode}:\n"
                 f"{text[-4000:]}")
        lines = [line for line in text.splitlines()
                 if line.startswith("MESH_RANK ")]
        if not lines:
            fail(f"{label}: rank {rank} printed no report:\n{text[-4000:]}")
        reports.append(json.loads(lines[-1][len("MESH_RANK "):]))
    return reports


def backend_probe(device) -> dict:
    """Which of gloo's collectives take CUDA tensors (a 1-rank group on
    this card), and a 1-rank NCCL group's all_reduce on it: the backend a
    node with a card a rank would use, at least initialised on this
    card. Both groups are torn down again."""
    import torch.distributed as tdist

    out = {}
    tdist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
        world_size=1, rank=0)
    try:
        x = torch.ones(4, device=device)
        ops = {
            "all_reduce": lambda: tdist.all_reduce(x),
            "broadcast": lambda: tdist.broadcast(x, 0),
            "all_gather": lambda: tdist.all_gather([torch.empty_like(x)], x),
            "reduce_scatter": lambda: tdist.reduce_scatter(
                torch.empty_like(x), [x.clone()]),
            "all_to_all": lambda: tdist.all_to_all(
                [torch.empty_like(x)], [x.clone()]),
        }
        for name, op in ops.items():
            try:
                op()
                torch.cuda.synchronize()
                out[name] = "takes CUDA tensors"
            except Exception as e:  # the probe's answer, reported
                out[name] = f"refuses them ({type(e).__name__})"
    finally:
        tdist.destroy_process_group()
    tdist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
        world_size=1, rank=0)
    try:
        y = torch.arange(4, dtype=torch.float32, device=device)
        tdist.all_reduce(y)
        torch.cuda.synchronize()
        if not torch.equal(y.cpu(), torch.arange(4, dtype=torch.float32)):
            fail(f"a 1-rank NCCL all_reduce changed its input: {y}")
        out["nccl_all_reduce"] = "ok"
    finally:
        tdist.destroy_process_group()
    print("mesh backend probe (1-rank groups on the card): "
          + json.dumps(out), flush=True)
    return out


def mesh_phase(kernels, seed, scratch, dataset_folder) -> dict:
    """The main path of this slice: the train phase's job (fused loss
    forced, negatives drawn on the host) for 1 epoch with a validation,
    on 4 ranks of ``python -m kge_tpu_torch start`` as a 2x2 mesh (K1 on
    each rank's rows, K2 on each model rank's block of the padded table):
    on one card the ranks share it over gloo; on a machine with a card a
    rank (4 or more) each takes its own, over NCCL. Against the same job
    in one process on the card: epoch loss within rtol 1e-5; and the mesh's
    validation against one process's ``valid`` of the mesh run's
    checkpoint (the same weights: two trainings differ in the last bits
    of the embedding gradients, the atomics' order, which Adagrad's first
    step turns into 2 lr): MRR within 1e-6, rank and tie counts equal.
    Then a row-sparse epoch (the triple phase's job) on a 1x2 mesh, K3 on
    each shard, its checkpoint's tables and Adagrad state within 1e-6 of
    one process's. Then a 1-rank NCCL group initialised on the card."""
    from kge_tpu_torch import cli

    n_train = FB15K237["splits"]["train"]
    cards = torch.cuda.device_count()

    def backend(ranks):
        """The backend the port chooses for ``ranks`` ranks here."""
        return "gloo" if ranks > cards else "cpu:gloo,cuda:nccl"

    config_file = os.path.join(scratch, "complex-mesh.yaml")
    write_train_config(config_file, dataset_folder, seed)
    flags = ["--train.max_epochs", "1", "--tpu.fused_negsamp_loss", "always"]
    mesh_flags = ["--tpu.mesh.data", "2", "--tpu.mesh.model", "2"]

    single = os.path.join(scratch, "mesh-single")
    reset_counts(kernels)
    cli.main(["start", config_file, "--folder", single, *flags])
    torch.cuda.synchronize()
    single_counts = counts(kernels)

    run = os.path.join(scratch, "mesh-run")
    t0 = time.perf_counter()
    reports = run_ranks("mesh", 4, ["start", config_file, "--folder", run,
                                    *flags, *mesh_flags], scratch,
                        window=MESH_WINDOW, probe=True)
    seconds = time.perf_counter() - t0
    mesh_totals = np.load(os.path.join(scratch, "mesh-totals.npy"))
    # the mesh's weights validated in one process on the card
    valid = os.path.join(scratch, "mesh-valid")
    copy_run(run, valid, "checkpoint_00001.pt")
    record = []
    reset_counts(kernels)
    with recorded_counts(record):
        s_mrr = cli.main(["valid", valid, "--checkpoint", "1"])[
            "mean_reciprocal_rank_filtered"]
    torch.cuda.synchronize()
    valid_counts = counts(kernels)
    single_totals = np.concatenate([t[:2] for _, t in record], axis=-1)

    want = dict(shared_ce_loss=2 * TRAIN_STEPS, rank_counts=VALID_LAUNCHES,
                adagrad_row_update=0, sgd_row_update=0)
    expect_counts("the single-process run", single_counts, want)
    expect_counts("the single-process validation", valid_counts,
                  dict(want, shared_ce_loss=0))
    for report in reports:
        expect_counts(f"mesh rank {report['rank']}", report["counts"], want)
        if report["backend"] != backend(4):
            fail(f"mesh rank {report['rank']} ran on {report['backend']}, "
                 f"expected {backend(4)} ({cards} card(s))")
    s_epoch = read_trace(single, event="epoch_completed", job="train")[0]
    m_epoch = read_trace(run, event="epoch_completed", job="train")[0]
    m_valid = read_trace(run, event="eval_completed", job="eval")[0]
    m_mrr = m_valid["mean_reciprocal_rank_filtered"]
    s_valid_seconds = read_trace(single, event="eval_completed",
                                 job="eval")[0]["epoch_time"]
    rank_logs = [read_trace(os.path.join(run, f"proc{r}"),
                            event="epoch_completed", job="train")[0]
                 for r in (1, 2, 3)]
    loss_rel = relative(s_epoch["avg_loss"], m_epoch["avg_loss"])
    counts_equal = (single_totals.shape == mesh_totals.shape
                    and bool(np.array_equal(single_totals, mesh_totals)))
    differing = (int(np.sum(single_totals != mesh_totals))
                 if single_totals.shape == mesh_totals.shape else None)
    per_rank = []
    for report in reports:
        comm = sum(ms for name, ms in report["span_ms"].items()
                   if name.startswith("comm."))
        window_ms = 1e3 * report["window_seconds"]
        per_rank.append(dict(
            rank=report["rank"], backend=report["backend"],
            backend_reason=report["backend_reason"],
            counts=report["counts"],
            window_ms_per_step=window_ms / report["window_steps"],
            collective_ms_per_step=comm / report["window_steps"],
            collective_share_of_step=comm / window_ms,
            span_ms_per_step={k: v / report["window_steps"]
                              for k, v in sorted(report["span_ms"].items())}))
    out = dict(
        single=dict(avg_loss=s_epoch["avg_loss"], mrr_of_mesh_weights=s_mrr,
                    ms_per_step=1e3 * s_epoch["epoch_time"]
                    / s_epoch["batches"],
                    triples_per_s=n_train / s_epoch["epoch_time"],
                    epoch_seconds=s_epoch["epoch_time"],
                    valid_seconds=s_valid_seconds),
        mesh=dict(avg_loss=m_epoch["avg_loss"], mrr=m_mrr,
                  ms_per_step=1e3 * m_epoch["epoch_time"]
                  / m_epoch["batches"],
                  triples_per_s=n_train / m_epoch["epoch_time"],
                  triples_per_s_per_rank=n_train / m_epoch["epoch_time"] / 4,
                  epoch_seconds=m_epoch["epoch_time"],
                  valid_seconds=m_valid["epoch_time"],
                  seconds_all_ranks=seconds,
                  note=("4 ranks sharing one card (not a multi-GPU number)"
                        if cards < 4 else "4 ranks, a card each")),
        epoch_loss_relative_difference=loss_rel,
        mrr_difference=abs(s_mrr - m_mrr),
        cuda_collectives_in_the_4_rank_group=reports[0]["cuda_collectives"],
        rank_tie_counts_equal=counts_equal,
        rank_tie_counts_differing=differing, ranks=per_rank)
    print(f"mesh 2x2 ({cards} card(s)) vs one process on the card: "
          + json.dumps(out),
          flush=True)
    if any(e["avg_loss"] != m_epoch["avg_loss"] for e in rank_logs):
        fail(f"the mesh ranks report different losses: {rank_logs}")
    if loss_rel > 1e-5:
        fail(f"mesh epoch loss {m_epoch['avg_loss']} vs one process "
             f"{s_epoch['avg_loss']}: relative {loss_rel}")
    if abs(s_mrr - m_mrr) > 1e-6:
        fail(f"mesh MRR {m_mrr} vs one process {s_mrr}")
    if not counts_equal:
        fail(f"mesh rank and tie counts differ from one process's "
             f"({differing} entries)")
    if any(os.path.exists(os.path.join(run, f"proc{r}", "checkpoint_00001.pt"))
           for r in (1, 2, 3)) or not os.path.exists(
               os.path.join(run, "checkpoint_00001.pt")):
        fail("the mesh run's checkpoints are not rank 0's alone")

    # row-sparse on a 1x2 mesh: K3 on each rank's block
    sparse_file = os.path.join(scratch, "complex-mesh-sparse.yaml")
    write_strategy_config(
        sparse_file, dataset_folder, seed,
        dict(type="negative_sampling", loss="bce", batch_size=TRAIN_BATCH,
             optimizer={"default": {"type": "Adagrad", "args": {"lr": 0.2}}}),
        negative_sampling={"filtering": {"o": True}},
        lookup_embedder={"regularize_weight": 1e-5,
                         "regularize_args": {"weighted": True}},
        valid={"every": 0}, tpu={"sparse_updates": "always"})
    # deterministic algorithms on both sides: the embedding gradients'
    # index_add_ otherwise sums in the atomics' order, and Adagrad's first
    # step (about lr * sign(g)) turns a last-bit difference into 2 * lr
    sparse_single = os.path.join(scratch, "mesh-sparse-single")
    reset_counts(kernels)
    torch.use_deterministic_algorithms(True)
    try:
        cli.main(["start", sparse_file, "--folder", sparse_single])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    sparse_single_counts = counts(kernels)
    sparse_run = os.path.join(scratch, "mesh-sparse-run")
    sparse_reports = run_ranks(
        "mesh-sparse", 2, ["start", sparse_file, "--folder", sparse_run,
                           "--tpu.mesh.model", "2"], scratch,
        deterministic=True)
    want_sparse = dict(adagrad_row_update=TRAIN_STEPS, sgd_row_update=0,
                       shared_ce_loss=0, rank_counts=0)
    expect_counts("the row-sparse single-process run", sparse_single_counts,
                  want_sparse)
    for report in sparse_reports:
        expect_counts(f"row-sparse mesh rank {report['rank']}",
                      report["counts"], want_sparse)
        if report["backend"] != backend(2):
            fail(f"row-sparse mesh rank {report['rank']} ran on "
                 f"{report['backend']}, expected {backend(2)}")
    table_diff = max_table_difference(
        table_arrays(os.path.join(sparse_single, "checkpoint_00001.pt")),
        table_arrays(os.path.join(sparse_run, "checkpoint_00001.pt")))
    sparse_epoch = read_trace(sparse_run, event="epoch_completed",
                              job="train")[0]
    print("mesh 1x2 row-sparse vs one process on the card: " + json.dumps(
        dict(max_table_difference=table_diff,
             ms_per_step=1e3 * sparse_epoch["epoch_time"]
             / sparse_epoch["batches"],
             backends=[r["backend"] for r in sparse_reports],
             counts=[r["counts"] for r in sparse_reports])), flush=True)
    if table_diff > 1e-6:
        fail(f"row-sparse 1x2 mesh tables differ from one process's by "
             f"{table_diff}")
    probe = backend_probe(torch.device("cuda:0"))
    return dict(counts=single_counts,
                ranks={r["rank"]: r["counts"] for r in reports},
                sparse_ranks={r["rank"]: r["counts"] for r in sparse_reports},
                summary=out, probe=probe)


RAGAT_RECIPE = os.path.join(_RECIPES, "fb15k237-ragat.yaml")
RGNN_MESH_STEPS = 20
RGNN_MESH_WINDOW = (6, 16)
#: the jobs of the rgnn_mesh phase: recipe, options, the route they take
RGNN_MESH_RUNS = {
    "compgcn_ccorr": (COMPGCN_RECIPE, {}, "gathered"),
    "compgcn_sub": (COMPGCN_RECIPE, {
        "compgcn.encoder.message_passing_args.composition": "sub"}, "halo"),
    "ragat": (RAGAT_RECIPE, {}, "halo"),
}


@contextlib.contextmanager
def step_window(record: list, first: int, last: int):
    """Seconds from the start of step ``first`` to the end of step
    ``last`` (card synchronized) of every training job created inside,
    appended to ``record``."""
    from kge_tpu_torch.train.job import Job
    from kge_tpu_torch.train.train import TrainingJob

    def hooks(job):
        if not isinstance(job, TrainingJob) or job.is_forward_only:
            return
        step = {"n": 0}

        def pre(j):
            if step["n"] == first:
                torch.cuda.synchronize()
                step["t0"] = time.perf_counter()

        def post(j):
            step["n"] += 1
            if step["n"] == last:
                torch.cuda.synchronize()
                record.append(time.perf_counter() - step["t0"])

        job.pre_batch_hooks.append(pre)
        job.post_batch_hooks.append(post)

    Job.job_created_hooks.append(hooks)
    try:
        yield
    finally:
        Job.job_created_hooks.remove(hooks)


def halo_volume(halo: dict, P: int, S: int) -> list:
    """Per layer of a rank's report: the bytes one forward sends a rank
    on the halo route (each exchange (P-1) * rmax rows: of x @ W a mode
    and head, of the raw x once an edge set under attention) against the
    whole-table gather's ((P-1) * S rows of the layer's input; P blocks
    of S rows)."""
    out = []
    for layer in halo.get("layers", []):
        gather = (P - 1) * S * layer["in_dim"] * 4
        if not layer["halo"]:
            out.append(dict(name=layer["name"], route="gathered",
                            gather_bytes=gather))
            continue
        keys = layer["keys"]
        if layer["attention"]:
            sent = sum((P - 1) * halo["rmax"][k] * layer["in_dim"] * 4
                       for k in set(keys))
        else:
            sent = layer["heads"] * sum(
                (P - 1) * halo["rmax"][k] * layer["out_dim"] * 4
                for k in keys)
        out.append(dict(name=layer["name"], route="halo", halo_bytes=sent,
                        gather_bytes=gather, halo_over_gather=sent / gather))
    return out


def rgnn_mesh_phase(kernels, seed, scratch, dataset_folder) -> dict:
    """The main path of this slice: each of RGNN_MESH_RUNS on a 2x2 mesh
    of 4 ranks sharing the card against one process on the card, then
    the dense adjacency against the edge list (module docstring, phase
    25)."""
    from kge_tpu_torch import cli

    out = {}
    n = RGNN_MESH_STEPS
    for name, (recipe, options, route) in RGNN_MESH_RUNS.items():
        config_file = os.path.join(scratch, f"rgnn-mesh-{name}.yaml")
        write_recipe_config(config_file, recipe, dataset_folder, seed, {
            "train.max_epochs": 1, "train.trace_level": "batch",
            "valid.every": 0, "tpu.gnn_dense_adjacency": "never",
            **options})
        single = os.path.join(scratch, f"rgnn-mesh-{name}-single")
        windows = []
        reset_counts(kernels)
        with first_batches(n), step_window(windows, *RGNN_MESH_WINDOW):
            cli.main(["start", config_file, "--folder", single])
        torch.cuda.synchronize()
        single_counts = counts(kernels)
        expect_counts(f"rgnn_mesh {name}, one process", single_counts,
                      NO_KERNELS)
        run = os.path.join(scratch, f"rgnn-mesh-{name}")
        t0 = time.perf_counter()
        reports = run_ranks(
            f"rgnn-mesh-{name}", 4,
            ["start", config_file, "--folder", run, "--tpu.mesh.data", "2",
             "--tpu.mesh.model", "2"], scratch, window=RGNN_MESH_WINDOW,
            steps=n)
        seconds = time.perf_counter() - t0
        want_losses = batch_losses(single)
        losses = batch_losses(run)
        rank_losses = [batch_losses(os.path.join(run, f"proc{r}"))
                       for r in (1, 2, 3)]
        exchanges = [r["halo_exchanges"] for r in reports]
        engaged = all(e > 0 for e in exchanges) if route == "halo" else \
            not any(exchanges)
        with open(os.path.join(run, "kge.log")) as f:
            logged = [line.split(" ", 2)[-1].strip() for line in f
                      if "R-GNN encoder under a model axis" in line]
        # each model rank computes the loss of its data rows whole: equal
        # up to the order of the card's atomic sums (index_add_)
        rank_spread = max((relative(a, b) for l in rank_losses
                           for a, b in zip(losses, l)), default=0.0)
        first = relative(want_losses[0], losses[0]) if losses else None
        worst = max((relative(a, b) for a, b in zip(want_losses, losses)),
                    default=None)
        window_ms = [1e3 * r["window_seconds"] / r["window_steps"]
                     for r in reports]
        comm_share = [sum(ms for k, ms in r["span_ms"].items()
                          if k.startswith("comm.")) / (1e3 *
                                                       r["window_seconds"])
                      for r in reports]
        entry = dict(
            route=route, route_engaged=engaged, exchanges=exchanges,
            routes_logged=logged, halo=halo_volume(
                reports[0]["halo"], 2, FB_ENTITY_ROWS // 2),
            rmax=reports[0]["halo"].get("rmax"),
            losses=losses, single_losses=want_losses,
            first_step_relative_difference=first,
            largest_step_relative_difference=worst,
            rank_loss_spread=rank_spread, ms_per_step=window_ms, comm_share_of_step=comm_share,
            span_ms_per_step={k: v / reports[0]["window_steps"] for k, v in
                              sorted(reports[0]["span_ms"].items())},
            single_ms_per_step=1e3 * windows[0] / (
                RGNN_MESH_WINDOW[1] - RGNN_MESH_WINDOW[0]),
            seconds_all_ranks=seconds,
            counts={r["rank"]: r["counts"] for r in reports},
            single_counts=single_counts, backend=reports[0]["backend"])
        print(f"rgnn_mesh {name} 2x2 vs one process on the card: "
              + json.dumps(entry), flush=True)
        if not engaged:
            fail(f"rgnn_mesh {name}: the {route} route did not engage "
                 f"(exchanges {exchanges})")
        if len(losses) != n or len(want_losses) != n or not all(
                map(math.isfinite, losses)):
            fail(f"rgnn_mesh {name}: losses {losses} vs {want_losses}")
        if any(len(l) != n for l in rank_losses) or rank_spread > 1e-6:
            fail(f"rgnn_mesh {name}: the ranks' losses differ by "
                 f"{rank_spread}")
        if first > 1e-5 or worst > 1e-2:
            fail(f"rgnn_mesh {name}: first step {first}, largest {worst}")
        for report in reports:
            expect_counts(f"rgnn_mesh {name} rank {report['rank']}",
                          report["counts"], NO_KERNELS)
        shutil.rmtree(run)
        shutil.rmtree(single)
        out[name] = entry

    # the dense adjacency against the edge list, one process
    config_file = os.path.join(scratch, "rgnn-dense.yaml")
    write_recipe_config(config_file, COMPGCN_RECIPE, dataset_folder, seed, {
        "train.max_epochs": 1, "train.trace_level": "batch",
        "valid.every": 0, **RGNN_MESH_RUNS["compgcn_sub"][1]})
    dense = {}
    for label, flags in (
            ("edge_list", ["--tpu.gnn_dense_adjacency", "never"]),
            ("dense_float32", ["--tpu.gnn_dense_adjacency", "always"]),
            ("dense_bfloat16", ["--tpu.gnn_dense_adjacency", "always",
                                "--tpu.gnn_dense_adjacency_dtype",
                                "bfloat16"])):
        folder = os.path.join(scratch, f"rgnn-{label}")
        windows = []
        reset_counts(kernels)
        with first_batches(n), step_window(windows, *RGNN_MESH_WINDOW):
            cli.main(["start", config_file, "--folder", folder, *flags])
        torch.cuda.synchronize()
        launched = counts(kernels)
        expect_counts(f"rgnn_mesh {label}", launched, NO_KERNELS)
        with open(os.path.join(folder, "kge.log")) as f:
            used = "Using the dense" in f.read()
        if used != label.startswith("dense"):
            fail(f"rgnn_mesh {label}: the dense adjacency used: {used}")
        dense[label] = dict(
            losses=batch_losses(folder), counts=launched,
            ms_per_step=1e3 * windows[0] / (RGNN_MESH_WINDOW[1]
                                            - RGNN_MESH_WINDOW[0]))
        shutil.rmtree(folder)
    base = dense["edge_list"]["losses"]
    for label, bound in (("dense_float32", 1e-5), ("dense_bfloat16", 1e-2)):
        got = dense[label]["losses"]
        dense[label]["first_step_relative_difference"] = relative(
            base[0], got[0])
        dense[label]["largest_step_relative_difference"] = max(
            relative(a, b) for a, b in zip(base, got))
        if (len(got) != n or not all(map(math.isfinite, got))
                or dense[label]["first_step_relative_difference"] > bound):
            fail(f"rgnn_mesh {label} vs the edge list: {dense[label]}, "
                 f"edge list {base}")
    print("rgnn_mesh dense adjacency vs edge list (CompGCN sub, one "
          "process): " + json.dumps(dense), flush=True)
    out["dense"] = dense
    return out


def device_epoch_phase(kernels, seed, scratch, dataset_folder) -> dict:
    """The main path of this slice: ``start`` of the train phase's config
    at kge_tpu's defaults (on-device sampling, 4 steps a dispatch): the
    negatives drawn on the card, the epoch's positives uploaded once, each
    group of 4 steps one CUDA graph replay (the job's first group its
    warm-up, eagerly), a 2-step eager tail; 2 epochs with a validation
    after each, then ``resume`` to epoch 3. Beside it in this call: the
    eager host-sampled path (``on_device_sampling never``,
    ``steps_per_dispatch 1``), a 200-step window of the captured path
    profiled, the host time of a dispatch and of a replay, peak memory.
    Under ``torch.use_deterministic_algorithms`` (the embedding
    gradients' ``index_add_`` otherwise sums in the atomics' order): the
    captured run against the same run at ``steps_per_dispatch 1`` (epoch
    losses and tables within 1e-6), and epoch 3 after ``resume`` bit for
    bit a fresh 3-epoch run's. Then the draws' statistics."""
    from kge_tpu_torch import cli

    n_train = FB15K237["splits"]["train"]
    config_file = os.path.join(scratch, "complex-device-epoch.yaml")
    write_train_config(config_file, dataset_folder, seed,
                       host_sampling=False)
    run = os.path.join(scratch, "device-epoch-run")

    jobs, dispatch_seconds = [], []
    fresh_device_memory()
    reset_counts(kernels)
    t0 = time.perf_counter()
    with created_jobs(jobs):
        cli.main(["start", config_file, "--folder", run])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    launched = counts(kernels)
    job = jobs[0]
    with open(os.path.join(run, "kge.log")) as f:
        log = f.read()
    for line in ("Sampling negatives on device",
                 f"Capturing groups of {GROUP} steps as CUDA graphs."):
        if line not in log:
            fail(f"device_epoch: the log does not say {line!r}")
    epochs = check_start("device_epoch", run, launched, dict(
        shared_ce_loss=2 * 2 * TRAIN_STEPS, rank_counts=2 * VALID_LAUNCHES,
        adagrad_row_update=0, sgd_row_update=0), 2)
    # the job's first group is the capture's warm-up: every other group
    # of both epochs is a replay
    want_replays = 2 * GROUPS_PER_EPOCH - 1
    graphs = list(job._graphs)
    if job.graph_replays != want_replays or graphs != [("epoch", GROUP)]:
        fail(f"device_epoch: {job.graph_replays} replays of graphs {graphs}, "
             f"expected {want_replays} of [('epoch', {GROUP})]")
    if any(e["batches"] != TRAIN_STEPS for e in epochs):
        fail("device_epoch: an epoch did not take every batch")

    # host time of one replay's enqueue and device time of a replay, on
    # the finished job (more steps of its model, no checkpoint)
    entry = job._graphs[("epoch", GROUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        entry.graph.replay()
    replay_host_us = (time.perf_counter() - t0) / 50 * 1e6
    replay_ms = cuda_ms(entry.graph.replay, 50)
    del job, jobs[:], entry

    # resume to epoch 3
    reset_counts(kernels)
    with created_jobs(jobs):
        resumed = cli.main(["resume", run, "--train.max_epochs", "3"])
    torch.cuda.synchronize()
    resume_counts = counts(kernels)
    expect_counts("the resumed device epoch", resume_counts, dict(
        shared_ce_loss=2 * TRAIN_STEPS, rank_counts=VALID_LAUNCHES))
    if resumed["epoch"] != 3 or jobs[0].graph_replays != GROUPS_PER_EPOCH - 1:
        fail(f"device_epoch resume: epoch {resumed['epoch']}, "
             f"{jobs[0].graph_replays} replays")
    del jobs[:]

    # a training_loss validation resolves on-device sampling as training
    # does: a forward-only epoch of the valid split, drawn on the card, in
    # captured groups (K1 forward only)
    reset_counts(kernels)
    with created_jobs(jobs, forward_only=True):
        loss_entry = cli.main(["valid", run, "--eval.type", "training_loss"])
    torch.cuda.synchronize()
    loss_counts = counts(kernels)
    valid_groups = math.ceil(FB15K237["splits"]["valid"] / TRAIN_BATCH) // GROUP
    loss_out = dict(avg_loss=loss_entry["avg_loss"], launches=loss_counts,
                    on_device=jobs[0]._on_device_sampling,
                    graph_replays=jobs[0].graph_replays)
    print("device_epoch training_loss valid: " + json.dumps(loss_out),
          flush=True)
    expect_counts("the on-device training_loss validation", loss_counts,
                  dict(shared_ce_loss=TRAINING_LOSS_LAUNCHES, rank_counts=0))
    if (not loss_out["on_device"] or loss_out["graph_replays"]
            != valid_groups - 1 or not math.isfinite(loss_out["avg_loss"])):
        fail(f"device_epoch training_loss validation: {loss_out}")
    del jobs[:]

    # the same epoch from checkpoint_00000.pt: captured (with the host
    # time of each dispatch) and eager with the host's draws
    paths = {}
    for name, flags in (
            ("captured", []),
            ("eager_host_sampled", ["--tpu.on_device_sampling", "never",
                                    "--tpu.steps_per_dispatch", "1"])):
        folder = os.path.join(scratch, f"device-epoch-{name}")
        copy_run(run, folder, "checkpoint_00000.pt")
        record = []
        from kge_tpu_torch.train.job import Job
        hook = (lambda j: timed_dispatches(j, record)
                if hasattr(j, "_dispatch_group") and not j.is_forward_only
                else None)
        Job.job_created_hooks.append(hook)
        try:
            entry = cli.main(["resume", folder, "--train.max_epochs", "1",
                              "--valid.every", "0", *flags])
        finally:
            Job.job_created_hooks.remove(hook)
        paths[name] = dict(
            epoch_seconds=entry["epoch_time"],
            ms_per_step=1e3 * entry["epoch_time"] / entry["batches"],
            triples_per_s=n_train / entry["epoch_time"],
            avg_loss=entry["avg_loss"],
            dispatch_host_us=(1e6 * statistics.median(record[1:])
                              if len(record) > 1 else None))
        shutil.rmtree(folder)
    print("device_epoch paths in this call: " + json.dumps(paths), flush=True)

    # a 200-step window of the captured path, its epoch 2 (epoch 1 holds
    # the warm-up and the capture), under torch.profiler
    folder = os.path.join(scratch, "device-epoch-profiled")
    copy_run(run, folder, "checkpoint_00000.pt")
    from kge_tpu_torch.train.job import Job

    def window(job):
        payload = getattr(job, "_epoch_device_payload", None)
        if payload is not None:
            job._epoch_device_payload = lambda epoch: {
                k: v[:PROFILE_STEPS] for k, v in payload(epoch).items()}

    Job.job_created_hooks.append(window)
    try:
        base = fresh_device_memory()
        profiled, device = profile_run(
            "train device_epoch", "train.", lambda: cli.main([
                "resume", folder, "--train.max_epochs", "2",
                "--valid.every", "0"]), epoch_only=True, epoch=2)
    finally:
        Job.job_created_hooks.remove(window)
    device_ms = sum(ms for ms, _ in device.values())
    window_out = {
        "batches": profiled["batches"],
        "ms_per_step": 1e3 * profiled["epoch_time"] / profiled["batches"],
        "triples_per_s": profiled["batches"] * TRAIN_BATCH
        / profiled["epoch_time"],
        "device_busy_share": device_ms / (1e3 * profiled["epoch_time"]),
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
        "peak_device_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
        "device_memory_before_bytes": base}
    print("train device_epoch profiled window: " + json.dumps(window_out),
          flush=True)
    shutil.rmtree(folder)

    # captured vs per-batch steps and resume vs uninterrupted, bit for bit
    # where the math is the same: deterministic kernels
    torch.use_deterministic_algorithms(True)
    try:
        det = {}
        for name, argv, epochs_run in (
                ("fresh3", ["--train.max_epochs", "3"], 3),
                ("start2", ["--train.max_epochs", "2"], 2),
                ("per_batch2", ["--train.max_epochs", "2",
                                "--tpu.steps_per_dispatch", "1"], 2)):
            folder = os.path.join(scratch, f"device-epoch-{name}")
            cli.main(["start", config_file, "--folder", folder,
                      "--valid.every", "0", *argv])
            det[name] = folder
        # before the resume, whose checkpoint rotation drops epoch 2's
        table_difference = max_table_difference(
            table_arrays(os.path.join(det["start2"], "checkpoint_00002.pt")),
            table_arrays(os.path.join(det["per_batch2"],
                                      "checkpoint_00002.pt")))
        cli.main(["resume", det["start2"], "--train.max_epochs", "3"])
    finally:
        torch.use_deterministic_algorithms(False)

    def epoch_losses(folder):
        return [e["avg_loss"] for e in read_trace(
            folder, event="epoch_completed", job="train")]

    captured, per_batch = epoch_losses(det["start2"]), epoch_losses(
        det["per_batch2"])
    loss_difference = max(relative(a, b) for a, b in zip(
        captured[:2], per_batch))
    fresh = epoch_losses(det["fresh3"])
    resume_difference = max_table_difference(
        table_arrays(os.path.join(det["start2"], "checkpoint_00003.pt")),
        table_arrays(os.path.join(det["fresh3"], "checkpoint_00003.pt")))
    checks = dict(
        captured_vs_per_batch_loss_relative=loss_difference,
        captured_vs_per_batch_table_max_abs=table_difference,
        resumed_epoch3_loss=captured[2], fresh_epoch3_loss=fresh[2],
        resumed_vs_fresh_table_max_abs=resume_difference)
    print("device_epoch deterministic checks: " + json.dumps(checks),
          flush=True)
    if loss_difference > 1e-6 or table_difference > 1e-6:
        fail(f"device_epoch: captured vs per-batch steps: {checks}")
    if captured[2] != fresh[2] or resume_difference != 0.0:
        fail(f"device_epoch: resumed epoch 3 is not the fresh run's: "
             f"{checks}")
    for folder in det.values():
        shutil.rmtree(folder)

    draws = draw_statistics(seed, torch.device("cuda"))
    print("train device_epoch start on the card: " + json.dumps(dict(
        seconds_cli=seconds, graph_replays=want_replays,
        peak_device_memory_bytes=peak,
        peak_device_memory_reserved_bytes=peak_reserved,
        replay_host_us=replay_host_us, replay_device_ms=replay_ms,
        k1_launches_per_step=launched["shared_ce_loss"]
        / sum(e["batches"] for e in epochs))), flush=True)
    return dict(counts=launched, resume_counts=resume_counts,
                training_loss_counts=loss_counts, paths=paths,
                window=window_out, checks=checks, draws=draws)


UTILS_SCRIPT = r"""
import contextlib, io, json, os, sys, time
import numpy as np
import yaml
sys.path.insert(0, sys.argv[1])
from kge_tpu_torch import cli
from kge_tpu_torch.ops import negsamp_loss, rank_count, row_update
from kge_tpu_torch.utils.io import load_checkpoint

best, config_file, out = sys.argv[2:5]
kernels = (rank_count.rank_counts, negsamp_loss.shared_ce_loss,
           row_update.adagrad_row_update, row_update.sgd_row_update)
seconds = {}
package = os.path.join(out, "model.pt")
t0 = time.perf_counter()
cli.main(["package", best, "--file", package])
seconds["package"] = time.perf_counter() - t0
run = os.path.join(out, "pretrained")
for k in kernels:
    k.launches = 0
t0 = time.perf_counter()
entry = cli.main(["start", config_file, "--folder", run,
                  "--train.max_epochs", "1",
                  "--lookup_embedder.pretrain.model_filename", package,
                  "--lookup_embedder.pretrain.ensure_all", "true"])
seconds["start_pretrained"] = time.perf_counter() - t0
launches = {k.__name__: k.launches for k in kernels}
packaged = load_checkpoint(package)
initial = load_checkpoint(os.path.join(run, "checkpoint_00000.pt"))
equal = {key: bool(np.array_equal(
             initial["model"]["params"][key]["weights"],
             packaged["model"]["params"][key]["weights"]))
         for key in ("entity_embedder", "relation_embedder")}
dumps = {}
for name, argv in (
        ("checkpoint_package", ["checkpoint", package]),
        ("checkpoint_bf16", ["checkpoint", best]),
        ("checkpoint_pretrained", ["checkpoint",
                                   os.path.join(run, "checkpoint_00001.pt")]),
        ("trace_bf16", ["trace", os.path.dirname(best)]),
        ("trace_pretrained", ["trace", run])):
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        cli.main(["dump", *argv])
    seconds["dump_" + name] = time.perf_counter() - t0
    dumps[name] = text.getvalue()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "kge_tpu"))
print(json.dumps(dict(
    loaded=loaded, launches=launches, rows_equal=equal, seconds=seconds,
    package_type=packaged["type"],
    package_ids=len(packaged["dataset"]["meta"]),
    epoch=entry["epoch"], avg_loss=entry["avg_loss"],
    parameter_names=yaml.safe_load(
        dumps["checkpoint_package"])["parameter_names"],
    trace_rows={k: v.count("\n") for k, v in dumps.items()
                if k.startswith("trace")},
    checkpoint_keys={k: sorted(yaml.safe_load(v)) for k, v in dumps.items()
                     if k.startswith("checkpoint")},
    trace_header=dumps["trace_bf16"].splitlines()[0])))
"""


def utils_phase(kernels, scratch, config_file, best) -> dict:
    """``package`` of the bf16 run's best checkpoint, a 1-epoch float32
    ``start`` initialized from it by ``lookup_embedder.pretrain`` (its
    initial rows the package's, bit for bit), ``dump checkpoint`` and
    ``dump trace`` of both runs: in a subprocess that must load no module
    of JAX or of the JAX package."""
    out = os.path.join(scratch, "utils")
    os.makedirs(out)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", UTILS_SCRIPT, REPO, best, config_file, out],
        capture_output=True, text=True, timeout=900, cwd=REPO)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"the utils subprocess failed: {proc.stderr[-3000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    print("utils verbs: " + json.dumps(dict(seconds_subprocess=seconds,
                                            **result)), flush=True)
    if result["loaded"]:
        fail(f"the utils verbs loaded {result['loaded']}")
    if result["package_type"] != "package" or not result["package_ids"]:
        fail("the package is not a packaged model with its id maps")
    if not all(result["rows_equal"].values()):
        fail(f"pretrained rows differ from the package's: "
             f"{result['rows_equal']}")
    if result["parameter_names"] != ["entity_embedder.weights",
                                     "relation_embedder.weights"]:
        fail(f"dump checkpoint names {result['parameter_names']}")
    if any("parameter_names" not in keys
           for keys in result["checkpoint_keys"].values()):
        fail(f"dump checkpoint printed {result['checkpoint_keys']}")
    if min(result["trace_rows"].values()) < 2:
        fail(f"dump trace printed too little: {result['trace_rows']}")
    if result["epoch"] != 1 or not math.isfinite(result["avg_loss"]):
        fail(f"the pretrained run: epoch {result['epoch']} avg_loss "
             f"{result['avg_loss']}")
    expect_counts("the pretrained run", result["launches"], dict(
        shared_ce_loss=2 * TRAIN_STEPS, rank_counts=VALID_LAUNCHES,
        adagrad_row_update=0, sgd_row_update=0))
    return dict(counts=result["launches"])


@contextlib.contextmanager
def recorded_pair_counts(record: list):
    """Appends to ``record`` the (greater, ties) counts of every query the
    entity-pair ranking jobs created inside rank, raw then filtered."""
    from kge_tpu_torch.evaluation.entity_pair_ranking import (
        EntityPairRankingJob)
    from kge_tpu_torch.train.job import Job

    def hook(job):
        if isinstance(job, EntityPairRankingJob):
            final_rank = job._final_rank

            def recording(greater, ties):
                record.append((greater, ties))
                return final_rank(greater, ties)

            job._final_rank = recording

    Job.job_created_hooks.append(hook)
    try:
        yield
    finally:
        Job.job_created_hooks.remove(hook)


def pair_boundary_allowance(model64, s: int, p: int, o: int) -> int:
    """The (s', o') pairs under p whose float64 score lies at the tie
    boundary |x - t| = atol + rtol*|t| within the rounding of two float32
    computations of x and t (D * 2^-24 times |q| . |c| of each, ComplEx's
    dot form): the pairs that may rank on either side on the card and
    on the host."""
    from kge_tpu_torch.models import Ctx

    ctx = Ctx(state=model64.model_state)
    device = model64.device
    E = model64.dataset.num_entities()
    with torch.no_grad():
        cand, _ = model64.dot_candidates_all(ctx)
        one = lambda x: torch.tensor([x], device=device)
        q_true, _ = model64.dot_queries(one(s), one(p), one(o), ctx)
        true = float(q_true[0] @ cand[o])
        true_mag = float(q_true[0].abs() @ cand[o].abs())
        tol = ATOL + RTOL * abs(true)
        depth = cand.shape[1]
        near = 0
        for start in range(0, E, 1024):
            ids = torch.arange(start, min(start + 1024, E), device=device)
            q, _ = model64.dot_queries(ids, torch.full_like(ids, p), ids,
                                       ctx)
            scores = q @ cand.T
            rounding = depth * 2.0 ** -24 * (q.abs() @ cand.abs().T
                                             + true_mag)
            near += int(((((scores - true).abs() - tol).abs())
                         <= rounding).sum())
    return near


def pair_ranking_phase(kernels, seed, device, scratch, dataset_folder,
                       checkpoint=None) -> dict:
    """``test`` with ``--eval.type entity_pair_ranking`` of a float32
    ComplEx checkpoint (the train phase's best, else seeded random
    weights) on the first PAIR_QUERIES test triples, each ranked against
    all 14,541^2 entity pairs under its relation, on the card and on the
    host: every query's raw and filtered counts equal but for the pairs at
    the tie boundary (``pair_boundary_allowance``), the metrics within
    1e-4."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.models import KgeModel
    from kge_tpu_torch.utils.io import load_checkpoint

    subset = os.path.join(scratch, "pair-ranking-data")
    write_test_subset(dataset_folder, subset, PAIR_QUERIES)
    run = os.path.join(scratch, "pair-ranking-run")
    if checkpoint is None:
        write_checkpoint(run, dataset_folder, seed, device)
    else:
        copy_run(os.path.dirname(checkpoint), run, "checkpoint_best.pt")
    argv = ["test", run, "--eval.type", "entity_pair_ranking",
            "--dataset.name", subset, "--console.quiet", "true"]
    runs = {}
    for dev in ("cuda", "cpu"):
        record = []
        reset_counts(kernels)
        t0 = time.perf_counter()
        with recorded_pair_counts(record):
            entry = cli.main([*argv, "--job.device", dev])
        torch.cuda.synchronize()
        runs[dev] = dict(entry=entry, record=record,
                         seconds_cli=time.perf_counter() - t0,
                         launches=counts(kernels))
    card, host = runs["cuda"], runs["cpu"]
    expect_counts("the pair ranking", card["launches"], NO_KERNELS)
    if len(card["record"]) != 2 * PAIR_QUERIES or (
            len(host["record"]) != len(card["record"])):
        fail(f"pair ranking recorded {len(card['record'])} card and "
             f"{len(host['record'])} host rankings")
    triples = np.loadtxt(os.path.join(subset, "test.del"), dtype=np.int64,
                         ndmin=2)
    model64, differing, allowed = None, 0, 0
    for i, (a, b) in enumerate(zip(card["record"], host["record"])):
        worst = max(abs(x - y) for x, y in zip(a, b))
        if not worst:
            continue
        if model64 is None:
            model64 = KgeModel.create_from(
                load_checkpoint(os.path.join(run, "checkpoint_best.pt")),
                device=torch.device("cuda:0")).double()
        s, p, o = map(int, triples[i // 2])
        near = pair_boundary_allowance(model64, s, p, o)
        differing += 1
        allowed += near
        if worst > near:
            fail(f"pair ranking of {(s, p, o)}: card {a} vs host {b}, "
                 f"{near} pairs at the tie boundary")
    metrics = {k: v for k, v in card["entry"].items()
               if k.startswith(("mean_", "hits_"))}
    worst_metric = max(relative(v, host["entry"][k]) if host["entry"][k]
                       else abs(v) for k, v in metrics.items())
    epoch = card["entry"]["epoch_time"]
    print("pair ranking card vs host: " + json.dumps(dict(
        queries=PAIR_QUERIES, pairs_per_query=FB15K237["entities"] ** 2,
        card_seconds=epoch, host_seconds=host["entry"]["epoch_time"],
        queries_per_s=PAIR_QUERIES / epoch,
        host_queries_per_s=PAIR_QUERIES / host["entry"]["epoch_time"],
        differing_rankings=differing, boundary_pairs_in_them=allowed,
        largest_metric_difference=worst_metric, **metrics)), flush=True)
    if not 0.0 < metrics["mean_reciprocal_rank_filtered"] <= 1.0:
        fail(f"pair ranking MRR out of range: {metrics}")
    if worst_metric > 1e-4:
        fail(f"pair ranking metrics card vs host apart by {worst_metric}")
    return dict(counts=card["launches"])


def trial_seconds(folder: str) -> list:
    """Each trial's wall seconds, from its trace's first and last entry."""
    out = []
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name, "trace.yaml")
        if os.path.isfile(path):
            stamps = [e["timestamp"] for e in read_trace(
                os.path.join(folder, name))]
            out.append(stamps[-1] - stamps[0])
    return out


def search_phase(kernels, seed, scratch, dataset_folder) -> dict:
    """Hyperparameter search on the card (``search.device_pool``
    [cuda:0]), each trial 1 epoch of the training main path's config,
    validated through K2: a ``grid_search`` of 2 x 2 trials (Adagrad lr
    {0.1, 0.2} x negative_sampling.num_samples.o {64, 128}), an
    ``ax_search`` of 4 trials on the native backend (2 scrambled-Sobol,
    then the GP-EI phase), and ``resume`` of the finished ``ax_search``,
    which reruns no trial."""
    from kge_tpu_torch import cli

    config_file = os.path.join(scratch, "complex-negsamp-search.yaml")
    write_train_config(config_file, dataset_folder, seed)
    with open(config_file) as f:
        base = yaml.safe_load(f)
    base["job"]["type"] = "search"
    base["train"]["max_epochs"] = 1
    base["search"] = {"device_pool": ["cuda:0"], "num_workers": 1}
    searches = {
        "grid_search": {"grid_search": {"parameters": {
            "train.optimizer.default.args.lr": [0.1, 0.2],
            "negative_sampling.num_samples.o": [64, 128]}}},
        "ax_search": {"ax_search": {
            "num_trials": SEARCH_TRIALS, "num_sobol_trials": 2,
            "parameters": [
                {"name": "train.optimizer.default.args.lr", "type": "range",
                 "bounds": [0.05, 0.5], "log_scale": True},
                {"name": "negative_sampling.num_samples.o",
                 "type": "choice", "values": [64, 128]}]}},
    }
    # a trial's K1 launches: 2 a step; K2: one validation
    want = dict(shared_ce_loss=SEARCH_TRIALS * 2 * TRAIN_STEPS,
                rank_counts=SEARCH_TRIALS * VALID_LAUNCHES,
                adagrad_row_update=0, sgd_row_update=0)
    out = {}
    for search_type, section in searches.items():
        path = os.path.join(scratch, f"{search_type}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump({**base, "search": {**base["search"],
                                               "type": search_type},
                            **section}, f)
        folder = os.path.join(scratch, search_type)
        reset_counts(kernels)
        t0 = time.perf_counter()
        result = cli.main(["start", path, "--folder", folder])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counts(kernels)
        trials = trial_seconds(folder)
        valids = [e for e in read_trace(folder, scope="train")
                  if "mean_reciprocal_rank_filtered" in e]
        devices = {yaml.safe_load(open(os.path.join(
            folder, name, "config.yaml")))["job"]["device"]
            for name in os.listdir(folder)
            if os.path.isfile(os.path.join(folder, name, "config.yaml"))}
        from kge_tpu_torch.search.ax import HAVE_AX

        print(f"search {search_type} on the card: " + json.dumps(dict(
            backend="ax-platform" if HAVE_AX else "native",
            seconds_cli=seconds, trials=len(trials), trial_seconds=trials,
            seconds_per_trial=seconds / max(len(trials), 1),
            best_trial=result.get("best_trial"), devices=sorted(devices),
            launches=launched, valid_mrr_filtered=[
                v["mean_reciprocal_rank_filtered"] for v in valids])),
            flush=True)
        expect_counts(f"the {search_type}", launched, want)
        if len(trials) != SEARCH_TRIALS or result.get("best_trial") is None:
            fail(f"{search_type}: {len(trials)} trials, result {result}")
        if devices != {"cuda:0"}:
            fail(f"{search_type} trials ran on {devices}")
        if len(valids) != SEARCH_TRIALS or not all(
                0.0 < v["mean_reciprocal_rank_filtered"] <= 1.0
                for v in valids):
            fail(f"{search_type}: trial validations missing or out of range")
        out[search_type] = dict(counts=launched, result=result)

    # resume of the finished ax_search: no trial runs again
    reset_counts(kernels)
    folder = os.path.join(scratch, "ax_search")
    resumed = cli.main(["resume", folder])
    launched = counts(kernels)
    print("search ax_search resumed: " + json.dumps(dict(
        best_trial=resumed.get("best_trial"), launches=launched)),
        flush=True)
    expect_counts("the resumed ax_search", launched, NO_KERNELS)
    if resumed.get("best_trial") != out["ax_search"]["result"]["best_trial"]:
        fail(f"the resumed ax_search found another best trial: {resumed}")
    out["ax_resume"] = dict(counts=launched)
    return out


PHASES = ("k2", "k2_widths", "k1", "k3", "losses_optimizers", "eval",
          "compgcn", "rgnn_encoders", "conve", "scorers", "train", "mesh",
          "rgnn_mesh", "device_epoch", "sgd", "bf16", "utils", "pair_ranking", "search",
          "kvsall", "1vsall", "triple", "wikidata5m")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated subset of the phases to run (default: all; "
        "the kernels line is printed only when all ran)")
    args = parser.parse_args()
    selected = args.phases.split(",")
    unknown = set(selected) - set(PHASES)
    if unknown:
        fail(f"unknown phases {sorted(unknown)}; known: {PHASES}")

    if not torch.cuda.is_available():
        fail("no CUDA device available")
    if not os.path.isdir(os.path.join(REPO, "kge_tpu_torch")):
        fail(f"kge_tpu_torch not found next to {__file__}")
    sys.path.insert(0, REPO)
    from kge_tpu_torch.ops import ccorr_reduce as cr
    from kge_tpu_torch.ops import native
    from kge_tpu_torch.ops import negsamp_loss as nl
    from kge_tpu_torch.ops import rank_count as rc
    from kge_tpu_torch.ops import row_update as ru

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

    kernels = (rc.rank_counts, nl.shared_ce_loss, ru.adagrad_row_update,
               ru.sgd_row_update, cr.ccorr_reduce)
    seconds = {}
    results = {}

    def run(phase, fn, *fn_args):
        if phase not in selected:
            return None
        t0 = time.perf_counter()
        results[phase] = fn(*fn_args)
        seconds[phase] = time.perf_counter() - t0
        print(f"phase {phase}: {seconds[phase]} s", flush=True)
        return results[phase]

    run("k2", kernel_phase, rc, args.seed, device)
    run("k2_widths", rank_widths_phase, rc, args.seed, device)
    run("k1", k1_phase, nl, args.seed, device)
    run("k3", k3_phase, ru, args.seed, device)
    run("losses_optimizers", losses_optimizers_phase, args.seed, device)
    os.makedirs(os.path.join(REPO, "local"), exist_ok=True)
    scratch = tempfile.mkdtemp(prefix="chip_smoke-",
                               dir=os.path.join(REPO, "local"))
    try:
        ev = run("eval", eval_phase, rc, kernels, args.seed, device, scratch)
        if ev is None:
            graph = os.path.join(scratch, "fb15k237-synthetic")
            write_dataset(graph, args.seed)
        else:
            graph = ev["dataset_folder"]
        run("compgcn", compgcn_phase, kernels, args.seed, scratch, graph)
        run("rgnn_encoders", rgnn_encoders_phase, kernels, args.seed,
            scratch, graph)
        run("conve", conve_phase, kernels, args.seed, scratch, graph)
        run("scorers", scorers_phase, kernels, args.seed, scratch, graph)
        tr = run("train", train_phase, kernels, args.seed, scratch, graph)
        run("mesh", mesh_phase, kernels, args.seed, scratch, graph)
        run("rgnn_mesh", rgnn_mesh_phase, kernels, args.seed, scratch,
            graph)
        run("device_epoch", device_epoch_phase, kernels, args.seed, scratch,
            graph)
        if tr is not None:
            run("sgd", sgd_phase, kernels, scratch, tr["config_file"])
        bf = run("bf16", bf16_phase, kernels, args.seed, scratch, graph, tr)
        if bf is not None:
            run("utils", utils_phase, kernels, scratch, bf["config_file"],
                bf["best"])
        run("pair_ranking", pair_ranking_phase, kernels, args.seed, device,
            scratch, graph, tr and tr["best"])
        run("search", search_phase, kernels, args.seed, scratch, graph)
        run("kvsall", kvsall_phase, kernels, args.seed, scratch, graph)
        run("1vsall", onevsall_phase, kernels, args.seed, scratch, graph)
        run("triple", triple_phase, kernels, args.seed, scratch, graph)
        run("wikidata5m", w5m_phase, kernels, args.seed, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print("phase seconds: " + json.dumps(seconds), flush=True)

    # the port runs without JAX: neither it nor the JAX package was loaded
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                           "kge_tpu"))
    if loaded:
        fail(f"modules of JAX or the JAX package were loaded: {loaded}")
    if set(selected) != set(PHASES):
        print(json.dumps({"ok": True, "phases": selected}), flush=True)
        return
    k2, k1, k3 = results["k2"], results["k1"], results["k3"]
    ev, tr, sgd = results["eval"], results["train"], results["sgd"]
    kv, one, tri = results["kvsall"], results["1vsall"], results["triple"]
    w5m, conve = results["wikidata5m"], results["conve"]
    bf, search = results["bf16"], results["search"]
    de = results["device_epoch"]

    # each kernel's launches in every run that drives a path, the counts
    # set to 0 before the run and read after it
    compgcn = results["compgcn"]
    by_phase = {
        "compgcn": compgcn["start"], "compgcn_resume": compgcn["resume"],
        **{f"rgnn_{name}_{part}": out[f"{part}_launches"]
           for name, out in results["rgnn_encoders"].items()
           for part in ("train", "eval")},
        "conve": conve["start"], "conve_resume": conve["resume"],
        **{f"scorer_{name}_{part}": out[f"{part}_launches"]
           for name, out in results["scorers"].items()
           for part in ("train", "eval")},
        "eval": ev["counts"], "train_negsamp": tr["counts"],
        "sgd_sparse": sgd["counts"], "kvsall": kv["start"],
        "kvsall_resume": kv["resume"], "1vsall": one["start"],
        "triple_sparse": tri["start"], "wikidata5m": w5m["counts"],
        "wikidata5m_valid": w5m["valid_counts"],
        "mesh_single": results["mesh"]["counts"],
        **{f"mesh_rank{r}": c for r, c in results["mesh"]["ranks"].items()},
        **{f"mesh_sparse_rank{r}": c
           for r, c in results["mesh"]["sparse_ranks"].items()},
        **{f"rgnn_mesh_{name}_{who}": c
           for name, run in results["rgnn_mesh"].items() if name != "dense"
           for who, c in [("single", run["single_counts"])] + [
               (f"rank{r}", c) for r, c in run["counts"].items()]},
        **{f"rgnn_mesh_{label}": run["counts"]
           for label, run in results["rgnn_mesh"]["dense"].items()},
        "device_epoch": de["counts"], "device_epoch_resume": de["resume_counts"],
        "device_epoch_training_loss": de["training_loss_counts"],
        "bf16": bf["counts"], "bf16_training_loss": bf["training_loss_counts"],
        "utils_pretrained": results["utils"]["counts"],
        "pair_ranking": results["pair_ranking"]["counts"],
        "search_grid": search["grid_search"]["counts"],
        "search_ax": search["ax_search"]["counts"],
        "search_ax_resume": search["ax_resume"]["counts"]}

    def phases(name):
        return {phase: c[name] for phase, c in by_phase.items()}

    print(json.dumps({"kernels": [dict(
        name="rank_counts", route="cuda",
        source="kge_tpu_torch/csrc/rank_count.cu",
        replaces="kge_tpu/ops/pallas/rank_count.py:42",
        launches=de["counts"]["rank_counts"],
        max_abs_err=max(k2["max_abs_err"], *(
            w["max_abs_err"] for w in results["k2_widths"])),
        ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
        bound_by=k2["bound_by"], library_ms=k2["library_ms"],
        kernel_us=k2["kernel_us"], host_us=k2["host_us"],
        library_kernel_us=k2["library_kernel_us"],
        widths=results["k2_widths"],
        launches_by_phase=phases("rank_counts"),
    ), dict(
        name="shared_ce_loss", route="cuda",
        source="kge_tpu_torch/csrc/negsamp_loss.cu",
        replaces="kge_tpu/ops/pallas/negsamp_loss.py:44",
        launches=de["counts"]["shared_ce_loss"],
        max_abs_err=k1["max_abs_err"],
        ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
        bound_by=k1["bound_by"], library_ms=k1["library_ms"],
        kernel_us=k1["kernel_us"], host_us=k1["host_us"],
        library_kernel_us=k1["library_kernel_us"],
        bf16_ms=k1["bf16_ms"], bf16_kernel_us=k1["bf16_kernel_us"],
        bf16_host_us=k1["bf16_host_us"],
        launches_by_phase=phases("shared_ce_loss"),
    )] + [dict(
        name=f"row_update_{optimizer}", route="cuda",
        source="kge_tpu_torch/csrc/row_update.cu",
        replaces=f"kge_tpu/ops/pallas/row_update.py:{line}",
        launches=launches, **k3[optimizer],
        launches_by_phase=phases(f"{optimizer}_row_update"),
    ) for optimizer, line, launches in (
        ("adagrad", 60, w5m["launches"]), ("sgd", 78, sgd["launches"]))] + [
        dict(name="ccorr_reduce", route="cuda",
             source="kge_tpu_torch/csrc/ccorr_reduce.cu",
             replaces=None, launches=compgcn["start"]["ccorr_reduce"],
             max_rel_err=compgcn["ccorr_reduce"]["max_rel_err"],
             **{order: compgcn["ccorr_reduce"][order]
                for order in ("src", "nbr", "type")},
             launches_by_phase=phases("ccorr_reduce"))]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
