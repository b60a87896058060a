"""The R-GNN encoder's profiler spans in the port: a training forward of
the encoder is ``train.encode`` inside ``train.forward``, with
``train.encode.messages`` and ``train.encode.aggregate`` inside it, and
its backward is one ``train.encode.backward`` a step, which holds the
spectral reduce's backward (``CcorrReduceBackward``) and the FFTs' and
none of ConvE's backward. The spans change no
number: two steps of CompGCN with a reciprocal ConvE decoder by KvsAll on
data/toy, every dropout on, give the same losses, gradients, Adam state,
model state and weights bit for bit with the profiler off and on. The
encoder's other routes (the dense adjacency, per-relation weights, the
attention softmax) name their phases alike, and ``tpu.profile_dir``'s
Chrome trace carries the four names. While a CUDA graph is captured the
encoder registers no backward hook, and the hooks it registers hold no
graph once the backward has ended."""

import contextlib
import gc
import glob
import itertools
import json
import os
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.models.rgnn.encoder import backward_span
from kge_tpu_torch.train.train import TrainingJob

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(REPO, "data", "toy")
SPANS = ("train.encode", "train.encode.messages", "train.encode.aggregate",
         "train.encode.backward")
STEPS = 2

BASE = {
    "job.type": "train", "job.device": "cpu", "console.quiet": True,
    "random_seed.default": 5, "train.max_epochs": 1,
    "train.batch_size": 32, "valid.every": 0,
    "tpu.on_device_sampling": "never", "tpu.steps_per_dispatch": 1,
    "train.optimizer.default.type": "Adam",
    "train.optimizer.default.args.lr": 0.003,
}


def options(preset, dim=8, **encoder):
    """``preset`` at dim ``dim`` with the encoder's dropouts on."""
    out = {f"{preset}.entity_embedder.dim": dim,
           f"{preset}.relation_embedder.dim": dim,
           f"{preset}.encoder.edge_dropout": 0.2,
           f"{preset}.encoder.self_edge_dropout": 0.1,
           f"{preset}.encoder.emb_entity_dropout": 0.1,
           f"{preset}.encoder.message_passing_args.emb_propagation_dropout":
               0.3}
    out.update({f"{preset}.encoder.{k}": v for k, v in encoder.items()})
    return out


#: CompGCN's FB15k-237 recipe cut to the toy: ccorr messages over the
#: edge list, reciprocal ConvE by KvsAll, ConvE's dropouts at its defaults
COMPGCN_CONVE = ("compgcn", {
    **options("compgcn", num_layers=1, activation="tanh",
              **{"message_passing_args.composition": "ccorr"}),
    "compgcn.decoder.base_model.entity_embedder.dim": 8,
    "compgcn.decoder.base_model.relation_embedder.dim": 8,
    "train.type": "KvsAll", "train.loss": "bce",
    "KvsAll.label_smoothing": 0.1})

#: the other routes of a message-passing layer, by negative sampling
ROUTES = {
    # ``sub`` is hoistable: with no edge dropout the dense adjacency
    "dense": ("compgcn", {
        **options("compgcn", edge_dropout=0.0, self_edge_dropout=0.0,
                  **{"message_passing_args.composition": "sub"}),
        "compgcn.decoder.model": "distmult",
        "compgcn.decoder.type": "distmult",
        "tpu.gnn_dense_adjacency": "always"}),
    "per_relation": ("compgcn", {
        **options("compgcn", dim=16, weight_decomposition="basis",
                  num_blocks_or_bases=2,
                  **{"message_passing_args.propagation": "per_relation",
                     "message_passing_args.composition": "sub"}),
        "compgcn.decoder.model": "distmult",
        "compgcn.decoder.type": "distmult"}),
    "attention": ("ragat", {
        **options("ragat"), "ragat.decoder.model": "distmult",
        "ragat.decoder.type": "distmult"}),
}
NEGATIVE_SAMPLING = {"train.type": "negative_sampling", "train.loss": "bce",
                     "negative_sampling.num_samples.s": 4,
                     "negative_sampling.num_samples.o": 4}


def make_job(case, folder, **extra):
    preset, opts = case
    config = Config(folder=str(folder))
    config.set("model", preset)
    config._import(preset)
    for key, value in {**BASE, **opts, **extra}.items():
        config.set(key, value, create=True)
    config.init_folder()
    return TrainingJob.create(config, Dataset.create(config, TOY))


def run_steps(job, profiler=None):
    """Epoch 1 of ``job`` cut to its first ``STEPS`` batches (under
    ``profiler``): each step's loss and gradients."""
    record = {"losses": [], "grads": []}
    step, generate = job._step, job._generate_batches

    def stepped(batch, lrs, correction=None):
        out = step(batch, lrs, correction)
        record["losses"].append(out["avg_loss"].clone())
        record["grads"].append({n: p.grad.clone() for n, p
                                in job.model.named_parameters()
                                if p.grad is not None})
        return out

    job._step = stepped
    job._generate_batches = lambda epoch: itertools.islice(
        generate(epoch), STEPS)
    job._prepare()
    job._is_prepared = True
    job.epoch = 1
    with profiler or contextlib.nullcontext():
        job.run_epoch()
    return record


def assert_equal_trees(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for key in a:
            assert_equal_trees(a[key], b[key], f"{where}.{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_trees(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def state(job, record):
    return {**record, "opt_state": job.opt_state,
            "model_state": job.model.model_state,
            "weights": {n: p.detach() for n, p
                        in job.model.named_parameters()}}


def ancestors(event):
    out = []
    while event.cpu_parent is not None:
        event = event.cpu_parent
        out.append(event.name)
    return out


def descendants(event):
    for child in event.cpu_children:
        yield child
        yield from descendants(child)


def profiled_steps(case, folder, **extra):
    """(plain record, profiled record, the profiler's events) of two jobs
    from one seed; asserts that nothing differs."""
    plain = make_job(case, folder / "plain", **extra)
    want = run_steps(plain)
    traced = make_job(case, folder / "traced", **extra)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = run_steps(traced)
    assert len(want["losses"]) == STEPS
    assert_equal_trees(state(traced, got), state(plain, want), "step")
    return prof.events()


def test_compgcn_conve_spans_change_no_number(tmp_path):
    events = profiled_steps(COMPGCN_CONVE, tmp_path)
    by_name = {name: [e for e in events if e.name == name] for name in SPANS}
    # one forward a step (stale embeddings: every score call reads it)
    assert len(by_name["train.encode"]) == STEPS
    for e in by_name["train.encode"]:
        assert "train.forward" in ancestors(e)
    # direction propagation: messages of the in, out and loop modes,
    # the in and out modes reduced by node
    assert len(by_name["train.encode.messages"]) == 3 * STEPS
    assert len(by_name["train.encode.aggregate"]) == 2 * STEPS
    for name in ("train.encode.messages", "train.encode.aggregate"):
        for e in by_name[name]:
            assert "train.encode" in ancestors(e), name
    # ccorr takes the spectral route: the node and relation tables' FFTs
    # once a step, in the first mode's messages; each edge mode's reduce
    # by node in the spectral domain (the kernel's plain version on the
    # host, its index_add_), then the inverse FFT and the mode weight
    messages = [d.name for e in by_name["train.encode.messages"]
                for d in descendants(e)]
    assert messages.count("aten::_fft_r2c") == 2 * STEPS
    aggregates = {d.name for e in by_name["train.encode.aggregate"]
                  for d in descendants(e)}
    assert {"CcorrReduce", "aten::index_add_", "aten::_fft_c2r",
            "aten::mm"} <= aggregates, aggregates
    # the backward: one a step, closed inside the step's train.backward,
    # the reduce's backward (the same reduce by neighbour and by relation)
    # and the FFTs' in it, no per-edge gather's and none of ConvE's
    backward = by_name["train.encode.backward"]
    assert len(backward) == STEPS
    for e in backward:
        assert e.time_range.end > e.time_range.start
        assert "train.backward" in ancestors(e)
        inside = {d.name for d in descendants(e)}
        assert "CcorrReduceBackward" in inside, inside
        assert any(n.startswith("aten::index_add") for n in inside), inside
        assert not any("ConvolutionBackward0" in n for n in inside), inside
        assert not any("IndexSelectBackward0" in n for n in inside), inside
        assert {"FftR2CBackward0", "FftC2RBackward0"} <= inside, inside


@pytest.mark.parametrize("route", list(ROUTES))
def test_other_routes_name_their_phases(route, tmp_path):
    events = profiled_steps(ROUTES[route], tmp_path, **NEGATIVE_SAMPLING)
    names = [e.name for e in events]
    for name in SPANS:
        assert names.count(name) >= STEPS, (route, name)
    for e in events:
        if e.name in ("train.encode.messages", "train.encode.aggregate"):
            assert "train.encode" in ancestors(e), (route, e.name)
        if e.name == "train.encode.backward":
            assert "train.backward" in ancestors(e), route


def test_no_span_or_hook_without_a_profiler(tmp_path, monkeypatch):
    """Without a profiler the encoder registers no gradient hook."""
    registered = []
    real = torch.autograd.graph.register_multi_grad_hook

    def counting(*args, **kwargs):
        registered.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook",
                        counting)
    record = run_steps(make_job(COMPGCN_CONVE, tmp_path))
    assert len(record["losses"]) == STEPS and not registered
    with profile(activities=[ProfilerActivity.CPU]):
        run_steps(make_job(COMPGCN_CONVE, tmp_path / "traced"))
    # one for the outputs, one for the inputs, each step
    assert len(registered) == 2 * STEPS


def test_no_hook_while_capturing(tmp_path, monkeypatch):
    """While the current stream captures a CUDA graph (faked here) the
    encoder registers no gradient hook, under a profiler too: a replay
    runs no Python, and the hooks' span would mean nothing there. The
    forward's spans stay."""
    registered = []
    real = torch.autograd.graph.register_multi_grad_hook

    def counting(*args, **kwargs):
        registered.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook",
                        counting)
    job = make_job(COMPGCN_CONVE, tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with monkeypatch.context() as capture:
            capture.setattr(torch.cuda, "is_available", lambda: True)
            capture.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
            record = run_steps(job)
    assert len(record["losses"]) == STEPS and not registered
    names = [e.name for e in prof.events()]
    assert names.count("train.encode") == STEPS
    assert "train.encode.backward" not in names


class Kept(torch.autograd.Function):
    """The identity, whose graph node holds ``marker`` while it lives."""

    @staticmethod
    def forward(ctx, x, marker):
        ctx.marker = marker
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def test_backward_span_holds_no_graph_after_the_backward():
    """With the garbage collector off, a graph whose backward ran under
    the span goes with its last reference: the span's hooks are removed
    when the backward ends (they hold the graph's nodes in a cycle, so a
    later step would reuse the leaves' gradient accumulators, and with
    them the stream they were made on, which fails a CUDA graph capture
    on another stream)."""
    class Marker:
        pass

    marker = Marker()
    probe = weakref.ref(marker)
    w = torch.nn.Parameter(torch.randn(4, 3))
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            x0 = Kept.apply(w * 2, marker)
            x = (x0 * 3).tanh()
            backward_span((x,), (x0,))
            x.sum().backward()
        del marker, x0, x
        assert probe() is None
    finally:
        gc.enable()
    assert [e.name for e in prof.events()].count("train.encode.backward") == 1


def test_profile_dir_trace_names_the_encoder(tmp_path):
    job = make_job(COMPGCN_CONVE, tmp_path,
                   **{"tpu.profile_dir": str(tmp_path / "profile")})
    run_steps(job)
    (path,) = glob.glob(str(tmp_path / "profile" / "*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(SPANS) <= names
