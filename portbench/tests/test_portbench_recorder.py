"""The training entry's ``Recorder`` under CUDA graphs: a capture runs
nothing, so its wrappers pass it through untouched; a replayed group's
steps are recorded from the values it returns and the eager group of the
same key; and on a card a captured job's records equal, bit for bit,
those of the same job run eagerly."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from harness.cell import Cell, benchmark_file
from harness.graph import dataset_folder


def train_entry():
    return Cell(benchmark_file(), "compgcn-fb15k237.train").entry()


class Untouchable:
    """A generator that fails the test when anything of it is used."""

    def __getattr__(self, name):
        raise AssertionError(f"generator.{name} used under a capture")


class FakeJob:
    """The program names the recorder wraps, each call noted."""

    opt_state = {}

    def __init__(self, generator):
        self.calls = []
        self.graph_replays = 0
        self._dropout_gen = generator
        self.model = torch.nn.Linear(1, 1)

    def _generate_batches(self, epoch):
        yield from ()

    def _step(self, batch, lrs, correction=None):
        self.calls.append("step")
        return {"avg_loss": torch.ones(())}

    def _dispatch_group(self, key, host, run):
        self.calls.append("group")
        return ["avg_loss"], torch.ones((1, 1))


@pytest.mark.parametrize("capture", [True, False])
def test_a_capture_is_passed_through(monkeypatch, capture):
    """Under a (faked) capture the wrappers call the program's own and
    touch no generator and record nothing; outside one the same calls
    are recorded."""
    from kge_tpu_torch.models.api import Ctx

    entry = train_entry()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: capture)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capture)
    generator = Untouchable() if capture else torch.Generator()
    job = FakeJob(generator)
    monkeypatch.setattr(Ctx, "dropout",
                        lambda ctx, x, rate, replicated=False:
                        job.calls.append("dropout") or x)
    ctx = SimpleNamespace(train=True, generator=generator)

    def step_with_dropout(batch, lrs, correction=None):
        Ctx.dropout(ctx, torch.ones(3), 0.5)
        return FakeJob._step(job, batch, lrs, correction)
    job._step = step_with_dropout
    with entry.Recorder(job, 4) as rec:
        job._step({}, {})
        job._dispatch_group("key", {}, None)
    assert job.calls == ["dropout", "step", "group"]
    if capture:
        assert rec.losses == [] and rec.draws == [] and rec.state1 is None
    else:
        assert rec.losses == [1.0] and len(rec.draws[0]) == 1
        assert rec.state1 == {} and set(rec.params1) == {"weight", "bias"}


class PhiloxGenerator:
    """A CUDA generator's state: 8 bytes of seed, 8 of Philox offset;
    each draw moves the offset by 4."""

    def __init__(self, seed, offset):
        self.seed, self.offset = seed, offset

    def get_state(self):
        return torch.tensor([self.seed, self.offset],
                            dtype=torch.int64).view(torch.uint8)


def test_replayed_group_is_recorded_from_the_eager_group(monkeypatch):
    """Group 1 of a key runs its two steps eagerly (two draws each, the
    generator at offset 40); group 2 replays them from offset 100: its
    records are the returned losses and the eager draws moved by 60."""
    from kge_tpu_torch.models.api import Ctx

    entry = train_entry()
    generator = PhiloxGenerator(seed=7, offset=40)
    ctx = SimpleNamespace(train=True, generator=generator)

    def draw(ctx, x, rate, replicated=False):
        generator.offset += 4
        return x
    monkeypatch.setattr(Ctx, "dropout", draw)
    job = FakeJob(generator)

    def step(batch, lrs, correction=None):
        Ctx.dropout(ctx, torch.ones(2), 0.5)
        Ctx.dropout(ctx, torch.ones(3), 0.5)
        return {"avg_loss": torch.tensor(float(batch))}

    def dispatch(key, host, run):
        if job.graph_replays or key != "k":
            raise AssertionError("one eager group, then one replay")
        if not job.calls:
            job.calls.append("eager")
            return ["avg_penalty", "avg_loss"], torch.stack([
                torch.stack([torch.zeros(()), job._step(i, {})["avg_loss"]])
                for i in (1, 2)])
        generator.offset = 100 + 16
        job.graph_replays += 1
        return ["avg_penalty", "avg_loss"], torch.tensor([[0.0, 3.0],
                                                          [0.0, 4.0]])
    job._step, job._dispatch_group = step, dispatch
    with entry.Recorder(job, 4) as rec:
        job._dispatch_group("k", {}, None)
        generator.offset = 100
        job._dispatch_group("k", {}, None)
    assert rec.losses == [1.0, 2.0, 3.0, 4.0]
    offsets = [[entry.philox_offset(d["state"]) for d in draws]
               for draws in rec.draws]
    assert offsets == [[40, 44], [48, 52], [100, 104], [108, 112]]
    for draws in rec.draws:
        for d in draws:
            assert int(d["state"][:8].view(torch.int64)[0]) == 7
    assert [d["shape"] for d in rec.draws[3]] == [(2,), (3,)]


#: reciprocal ConvE by KvsAll with its default dropouts (0.2 on both
#: embedders and the feature maps, 0.3 on the projection), Adam, groups
#: of 4 steps: a job the port captures on a card
CONVE = {
    "job": {"type": "train"},
    "model": "reciprocal_relations_model",
    "reciprocal_relations_model": {"base_model": {"type": "conve"}},
    "conve": {"round_dim": True, "entity_embedder": {"dim": 32},
              "relation_embedder": {"dim": 32}},
    "train": {"type": "KvsAll", "loss": "bce", "max_epochs": 1,
              "batch_size": 32,
              "optimizer": {"default": {"type": "Adam",
                                        "args": {"lr": 0.001}}}},
    "KvsAll": {"label_smoothing": 0.1},
    "valid": {"every": 0},
    "tpu": {"steps_per_dispatch": 4},
    "console": {"quiet": True},
}
GRAPH = {"entities": 300, "relations": 12,
         "splits": {"train": 3000, "valid": 200, "test": 200}}


def conve_records(tmp_path, capture: bool, steps: int = 48):
    """The recorder's records of the first ``steps`` steps of a fresh
    ConvE job on the card, with its groups captured or (``_capture``
    False) run eagerly."""
    from kge_tpu_torch import Config, Dataset
    from kge_tpu_torch.train.train import TrainingJob

    folder, _ = dataset_folder(str(tmp_path / "data"), "conve", GRAPH,
                               20261018, 5)
    settings = dict(CONVE, dataset={"name": folder},
                    random_seed={"default": 4321},
                    job={"type": "train", "device": "cuda"})
    path = tmp_path / f"conve-{capture}.yaml"
    path.write_text(yaml.safe_dump(settings))
    config = Config()
    config.load(str(path), create=True)
    job = TrainingJob.create(config, Dataset.create(config, folder))
    job._prepare()
    job._is_prepared = True
    if not capture:
        job._capture = False
    job.epoch = 1
    with train_entry().Recorder(job, steps) as rec:
        job.run_epoch()
    return rec, job.graph_replays


@pytest.mark.cuda
def test_recorder_follows_graph_replays(tmp_path, monkeypatch):
    """With capture the group sequence holds a replay; every loss, draw
    and the optimizer's state after step 1 equal the eager run's bit for
    bit. Both run under deterministic algorithms: the program's embedding
    gradients are summed with atomics, so two eager runs (or two captured
    ones) part in the last bits of a loss after a few steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        captured, replays = conve_records(tmp_path, True)
        eager, none = conve_records(tmp_path, False)
    finally:
        torch.use_deterministic_algorithms(False)
    assert replays >= 1 and none == 0
    assert len(captured.losses) == len(eager.losses) == 48
    assert captured.losses == eager.losses
    for a, b in zip(captured.batches, eager.batches):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    for step_a, step_b in zip(captured.draws, eager.draws):
        assert len(step_a) == len(step_b) > 0
        for a, b in zip(step_a, step_b):
            assert a["shape"] == b["shape"]
            assert torch.equal(a["state"], b["state"])
    for slot, leaves in eager.state1.items():
        for name, value in leaves.items():
            assert torch.equal(captured.state1[slot][name], value), name
    for name, value in eager.params1.items():
        assert torch.equal(captured.params1[name], value), name
