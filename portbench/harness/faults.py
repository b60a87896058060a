"""Faults planted in the program underneath a run, to see ``correct``
come out false (``tests/test_portbench_reference.py``) and to read what
each does to the numbers compared (``calibrate.py --fault``):

- ``unchanged_state``: the optimizer's step leaves every leaf as it is;
- ``half_batch``: the training loss of a step over the first half of its
  rows only, as their mean;
- ``reversed_step``: the optimizer's step goes up the loss instead of
  down it (each leaf moved by the opposite of its update), its state
  kept as the step left it."""

from __future__ import annotations

import contextlib


def _patch(patches, cls, name, value):
    patches.append((cls, name, getattr(cls, name)))
    setattr(cls, name, value)


def unchanged_state(patches):
    from kge_tpu_torch.train.optimizer import KgeOptimizer

    _patch(patches, KgeOptimizer, "step", lambda self, *a, **k: None)
    _patch(patches, KgeOptimizer, "sparse_row_update",
           lambda self, *a, **k: None)


def half_batch(patches):
    from kge_tpu_torch.train.train_kvsall import TrainingJobKvsAll

    loss = TrainingJobKvsAll._subbatch_loss

    def half(self, ctx, batch, sl):
        rows = batch["weights"].shape[0]
        return 2 * loss(self, ctx, batch, slice(0, rows // 2))
    _patch(patches, TrainingJobKvsAll, "_subbatch_loss", half)


def reversed_step(patches):
    import torch
    from kge_tpu_torch.train.optimizer import KgeOptimizer

    step = KgeOptimizer.step

    def reversed_(self, *args, **kwargs):
        before = {n: p.detach().clone() for n, p in self.params.items()}
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(2 * before[n] - p)
        return out
    _patch(patches, KgeOptimizer, "step", reversed_)


FAULTS = {f.__name__: f for f in (unchanged_state, half_batch,
                                  reversed_step)}


@contextlib.contextmanager
def planted(name: str):
    patches = []
    try:
        FAULTS[name](patches)
        yield
    finally:
        for cls, attr, value in reversed(patches):
            setattr(cls, attr, value)
