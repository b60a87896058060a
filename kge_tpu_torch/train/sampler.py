"""Negative samplers on the host, in numpy (the port's own copy of
``kge_tpu/train/sampler.py``; reference: kge/util/sampler.py).

Every draw comes from the sampler's numpy ``Generator`` in the same
order as in ``kge_tpu``, so a sampler seeded alike draws bit-identical
batches in both packages. Batches keep ``kge_tpu``'s fixed-shape layout:

- non-shared: ``negatives`` [B, num] int32
- shared: ``unique`` [num+1] int32 (padded) plus the factored form
  (``num_unique``, ``repeat_indexes``, ``drop``) that expands to the
  per-row ``gather`` column map or the per-row candidate multiplicities
  (``counts``, what the fused loss consumes).

The uniform sampler (shared and not shared), the frequency sampler (not
shared) and the filtering of known positives are here, and
``device_shared_sample``: uniform shared sampling drawn on the device in
the factored form (``tpu.on_device_sampling``), from a
``torch.Generator``. The torch and JAX PRNG streams differ, so its draws
are held to ``kge_tpu``'s by their distribution.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset

S, P, O = 0, 1, 2
SLOT_STR = ["s", "p", "o"]
SLOTS = [S, P, O]


class BatchNegativeSample:
    """Fixed-shape negative sample for one slot of a batch; shared
    samples are stored in factored form and expand on demand."""

    def __init__(self, slot: int, num_samples: int,
                 negatives: Optional[np.ndarray] = None,
                 unique: Optional[np.ndarray] = None,
                 num_unique: Optional[int] = None,
                 repeat_indexes: Optional[np.ndarray] = None,
                 drop: Optional[np.ndarray] = None,
                 batch_size: Optional[int] = None):
        self.slot = slot
        self.num_samples = num_samples
        self._negatives = negatives
        self.unique = unique
        self._gather = None
        self.num_unique = num_unique
        self.repeat_indexes = repeat_indexes
        self.drop = drop
        self._batch_size = batch_size

    @property
    def shared(self) -> bool:
        return self.unique is not None

    @property
    def gather(self) -> Optional[np.ndarray]:
        """[B, num] column map into ``unique`` (built lazily)."""
        if self._gather is None and self.unique is not None:
            nu = self.num_unique
            if self.drop is None:  # naive: every row sees the same columns
                cols = np.broadcast_to(
                    np.arange(nu, dtype=np.int32), (self._batch_size, nu)
                )
            else:
                # default: the dropped position is replaced by the extra
                # candidate parked at position num_unique
                cols = np.broadcast_to(
                    np.arange(nu, dtype=np.int64), (len(self.drop), nu)
                ).copy()
                cols[cols == self.drop[:, None]] = nu
                cols = cols.astype(np.int32)
            if len(self.repeat_indexes):
                cols = np.concatenate(
                    [cols, cols[:, self.repeat_indexes]], axis=1
                )
            self._gather = cols
        return self._gather

    def count_factors(self):
        """The [num+1] float32 base multiplicities (1 + repeats per live
        column, 0 at the extra and padding positions) and the per-row
        dropped position (None for naive sharing)."""
        num, nu = self.num_samples, self.num_unique
        base = np.zeros(num + 1, dtype=np.float32)
        base[:nu] = 1.0
        if len(self.repeat_indexes):
            base[:nu] += np.bincount(
                self.repeat_indexes, minlength=nu
            ).astype(np.float32)
        return base, self.drop

    def counts(self) -> np.ndarray:
        """[B, num+1] float32 multiplicity of each unique candidate in
        each row's sample. KEEP IN LOCKSTEP with the device expansion
        ``kge_tpu_torch.ops.negsamp_loss.expand_counts``."""
        num, nu = self.num_samples, self.num_unique
        base, drop = self.count_factors()
        if drop is None:
            return np.broadcast_to(base, (self._batch_size, num + 1))
        B = len(drop)
        counts = np.tile(base, (B, 1))
        extra = np.where(
            drop < nu, base[np.minimum(drop, nu - 1)], 0.0
        ).astype(np.float32)
        counts[np.arange(B), drop] = 0.0
        counts[:, nu] = extra
        return counts

    def materialize(self) -> np.ndarray:
        """[B, num] negative indexes (expands the shared representation)."""
        if self._negatives is not None:
            return self._negatives
        return self.unique[self.gather]


def _below(bound: torch.Tensor, n: int,
           generator: torch.Generator) -> torch.Tensor:
    """``n`` uniform integers in ``[0, bound)`` for a 0-d device ``bound``
    >= 1, without a host sync: 62 uniform bits reduced modulo the bound
    (``torch.randint`` takes Python bounds only). The modulo bias is
    below bound / 2^62."""
    bits = torch.randint(0, 2 ** 62, (n,), generator=generator,
                         device=bound.device)
    return torch.remainder(bits, bound)


def device_shared_sample(generator: torch.Generator, num: int, voc: int,
                         naive: bool, with_replacement: bool,
                         positives: torch.Tensor):
    """Uniform shared sampling on the device, line for line ``kge_tpu``'s
    ``device_shared_sample`` (``kge_tpu/train/sampler.py:143-205``), in the
    factored form the fused loss reads: ``(unique [num+1] int64, base
    [num+1] float32, nu 0-d int64, drop [B] int64 or None)``, static
    shapes and no host sync, drawn from ``generator`` on ``positives``'
    device:

    - with replacement, ``nu`` is the number of distinct values in
      ``num`` draws over the base vocabulary (sorted, neighbours that
      differ counted); without, ``num``;
    - the uniques are the top ``num + 1`` of ``voc`` uniform int32 keys
      (an ordered sample without replacement), the first ``take`` of them
      kept (``nu``, plus the extra candidate of ``default`` sharing);
      positions at and past ``take`` repeat ``unique[0]``;
    - ``base`` is 1 on the ``nu`` live columns plus the ``num - nu``
      repeats, each uniform over them (a masked full-size draw: masked
      adds are zero);
    - ``drop`` (``default`` sharing) is uniform over ``[0, nu]``,
      overridden to the positive's position where the positive was drawn.

    Draws, in order: the distinct-count draw, the keys, the repeats, the
    drops. Requires voc >= num + 1. KEEP IN LOCKSTEP with
    ``KgeUniformSampler._sample_shared`` and ``count_factors``."""
    device = positives.device
    base_voc = voc if naive else voc - 1
    if with_replacement:
        d = torch.randint(0, base_voc, (num,), generator=generator,
                          device=device)
        ds = torch.sort(d).values
        nu = 1 + torch.sum(ds[1:] != ds[:-1])
    else:
        nu = torch.full((), num, dtype=torch.int64, device=device)
    take = nu if naive else nu + 1
    # int32 keys rather than float uniforms: float32 has 2^24 values, so
    # a large vocabulary ties often and top-k's tie order would bias the
    # boundary slot toward some ids
    keys = torch.randint(-2 ** 31, 2 ** 31, (voc,), generator=generator,
                         device=device, dtype=torch.int32)
    top = torch.topk(keys, num + 1).indices
    idx = torch.arange(num + 1, device=device)
    unique = torch.where(idx < take, top, top[0])
    base = (idx < nu).to(torch.float32)
    if with_replacement:
        rep = _below(torch.clamp(nu, min=1), num, generator)
        rep_mask = (torch.arange(num, device=device) < num - nu).to(
            torch.float32)
        # the repeats' counts as a [num, num+1] one-hot sum: exact (0/1
        # adds) and free of atomics, so deterministic on a card
        base = base + torch.sum(
            rep_mask[:, None] * (rep[:, None] == idx[None, :]), dim=0)
    drop = None
    if not naive:
        drop0 = _below(nu + 1, positives.shape[0], generator)
        match = ((unique[None, :] == positives[:, None])
                 & (idx < take)[None, :])
        hit = torch.any(match, dim=1)
        hit_pos = torch.argmax(match.to(torch.int32), dim=1)
        drop = torch.where(hit, hit_pos, drop0)
    return unique, base, nu, drop


class KgeSampler(Configurable):
    def __init__(self, config: Config, configuration_key: str,
                 dataset: Dataset):
        super().__init__(config, configuration_key)
        self.dataset = dataset
        self.num_samples = np.zeros(3, dtype=np.int64)
        self.filter_positives = np.zeros(3, dtype=bool)
        self.vocabulary_size = np.zeros(3, dtype=np.int64)
        self.shared = self.get_option("shared")
        self.shared_type = self.check_option("shared_type",
                                             ["naive", "default"])
        self.with_replacement = self.get_option("with_replacement")
        if not self.with_replacement and not self.shared:
            raise ValueError(
                "without-replacement sampling requires shared negative "
                "sampling"
            )
        self.filtering_split = config.get("negative_sampling.filtering.split")
        if self.filtering_split == "":
            self.filtering_split = config.get("train.split")
        for slot in SLOTS:
            slot_str = SLOT_STR[slot]
            self.num_samples[slot] = self.get_option(f"num_samples.{slot_str}")
            self.filter_positives[slot] = self.get_option(
                f"filtering.{slot_str}")
            self.vocabulary_size[slot] = (
                dataset.num_relations() if slot == P
                else dataset.num_entities()
            )
            if self.filter_positives[slot]:
                pair = ["po", "so", "sp"][slot]
                dataset.index(f"{self.filtering_split}_{pair}_to_{slot_str}")
        if self.filter_positives.any() and self.shared:
            raise ValueError("filtering is incompatible with shared sampling")
        # auto-complete sample counts (-1: copy from S)
        for slot, copy_from in [(S, O), (P, None), (O, S)]:
            if self.num_samples[slot] < 0:
                if copy_from is not None and self.num_samples[copy_from] > 0:
                    self.num_samples[slot] = self.num_samples[copy_from]
                else:
                    self.num_samples[slot] = 0
        self._rng = np.random.default_rng()

    def seed(self, seed) -> None:
        """Reset the sampler's numpy generator (any SeedSequence entropy:
        the trainer passes (seed, epoch))."""
        self._rng = np.random.default_rng(seed)

    @staticmethod
    def create(config: Config, configuration_key: str,
               dataset: Dataset) -> "KgeSampler":
        sampling_type = config.get(configuration_key + ".sampling_type")
        if sampling_type == "uniform":
            return KgeUniformSampler(config, configuration_key, dataset)
        if sampling_type == "frequency":
            return KgeFrequencySampler(config, configuration_key, dataset)
        raise ValueError(configuration_key + ".sampling_type")

    def sample(self, positive_triples: np.ndarray, slot: int,
               num_samples: Optional[int] = None) -> BatchNegativeSample:
        if num_samples is None:
            num_samples = int(self.num_samples[slot])
        if self.shared:
            return self._sample_shared(positive_triples, slot, num_samples)
        negatives = self._sample(positive_triples, slot, num_samples)
        if self.filter_positives[slot]:
            negatives = self._filter_and_resample(
                negatives, slot, positive_triples)
        return BatchNegativeSample(slot, num_samples, negatives=negatives)

    def _sample(self, positive_triples: np.ndarray, slot: int,
                num_samples: int) -> np.ndarray:
        raise NotImplementedError

    def _sample_shared(self, positive_triples: np.ndarray, slot: int,
                       num_samples: int) -> BatchNegativeSample:
        raise NotImplementedError(
            "the selected sampler does not support shared sampling"
        )

    def _filter_and_resample(self, negatives: np.ndarray, slot: int,
                             positive_triples: np.ndarray) -> np.ndarray:
        """Redraw the entries that are known positives of their row's
        pair, in place: each round draws one fresh value for every
        position still bad in one ``_sample`` call (``kge_tpu``'s draws, in
        its order), for at most 1000 rounds, then warns."""
        pair_str = ["po", "so", "sp"][slot]
        index = self.dataset.index(
            f"{self.filtering_split}_{pair_str}_to_{SLOT_STR[slot]}"
        )
        cols = [[P, O], [S, O], [S, P]][slot]
        pos_rows, pos_vals = index.get_all_coords(positive_triples[:, cols])
        if len(pos_rows) == 0:
            return negatives
        voc = int(self.vocabulary_size[slot])
        pos_keys = np.sort(pos_rows.astype(np.int64) * voc + pos_vals)

        def is_positive(rows, vals):
            keys = rows.astype(np.int64) * voc + vals
            i = np.minimum(np.searchsorted(pos_keys, keys),
                           len(pos_keys) - 1)
            return pos_keys[i] == keys

        B, K = negatives.shape
        row_of = np.broadcast_to(np.arange(B)[:, None], (B, K))
        bad_i, bad_j = np.nonzero(is_positive(row_of, negatives))
        rounds = 0
        while len(bad_i) and rounds < 1000:
            fresh = self._sample(positive_triples[bad_i], slot, 1).reshape(-1)
            ok = ~is_positive(bad_i, fresh)
            negatives[bad_i[ok], bad_j[ok]] = fresh[ok]
            bad_i, bad_j = bad_i[~ok], bad_j[~ok]
            rounds += 1
        if len(bad_i):
            self.config.log(
                f"WARNING: filtering could not replace {len(bad_i)} "
                f"positive(s) in the negative sample "
                f"(slot {SLOT_STR[slot]}) after 1000 rounds"
            )
        return negatives


class KgeUniformSampler(KgeSampler):
    def _sample(self, positive_triples, slot, num_samples):
        return self._rng.integers(
            self.vocabulary_size[slot],
            size=(len(positive_triples), num_samples),
            dtype=np.int64,
        ).astype(np.int32)

    def _sample_shared(self, positive_triples, slot, num_samples):
        """Shared sampling with the positive-drop trick (reference:
        kge/util/sampler.py:597-698), emitted in factored form."""
        batch_size = len(positive_triples)
        voc = int(self.vocabulary_size[slot])
        if self.with_replacement:
            # distribution of #distinct values in a WR sample
            base = voc if self.shared_type == "naive" else voc - 1
            num_unique = len(
                np.unique(self._rng.integers(base, size=num_samples))
            )
        else:
            num_unique = num_samples
        take = num_unique if self.shared_type == "naive" else num_unique + 1
        unique = self._choice_without_replacement(voc, take)
        if num_unique != num_samples:
            repeat_indexes = self._rng.integers(
                num_unique, size=num_samples - num_unique
            )
        else:
            repeat_indexes = np.zeros(0, dtype=np.int64)

        drop = None
        if self.shared_type != "naive":
            positives = positive_triples[:, slot]
            drop = self._rng.integers(num_unique + 1, size=batch_size)
            # rows whose positive is among the unique samples drop exactly it
            pos_in_unique = np.searchsorted(np.sort(unique), positives)
            order = np.argsort(unique, kind="stable")
            sorted_unique = unique[order]
            hit = (pos_in_unique < len(unique)) & (
                sorted_unique[np.minimum(pos_in_unique, len(unique) - 1)]
                == positives
            )
            drop = np.where(
                hit, order[np.minimum(pos_in_unique, len(unique) - 1)], drop
            )
        # pad unique to the static length num_samples+1
        padded = np.zeros(num_samples + 1, dtype=np.int32)
        padded[: len(unique)] = unique
        if 0 < len(unique) < num_samples + 1:
            padded[len(unique):] = unique[0]
        return BatchNegativeSample(
            slot, num_samples, unique=padded, num_unique=num_unique,
            repeat_indexes=repeat_indexes, drop=drop, batch_size=batch_size,
        )

    def _choice_without_replacement(self, voc: int, take: int) -> np.ndarray:
        """Uniform ordered sample without replacement: ``choice`` when
        ``take`` is a large share of ``voc``, else i.i.d. draws with the
        collisions redrawn (same distribution, O(take))."""
        if take * 8 >= voc:
            return self._rng.choice(
                voc, size=take, replace=False
            ).astype(np.int32)
        out = self._rng.integers(voc, size=take)
        while True:
            uniq, first = np.unique(out, return_index=True)
            if len(uniq) == take:
                return out.astype(np.int32)
            dup = np.ones(take, dtype=bool)
            dup[first] = False
            out[dup] = self._rng.integers(voc, size=int(dup.sum()))


class KgeFrequencySampler(KgeSampler):
    """Samples in proportion to the smoothed frequency of each id in the
    train split (reference: kge/util/sampler.py:755-793); not shared."""

    def __init__(self, config, configuration_key, dataset):
        super().__init__(config, configuration_key, dataset)
        self._cdf = [None, None, None]
        smoothing = self.get_option("frequency.smoothing")
        train = dataset.split(config.get("train.split"))
        for slot in SLOTS:
            counts = np.bincount(
                train[:, slot], minlength=int(self.vocabulary_size[slot])
            ).astype(np.float64) + smoothing
            self._cdf[slot] = np.cumsum(counts / counts.sum())

    def _sample(self, positive_triples, slot, num_samples):
        u = self._rng.random((len(positive_triples), num_samples))
        idx = np.searchsorted(self._cdf[slot], u)
        # the float64 CDF's last entry can land below 1.0, letting
        # searchsorted return vocabulary_size; clamp to the last id
        return np.minimum(idx, self.vocabulary_size[slot] - 1).astype(np.int32)
