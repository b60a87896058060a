"""Bayesian/quasi-random search (counterpart of ``kge_tpu/search/ax.py``;
reference: kge/job/search_ax.py).

Uses ax-platform when it is installed. Otherwise the native backend, line
for line ``kge_tpu``'s: the same search-space definition and resume
semantics (fixed sobol_seed, already-generated arms regenerated and
skipped on resume); a scrambled-Sobol quasi-random phase, then GP+EI (a
numpy Gaussian process, RBF kernel on the unit-cube encoding, Cholesky
solve, scoring a Sobol candidate pool by expected improvement); linear
parameter constraints enforced by rejection and masking; and a separately
seeded fallback stream for GP-phase trials the GP cannot fit yet.
Deterministic given the stored trial results, so resume refits. scipy
(``scipy.stats.qmc``, ``norm``) is imported where the backend runs.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from kge_tpu_torch.search.auto import AutoSearchJob
from kge_tpu_torch.train.job import Job

try:
    from ax.service.ax_client import AxClient  # type: ignore

    HAVE_AX = True
except ImportError:
    HAVE_AX = False


class AxSearchJob(AutoSearchJob):
    def __init__(self, config, dataset, parent_job=None):
        super().__init__(config, dataset, parent_job)
        self.num_trials = self.config.get("ax_search.num_trials")
        self.num_sobol_trials = self.config.get("ax_search.num_sobol_trials")
        self.sobol_seed = self.config.get("ax_search.sobol_seed")
        self.search_space: List[Dict] = self.config.get("ax_search.parameters")
        self.ax_client = None
        self._sobol = None
        self._generated = 0
        # linear parameter constraints ("2*a + b <= 5", "a <= b"): passed
        # through to ax-platform, ENFORCED by rejection/masking in the
        # native fallback (reference behavior via Ax,
        # kge/job/search_ax.py:32-56)
        self._constraints = self._parse_constraints(
            self.config.get("ax_search.parameter_constraints")
        )
        known = {p["name"] for p in self.search_space}
        for coeffs, _, _ in self._constraints:
            unknown = set(coeffs) - known
            if unknown:
                raise ValueError(
                    f"parameter_constraints reference unknown "
                    f"parameters {sorted(unknown)}"
                )
        if self.num_shards > 1 and self._num_sobol() < self.num_trials:
            raise ValueError(
                "search.num_shards > 1 requires a pure Sobol schedule "
                "(ax_search.num_sobol_trials >= num_trials): the GP "
                "phase is sequential and shards only see their own "
                "results"
            )
        if self.__class__ == AxSearchJob:
            for f in Job.job_created_hooks:
                f(self)

    def _planned_trials(self) -> int:
        return self.num_trials

    def init_search(self):
        if HAVE_AX:
            from ax.modelbridge.generation_strategy import (
                GenerationStep, GenerationStrategy,
            )
            from ax.modelbridge.registry import Models

            num_sobol = self.num_sobol_trials
            if num_sobol < 0:
                num_sobol = max(self.num_trials // 2, 5)
            gs = GenerationStrategy(
                steps=[
                    GenerationStep(
                        model=Models.SOBOL,
                        num_trials=num_sobol,
                        model_kwargs={"seed": self.sobol_seed},
                    ),
                    GenerationStep(model=Models.GPEI, num_trials=-1),
                ]
            )
            self.ax_client = AxClient(generation_strategy=gs)
            self.ax_client.create_experiment(
                name=self.job_id,
                parameters=self.search_space,
                objective_name=self.config.get("valid.metric"),
                minimize=not self.config.get("valid.metric_max"),
                parameter_constraints=self.config.get(
                    "ax_search.parameter_constraints"
                ),
            )
        else:
            from scipy.stats import qmc

            self.config.log(
                "ax-platform not installed: using built-in scrambled-Sobol "
                "backend (quasi-random phase only)"
            )
            dims = [p for p in self.search_space if p.get("type") != "fixed"]
            self._sobol = qmc.Sobol(
                d=max(len(dims), 1), scramble=True, seed=self.sobol_seed
            )
            self._sobol_dims = dims

    # ------------------------------------------------------------------ constraints

    @staticmethod
    def _parse_constraints(constraints) -> List[Tuple[Dict[str, float], str,
                                                      float]]:
        """Parse Ax-style linear constraint strings into
        (coefficients, op, bound) triples. Supported forms:
        "a <= 5", "2*a + b <= 5", "a - b >= 0", "a <= b"."""

        def parse_expr(expr: str) -> Tuple[Dict[str, float], float]:
            coeffs: Dict[str, float] = {}
            const = 0.0
            # split into +/- terms, EXCEPT scientific-notation exponents
            # ("1e-3", "2E+2*a"): those are digit/dot + e/E + sign
            for term in re.split(
                r"(?<![0-9.][eE])\+",
                re.sub(r"(?<![0-9.][eE])-", "+-", expr),
            ):
                term = term.strip()
                if not term:
                    continue
                sign = 1.0
                if term.startswith("-"):
                    sign, term = -1.0, term[1:].strip()
                if "*" in term:
                    coef_s, name = term.split("*", 1)
                    coeffs[name.strip()] = (
                        coeffs.get(name.strip(), 0.0) + sign * float(coef_s)
                    )
                else:
                    try:
                        const += sign * float(term)
                    except ValueError:
                        coeffs[term] = coeffs.get(term, 0.0) + sign
            return coeffs, const

        parsed = []
        for c in constraints or []:
            op = "<=" if "<=" in c else ">=" if ">=" in c else None
            if op is None:
                raise ValueError(f"unsupported constraint {c!r} (need "
                                 f"'<=' or '>=')")
            lhs_s, rhs_s = c.split(op, 1)
            lc, lconst = parse_expr(lhs_s)
            rc, rconst = parse_expr(rhs_s)
            coeffs = dict(lc)
            for name, v in rc.items():
                coeffs[name] = coeffs.get(name, 0.0) - v
            parsed.append((coeffs, op, rconst - lconst))
        return parsed

    def _satisfies_constraints(self, params: Dict[str, Any]) -> bool:
        for coeffs, op, bound in self._constraints:
            total = sum(c * float(params[n]) for n, c in coeffs.items())
            if op == "<=" and total > bound + 1e-12:
                return False
            if op == ">=" and total < bound - 1e-12:
                return False
        return True

    def _next_feasible_sobol(self) -> np.ndarray:
        """Next main-stream Sobol draw satisfying the constraints
        (rejection sampling; replayed identically on resume)."""
        u = self._sobol.random(1)[0]
        if not self._constraints:
            return u
        for _ in range(512):
            if self._satisfies_constraints(self._decode_sobol_point(u)):
                return u
            u = self._sobol.random(1)[0]
        self.config.log(
            "WARNING: no constraint-satisfying Sobol point in 512 draws; "
            "using the last draw"
        )
        return u

    # ------------------------------------------------------------------ backend

    def _decode_sobol_point(self, u: np.ndarray) -> Dict[str, Any]:
        params: Dict[str, Any] = {}
        for p in self.search_space:
            if p.get("type") == "fixed":
                params[p["name"]] = p["value"]
        for x, p in zip(u, self._sobol_dims):
            if p["type"] == "range":
                lo, hi = p["bounds"]
                if p.get("log_scale"):
                    value = float(np.exp(
                        np.log(lo) + x * (np.log(hi) - np.log(lo))
                    ))
                else:
                    value = float(lo + x * (hi - lo))
                if p.get("value_type") == "int" or (
                    isinstance(lo, int) and isinstance(hi, int)
                    and p.get("value_type") != "float"
                ):
                    value = int(round(value))
                params[p["name"]] = value
            elif p["type"] == "choice":
                values = p["values"]
                params[p["name"]] = values[
                    min(int(x * len(values)), len(values) - 1)
                ]
            else:
                raise ValueError(f"unsupported parameter type {p['type']}")
        return params

    def _encode_point(self, params: Dict[str, Any]) -> np.ndarray:
        """Inverse of _decode_sobol_point: parameters -> unit cube."""
        u = np.zeros(len(self._sobol_dims))
        for i, p in enumerate(self._sobol_dims):
            v = params[p["name"]]
            if p["type"] == "range":
                lo, hi = p["bounds"]
                if p.get("log_scale"):
                    u[i] = (np.log(v) - np.log(lo)) / max(
                        np.log(hi) - np.log(lo), 1e-12
                    )
                else:
                    u[i] = (v - lo) / max(hi - lo, 1e-12)
            else:  # choice
                values = p["values"]
                u[i] = (values.index(v) + 0.5) / len(values)
        return np.clip(u, 0.0, 1.0)

    def _num_sobol(self) -> int:
        if self.num_sobol_trials < 0:
            return max(self.num_trials // 2, 5)
        return self.num_sobol_trials

    def _gp_ei_point(self) -> Optional[Dict[str, Any]]:
        """One GP+EI arm from the completed trials; None when the model
        cannot be fit yet (falls back to Sobol)."""
        metric = self.config.get("valid.metric")
        X, y = [], []
        for params, result in zip(self.parameters, self.results):
            if result is None or metric not in result:
                continue
            X.append(self._encode_point(params))
            y.append(float(result[metric]))
        if len(X) < 3 or not self._sobol_dims:
            return None
        X = np.asarray(X)
        sign = 1.0 if self.config.get("valid.metric_max") else -1.0
        y = sign * np.asarray(y)
        std = max(float(y.std()), 1e-9)
        yn = (y - y.mean()) / std

        ls = 0.3  # RBF lengthscale on the unit cube

        def kern(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / ls ** 2)

        try:
            L = np.linalg.cholesky(
                kern(X, X) + 1e-6 * np.eye(len(X))
            )
        except np.linalg.LinAlgError:
            return None
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        from scipy.stats import norm, qmc

        pool = qmc.Sobol(
            d=len(self._sobol_dims), scramble=True,
            seed=self.sobol_seed + 1,
        ).random(256)
        Ks = kern(pool, X)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.maximum(1.0 - (v ** 2).sum(0), 1e-12)
        sd = np.sqrt(var)
        z = (mu - yn.max() - 0.01) / sd
        ei = sd * (z * norm.cdf(z) + norm.pdf(z))
        # never re-propose an already-evaluated point
        dup = (np.abs(pool[:, None, :] - X[None, :, :]).max(-1) < 1e-9)
        ei[dup.any(1)] = -np.inf
        if self._constraints:
            feasible = np.array([
                self._satisfies_constraints(self._decode_sobol_point(p))
                for p in pool
            ])
            ei[~feasible] = -np.inf
            if not feasible.any():
                return None  # fall back to the quasi-random stream
        return self._decode_sobol_point(pool[int(np.argmax(ei))])

    def _fallback_point(self, trial_id: int) -> np.ndarray:
        """Quasi-random point for a GP-phase trial whose GP cannot fit
        yet. Drawn from a SEPARATE stream positioned by trial id, so the
        main Sobol stream stays exactly num_sobol draws long and resume
        (which fast-forwards by min(done, num_sobol)) regenerates the
        same arms no matter how many fallbacks occurred pre-crash."""
        from scipy.stats import qmc

        s = qmc.Sobol(
            d=max(len(self._sobol_dims), 1), scramble=True,
            seed=self.sobol_seed + 2,
        )
        if not self._constraints:
            if trial_id:
                s.fast_forward(trial_id)
            return s.random(1)[0]
        # constrained: draw a fixed-size block positioned by trial id and
        # take the first feasible point (position-independent, so resume
        # regenerates the same arm regardless of other trials)
        block = 64
        if trial_id:
            s.fast_forward(trial_id * block)
        draws = s.random(block)
        for u in draws:
            if self._satisfies_constraints(self._decode_sobol_point(u)):
                return u
        self.config.log(
            "WARNING: no constraint-satisfying fallback point in "
            f"{block} draws; using the first"
        )
        return draws[0]

    def register_trial(self, parameters=None):
        if self._generated >= self.num_trials:
            return None, None
        if HAVE_AX and self.ax_client is not None:
            parameters, trial_id = self.ax_client.get_next_trial()
            self._generated += 1
            return parameters, trial_id
        trial_id = self._generated
        if trial_id >= self._num_sobol():
            point = self._gp_ei_point()
            self._generated += 1
            if point is not None:
                return point, trial_id
            return self._decode_sobol_point(
                self._fallback_point(trial_id)
            ), trial_id
        u = self._next_feasible_sobol()
        self._generated += 1
        return self._decode_sobol_point(u), trial_id

    def register_trial_result(self, trial_id, parameters, trace_entry):
        if HAVE_AX and self.ax_client is not None:
            metric_name = self.config.get("valid.metric")
            if trace_entry is None or metric_name not in trace_entry:
                self.ax_client.log_trial_failure(trial_index=trial_id)
            else:
                self.ax_client.complete_trial(
                    trial_index=trial_id,
                    raw_data=float(trace_entry[metric_name]),
                )

    def get_best_parameters(self):
        if HAVE_AX and self.ax_client is not None:
            return self.ax_client.get_best_parameters()
        return None

    def resume(self):
        super().resume()
        if not len(self.parameters):
            return
        # regenerate already-used arms so the sequence continues
        # deterministically (reference: kge/job/search_ax.py:71-92)
        if HAVE_AX and self.ax_client is not None:
            metric_name = self.config.get("valid.metric")
            for i, result in enumerate(self.results):
                # fixed sobol seed: regenerated arm i gets trial id i;
                # the stored parameters stay the source of truth for the
                # trial's config (reference caveat: GP+EI arms do not
                # regenerate identically, ids still align)
                _, trial_id = self.ax_client.get_next_trial()
                if result is not None and metric_name in result:
                    self.ax_client.complete_trial(
                        trial_index=trial_id,
                        raw_data=float(result[metric_name]),
                    )
                # result None: deliberately left RUNNING — the main loop
                # re-runs exactly these trials and resolves each via
                # register_trial_result (complete or log_trial_failure);
                # failing them here would break that re-registration
            self._generated = len(self.parameters)
        elif self._sobol is not None:
            # only the first _num_sobol() arms consumed Sobol draws; the
            # GP phase refits from the restored results deterministically
            n = min(len(self.parameters), self._num_sobol())
            if self._constraints:
                # replay the identical rejection process so the stream
                # lands exactly where the crashed run left it
                for _ in range(n):
                    self._next_feasible_sobol()
            else:
                self._sobol.fast_forward(n)
            self._generated = len(self.parameters)
