"""Trial schedulers: early stopping and population-based training.

Reference parity: python/ray/tune/schedulers/ — FIFOScheduler
(trial_scheduler.py), AsyncHyperBandScheduler/ASHA (async_hyperband.py),
HyperBandScheduler (hyperband.py), MedianStoppingRule
(median_stopping_rule.py), PopulationBasedTraining (pbt.py). This build
keeps the decision interface (CONTINUE/STOP + PBT's exploit) and drives it
from the TuneController's result-poll loop; a decision reads only the
reported metrics, whatever device the trial trains on.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    """Decision hook invoked on every reported result."""

    def set_metric(self, metric: str, mode: str):
        self._metric = metric
        self._mode = mode

    def _has_metric(self, result: Dict) -> bool:
        m = getattr(self, "_metric", None)
        return m is not None and m in result

    def _score(self, result: Dict) -> float:
        v = float(result[self._metric])
        return v if self._mode == "max" else -v

    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str):
        pass

    # PBT-only hook; (src_trial_id, mutated_config) or None
    def exploit_decision(self, trial_id: str,
                         configs: Dict[str, Dict]) -> Optional[Tuple[str, Dict]]:
        return None


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (reference: trial_scheduler.py)."""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: async_hyperband.py AsyncHyperBandScheduler).

    Rungs at grace_period * reduction_factor^k; a trial reaching a rung
    stops unless its score is in the top 1/reduction_factor of results
    recorded at that rung so far (asynchronous promotion — no waiting for
    the full cohort, the property that makes ASHA scale).
    """

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4, brackets: int = 1):
        self._time_attr = time_attr
        self._max_t = max_t
        self._grace = grace_period
        self._rf = reduction_factor
        if metric:
            self.set_metric(metric, mode or "max")
        # rung milestone -> recorded scores
        self._rungs: Dict[int, List[float]] = {}
        # rung milestone -> trial_ids already recorded there (a trial hits
        # each rung once even when its reports skip the exact milestone).
        self._rung_members: Dict[int, set] = {}
        milestone = grace_period
        self._milestones = []
        while milestone < max_t:
            self._milestones.append(int(milestone))
            milestone *= reduction_factor

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = int(result.get(self._time_attr, 0))
        if t >= self._max_t:
            return STOP
        if not self._has_metric(result):
            # Results missing the metric (warmup reports etc.) pass through
            # rather than crashing the experiment (reference tolerance).
            return CONTINUE
        decision = CONTINUE
        for m in self._milestones:
            # Reference ASHA cuts at t >= milestone (async_hyperband.py):
            # trials whose report cadence skips the exact milestone value
            # still get evaluated, once, at the first report past it.
            members = self._rung_members.setdefault(m, set())
            if t >= m and trial_id not in members:
                members.add(trial_id)
                score = self._score(result)
                rung = self._rungs.setdefault(m, [])
                rung.append(score)
                k = max(1, int(math.ceil(len(rung) / self._rf)))
                top = sorted(rung, reverse=True)[:k]
                if score < top[-1]:
                    decision = STOP
        return decision


class HyperBandScheduler(AsyncHyperBandScheduler):
    """Synchronous HyperBand approximated by ASHA rung logic (reference:
    hyperband.py; the async variant dominates it in practice and shares
    the successive-halving core)."""


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average score falls below the median of
    the other trials' running averages at the same step (reference:
    median_stopping_rule.py)."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 grace_period: int = 1, min_samples_required: int = 3):
        self._time_attr = time_attr
        self._grace = grace_period
        self._min_samples = min_samples_required
        if metric:
            self.set_metric(metric, mode or "max")
        self._running: Dict[str, List[float]] = {}

    def on_result(self, trial_id: str, result: Dict) -> str:
        if not self._has_metric(result):
            return CONTINUE
        t = int(result.get(self._time_attr, 0))
        scores = self._running.setdefault(trial_id, [])
        scores.append(self._score(result))
        if t < self._grace:
            return CONTINUE
        others = [sum(v) / len(v) for k, v in self._running.items()
                  if k != trial_id and v]
        if len(others) < self._min_samples:
            return CONTINUE
        median = sorted(others)[len(others) // 2]
        mine = sum(scores) / len(scores)
        return STOP if mine < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: pbt.py PopulationBasedTraining): every
    perturbation_interval steps, a bottom-quantile trial clones the
    checkpoint of a top-quantile trial and continues with mutated
    hyperparameters."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self._time_attr = time_attr
        self._interval = perturbation_interval
        self._mutations = hyperparam_mutations or {}
        self._quantile = quantile_fraction
        self._resample_p = resample_probability
        self._rng = random.Random(seed)
        if metric:
            self.set_metric(metric, mode or "max")
        self._last_perturb: Dict[str, int] = {}
        self._latest: Dict[str, float] = {}

    def on_result(self, trial_id: str, result: Dict) -> str:
        if self._has_metric(result):
            self._latest[trial_id] = self._score(result)
        return CONTINUE

    def should_perturb(self, trial_id: str, result: Dict) -> bool:
        t = int(result.get(self._time_attr, 0))
        last = self._last_perturb.get(trial_id, 0)
        if t - last >= self._interval:
            self._last_perturb[trial_id] = t
            return True
        return False

    def exploit_decision(self, trial_id: str,
                         configs: Dict[str, Dict]) -> Optional[Tuple[str, Dict]]:
        """If `trial_id` is bottom-quantile, pick a top-quantile source and
        a mutated clone of its config (reference: pbt.py _exploit)."""
        if len(self._latest) < 2:
            return None
        ranked = sorted(self._latest.items(), key=lambda kv: kv[1])
        n = len(ranked)
        k = max(1, int(n * self._quantile))
        bottom = {tid for tid, _ in ranked[:k]}
        top = [tid for tid, _ in ranked[-k:]]
        if trial_id not in bottom:
            return None
        src = self._rng.choice(top)
        if src == trial_id:
            return None
        return src, self._mutate(configs[src])

    def _mutate(self, config: Dict) -> Dict:
        from .search import Domain
        out = dict(config)
        for key, spec in self._mutations.items():
            if self._rng.random() < self._resample_p or key not in out:
                if isinstance(spec, Domain):
                    out[key] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    out[key] = self._rng.choice(spec)
                elif callable(spec):
                    out[key] = spec()
            else:
                cur = out[key]
                if isinstance(cur, (int, float)):
                    factor = self._rng.choice([0.8, 1.2])
                    out[key] = type(cur)(cur * factor)
        return out


class PB2(PopulationBasedTraining):
    """Population-Based Bandits (reference: schedulers/pb2.py PB2:256).

    PBT where the exploit step's new hyperparameters come from a
    GP-bandit instead of random perturbation: a Gaussian process is fit
    to observed (time, hyperparams) -> reward-CHANGE data across the
    population, and the clone's config maximizes UCB over the bounded
    search box. The reference fits a time-varying kernel with GPy; this
    build uses a native numpy RBF-GP with UCB over sampled candidates —
    the same exploit policy without the GPy dependency (offline image).

    hyperparam_bounds: {key: (low, high)} continuous search box (ints
    are detected from the bound types and rounded).
    """

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 seed: Optional[int] = None):
        super().__init__(time_attr=time_attr, metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations=None,
                         quantile_fraction=quantile_fraction, seed=seed)
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds")
        self._bounds = dict(hyperparam_bounds)
        self._keys = sorted(self._bounds)
        # Observations: rows of [t, *config] with y = score delta since
        # the trial's previous observation (the GP models reward
        # CHANGE, pb2_utils in the reference).
        self._X: List[List[float]] = []
        self._y: List[float] = []
        self._prev: Dict[str, Tuple[float, float]] = {}  # tid -> (t, score)

    def exploit_decision(self, trial_id: str,
                         configs: Dict[str, Dict]) -> Optional[Tuple[str, Dict]]:
        decision = super().exploit_decision(trial_id, configs)
        if decision is not None:
            # The clone resumes from the SOURCE's checkpoint: the score
            # jump across the boundary is inheritance, not this
            # config's reward change — it must not train the GP.
            self._prev.pop(trial_id, None)
        return decision

    # Controller hook: result + the trial's CURRENT config.
    def observe(self, trial_id: str, result: Dict, config: Dict):
        if not self._has_metric(result):
            return
        t = float(result.get(self._time_attr, 0))
        score = self._score(result)
        prev = self._prev.get(trial_id)
        self._prev[trial_id] = (t, score)
        if prev is None or t <= prev[0]:
            return
        dy = (score - prev[1]) / (t - prev[0])
        row = [t] + [float(config.get(k, self._bounds[k][0]))
                     for k in self._keys]
        self._X.append(row)
        self._y.append(dy)
        if len(self._X) > 512:  # sliding window: old dynamics go stale
            self._X.pop(0)
            self._y.pop(0)

    def _mutate(self, config: Dict) -> Dict:
        """GP-UCB selection replaces random perturbation."""
        import numpy as np
        out = dict(config)
        if len(self._y) < 4:
            # Cold start: uniform sample inside the box.
            for k in self._keys:
                lo, hi = self._bounds[k]
                v = self._rng.uniform(float(lo), float(hi))
                out[k] = self._cast(k, v)
            return out
        X = np.asarray(self._X, dtype=np.float64)
        y = np.asarray(self._y, dtype=np.float64)
        # Normalize to the unit box (t included).
        lo = X.min(axis=0)
        span = np.maximum(X.max(axis=0) - lo, 1e-9)
        Xn = (X - lo) / span
        ystd = y.std() or 1.0
        yn = (y - y.mean()) / ystd
        # RBF GP posterior.
        ell, noise = 0.3, 1e-3
        d2 = ((Xn[:, None, :] - Xn[None, :, :]) ** 2).sum(-1)
        K = np.exp(-d2 / (2 * ell * ell)) + noise * np.eye(len(Xn))
        try:
            L = np.linalg.cholesky(K)
            alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        except np.linalg.LinAlgError:
            return super()._mutate(config)
        t_now = Xn[:, 0].max()
        n_cand = 256
        cand = np.empty((n_cand, X.shape[1]))
        cand[:, 0] = t_now
        rng = np.random.default_rng(self._rng.randrange(2 ** 31))
        cand[:, 1:] = rng.uniform(0.0, 1.0, size=(n_cand, len(self._keys)))
        d2c = ((cand[:, None, :] - Xn[None, :, :]) ** 2).sum(-1)
        Kc = np.exp(-d2c / (2 * ell * ell))
        mu = Kc @ alpha
        v = np.linalg.solve(L, Kc.T)
        var = np.maximum(1.0 - (v * v).sum(axis=0), 1e-12)
        ucb = mu + 1.0 * np.sqrt(var)
        best = cand[int(ucb.argmax())]
        for i, k in enumerate(self._keys):
            blo, bhi = self._bounds[k]
            val = float(lo[i + 1] + best[i + 1] * span[i + 1])
            val = min(max(val, float(blo)), float(bhi))
            out[k] = self._cast(k, val)
        return out

    def _cast(self, key: str, val: float):
        lo, hi = self._bounds[key]
        if isinstance(lo, int) and isinstance(hi, int):
            return int(round(val))
        return float(val)


class HyperBandForBOHB(AsyncHyperBandScheduler):
    """BOHB's bracket scheduler (reference: schedulers/hb_bohb.py).

    The reference pairs synchronous HyperBand brackets with the TuneBOHB
    searcher; this build keeps the successive-halving rung core (shared
    with ASHA — the async promotion rule, which BOHB's own authors note
    performs comparably) and feeds every rung-crossing observation to a
    paired TuneBOHB searcher so its model trains on intermediate
    budgets, not just final results."""

    def __init__(self, *args, searcher=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._paired_searcher = searcher

    def pair_with(self, searcher):
        self._paired_searcher = searcher

    def observe(self, trial_id: str, result: Dict, config: Dict):
        s = self._paired_searcher
        if s is not None and self._has_metric(result):
            budget = int(result.get(self._time_attr, 0))
            s.observe_budget(config, self._score(result), budget)


class ResourceChangingScheduler(TrialScheduler):
    """Reallocate trial resources mid-experiment (reference:
    schedulers/resource_changing_scheduler.py:592).

    Wraps a base scheduler (decisions delegate to it) and, at every
    reallocation interval, asks `resources_allocation_function(
    cluster_resources, trial_id, result, trial_resources_map)` for the
    trial's new resource dict. A change restarts the trial FROM ITS
    CHECKPOINT with the new allocation — the controller owns the
    restart, exactly like a PBT exploit."""

    def __init__(self, base_scheduler: Optional[TrialScheduler] = None,
                 resources_allocation_function=None,
                 reallocation_interval: int = 2,
                 time_attr: str = "training_iteration"):
        self._base = base_scheduler or FIFOScheduler()
        self._alloc = (resources_allocation_function
                       or evenly_distribute_cpus)
        self._interval = reallocation_interval
        self._time_attr = time_attr
        self._last_realloc: Dict[str, int] = {}

    def set_metric(self, metric: str, mode: str):
        super().set_metric(metric, mode)
        self._base.set_metric(metric, mode)

    def on_result(self, trial_id: str, result: Dict) -> str:
        return self._base.on_result(trial_id, result)

    def on_trial_complete(self, trial_id: str):
        self._base.on_trial_complete(trial_id)

    # Full delegation so wrapping PBT/PB2/BOHB keeps their behavior
    # (the controller unwraps via `base_scheduler` for isinstance
    # checks; these forward the per-result hooks).
    @property
    def base_scheduler(self) -> TrialScheduler:
        return self._base

    def exploit_decision(self, trial_id: str, configs: Dict[str, Dict]):
        return self._base.exploit_decision(trial_id, configs)

    def should_perturb(self, trial_id: str, result: Dict) -> bool:
        fn = getattr(self._base, "should_perturb", None)
        return bool(fn(trial_id, result)) if fn is not None else False

    def observe(self, trial_id: str, result: Dict, config: Dict):
        fn = getattr(self._base, "observe", None)
        if fn is not None:
            fn(trial_id, result, config)

    def reallocate_decision(self, trial_id: str, result: Dict,
                            cluster_resources: Dict[str, float],
                            trial_resources: Dict[str, Dict[str, float]]
                            ) -> Optional[Dict[str, float]]:
        """New resources for `trial_id`, or None to keep the current
        allocation. Rate-limited by reallocation_interval."""
        t = int(result.get(self._time_attr, 0))
        last = self._last_realloc.get(trial_id, 0)
        if t - last < self._interval:
            return None
        self._last_realloc[trial_id] = t
        new = self._alloc(cluster_resources, trial_id, result,
                          trial_resources)
        if new is None or new == trial_resources.get(trial_id):
            return None
        return new


def evenly_distribute_cpus(cluster_resources: Dict[str, float],
                           trial_id: str, result: Dict,
                           trial_resources: Dict[str, Dict[str, float]]
                           ) -> Optional[Dict[str, float]]:
    """Default allocation policy (reference: DistributeResources in
    resource_changing_scheduler.py): split the cluster's CPUs evenly
    over live trials, so finished trials' capacity flows to survivors."""
    n = max(1, len(trial_resources))
    total = int(cluster_resources.get("CPU", 1))
    share = max(1, total // n)
    cur = dict(trial_resources.get(trial_id) or {})
    if cur.get("CPU") == share:
        return None
    cur["CPU"] = share
    return cur
