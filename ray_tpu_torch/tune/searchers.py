"""Search algorithms: sequential config suggestion.

Reference parity: python/ray/tune/search/ — the `Searcher` interface
(search/searcher.py: suggest/on_trial_complete), `ConcurrencyLimiter`
(search/concurrency_limiter.py), and the adapter family (hyperopt, optuna,
ax, bohb, hebo, nevergrad, zoopt). Here: a native numpy TPE (the algorithm
hyperopt implements) plus a random searcher, and gated adapters that raise
informative errors when the optional backend package is absent — none are
baked into this image.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .search import (Choice, Domain, LogUniform, QRandInt, QUniform,
                     RandInt, SampleFrom, Uniform, _flatten_space,
                     _is_grid, _unflatten)


class Searcher:
    """Reference: tune/search/searcher.py Searcher."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self._metric = metric
        self._mode = mode
        self._space: Dict[str, Any] = {}

    def set_search_properties(self, metric: Optional[str], mode: str,
                              space: Dict[str, Any]) -> bool:
        if metric:
            self._metric = metric
        if mode:
            self._mode = mode
        self._space = _flatten_space(space)
        for k, v in self._space.items():
            if _is_grid(v) or isinstance(v, SampleFrom):
                raise ValueError(
                    f"Searchers accept Domain spaces only; key {k!r} uses "
                    "grid_search/sample_from (use the default "
                    "BasicVariantGenerator for those)")
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict] = None,
                          error: bool = False) -> None:
        pass

    # -- helpers -----------------------------------------------------------
    def _score(self, result: Optional[Dict]) -> Optional[float]:
        if not result or self._metric not in result:
            return None
        v = float(result[self._metric])
        return v if self._mode == "max" else -v


class ConcurrencyLimiter(Searcher):
    """Reference: tune/search/concurrency_limiter.py — caps in-flight
    suggestions so sequential model-based searchers see results before
    proposing too far ahead."""

    def __init__(self, searcher: Searcher, max_concurrent: int = 4):
        super().__init__(searcher._metric, searcher._mode)
        self.searcher = searcher
        self.max_concurrent = max(1, int(max_concurrent))
        self._live: set = set()

    def set_search_properties(self, metric, mode, space) -> bool:
        super().set_search_properties(metric, mode, space)
        return self.searcher.set_search_properties(metric, mode, space)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._live) >= self.max_concurrent:
            return None  # backpressure: try again after a completion
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)


class RandomSearch(Searcher):
    """Prior sampling (reference: the random fallbacks in searchers)."""

    def __init__(self, metric=None, mode="max", seed: Optional[int] = None):
        super().__init__(metric, mode)
        self._rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        cfg = {k: (v.sample(self._rng) if isinstance(v, Domain) else v)
               for k, v in self._space.items()}
        return _unflatten(cfg)


def _to_unit(domain: Domain, value: Any) -> Optional[float]:
    """Map a sampled value into [0, 1] for density modeling; None for
    categorical domains (handled by counting)."""
    if isinstance(domain, LogUniform):
        lo, hi = math.log(domain.lower), math.log(domain.upper)
        return (math.log(value) - lo) / (hi - lo)
    if isinstance(domain, (Uniform, QUniform)):
        return (value - domain.lower) / (domain.upper - domain.lower)
    if isinstance(domain, (RandInt, QRandInt)):
        span = max(1, domain.upper - domain.lower)
        return (value - domain.lower) / span
    return None


def _from_unit(domain: Domain, u: float) -> Any:
    u = min(1.0, max(0.0, u))
    if isinstance(domain, LogUniform):
        lo, hi = math.log(domain.lower), math.log(domain.upper)
        return math.exp(lo + u * (hi - lo))
    if isinstance(domain, QUniform):
        v = domain.lower + u * (domain.upper - domain.lower)
        # q-rounding can land outside [lower, upper] — clamp like
        # Domain.sample() does.
        return min(domain.upper,
                   max(domain.lower, round(v / domain.q) * domain.q))
    if isinstance(domain, Uniform):
        return domain.lower + u * (domain.upper - domain.lower)
    if isinstance(domain, QRandInt):
        v = domain.lower + u * max(1, domain.upper - domain.lower)
        return int(min(domain.upper,
                       max(domain.lower,
                           round(v / domain.q) * domain.q)))
    if isinstance(domain, RandInt):
        return int(min(domain.upper - 1,
                       domain.lower + u * (domain.upper - domain.lower)))
    raise TypeError(f"unsupported domain {type(domain)}")


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator, numpy-native (the algorithm
    behind the reference's HyperOptSearch, tune/search/hyperopt/).

    Completed trials split into good (top `gamma` quantile) and rest;
    numeric dims model each group with a Gaussian KDE in unit space and
    propose the candidate maximizing l(x)/g(x); categorical dims use
    smoothed count ratios. Until `n_startup` results arrive, suggestions
    are prior samples.
    """

    def __init__(self, metric=None, mode="max", seed: Optional[int] = None,
                 gamma: float = 0.25, n_startup: int = 8,
                 n_candidates: int = 64, exploration_ratio: float = 0.15):
        super().__init__(metric, mode)
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self.gamma = gamma
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        # Fraction of post-startup suggestions drawn from the prior:
        # factorized TPE can pin a dimension to an early cluster (the
        # classic small-budget pathology); periodic prior draws give every
        # dim a chance to escape.
        self.exploration_ratio = exploration_ratio
        self._live: Dict[str, Dict[str, Any]] = {}
        self._history: List[Tuple[Dict[str, Any], float]] = []

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if (len(self._history) < self.n_startup
                or self._np_rng.random() < self.exploration_ratio):
            flat = self._prior_sample()
        else:
            flat = self._tpe_sample()
        self._live[trial_id] = flat
        return _unflatten(dict(flat))

    def on_trial_complete(self, trial_id, result=None, error=False):
        flat = self._live.pop(trial_id, None)
        score = self._score(result)
        if flat is not None and score is not None and not error:
            self._history.append((flat, score))

    # -- sampling ----------------------------------------------------------
    def _prior_sample(self) -> Dict[str, Any]:
        return {k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                for k, v in self._space.items()}

    def _split(self):
        ranked = sorted(self._history, key=lambda t: -t[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        return ranked[:n_good], ranked[n_good:]

    @staticmethod
    def _bandwidth(samples: np.ndarray) -> float:
        """Scott's-rule bandwidth over unit space, floored so a tight
        cluster still explores its neighborhood."""
        if len(samples) < 2:
            return 0.25
        return float(np.clip(samples.std() * len(samples) ** (-0.2),
                             0.05, 0.5))

    @classmethod
    def _kde_logpdf(cls, xs: np.ndarray, samples: np.ndarray) -> np.ndarray:
        """Parzen mixture density in unit space INCLUDING a uniform prior
        component with weight 1/(n+1) — the detail that keeps TPE from
        collapsing onto its first good cluster (hyperopt mixes the prior
        into l(x) the same way)."""
        if len(samples) == 0:
            return np.zeros(len(xs))
        bw = cls._bandwidth(samples)
        d = (xs[:, None] - samples[None, :]) / bw
        comp = np.exp(-0.5 * d * d) / (bw * math.sqrt(2 * math.pi))
        dens = (comp.sum(axis=1) + 1.0) / (len(samples) + 1)
        return np.log(dens + 1e-12)

    def _tpe_sample(self) -> Dict[str, Any]:
        good, bad = self._split()
        out: Dict[str, Any] = {}
        for key, domain in self._space.items():
            if not isinstance(domain, Domain):
                out[key] = domain
                continue
            if isinstance(domain, Choice):
                out[key] = self._tpe_categorical(key, domain, good, bad)
                continue
            g = np.array([u for cfg, _ in good
                          if (u := _to_unit(domain, cfg[key])) is not None])
            b = np.array([u for cfg, _ in bad
                          if (u := _to_unit(domain, cfg[key])) is not None])
            # TPE proper: candidates drawn FROM l(x) — the good-points
            # Parzen mixture whose components include the uniform prior
            # (index n == prior draw) — scored by the ratio l(x)/g(x).
            cand = self._np_rng.random(self.n_candidates)
            if len(g):
                bw = self._bandwidth(g)
                pick = self._np_rng.integers(0, len(g) + 1,
                                             size=self.n_candidates)
                local = pick < len(g)
                cand[local] = np.clip(
                    g[pick[local]]
                    + self._np_rng.normal(0, bw, size=int(local.sum())),
                    0, 1)
            ratio = self._kde_logpdf(cand, g) - self._kde_logpdf(cand, b)
            out[key] = _from_unit(domain, float(cand[np.argmax(ratio)]))
        return out

    def _tpe_categorical(self, key: str, domain: Choice, good, bad):
        cats = list(domain.categories)
        idx = {self._cat_key(c): i for i, c in enumerate(cats)}

        def counts(group):
            c = np.ones(len(cats))  # +1 smoothing
            for cfg, _ in group:
                i = idx.get(self._cat_key(cfg[key]))
                if i is not None:
                    c[i] += 1
            return c / c.sum()

        ratio = counts(good) / counts(bad)
        return cats[int(np.argmax(ratio))]

    @staticmethod
    def _cat_key(v):
        try:
            hash(v)
            return v
        except TypeError:
            return repr(v)


class TuneBOHB(TPESearcher):
    """BOHB's model-based searcher, native (reference:
    tune/search/bohb/bohb_search.py TuneBOHB, which wraps hpbandster —
    unavailable offline; BOHB's config model IS a TPE-family KDE, so
    this build extends the native TPESearcher with budget-aware
    observations).

    Pair with `HyperBandForBOHB(..., searcher=this)`: every rung
    crossing feeds `observe_budget`, and the model trains on the
    HIGHEST budget that has at least `min_points` observations —
    BOHB's multi-fidelity rule — instead of waiting for final results
    only."""

    def __init__(self, *args, min_points: int = 6, **kwargs):
        super().__init__(*args, **kwargs)
        self._min_points = min_points
        # budget -> [(flat_config, score)]
        self._by_budget: Dict[int, List[Tuple[Dict, float]]] = {}

    def observe_budget(self, config: Dict, score: float, budget: int):
        # Key by the SPACE's flat keys (not naive recursion): a
        # dict-valued categorical choice must stay one value, or the
        # model's cfg[key] lookups KeyError for spaces the base
        # searcher supports.
        from .search import _SEP
        flat: Dict[str, Any] = {}
        for k in self._space:
            v: Any = config
            ok = True
            for part in k.split(_SEP):
                if isinstance(v, dict) and part in v:
                    v = v[part]
                else:
                    ok = False
                    break
            if ok:
                flat[k] = v
        if flat:
            self._by_budget.setdefault(int(budget), []).append(
                (flat, score))

    def _split(self):
        # Highest budget with enough points wins (BOHB's model choice);
        # final-result history is the floor.
        pool = self._history
        for budget in sorted(self._by_budget, reverse=True):
            obs = self._by_budget[budget]
            if len(obs) >= self._min_points:
                pool = obs
                break
        ranked = sorted(pool, key=lambda t: -t[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        return ranked[:n_good], ranked[n_good:]

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        have_model = (len(self._history) >= self.n_startup
                      or any(len(v) >= self._min_points
                             for v in self._by_budget.values()))
        if not have_model or self._np_rng.random() < self.exploration_ratio:
            flat = self._prior_sample()
        else:
            flat = self._tpe_sample()
        self._live[trial_id] = flat
        return _unflatten(dict(flat))


def _missing_backend(name: str, pip_name: str):
    class _Missing:
        def __init__(self, *a, **kw):
            raise ImportError(
                f"{name} requires the `{pip_name}` package, which is not "
                f"installed in this environment. Use TPESearcher (native "
                f"TPE) or RandomSearch instead.")
    _Missing.__name__ = name
    return _Missing


# Reference adapter surface (tune/search/{hyperopt,optuna,ax,bohb,...}).
# hyperopt's algorithm (and optuna's default sampler) IS TPE, so the
# native TPESearcher serves as the drop-in regardless of whether the
# backend package is installed. The others have no native equivalent and
# gate with a clear error.
HyperOptSearch = TPESearcher
OptunaSearch = TPESearcher
AxSearch = _missing_backend("AxSearch", "ax-platform")
# TuneBOHB: native implementation above (was an hpbandster stub).
NevergradSearch = _missing_backend("NevergradSearch", "nevergrad")
ZOOptSearch = _missing_backend("ZOOptSearch", "zoopt")
HEBOSearch = _missing_backend("HEBOSearch", "HEBO")
