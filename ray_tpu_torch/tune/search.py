"""Search spaces and trial-variant generation.

Reference parity: python/ray/tune/search/ — sample domains
(tune/search/sample.py: uniform/loguniform/choice/randint/grid_search) and
the default BasicVariantGenerator (tune/search/basic_variant.py), which
expands every ``grid_search`` cartesian-product combination ``num_samples``
times and draws the stochastic domains fresh per trial.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List, Optional


class Domain:
    """A sampleable hyperparameter domain (reference: sample.py Domain)."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.uniform(self.lower, self.upper)


class QUniform(Domain):
    def __init__(self, lower: float, upper: float, q: float):
        self.lower, self.upper, self.q = lower, upper, q

    def sample(self, rng):
        v = rng.uniform(self.lower, self.upper)
        # Clamp: rounding to a q-multiple can land outside [lower, upper].
        return min(self.upper, max(self.lower, round(v / self.q) * self.q))


class LogUniform(Domain):
    def __init__(self, lower: float, upper: float, base: float = 10):
        import math
        self.lower, self.upper, self.base = lower, upper, base
        self._lo = math.log(lower, base)
        self._hi = math.log(upper, base)

    def sample(self, rng):
        return self.base ** rng.uniform(self._lo, self._hi)


class RandInt(Domain):
    """Uniform integer in [lower, upper) (reference semantics)."""

    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class QRandInt(Domain):
    def __init__(self, lower: int, upper: int, q: int):
        self.lower, self.upper, self.q = lower, upper, q

    def sample(self, rng):
        v = rng.randint(self.lower, self.upper)
        return int(min(self.upper,
                       max(self.lower, round(v / self.q) * self.q)))


class Choice(Domain):
    def __init__(self, categories: List[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class SampleFrom(Domain):
    """Callable domain; receives a spec namespace with `.config`
    (reference: sample.py Function / tune.sample_from)."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):  # resolved late, against the partial config
        raise RuntimeError("SampleFrom is resolved against the trial config")


def uniform(lower: float, upper: float) -> Uniform:
    return Uniform(lower, upper)


def quniform(lower: float, upper: float, q: float) -> QUniform:
    return QUniform(lower, upper, q)


def loguniform(lower: float, upper: float, base: float = 10) -> LogUniform:
    return LogUniform(lower, upper, base)


def randint(lower: int, upper: int) -> RandInt:
    return RandInt(lower, upper)


def qrandint(lower: int, upper: int, q: int = 1) -> QRandInt:
    return QRandInt(lower, upper, q)


def choice(categories: List[Any]) -> Choice:
    return Choice(categories)


def sample_from(fn: Callable) -> SampleFrom:
    return SampleFrom(fn)


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    """Marker dict, reference-identical shape (sample.py grid_search)."""
    return {"grid_search": list(values)}


class _Spec:
    """Namespace handed to sample_from callables (spec.config.*)."""

    def __init__(self, config: Dict[str, Any]):
        class _NS:
            pass
        self.config = _NS()
        for k, v in config.items():
            setattr(self.config, k, v)


def _is_grid(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


_SEP = "\x1f"  # internal nesting separator


def _flatten_space(space: Dict[str, Any], prefix: str = ""
                   ) -> Dict[str, Any]:
    """Flatten nested dict spaces to path keys so nested grid_search
    participates in the cartesian product (reference: format_vars /
    resolve_nested_dict in tune/search/variant_generator.py). The internal
    separator is \\x1f, not '/', so user keys containing slashes survive
    the round trip."""
    flat: Dict[str, Any] = {}
    for k, v in space.items():
        if isinstance(v, dict) and not _is_grid(v):
            flat.update(_flatten_space(v, prefix + str(k) + _SEP))
        else:
            flat[prefix + str(k)] = v
    return flat


def _unflatten(cfg: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in cfg.items():
        parts = k.split(_SEP)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: Optional[int] = None) -> List[Dict[str, Any]]:
    """Expand a param space into concrete trial configs
    (reference: BasicVariantGenerator — grid cartesian product ×
    num_samples, random domains re-drawn per variant; nested dicts
    flatten into the product)."""
    rng = random.Random(seed)
    flat_space = _flatten_space(param_space)
    grid_keys = [k for k, v in flat_space.items() if _is_grid(v)]
    grid_values = [flat_space[k]["grid_search"] for k in grid_keys]
    combos = list(itertools.product(*grid_values)) if grid_keys else [()]
    variants = []
    for _ in range(num_samples):
        for combo in combos:
            cfg: Dict[str, Any] = {}
            for k, v in flat_space.items():
                if _is_grid(v):
                    continue
                if isinstance(v, Domain) and not isinstance(v, SampleFrom):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            for k, val in zip(grid_keys, combo):
                cfg[k] = val
            # sample_from last: may reference other (top-level) values
            nested = _unflatten({k: v for k, v in cfg.items()
                                 if not isinstance(v, SampleFrom)})
            for k, v in flat_space.items():
                if isinstance(v, SampleFrom):
                    cfg[k] = v.fn(_Spec(nested))
            variants.append(_unflatten(cfg))
    return variants


class BasicVariantGenerator:
    """Reference: tune/search/basic_variant.py BasicVariantGenerator."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self._variants = generate_variants(param_space, num_samples, seed)
        self._i = 0

    def next_trial_config(self) -> Optional[Dict[str, Any]]:
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg

    def total(self) -> int:
        return len(self._variants)
