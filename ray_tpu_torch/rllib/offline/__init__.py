"""Offline RL: experience IO + off-policy estimation.

Reference parity: rllib/offline/ — dataset_writer.py/dataset_reader.py
(experiences as Ray Data datasets / JSON-parquet files), io_context.py,
and is_estimator.py (importance-sampling off-policy evaluation). Here
experiences are ray_tpu_torch.data Datasets of transition rows, written from
env-runner sample fragments and read back as shuffled training batches.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

__all__ = ["SampleWriter", "DatasetReader",
           "ImportanceSamplingEstimator",
           "WeightedImportanceSamplingEstimator",
           "DirectMethodEstimator", "DoublyRobustEstimator",
           "rows_from_fragments"]

_COLUMNS = ("obs", "actions", "rewards", "terminateds", "truncateds",
            "next_obs", "action_logp")


def rows_from_fragments(fragments: List[Dict[str, np.ndarray]]
                        ) -> List[Dict]:
    """Columnar sample fragments -> per-transition rows.

    A fragment's final row is marked truncated if the episode didn't
    end there: the recorded trajectory stops at the fragment boundary,
    and with multiple runners the next row belongs to an unrelated
    episode — return computations must not bleed across it (the
    reference's SampleBatch marks fragment cuts the same way)."""
    rows = []
    for frag in fragments:
        n = len(frag["rewards"])
        keys = [k for k in _COLUMNS if k in frag]
        for i in range(n):
            row = {k: frag[k][i] for k in keys}
            if i == n - 1 and not (bool(row.get("terminateds"))
                                   or bool(row.get("truncateds"))):
                row["truncateds"] = np.bool_(True)
            rows.append(row)
    return rows


class SampleWriter:
    """Accumulate rollout fragments; materialize as a Dataset or parquet
    (reference: dataset_writer.py)."""

    def __init__(self):
        self._fragments: List[Dict[str, np.ndarray]] = []

    def write(self, fragment: Dict[str, np.ndarray]) -> None:
        self._fragments.append(fragment)

    def __len__(self) -> int:
        return sum(len(f["rewards"]) for f in self._fragments)

    def to_dataset(self):
        import ray_tpu_torch.data as rd

        return rd.from_items(rows_from_fragments(self._fragments))

    def write_parquet(self, path: str) -> List[str]:
        return self.to_dataset().write_parquet(path)


class DatasetReader:
    """Shuffled minibatches from an experience Dataset (reference:
    dataset_reader.py get_dataset_and_shards + batch iteration).

    `compute_returns=gamma` adds a `value_targets` column of per-episode
    Monte-Carlo returns BEFORE shuffling — returns are a property of the
    episode-ordered data, so they must be computed here, never on
    shuffled minibatches. A trailing episode cut off by the end of the
    dataset is treated as ending there (documented bias: its targets
    omit the unrecorded future)."""

    def __init__(self, dataset, batch_size: int = 256, seed: int = 0,
                 compute_returns: Optional[float] = None):
        self._rows = [r for r in dataset.iter_rows()]
        self._batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        if compute_returns is not None and self._rows:
            self._add_value_targets(float(compute_returns))

    def _add_value_targets(self, gamma: float) -> None:
        acc = 0.0
        for row in reversed(self._rows):
            done = bool(row.get("terminateds")) or \
                bool(row.get("truncateds"))
            if done:
                acc = 0.0
            acc = float(row["rewards"]) + gamma * acc
            row["value_targets"] = np.float32(acc)

    @classmethod
    def from_parquet(cls, path, **kwargs) -> "DatasetReader":
        import ray_tpu_torch.data as rd

        return cls(rd.read_parquet(path), **kwargs)

    def __len__(self) -> int:
        return len(self._rows)

    def iter_batches(self, epochs: int = 1) -> Iterator[Dict[str,
                                                             np.ndarray]]:
        idx = np.arange(len(self._rows))
        bs = min(self._batch_size, len(idx))
        if bs == 0:
            return
        for _ in range(epochs):
            self._rng.shuffle(idx)
            # A dataset smaller than batch_size still yields one batch.
            for s in range(0, max(len(idx) - bs + 1, 1), bs):
                chunk = [self._rows[i] for i in idx[s:s + bs]]
                yield {k: np.asarray([r[k] for r in chunk])
                       for k in chunk[0]}


class ImportanceSamplingEstimator:
    """Off-policy evaluation via per-episode importance weighting
    (reference: offline/estimators is_estimator.py — OPE of a target
    policy's return from behavior-policy data)."""

    def __init__(self, gamma: float = 0.99, clip_weight: float = 20.0):
        self.gamma = gamma
        self.clip = clip_weight

    def estimate(self, fragments: List[Dict[str, np.ndarray]],
                 target_logp_fn) -> Dict[str, float]:
        """fragments must carry `action_logp` (behavior);
        target_logp_fn(obs, actions) -> target policy log-probs."""
        returns = []
        for frag in fragments:
            t_logp = np.asarray(
                target_logp_fn(frag["obs"], frag["actions"]))
            b_logp = np.asarray(frag["action_logp"])
            # Complete episodes plus (uniformly) the trailing partial
            # one, if any (_episode_bounds — shared with WIS/DM/DR so
            # the segmentation rule cannot drift between estimators).
            for start, end in _episode_bounds(frag):
                w = float(np.exp(np.clip(
                    np.sum(t_logp[start:end] - b_logp[start:end]),
                    -np.log(self.clip), np.log(self.clip))))
                disc = self.gamma ** np.arange(end - start)
                returns.append(
                    w * float(np.sum(frag["rewards"][start:end] * disc)))
        if not returns:
            return {"v_target": float("nan"), "episodes": 0}
        return {"v_target": float(np.mean(returns)),
                "episodes": len(returns)}


def _episode_bounds(frag: Dict[str, np.ndarray]):
    done = np.logical_or(
        frag["terminateds"],
        frag.get("truncateds", np.zeros_like(frag["terminateds"])))
    ends = list(np.nonzero(done)[0] + 1)
    n = len(frag["rewards"])
    if not ends or ends[-1] < n:
        ends.append(n)
    start = 0
    for end in ends:
        yield start, end
        start = end


class WeightedImportanceSamplingEstimator(ImportanceSamplingEstimator):
    """WIS (reference: offline/estimators/weighted_importance_sampling
    .py): per-episode IS weights normalized by their mean — biased but
    far lower variance than ordinary IS."""

    def estimate(self, fragments, target_logp_fn) -> Dict[str, float]:
        weights, raw_returns = [], []
        for frag in fragments:
            t_logp = np.asarray(
                target_logp_fn(frag["obs"], frag["actions"]))
            b_logp = np.asarray(frag["action_logp"])
            for start, end in _episode_bounds(frag):
                w = float(np.exp(np.clip(
                    np.sum(t_logp[start:end] - b_logp[start:end]),
                    -np.log(self.clip), np.log(self.clip))))
                disc = self.gamma ** np.arange(end - start)
                weights.append(w)
                raw_returns.append(
                    float(np.sum(frag["rewards"][start:end] * disc)))
        if not weights:
            return {"v_target": float("nan"), "episodes": 0}
        w = np.asarray(weights)
        r = np.asarray(raw_returns)
        return {"v_target": float(np.sum(w * r) / max(np.sum(w), 1e-12)),
                "episodes": len(w)}


class DirectMethodEstimator:
    """DM (reference: offline/estimators/direct_method.py): fit a
    Q-model on the offline data (fitted Q evaluation) and report the
    model's value of the TARGET policy at episode starts. `q_fn(obs)
    -> per-action Q values` is the fitted model; `target_probs_fn(obs)
    -> per-action target-policy probabilities`."""

    def __init__(self, gamma: float = 0.99):
        self.gamma = gamma

    def estimate(self, fragments, q_fn, target_probs_fn
                 ) -> Dict[str, float]:
        values = []
        for frag in fragments:
            for start, _end in _episode_bounds(frag):
                obs0 = np.asarray(frag["obs"][start:start + 1],
                                  np.float32)
                q = np.asarray(q_fn(obs0))[0]
                p = np.asarray(target_probs_fn(obs0))[0]
                values.append(float(np.sum(p * q)))
        if not values:
            return {"v_target": float("nan"), "episodes": 0}
        return {"v_target": float(np.mean(values)),
                "episodes": len(values)}


class DoublyRobustEstimator(DirectMethodEstimator):
    """DR (reference: offline/estimators/doubly_robust.py): the model
    baseline (DM) plus a stepwise importance-weighted correction of the
    model's residuals — unbiased when EITHER the model or the behavior
    log-probs are right."""

    def __init__(self, gamma: float = 0.99, clip_weight: float = 20.0):
        super().__init__(gamma)
        self.clip = clip_weight

    def estimate(self, fragments, q_fn, target_probs_fn,
                 target_logp_fn=None) -> Dict[str, float]:
        values = []
        for frag in fragments:
            obs = np.asarray(frag["obs"], np.float32)
            acts = np.asarray(frag["actions"]).astype(np.int64)
            q_all = np.asarray(q_fn(obs))
            p_all = np.asarray(target_probs_fn(obs))
            v_model = np.sum(p_all * q_all, axis=-1)
            q_taken = q_all[np.arange(len(acts)), acts]
            if target_logp_fn is not None:
                t_logp = np.asarray(target_logp_fn(frag["obs"],
                                                   frag["actions"]))
            else:
                t_logp = np.log(np.maximum(
                    p_all[np.arange(len(acts)), acts], 1e-12))
            b_logp = np.asarray(frag["action_logp"])
            step_rho = np.exp(np.clip(t_logp - b_logp,
                                      -np.log(self.clip),
                                      np.log(self.clip)))
            for start, end in _episode_bounds(frag):
                # Backward recursion (Jiang & Li 2016): V_DR(t) =
                # v_model(t) + rho_t (r_t + gamma V_DR(t+1) - q(s_t,a_t))
                v_dr = 0.0
                for t in range(end - 1, start - 1, -1):
                    v_dr = v_model[t] + step_rho[t] * (
                        float(frag["rewards"][t])
                        + self.gamma * v_dr - q_taken[t])
                values.append(float(v_dr))
        if not values:
            return {"v_target": float("nan"), "episodes": 0}
        return {"v_target": float(np.mean(values)),
                "episodes": len(values)}


def resolve_offline_reader(config, algo_name: str,
                           compute_returns=None) -> "DatasetReader":
    """Shared `.training(offline_data=...)` resolution for offline
    algorithms (BC/MARWIL/CQL): accept a Dataset or a ready
    DatasetReader, error clearly when absent."""
    reader = config.extra.get("offline_data")
    if reader is None:
        raise ValueError(
            f"{algo_name} needs .training(offline_data="
            f"<Dataset|DatasetReader>)")
    if not isinstance(reader, DatasetReader):
        reader = DatasetReader(reader,
                               batch_size=config.train_batch_size,
                               seed=config.seed,
                               compute_returns=compute_returns)
    return reader
