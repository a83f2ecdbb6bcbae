"""Replay buffers (reference: rllib/utils/replay_buffers/ —
ReplayBuffer uniform sampling; prioritized_replay_buffer.py
PrioritizedReplayBuffer with sum-tree proportional sampling +
importance weights)."""
from typing import Dict, List, Optional

import numpy as np


class ReplayBuffer:
    """Uniform FIFO transition buffer (columnar storage)."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(next(iter(batch.values())))
        if not self._cols:
            for k, v in batch.items():
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
        for i in range(n):
            for k, v in batch.items():
                self._cols[k][self._next] = v[i]
            self._next = (self._next + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._cols.items()}


class _SumTree:
    """Binary indexed sum-tree over leaf priorities: O(log n) updates,
    vectorized proportional prefix-sum sampling (reference: the segment
    tree under rllib's PrioritizedReplayBuffer)."""

    def __init__(self, capacity: int):
        base = 1
        while base < capacity:
            base *= 2
        self.base = base
        self.tree = np.zeros(2 * base, np.float64)

    def set_many(self, idxs: np.ndarray, vals: np.ndarray):
        if len(idxs) == 0:
            return
        pos = self.base + np.asarray(idxs, np.int64)
        self.tree[pos] = vals
        parents = np.unique(pos >> 1)
        while parents[0] >= 1:
            self.tree[parents] = (self.tree[2 * parents]
                                  + self.tree[2 * parents + 1])
            if parents[0] == 1:
                break
            parents = np.unique(parents >> 1)

    @property
    def total(self) -> float:
        return float(self.tree[1])

    def sample_leaves(self, prefix: np.ndarray) -> np.ndarray:
        """Leaf index per prefix sum (all walks proceed level-locked,
        so the loop is log2(base) vectorized steps)."""
        idx = np.ones(len(prefix), np.int64)
        prefix = prefix.astype(np.float64).copy()
        while idx[0] < self.base:
            left = self.tree[2 * idx]
            go_right = prefix > left
            prefix -= left * go_right
            idx = 2 * idx + go_right
        return idx - self.base


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    rllib/utils/replay_buffers/prioritized_replay_buffer.py):
    P(i) ∝ p_i^alpha, importance weights w_i = (N * P(i))^-beta
    normalized by max w. New transitions enter at the current max
    priority; `update_priorities` feeds TD errors back after each
    learner step."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 seed: int = 0, eps: float = 1e-6):
        super().__init__(capacity, seed)
        if alpha < 0:
            raise ValueError("alpha must be >= 0")
        self.alpha = float(alpha)
        self.eps = float(eps)
        self._tree = _SumTree(capacity)
        self._max_priority = 1.0

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(next(iter(batch.values())))
        start = self._next
        super().add_batch(batch)
        idxs = (start + np.arange(n)) % self.capacity
        self._tree.set_many(
            idxs, np.full(n, self._max_priority ** self.alpha))

    def sample(self, batch_size: int,
               beta: float = 0.4) -> Dict[str, np.ndarray]:
        total = self._tree.total
        if total <= 0:
            return super().sample(batch_size)
        # Stratified prefix sums (reference: one draw per segment keeps
        # coverage across the priority range).
        seg = total / batch_size
        prefix = (np.arange(batch_size) + self._rng.random(batch_size)
                  ) * seg
        idx = self._tree.sample_leaves(np.minimum(prefix, total * (1 -
                                                                   1e-12)))
        idx = np.minimum(idx, self._size - 1)
        probs = self._tree.tree[self._tree.base + idx] / total
        weights = (self._size * np.maximum(probs, 1e-12)) ** -beta
        weights /= weights.max()
        out = {k: v[idx] for k, v in self._cols.items()}
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx.astype(np.int64)
        return out

    def update_priorities(self, indexes: np.ndarray,
                          priorities: np.ndarray):
        if len(indexes) == 0:
            return
        p = np.abs(np.asarray(priorities, np.float64)) + self.eps
        self._max_priority = max(self._max_priority, float(p.max()))
        self._tree.set_many(np.asarray(indexes, np.int64),
                            p ** self.alpha)
