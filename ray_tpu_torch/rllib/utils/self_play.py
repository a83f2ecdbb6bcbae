"""League-based self-play (reference: the self-play / league-training
callbacks in rllib/examples/multi_agent/self_play_*.py and the
AlphaStar-style league utilities: a MAIN policy trains against FROZEN
snapshots of its past selves; when it beats the current opponent
reliably, it is snapshotted into the league and a fresh opponent is
drawn).

Works with MultiAgentPPO + `policies_to_train=[main]` (the opponent
module exists but never receives gradients; this manager overwrites its
weights with league snapshots)."""

from __future__ import annotations

import copy
import random
from typing import Any, Dict, List, Optional

__all__ = ["SelfPlayLeague"]


class SelfPlayLeague:
    """Promote-and-resample loop driven from the training loop::

        league = SelfPlayLeague(main="main", opponent="opponent",
                                win_rate_threshold=0.7)
        for _ in range(iters):
            result = algo.train()
            stats = league.update(algo, win_rate(result))

    `update` snapshots the main policy into the league whenever the
    reported win rate crosses the threshold, then (re)assigns the
    frozen opponent's weights to a league member (uniform sample — the
    reference's examples sample uniformly; pass `sample_fn` for
    prioritized matchmaking)."""

    def __init__(self, main: str = "main", opponent: str = "opponent",
                 win_rate_threshold: float = 0.7,
                 max_league_size: int = 10,
                 seed: Optional[int] = None,
                 sample_fn=None):
        self.main = main
        self.opponent = opponent
        self.threshold = float(win_rate_threshold)
        self.max_size = int(max_league_size)
        self._rng = random.Random(seed)
        self._sample_fn = sample_fn
        self.snapshots: List[Any] = []
        self.promotions = 0

    def bootstrap(self, algo) -> None:
        """Seed the league with the untrained main policy and freeze it
        into the opponent slot (call once before training)."""
        self._snapshot(algo)
        self._assign_opponent(algo)

    def update(self, algo, win_rate: float) -> Dict[str, Any]:
        promoted = False
        if win_rate >= self.threshold:
            self._snapshot(algo)
            self._assign_opponent(algo)
            promoted = True
        return {"league_size": len(self.snapshots),
                "promotions": self.promotions,
                "promoted_this_iter": promoted,
                "win_rate": float(win_rate)}

    # -- internals --------------------------------------------------------
    def _snapshot(self, algo) -> None:
        weights = copy.deepcopy(algo.learners[self.main].get_weights())
        self.snapshots.append(weights)
        if len(self.snapshots) > self.max_size:
            # Oldest-out, but never drop the newest (the usual league
            # trim; prioritized schemes can override via sample_fn).
            self.snapshots.pop(0)
        self.promotions += 1

    def _assign_opponent(self, algo) -> None:
        if not self.snapshots:
            return
        pick = (self._sample_fn(self.snapshots) if self._sample_fn
                else self._rng.choice(self.snapshots))
        algo.learners[self.opponent].set_weights(copy.deepcopy(pick))
        algo.env_runner_group.sync_weights(algo.get_weights())
