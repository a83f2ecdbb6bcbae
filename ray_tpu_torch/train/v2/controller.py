"""TrainController: the state machine that drives training execution.

Reference parity: train/v2/_internal/execution/controller/controller.py:91
(TrainController, run loop :436). States and transitions:

    INITIALIZING -> SCHEDULING -> RUNNING -> FINISHED
                         ^            |
                         |            v (worker failure)
                    RESTARTING <- [FailurePolicy.RETRY]
                                      |
                                      v (FailurePolicy.RAISE)
                                   ERRORED

Each (re)start asks the ScalingPolicy for a ResizeDecision, so recovery
is elastic: the next gang may be smaller/larger than the last. Worker
reports and checkpoints are drained every poll tick and registered with
the CheckpointManager; restarts restore from the latest checkpoint.
"""

from __future__ import annotations

import enum
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from ... import api
from ...exceptions import (ActorDiedError, RayError, TaskError,
                           TaskUnschedulableError)
from ..checkpoint import Checkpoint, CheckpointManager
from ..session import TrainContext
from ..worker_group import WorkerGroup
from .failure_policy import FailureDecision, FailurePolicy
from .scaling_policy import ResizeDecision, ScalingPolicy


class TrainControllerState(enum.Enum):
    INITIALIZING = "INITIALIZING"
    SCHEDULING = "SCHEDULING"
    RUNNING = "RUNNING"
    RESTARTING = "RESTARTING"
    ERRORED = "ERRORED"
    FINISHED = "FINISHED"


class TrainController:
    """Drives worker groups through the training state machine."""

    def __init__(self, *,
                 train_fn: Callable,
                 train_fn_config: Optional[Dict],
                 scaling_policy: ScalingPolicy,
                 failure_policy: FailurePolicy,
                 backend_config,
                 checkpoint_manager: CheckpointManager,
                 experiment_name: str,
                 experiment_dir: str,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 dataset_splitter: Optional[Callable[[int], Optional[
                     List[Dict[str, Any]]]]] = None,
                 checkpoint_adopter: Optional[Callable] = None,
                 poll_interval_s: float = 0.2):
        self._train_fn = train_fn
        self._train_fn_config = train_fn_config or {}
        self._scaling_policy = scaling_policy
        self._failure_policy = failure_policy
        self._backend_config = backend_config
        self._manager = checkpoint_manager
        self._name = experiment_name
        self._exp_dir = experiment_dir
        self._restore = resume_from_checkpoint
        self._split_datasets = dataset_splitter or (lambda n: None)
        self._adopt = checkpoint_adopter or (lambda m, c: c)
        self._poll_interval_s = poll_interval_s

        self._state_log: List[Tuple[str, float]] = []
        self._set_state(TrainControllerState.INITIALIZING)
        self._group: Optional[WorkerGroup] = None
        self._run_refs: List = []
        self._latest_metrics: Dict[str, Any] = {}
        self._error: Optional[BaseException] = None
        self._world_sizes: List[int] = []

    # ------------------------------------------------------------------
    def _set_state(self, state: TrainControllerState):
        self._state = state
        self._state_log.append((state.value, time.time()))

    @property
    def state(self) -> TrainControllerState:
        return self._state

    @property
    def state_log(self) -> List[Tuple[str, float]]:
        return list(self._state_log)

    @property
    def world_sizes(self) -> List[int]:
        """World size of each gang started (elasticity observable)."""
        return list(self._world_sizes)

    # ------------------------------------------------------------------
    def run(self):
        """Run to a terminal state; returns (metrics, checkpoint, error)."""
        try:
            while self._state not in (TrainControllerState.ERRORED,
                                      TrainControllerState.FINISHED):
                if self._state in (TrainControllerState.INITIALIZING,
                                   TrainControllerState.RESTARTING):
                    self._set_state(TrainControllerState.SCHEDULING)
                elif self._state == TrainControllerState.SCHEDULING:
                    self._start_worker_group()
                elif self._state == TrainControllerState.RUNNING:
                    self._poll_worker_group()
        finally:
            # v1 trainer.fit's `finally: group.shutdown()` guarantee:
            # no path (including unexpected exceptions) leaks workers.
            self._teardown_group()
        return self._latest_metrics, self._manager.latest, self._error

    # ------------------------------------------------------------------
    def _start_worker_group(self):
        decision: ResizeDecision = \
            self._scaling_policy.make_decision_for_new_group()
        # Surface a gang the cluster can't currently hold (reference:
        # infeasible-demand surfacing; without this the setup just
        # times out with no diagnosis).
        totals = api.cluster_resources()
        demand = {k: v * decision.num_workers
                  for k, v in decision.resources_per_worker.items()}
        infeasible = {k: v for k, v in demand.items()
                      if v > totals.get(k, 0.0) + 1e-9}
        if infeasible:
            # Routed through the failure policy: an autoscaler may grow
            # totals, and elastic recovery may be mid-rejoin. With the
            # default max_failures=0 it surfaces immediately; when the
            # policy opts to RETRY, pace the loop so an unbounded retry
            # budget waits for capacity instead of hot-spinning.
            self._handle_failure(TaskUnschedulableError(
                f"Worker group of {decision.num_workers} needs "
                f"{demand}, exceeding current cluster totals "
                f"{ {k: totals.get(k, 0.0) for k in demand} }. Reduce "
                f"num_workers/resources_per_worker or add nodes."))
            if self._state == TrainControllerState.RESTARTING:
                time.sleep(max(self._poll_interval_s, 1.0))
            return
        # Materialize dataset shards BEFORE the gang reserves its
        # resources: split/repartition tasks need cluster CPU, and on a
        # small cluster a fully-reserved gang starves them forever.
        # Split failures are gang failures: route through the policy.
        try:
            dataset_shards = self._split_datasets(decision.num_workers)
        except (ActorDiedError, TaskError, RayError, TimeoutError) as e:
            self._handle_failure(e)
            return
        group = WorkerGroup(decision.num_workers,
                            decision.resources_per_worker)
        uid = uuid.uuid4().hex[:8]
        name, exp_dir = self._name, self._exp_dir

        def make_context(rank: int) -> TrainContext:
            return TrainContext(
                world_size=decision.num_workers,
                world_rank=rank, local_rank=rank,
                trial_name=name, experiment_name=f"{name}_{uid}",
                storage_path=exp_dir)

        try:
            group.setup(make_context, self._backend_config,
                        self._restore or self._manager.latest,
                        dataset_shards)
            self._run_refs = group.run(self._train_fn,
                                       self._train_fn_config)
        except (ActorDiedError, TaskError, RayError, TimeoutError) as e:
            group.shutdown()
            self._handle_failure(e)
            return
        except BaseException:
            # Non-gang errors (e.g. unpicklable train_fn) are not
            # retryable — don't leak the just-created actors.
            group.shutdown()
            raise
        self._group = group
        self._world_sizes.append(decision.num_workers)
        self._set_state(TrainControllerState.RUNNING)

    def _poll_worker_group(self):
        pending = list(self._run_refs)
        error: Optional[BaseException] = None
        while pending and error is None:
            ready, pending = api.wait(pending, num_returns=1,
                                      timeout=self._poll_interval_s)
            try:
                self._drain_reports()
            except (ActorDiedError, TaskError, RayError,
                    TimeoutError) as e:
                # A dead worker surfaces here (poll on a killed actor)
                # before its run ref does — route it through the failure
                # policy like any other gang failure.
                error = e
                break
            for ref in ready:
                try:
                    api.get(ref)
                except BaseException as e:  # noqa: BLE001
                    error = e
                    break
        try:
            self._drain_reports()
        except Exception:
            pass
        if error is None:
            self._set_state(TrainControllerState.FINISHED)
        else:
            self._teardown_group()
            self._handle_failure(error)

    def _handle_failure(self, error: BaseException):
        decision = self._failure_policy.make_decision(error)
        if decision == FailureDecision.RETRY:
            # Elastic restart from the latest checkpoint (reference:
            # failure_handling/ + scaling_policy on the next schedule).
            self._restore = self._manager.latest
            self._set_state(TrainControllerState.RESTARTING)
        else:
            self._error = error
            self._set_state(TrainControllerState.ERRORED)

    # ------------------------------------------------------------------
    def _drain_reports(self):
        if self._group is None:
            return
        all_reports = self._group.poll_all(timeout=30.0)
        for rank, reports in enumerate(all_reports):
            for rep in reports:
                ckpt = rep.get("checkpoint")
                if ckpt is not None and rank == 0:
                    managed = self._adopt(self._manager, ckpt)
                    self._manager.register(managed, rep["metrics"])
                if rank == 0:
                    self._latest_metrics.update(rep["metrics"])

    def _teardown_group(self):
        if self._group is not None:
            self._group.shutdown()
            self._group = None
