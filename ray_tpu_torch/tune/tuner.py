"""Tuner + TuneController: the trial-driving event loop.

Reference parity: python/ray/tune/tuner.py (Tuner.fit :344) →
tune/impl/tuner_internal.py → tune/execution/tune_controller.py (the
event loop managing trial actors, :68). Trials run as dedicated actors
(one process each, like the reference's trainable actors); the controller
polls their report buffers, feeds results to the scheduler, enforces stop
conditions, retries failures per FailureConfig, checkpoints experiment
state, and supports Tuner.restore (tune_controller.py:223,352,458
experiment checkpointing).
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .. import api
from ..train.checkpoint import Checkpoint
from ..train.config import RunConfig
from . import schedulers as sched_mod
from . import session as tune_session
from .result_grid import Result, ResultGrid
from .search import BasicVariantGenerator
from .trainable import wrap_trainable

# Trial states (reference: tune/experiment/trial.py)
PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERRORED = "ERRORED"


@dataclass
class TuneConfig:
    """Reference: tune/tune_config.py TuneConfig."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[sched_mod.TrialScheduler] = None
    # Sequential search algorithm (reference: TuneConfig.search_alg →
    # tune/search/ Searcher); None = BasicVariantGenerator up front.
    search_alg: Optional[Any] = None
    time_budget_s: Optional[float] = None
    seed: Optional[int] = None


@dataclass
class _Trial:
    trial_id: str
    config: Dict[str, Any]
    state: str = PENDING
    last_result: Dict[str, Any] = field(default_factory=dict)
    all_results: List[Dict] = field(default_factory=list)
    checkpoint_path: Optional[str] = None
    error: Optional[str] = None
    failures: int = 0
    restore_from: Optional[str] = None
    # Per-trial resource override (ResourceChangingScheduler); None =
    # the experiment default.
    resources: Optional[Dict[str, float]] = None
    actor: Any = None
    run_ref: Any = None
    dir: str = ""


def _actor_options(res: Dict[str, float]) -> Dict[str, Any]:
    """A trial's resource dict as actor options: ``"GPU"`` reserves
    cards through ``num_gpus``, so the scheduler pins them through
    ``CUDA_VISIBLE_DEVICES`` (as a custom resource it would be counted
    against the card while the trial saw none), and every other key but
    ``"CPU"`` stays a custom resource. No node of the port declares a
    TPU, so ``"TPU"`` raises, as ``num_tpus`` does."""
    if res.get("TPU"):
        raise ValueError(
            f"trial resources {res!r}: ray_tpu_torch schedules GPUs, and "
            f"no node declares a TPU; ask for {{'GPU': n}} instead")
    return {"num_cpus": res.get("CPU", 1),
            "num_gpus": res.get("GPU", 0) or None,
            "resources": {k: v for k, v in res.items()
                          if k not in ("CPU", "GPU", "TPU")}}


@api.remote
class _TrialActor:
    """One trial == one actor process (reference: the Trainable actor).
    max_concurrency=4 so poll()/request_stop() interleave with run()."""

    def __init__(self):
        self._stop = False

    def run(self, fn_blob: bytes, config: Dict, trial_id: str,
            trial_dir: str, restore_path: Optional[str],
            stop_conditions: Optional[Dict] = None,
            resources: Optional[Dict] = None) -> Dict:
        import cloudpickle

        fn = cloudpickle.loads(fn_blob)
        restore = (Checkpoint.from_directory(restore_path)
                   if restore_path else None)
        s = tune_session._TuneSession(trial_id, trial_dir, restore,
                                      stop_conditions)
        s.trial_resources = dict(resources or {})
        if self._stop:
            s.stop_requested = True
        self._session = s
        tune_session._set_session(s)
        try:
            fn(config)
            return {"status": "ok"}
        except tune_session.TrialStopSignal:
            return {"status": "stopped"}
        finally:
            tune_session._set_session(None)

    def poll(self) -> List[Dict]:
        s = getattr(self, "_session", None)
        return s.drain() if s else []

    def request_stop(self):
        self._stop = True
        s = getattr(self, "_session", None)
        if s is not None:
            s.request_stop()


class Tuner:
    """Reference: tune/tuner.py Tuner (fit :344, restore :162)."""

    def __init__(self, trainable: Callable = None, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._restored_state: Optional[dict] = None

    @classmethod
    def restore(cls, path: str, trainable: Callable) -> "Tuner":
        """Resume an interrupted experiment from its directory
        (reference: Tuner.restore)."""
        from ..train.config import FailureConfig
        with open(os.path.join(path, "tuner_state.json")) as f:
            state = json.load(f)
        t = cls(trainable,
                param_space={},  # configs come from saved trial state
                tune_config=TuneConfig(
                    metric=state["metric"], mode=state["mode"]),
                run_config=RunConfig(
                    name=os.path.basename(path),
                    storage_path=os.path.dirname(path),
                    stop=state.get("stop") or None,
                    failure_config=FailureConfig(
                        max_failures=state.get("max_failures", 0))))
        t._restored_state = state
        return t

    def fit(self) -> ResultGrid:
        if not api.is_initialized():
            api.init(ignore_reinit_error=True)
        controller = _TuneController(
            self._trainable, self._param_space, self._tune_config,
            self._run_config, self._restored_state)
        return controller.run()


class _TuneController:
    """Reference: tune/execution/tune_controller.py TuneController:68."""

    def __init__(self, trainable, param_space, tune_config: TuneConfig,
                 run_config: RunConfig, restored_state: Optional[dict]):
        import cloudpickle

        self._fn = wrap_trainable(trainable)
        self._fn_blob = cloudpickle.dumps(self._fn)
        self._resources = getattr(self._fn, "__tune_resources__",
                                  {"CPU": 1})
        _actor_options(self._resources)  # a TPU request raises here
        self._tc = tune_config
        self._rc = run_config
        self._scheduler = tune_config.scheduler or sched_mod.FIFOScheduler()
        if tune_config.metric:
            self._scheduler.set_metric(tune_config.metric, tune_config.mode)
        name = run_config.name or f"tune_{int(time.time())}"
        self._exp_dir = os.path.join(run_config.resolved_storage_path(), name)
        os.makedirs(self._exp_dir, exist_ok=True)
        self._stop_conditions = dict(getattr(run_config, "stop", None) or {})
        self._trials: List[_Trial] = []
        self._searcher = None
        self._suggest_budget = 0
        if restored_state is not None:
            for ts in restored_state["trials"]:
                tr = _Trial(trial_id=ts["trial_id"], config=ts["config"],
                            state=ts["state"],
                            last_result=ts.get("last_result", {}),
                            checkpoint_path=ts.get("checkpoint_path"),
                            error=ts.get("error"))
                tr.dir = os.path.join(self._exp_dir, tr.trial_id)
                if tr.state in (PENDING, RUNNING, ERRORED):
                    # unfinished work resumes (from its checkpoint if any)
                    tr.state = PENDING
                    tr.restore_from = tr.checkpoint_path
                self._trials.append(tr)
        elif tune_config.search_alg is not None:
            # Lazy suggestion loop: trials materialize as the searcher
            # proposes them (reference: TuneController + SearchGenerator).
            self._searcher = tune_config.search_alg
            self._searcher.set_search_properties(
                tune_config.metric, tune_config.mode, param_space)
            self._suggest_budget = tune_config.num_samples
        else:
            gen = BasicVariantGenerator(param_space, tune_config.num_samples,
                                        tune_config.seed)
            while True:
                cfg = gen.next_trial_config()
                if cfg is None:
                    break
                tr = _Trial(trial_id=f"trial_{uuid.uuid4().hex[:8]}",
                            config=cfg)
                tr.dir = os.path.join(self._exp_dir, tr.trial_id)
                self._trials.append(tr)

    # -- persistence -------------------------------------------------------
    def _save_state(self):
        state = {
            "metric": self._tc.metric, "mode": self._tc.mode,
            "stop": self._stop_conditions,
            "max_failures": self._rc.failure_config.max_failures,
            "trials": [{
                "trial_id": t.trial_id, "config": t.config,
                "state": t.state, "last_result": t.last_result,
                "checkpoint_path": t.checkpoint_path, "error": t.error,
            } for t in self._trials],
        }
        tmp = os.path.join(self._exp_dir, ".tuner_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, default=str)
        os.replace(tmp, os.path.join(self._exp_dir, "tuner_state.json"))

    # -- trial lifecycle ---------------------------------------------------
    def _start_trial(self, t: _Trial):
        os.makedirs(t.dir, exist_ok=True)
        res = t.resources or self._resources
        t.actor = _TrialActor.options(max_concurrency=4,
                                      **_actor_options(res)).remote()
        t.run_ref = t.actor.run.remote(
            self._fn_blob, t.config, t.trial_id, t.dir, t.restore_from,
            self._stop_conditions, dict(res))
        t.state = RUNNING

    def _finalize_trial(self, t: _Trial):
        try:
            api.get(t.run_ref, timeout=30)
            self._drain_reports(t)
            t.state = TERMINATED
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001
            self._drain_reports(t)
            t.failures += 1
            if t.failures <= self._rc.failure_config.max_failures:
                # Elastic retry from the last checkpoint (reference:
                # FailureConfig.max_failures, air/config.py:397).
                t.restore_from = t.checkpoint_path
                t.state = PENDING
            else:
                t.state = ERRORED
                t.error = repr(e)
        finally:
            if t.state != RUNNING:
                try:
                    api.kill(t.actor)
                except Exception:
                    pass
                t.actor = None
                t.run_ref = None
        self._scheduler.on_trial_complete(t.trial_id)
        if self._searcher is not None and t.state in (TERMINATED, ERRORED):
            self._searcher.on_trial_complete(
                t.trial_id, t.last_result, error=(t.state == ERRORED))
        self._save_state()

    def _drain_reports(self, t: _Trial):
        try:
            reports = api.get(t.actor.poll.remote(), timeout=30)
        except Exception:
            return
        for rec in reports:
            metrics = rec["metrics"]
            t.last_result = metrics
            t.all_results.append(metrics)
            if rec.get("checkpoint_path"):
                t.checkpoint_path = rec["checkpoint_path"]
            self._process_result(t, metrics)

    def _process_result(self, t: _Trial, metrics: Dict):
        # user stop conditions (reference: air.RunConfig(stop={...}))
        for k, v in self._stop_conditions.items():
            if k in metrics and metrics[k] >= v:
                self._request_stop(t)
                return
        # Config-aware observation hook (PB2's GP data, BOHB's
        # budget-tagged model points).
        observe = getattr(self._scheduler, "observe", None)
        if observe is not None:
            observe(t.trial_id, metrics, t.config)
        decision = self._scheduler.on_result(t.trial_id, metrics)
        if decision == sched_mod.STOP:
            self._request_stop(t)
            return
        # ResourceChangingScheduler: a new allocation restarts the
        # trial from its checkpoint with the new resources (reference:
        # resource_changing_scheduler.py:592).
        rcs = self._scheduler
        if (isinstance(rcs, sched_mod.ResourceChangingScheduler)
                and t.checkpoint_path):
            # No checkpoint -> no reallocation: restarting from scratch
            # would silently discard the trial's progress (the
            # reference refuses non-checkpointing trainables too).
            live = {x.trial_id: dict(x.resources or self._resources)
                    for x in self._trials if x.state == RUNNING}
            new_res = rcs.reallocate_decision(
                t.trial_id, metrics, api.cluster_resources(), live)
            if new_res is not None:
                t.resources = new_res
                t.restore_from = t.checkpoint_path
                self._request_stop(t, restart=True)
                return
        # PBT exploit: bottom-quantile trial adopts a top trial's
        # checkpoint + mutated config at perturbation boundaries.
        # (ResourceChangingScheduler delegates; unwrap for the type
        # check but call through the wrapper.)
        pbt = self._scheduler
        base = getattr(pbt, "base_scheduler", pbt)
        if isinstance(base, sched_mod.PopulationBasedTraining) \
                and pbt.should_perturb(t.trial_id, metrics):
            configs = {x.trial_id: x.config for x in self._trials}
            decision2 = pbt.exploit_decision(t.trial_id, configs)
            if decision2 is not None:
                src_id, new_config = decision2
                src = next(x for x in self._trials
                           if x.trial_id == src_id)
                if src.checkpoint_path:
                    t.config = new_config
                    t.restore_from = src.checkpoint_path
                    self._request_stop(t, restart=True)

    def _request_stop(self, t: _Trial, restart: bool = False):
        t._restart_after_stop = restart
        if t.actor is not None:
            try:
                t.actor.request_stop.remote()
            except Exception:
                pass

    # -- main loop ---------------------------------------------------------
    def run(self) -> ResultGrid:
        start = time.monotonic()
        max_conc = self._tc.max_concurrent_trials or max(
            1, int(api.cluster_resources().get("CPU", 1)))
        while True:
            running = [t for t in self._trials if t.state == RUNNING]
            pending = [t for t in self._trials if t.state == PENDING]
            # Searcher-driven mode: materialize new trials on demand
            # until the sample budget is spent (a ConcurrencyLimiter may
            # return None to backpressure; retry after completions).
            while (self._searcher is not None and self._suggest_budget > 0
                   and len(running) + len(pending) < max_conc):
                trial_id = f"trial_{uuid.uuid4().hex[:8]}"
                cfg = self._searcher.suggest(trial_id)
                if cfg is None:
                    break
                tr = _Trial(trial_id=trial_id, config=cfg)
                tr.dir = os.path.join(self._exp_dir, tr.trial_id)
                self._trials.append(tr)
                pending.append(tr)
                self._suggest_budget -= 1
            if not running and not pending:
                break
            budget_spent = (self._tc.time_budget_s is not None and
                            time.monotonic() - start >
                            self._tc.time_budget_s)
            if budget_spent:
                for t in running:
                    self._request_stop(t)
                for t in pending:
                    t.state = TERMINATED
            while (not budget_spent and pending
                   and len(running) < max_conc):
                t = pending.pop(0)
                self._start_trial(t)
                running.append(t)
            # poll: completed run() refs first, then live report buffers
            done_refs = [t.run_ref for t in running]
            if not done_refs:
                time.sleep(0.05)
                continue
            ready, _ = api.wait(done_refs, num_returns=1, timeout=0.05)
            ready_set = {r.id.binary() for r in ready}
            for t in list(running):
                if t.run_ref.id.binary() in ready_set:
                    # Finalize FIRST: its drain may process the final
                    # report that sets the PBT restart flag.
                    self._finalize_trial(t)
                    if getattr(t, "_restart_after_stop", False) \
                            and t.state == TERMINATED:
                        t._restart_after_stop = False
                        t.state = PENDING
                else:
                    self._drain_reports(t)
        self._save_state()
        results = [
            Result(metrics=t.last_result,
                   checkpoint=(Checkpoint.from_directory(t.checkpoint_path)
                               if t.checkpoint_path else None),
                   error=t.error, path=t.dir, config=t.config)
            for t in self._trials
        ]
        return ResultGrid(results, metric=self._tc.metric,
                          mode=self._tc.mode)
