"""The port's Tune (``ray_tpu_torch.tune``) held against ``ray_tpu.tune``.

Both packages' clusters are alive in this process (4 CPUs each; the
port's with 2 GPUs faked through ``RTT_NUM_GPUS``), and every sweep runs
once in each, its trials in that package's actor processes. The
trainables live in ``tests/torch_tune_trainables.py``, which the trial
processes import by name.

A scheduler or searcher decides on each report as it is drained, and a
trial keeps training until the stop request reaches it, so how many
reports a cut trial sends after its cut depends on timing, in both
packages alike. The decisions are therefore compared by record and
replay: every call the controller makes on its scheduler and searcher
in one package's sweep (arguments and result) is replayed, in the same
order, on fresh objects of the other package built with the same
arguments, and each result must be equal. Sweeps whose trials are
never cut (FIFO, the session's own stop condition) are compared by
their results directly.

The slice whole: an ASHA sweep whose trials run the GPT train step (2
layers of ``GPTConfig.tiny()``, f32, T=64) from the same weights, drawn
by ``ray_tpu`` and handed to both as numpy; the port's trial converts
them with ``from_jax_params``. The cut decisions must be equal and the
per-iteration losses within ``rtol`` 1e-5, the f32 ``loss_rtol`` of
``test_torch_train.py``.
"""

import copy
import dataclasses
import importlib
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tune_trainables as tt

PACKAGES = ("ray_tpu", "ray_tpu_torch")
OTHER = {"ray_tpu": "ray_tpu_torch", "ray_tpu_torch": "ray_tpu"}
# The controller-facing calls of a scheduler and of a searcher.
RECORDED = ("on_result", "observe", "should_perturb", "exploit_decision",
            "on_trial_complete", "reallocate_decision", "suggest")
# f32 GPT losses, as test_torch_train.py's TestTrainStep holds them.
LOSS_RTOL = 1e-5


def _tune(package):
    return importlib.import_module(package + ".tune")


@pytest.fixture(scope="module")
def clusters():
    """Both packages' clusters, the port's with 2 GPUs faked."""
    import ray_tpu
    import ray_tpu_torch

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTT_NUM_GPUS", "2")
        ray_tpu.init(num_cpus=4, ignore_reinit_error=True)
        try:
            ray_tpu_torch.init(num_cpus=4)
            try:
                yield
            finally:
                ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()


def recording(cls, log: list, tag: str):
    """A subclass of ``cls`` that appends ``(tag, name, args, kwargs,
    result)`` to ``log`` for each controller-facing call."""
    def wrap(name):
        def method(self, *args, **kwargs):
            out = getattr(super(sub, self), name)(*args, **kwargs)
            log.append((tag, name, copy.deepcopy(args),
                        copy.deepcopy(kwargs), copy.deepcopy(out)))
            return out
        return method

    sub = type("Recording" + cls.__name__, (cls,),
               {name: wrap(name) for name in RECORDED if hasattr(cls, name)})
    return sub


def _both(one):
    """``one(package)`` for both packages at once, each in a thread of
    its own (a sweep mostly waits on its trials): {package: result}."""
    with ThreadPoolExecutor(len(PACKAGES)) as pool:
        futures = {pkg: pool.submit(one, pkg) for pkg in PACKAGES}
        return {pkg: f.result() for pkg, f in futures.items()}


def _same(out):
    """The port's result, which must equal ray_tpu's."""
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    return out["ray_tpu"]


def replay(log: list, scheduler, searcher) -> int:
    """Replays ``log`` on ``scheduler`` and ``searcher``; each result must
    equal the recorded one. Returns the number of calls replayed."""
    for tag, name, args, kwargs, want in log:
        obj = scheduler if tag == "scheduler" else searcher
        got = getattr(obj, name)(*copy.deepcopy(args),
                                 **copy.deepcopy(kwargs))
        assert got == want, (tag, name, args, got, want)
    return len(log)


# -- the scheduler cases: (trainable, param space, scheduler, searcher,
#    TuneConfig fields), each built from a package's tune module ----------

def _asha(tune):
    return (tt.curve,
            {"quality": tune.grid_search([5.0, 2.0, 4.0, 1.0])},
            (tune.ASHAScheduler, {"max_t": 8, "grace_period": 2,
                                  "reduction_factor": 3}), None,
            {"max_concurrent_trials": 2})


def _hyperband(tune):
    return (tt.curve,
            {"quality": tune.grid_search([5.0, 2.0, 4.0, 1.0])},
            (tune.HyperBandScheduler, {"max_t": 8, "grace_period": 2,
                                       "reduction_factor": 3}), None,
            {"max_concurrent_trials": 2})


def _median(tune):
    return (tt.curve,
            {"quality": tune.grid_search([5.0, 4.0, 1.0, 0.5])},
            (tune.MedianStoppingRule, {"grace_period": 2,
                                       "min_samples_required": 2}), None,
            {"max_concurrent_trials": 2})


def _pbt(tune):
    return (tt.growth, {"lr": tune.uniform(0.0, 1.0)},
            (tune.PopulationBasedTraining, {
                "perturbation_interval": 2, "quantile_fraction": 0.5,
                "hyperparam_mutations": {"lr": tune.uniform(0.0, 1.0)},
                "seed": 0}), None,
            {"num_samples": 4, "seed": 3, "max_concurrent_trials": 2})


def _pb2(tune):
    return (tt.growth, {"lr": tune.uniform(0.0, 1.0)},
            (tune.PB2, {"perturbation_interval": 2, "quantile_fraction": 0.5,
                        "hyperparam_bounds": {"lr": (0.0, 1.0)},
                        "seed": 7}), None,
            {"num_samples": 4, "seed": 7, "max_concurrent_trials": 2})


def _bohb(tune):
    return (tt.bump, {"x": tune.uniform(0.0, 1.0)},
            (tune.HyperBandForBOHB, {"max_t": 8, "grace_period": 2,
                                     "reduction_factor": 3}),
            (tune.TuneBOHB, {"seed": 5, "min_points": 3, "n_startup": 3}),
            {"num_samples": 6, "max_concurrent_trials": 2})


CASES = {"asha": _asha, "hyperband": _hyperband, "median": _median,
         "pbt": _pbt, "pb2": _pb2, "bohb": _bohb}
# What each case's log must hold, so that the replay compares decisions
# and not only continues: a cut, an exploit, a suggestion from the model.
EXPECTED = {"asha": ("on_result", "STOP"),
            "hyperband": ("on_result", "STOP"),
            "median": ("on_result", "STOP"),
            "pbt": ("exploit_decision", None),
            "pb2": ("exploit_decision", None),
            "bohb": ("suggest", None)}


def _build(case, package, log=None):
    """The case's (trainable, space, scheduler, searcher, fields) in
    ``package``; with ``log``, the scheduler and searcher record."""
    tune = _tune(package)
    fn, space, (scls, skw), search, fields = CASES[case](tune)
    if log is not None:
        scls = recording(scls, log, "scheduler")
    scheduler = scls(metric="score", mode="max", **skw)
    searcher = None
    if search is not None:
        cls, kw = search
        if log is not None:
            cls = recording(cls, log, "searcher")
        searcher = cls(metric="score", mode="max", **kw)
        searcher.set_search_properties("score", "max", space)
        scheduler.pair_with(searcher)
    return fn, space, scheduler, searcher, fields


def _sweep(package, storage, fn, space, metric, mode, scheduler=None,
           searcher=None, resources=None, run=None, bind=None, **fields):
    """``fn`` swept over ``space`` in ``package``'s cluster, bound to
    the package (and to ``bind``)."""
    tune = _tune(package)
    trainable = tune.with_parameters(fn, package=package, **(bind or {}))
    if resources is not None:
        trainable = tune.with_resources(trainable, resources)
    return tune.Tuner(
        trainable, param_space=space,
        tune_config=tune.TuneConfig(metric=metric, mode=mode,
                                    scheduler=scheduler,
                                    search_alg=searcher, **fields),
        run_config=tune.RunConfig(storage_path=os.path.join(storage,
                                                            package),
                                  **(run or {}))).fit()


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_decisions_replay_across_packages(clusters, tmp_path,
                                                    case):
    """Each package's sweep, recorded, is replayed on the other
    package's scheduler (and searcher): every decision equal."""
    def one(package):
        log = []
        fn, space, scheduler, searcher, fields = _build(case, package, log)
        grid = _sweep(package, str(tmp_path), fn, space, "score", "max",
                      scheduler, searcher, **fields)
        assert grid.num_errors == 0, grid.errors
        return log

    logs = _both(one)
    name, value = EXPECTED[case]
    for package, log in logs.items():
        assert any(n == name and (value is None or out == value)
                   and (name != "exploit_decision" or out is not None)
                   for _, n, _, _, out in log), (case, package)
        _, _, scheduler, searcher, _ = _build(case, OTHER[package])
        assert replay(log, scheduler, searcher) > 10


# -- sampling ---------------------------------------------------------------

def _variant_space(tune):
    return {"a": tune.grid_search([1, 2]),
            "opt": {"lr": tune.loguniform(1e-4, 1e-1),
                    "name": tune.choice(["sgd", "adam"])},
            "n": tune.randint(1, 10), "q": tune.qrandint(0, 20, 5),
            "u": tune.uniform(-1.0, 1.0), "qu": tune.quniform(0, 1, 0.25),
            "b": tune.sample_from(lambda spec: spec.config.a * 10),
            "fixed": "x"}


def test_variants_are_the_same():
    """grid_search, every domain and sample_from, expanded with one seed."""
    def one(package):
        search = importlib.import_module(package + ".tune.search")
        return search.generate_variants(_variant_space(_tune(package)),
                                        num_samples=3, seed=0)

    assert len(_same({pkg: one(pkg) for pkg in PACKAGES})) == 6


@pytest.mark.parametrize("searcher", ["RandomSearch", "TPESearcher"])
def test_searchers_suggest_the_same_configs(clusters, tmp_path, searcher):
    """One trial at a time, so the model sees every result before its
    next suggestion: the suggested configs and scores, in order (TPE's
    last two from its model)."""
    def one(package):
        tune = _tune(package)
        kwargs = {"seed": 3}
        if searcher == "TPESearcher":
            kwargs["n_startup"] = 3
        alg = tune.ConcurrencyLimiter(
            getattr(tune, searcher)(metric="score", mode="max", **kwargs),
            max_concurrent=1)
        grid = _sweep(package, str(tmp_path), tt.quadratic,
                      {"x": tune.uniform(0.0, 6.0)}, "score", "max",
                      searcher=alg, num_samples=5, max_concurrent_trials=1)
        return [(r.config, r.metrics["score"]) for r in grid]

    assert len(_same(_both(one))) == 5


# -- results, restore, the class API, with_parameters -------------------------

def _outcome(grid, metric):
    """A grid as comparable data: each trial's config, metric, iteration
    and whether it errored, in trial order, and the best trial's config."""
    rows = [(r.config, r.metrics.get(metric),
             r.metrics.get("training_iteration"), r.error is not None)
            for r in grid]
    return rows, grid.get_best_result().config


def test_result_grid_is_the_same(clusters, tmp_path):
    """A grid sweep with an erroring trial and a with_parameters offset."""
    def one(package):
        tune = _tune(package)
        grid = _sweep(package, str(tmp_path), tt.quadratic,
                      {"x": tune.grid_search([0, 2, 3, 13, 5])},
                      "score", "max", bind={"offset": 0.5})
        assert grid.num_errors == 1 and "unlucky" in grid.errors[0]
        return _outcome(grid, "score")

    assert _same(_both(one))[1] == {"x": 3}


def test_stop_condition_and_retry_from_checkpoint(clusters, tmp_path):
    """RunConfig's stop and FailureConfig's retry: the failed trial
    resumes from its checkpoint and counts on."""
    def one(package):
        tune = _tune(package)
        marker = str(tmp_path / f"{package}.failed")
        grid = _sweep(
            package, str(tmp_path), tt.counting,
            {"step": tune.grid_search([1, 2])}, "count", "max",
            bind={"iters": 6, "fail_at": 2, "marker": marker},
            run={"stop": {"training_iteration": 4},
                 "failure_config": tune.FailureConfig(max_failures=1)},
            max_concurrent_trials=1)
        assert grid.num_errors == 0, grid.errors
        return (_outcome(grid, "count"),
                [r.metrics["resumed_at"] for r in grid],
                [os.path.basename(r.checkpoint.path) for r in grid])

    outcome, resumed_at, _ = _same(_both(one))
    # the first trial failed after its checkpoint 2 and resumed at 3;
    # both stopped at iteration 4.
    assert resumed_at == [3, 1]
    assert [row[2] for row in outcome[0]] == [4, 4]


def test_restore_completes_an_unfinished_experiment(clusters, tmp_path):
    def one(package):
        tune = _tune(package)
        trainable = tune.with_parameters(tt.quadratic, package=package)
        tuner = tune.Tuner(
            trainable, param_space={"x": tune.grid_search([1, 2, 3])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
            run_config=tune.RunConfig(name="exp",
                                      storage_path=str(tmp_path / package)))
        assert len(tuner.fit()) == 3
        # An interruption: the second trial still PENDING, no result.
        path = tmp_path / package / "exp"
        state = json.loads((path / "tuner_state.json").read_text())
        state["trials"][1].update(state="PENDING", last_result={})
        (path / "tuner_state.json").write_text(json.dumps(state))
        return _outcome(tune.Tuner.restore(str(path), trainable).fit(),
                        "score")

    assert [row[1] for row in _same(_both(one))[0]] == [-4, -1, 0]


def test_class_api_with_parameters(clusters, tmp_path):
    """A Trainable subclass bound with with_parameters: setup's extra
    argument, the done flag and the checkpoint it saves."""
    def one(package):
        tune = _tune(package)
        bound = tune.with_parameters(tt.accumulator(package), bonus=100)
        grid = tune.Tuner(
            bound, param_space={"x": tune.grid_search([1, 10])},
            tune_config=tune.TuneConfig(metric="total", mode="max"),
            run_config=tune.RunConfig(
                storage_path=str(tmp_path / package))).fit()
        best = grid.get_best_result()
        with open(os.path.join(best.checkpoint.path, "total.txt")) as f:
            saved = int(f.read())
        return _outcome(grid, "total"), best.metrics["total"], saved

    assert _same(_both(one))[1:] == (330, 330)


def test_air_session_reports_to_the_trial(clusters, tmp_path):
    """``air.session.report`` inside a trial goes to its Tune session."""
    def one(package):
        grid = _sweep(package, str(tmp_path), tt.air_report,
                      {"x": _tune(package).grid_search([1, 2])}, "y", "max")
        return _outcome(grid, "y")

    assert _same(_both(one))[1] == {"x": 2}


# -- GPU trials (the port only) ----------------------------------------------

def test_gpu_trials_are_pinned(clusters, tmp_path):
    """``{"GPU": 1}`` trials reserve faked GPUs through num_gpus: each
    sees its own id through CUDA_VISIBLE_DEVICES; a CPU trial sees none."""
    tune = _tune("ray_tpu_torch")
    grid = _sweep("ray_tpu_torch", str(tmp_path), tt.where,
                  {"i": tune.grid_search([0, 1])}, "pid", "max",
                  resources={"CPU": 1, "GPU": 1}, max_concurrent_trials=2)
    seen = [r.metrics for r in grid]
    assert grid.num_errors == 0, grid.errors
    assert sorted(m["gpu_ids"] for m in seen) == [[0], [1]]
    assert all(m["cuda_visible_devices"] == str(m["gpu_ids"][0])
               and m["resources"] == {"CPU": 1, "GPU": 1} for m in seen)
    cpu = _sweep("ray_tpu_torch", str(tmp_path), tt.where, {}, "pid", "max")
    assert cpu[0].metrics["cuda_visible_devices"] == ""
    assert cpu[0].metrics["gpu_ids"] == []


def test_tpu_trials_raise(clusters, tmp_path):
    with pytest.raises(ValueError, match="GPU"):
        _sweep("ray_tpu_torch", str(tmp_path), tt.where, {}, "pid", "max",
               resources={"CPU": 1, "TPU": 1})


# -- the slice whole: GPT trials under ASHA ----------------------------------

GPT_FIELDS = {"n_layers": 2}
GPT_STEPS = 8
GPT_LRS = [3e-3, 1e-3, 0.0]


def _gpt_inputs():
    from ray_tpu.models import GPTConfig, gpt_init

    cfg = dataclasses.replace(GPTConfig.tiny(), dtype=jnp.float32,
                              **GPT_FIELDS)
    params = jax.tree.map(np.asarray, gpt_init(jax.random.PRNGKey(0), cfg))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 65))
    return params, (tokens[:, :-1], tokens[:, 1:])


def test_gpt_sweep_under_asha(clusters, tmp_path):
    """Best lr first, one trial at a time: rung 1 (the loss before any
    update) ties every trial; at rung 4 the two lower lrs fall below the
    leader and are cut; the leader runs to max_t. Rungs 1 and 4 lie 3
    apart, more than the reports a cut trial sends before its stop."""
    params, batch = _gpt_inputs()

    def one(package):
        tune = _tune(package)
        log = []
        scheduler = recording(tune.ASHAScheduler, log, "scheduler")(
            metric="loss", mode="min", max_t=GPT_STEPS, grace_period=1,
            reduction_factor=4)
        grid = _sweep(package, str(tmp_path),
                      tt.gpt_jax if package == "ray_tpu" else tt.gpt_torch,
                      {"lr": tune.grid_search(GPT_LRS)}, "loss", "min",
                      scheduler, max_concurrent_trials=1,
                      bind={"params": params, "batch": batch,
                            "fields": GPT_FIELDS, "steps": GPT_STEPS})
        assert grid.num_errors == 0, grid.errors
        assert grid.get_best_result().config["lr"] == GPT_LRS[0]
        lr_of = {os.path.basename(r.path): r.config["lr"] for r in grid}
        losses, cuts = {lr: {} for lr in GPT_LRS}, {}
        for _, name, args, _, decision in log:
            if name != "on_result":
                continue
            lr, result = lr_of[args[0]], args[1]
            losses[lr][result["training_iteration"]] = result["loss"]
            if decision == "STOP":
                cuts.setdefault(lr, result["training_iteration"])
        return losses, cuts

    out = _both(one)
    cuts = _same({pkg: cuts for pkg, (_, cuts) in out.items()})
    assert cuts == {GPT_LRS[0]: GPT_STEPS, GPT_LRS[1]: 4, GPT_LRS[2]: 4}
    ours, theirs = out["ray_tpu_torch"][0], out["ray_tpu"][0]
    for lr in GPT_LRS:
        common = sorted(set(ours[lr]) & set(theirs[lr]))
        assert common[:cuts[lr]] == list(range(1, cuts[lr] + 1))
        np.testing.assert_allclose([ours[lr][i] for i in common],
                                   [theirs[lr][i] for i in common],
                                   rtol=LOSS_RTOL)
    # lr 0 learns nothing: its loss at the cut is its first
    assert theirs[0.0][4] == pytest.approx(theirs[0.0][1], rel=LOSS_RTOL)
