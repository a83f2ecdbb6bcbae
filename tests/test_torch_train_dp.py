"""ray_tpu_torch.train on the CPU: the data-parallel GPT step through the
port's own TorchTrainer on gloo, held against the JAX package's dp step,
and the Train contract of ``tests/test_train.py``.

The dp run: two gloo workers take two steps of ``GPTConfig.tiny()`` in
f32 on a ``MeshConfig(dp=2)`` mesh, from weights drawn by ``ray_tpu`` and
carried over with ``from_jax_params``, each worker fed its
``shard_batch`` of the same global batches; the JAX package runs
``make_train_step`` on a dp=2 CPU mesh with its own ``shard_batch``. One
small cluster (4 CPUs) serves the module; every wait has a deadline.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import train
from ray_tpu_torch.train import (Checkpoint, CheckpointManager,
                                 DataParallelTrainer, FailureConfig,
                                 RunConfig, ScalingConfig,
                                 TorchBackendConfig, TorchTrainer)

STEPS, GLOBAL_BATCH, SEQ = 2, 4, 16
# The single-device bands of tests/test_torch_train.py (f32, the same
# AdamW arithmetic): a leaf's max |port - jax| over its max |jax|, and
# the loss's relative error. The dp step sums each rank's gradient and
# then the ranks', where XLA sums the global batch's: another order of
# the same f32 sums.
PARAM_TOL, LOSS_RTOL = 2e-5, 1e-5


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _batches(vocab):
    out = []
    for i in range(STEPS):
        toks = np.random.default_rng(20 + i).integers(
            0, vocab, (GLOBAL_BATCH, SEQ + 1))
        out.append((toks[:, :-1], toks[:, 1:]))
    return out


def _dp_loop(config):
    """Each worker: the port's dp step on its shard of every batch. Rank 1
    starts from other weights, so the run also shows place_params
    broadcasting rank 0's."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import (GPTConfig, from_jax_params,
                                      make_train_step, shard_batch)
    from ray_tpu_torch.models.convert import tree_leaves
    from ray_tpu_torch.parallel import (MeshConfig, make_mesh,
                                        mesh_axis_size, tp_rules)

    torch.set_num_threads(2)
    ctx = train.get_context()
    cfg = GPTConfig(dtype=torch.float32, **config["cfg"])
    params = from_jax_params(config["params"], "cpu")
    if ctx.world_rank != 0:
        params = dict(params)
        params["embed"] = torch.zeros_like(params["embed"])
    mesh = make_mesh(MeshConfig(dp=2))
    init_state, train_step = make_train_step(cfg, device="cpu", mesh=mesh,
                                             rules=tp_rules())
    state = init_state(params=params)
    flat0 = torch.cat([p.detach().reshape(-1) for p in
                       tree_leaves(state["params"])])
    losses = []
    for batch in config["batches"]:
        state, m = train_step(state, shard_batch(batch, mesh))
        losses.append(float(m["loss"]))
    flat = torch.cat([p.detach().reshape(-1) for p in
                      tree_leaves(state["params"])])
    gathered = [torch.empty_like(flat) for _ in range(ctx.world_size)]
    dist.all_gather(gathered, flat)
    starts = [torch.empty_like(flat0) for _ in range(ctx.world_size)]
    dist.all_gather(starts, flat0)
    raised = {}
    for name, mc in (("tp", MeshConfig(dp=1, tp=2)),
                     ("fsdp", MeshConfig(dp=1, fsdp=2))):
        try:
            make_train_step(cfg, device="cpu", mesh=make_mesh(mc),
                            rules=tp_rules())
            raised[name] = None
        except NotImplementedError as e:
            raised[name] = str(e)
    metrics = {
        "losses": losses, "backend": dist.get_backend(),
        "world": dist.get_world_size(), "rank": ctx.world_rank,
        "mesh_names": list(mesh.mesh_dim_names),
        "dp_size": mesh_axis_size(mesh, "dp"),
        "ranks_agree": all(torch.equal(g, gathered[0]) for g in gathered),
        "starts_agree": all(torch.equal(s, starts[0]) for s in starts),
        "raised": raised,
        "params": to_numpy(state["params"]),
    }
    checkpoint = None
    if ctx.world_rank == 0:
        import tempfile

        checkpoint = Checkpoint.from_state(
            state, tempfile.mkdtemp(prefix="dp_ckpt_"))
    train.report(metrics, checkpoint=checkpoint)


def to_numpy(params):
    """A port param tree as numpy (f32), in the same dict/list shape."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [to_numpy(v) for v in params]
    return params.detach().float().numpy()


@pytest.fixture(scope="module")
def dp_run(cluster, tmp_path_factory):
    from ray_tpu.models import GPTConfig as JConfig
    from ray_tpu.models.gpt import make_train_step as j_make_train_step
    from ray_tpu.models.gpt import shard_batch as j_shard_batch
    from ray_tpu.parallel import MeshConfig as JMeshConfig
    from ray_tpu.parallel import make_mesh as j_make_mesh
    from ray_tpu.parallel import tp_rules as j_tp_rules

    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32)
    jmesh = j_make_mesh(JMeshConfig(dp=2), devices=jax.devices()[:2])
    j_init_state, j_step = j_make_train_step(jcfg, donate=False, mesh=jmesh,
                                             rules=j_tp_rules())
    jstate = j_init_state(jax.random.PRNGKey(7))
    start = jax.tree.map(np.asarray, jstate["params"])
    batches = _batches(jcfg.vocab_size)
    jlosses = []
    for tokens, targets in batches:
        jstate, jm = j_step(jstate, j_shard_batch(
            (jnp.asarray(tokens), jnp.asarray(targets)), jmesh))
        jlosses.append(float(jm["loss"]))

    cfg = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
           if f.name != "dtype"}
    result = TorchTrainer(
        _dp_loop,
        train_loop_config={"cfg": cfg, "params": start, "batches": batches},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="dp",
                             storage_path=str(tmp_path_factory.mktemp("dp"))),
    ).fit()
    return {"result": result, "jlosses": jlosses,
            "jparams": jax.tree.map(np.asarray, jstate["params"])}


def _norm_errs(ours, theirs):
    """Per leaf: max |ours - theirs| / max |theirs|."""
    return jax.tree.leaves(jax.tree.map(
        lambda t, j: float(np.abs(np.asarray(t) - j).max()
                           / max(np.abs(j).max(), 1e-30)), ours, theirs))


class TestDataParallelGPT:
    def test_ran_on_gloo_over_two_ranks(self, dp_run):
        result = dp_run["result"]
        assert result.error is None, result.error
        m = result.metrics
        assert (m["backend"], m["world"], m["rank"]) == ("gloo", 2, 0)
        assert m["mesh_names"] == ["dp", "fsdp", "pp", "sp", "ep", "tp"]
        assert m["dp_size"] == 2

    def test_losses_match_jax_dp2(self, dp_run):
        ours = dp_run["result"].metrics["losses"]
        theirs = dp_run["jlosses"]
        assert len(ours) == len(theirs) == STEPS
        for a, b in zip(ours, theirs):
            assert abs(a - b) <= LOSS_RTOL * abs(b), (ours, theirs)

    def test_params_match_jax_dp2(self, dp_run):
        errs = _norm_errs(dp_run["result"].metrics["params"],
                          dp_run["jparams"])
        assert len(errs) == 2 + 6 * 2
        assert max(errs) <= PARAM_TOL, errs

    def test_ranks_start_and_end_equal(self, dp_run):
        m = dp_run["result"].metrics
        # rank 1 drew other embeddings: place_params broadcast rank 0's.
        assert m["starts_agree"] and m["ranks_agree"]

    def test_checkpoint_holds_the_state(self, dp_run):
        ckpt = dp_run["result"].checkpoint
        state = ckpt.to_state()
        assert set(state) == {"params", "opt_state", "step"}
        assert state["step"] == STEPS
        errs = _norm_errs(to_numpy(state["params"]),
                          dp_run["result"].metrics["params"])
        assert max(errs) == 0.0
        assert set(state["opt_state"]) == {"state", "param_groups"}

    @pytest.mark.parametrize("axis", ["tp", "fsdp"])
    def test_other_axes_raise(self, dp_run, axis):
        msg = dp_run["result"].metrics["raised"][axis]
        assert msg is not None and "Queue 1 item 5" in msg, msg


class TestTorchTrainer:
    def test_process_group_at_world_size_one(self, cluster, tmp_path):
        def loop(config):
            import torch.distributed as dist
            train.report({"init": dist.is_initialized(),
                          "backend": dist.get_backend(),
                          "world": dist.get_world_size()})

        result = TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name="one", storage_path=str(tmp_path)),
        ).fit()
        assert result.error is None, result.error
        assert result.metrics == {"init": True, "backend": "gloo",
                                  "world": 1}

    def test_gloo_allreduce(self, cluster, tmp_path):
        def loop(config):
            import torch
            import torch.distributed as dist
            t = torch.ones(2) * (train.get_world_rank() + 1)
            dist.all_reduce(t)  # 1+2 = 3 across 2 workers
            train.report({"sum0": float(t[0])})

        result = TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name="ar", storage_path=str(tmp_path)),
        ).fit()
        assert result.metrics["sum0"] == 3.0

    @pytest.mark.parametrize("use_gpu,given,want", [
        (False, None, "gloo"), (True, None, "nccl"), (True, "gloo", "gloo")])
    def test_backend_follows_use_gpu(self, use_gpu, given, want):
        trainer = TorchTrainer(
            lambda config: None,
            torch_config=TorchBackendConfig(backend=given),
            scaling_config=ScalingConfig(use_gpu=use_gpu))
        assert trainer.backend_config.backend == want

    def test_use_gpu_reserves_a_gpu(self):
        assert ScalingConfig(use_gpu=True).worker_resources() == \
            {"CPU": 1.0, "GPU": 1.0}
        assert ScalingConfig().worker_resources() == {"CPU": 1.0}

    def test_use_gpu_without_a_gpu_is_reported(self, cluster, tmp_path):
        result = TorchTrainer(
            lambda config: None,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="nogpu", storage_path=str(tmp_path)),
        ).fit()
        assert result.error is not None and "GPU" in str(result.error)

    def test_nccl_never_falls_back_to_gloo(self, cluster, tmp_path):
        result = TorchTrainer(
            lambda config: train.report({"ran": 1}),
            torch_config=TorchBackendConfig(backend="nccl"),
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name="nccl", storage_path=str(tmp_path)),
        ).fit()
        assert result.error is not None and "GPU" in str(result.error)
        assert "ran" not in result.metrics

    def test_default_storage_is_the_ports(self):
        assert RunConfig().resolved_storage_path().endswith(
            "ray_tpu_torch_results")


class TestCheckpoint:
    def test_state_roundtrip(self, tmp_path):
        w = torch.arange(6.0).reshape(2, 3).requires_grad_()
        opt = torch.optim.AdamW([w], lr=0.1)
        w.sum().backward()
        opt.step()
        state = {"w": w, "nested": {"b": torch.ones(4, dtype=torch.bfloat16),
                                    "n": np.arange(3)},
                 "opt_state": opt, "step": 7}
        restored = Checkpoint.from_state(state, str(tmp_path / "ck")
                                         ).to_state()
        torch.testing.assert_close(restored["w"], w.detach())
        assert restored["nested"]["b"].dtype == torch.bfloat16
        torch.testing.assert_close(restored["nested"]["n"],
                                   torch.arange(3))
        assert restored["step"] == 7
        moments = restored["opt_state"]["state"][0]
        torch.testing.assert_close(moments["exp_avg"],
                                   opt.state[w]["exp_avg"])
        opt2 = torch.optim.AdamW([w.detach().clone().requires_grad_()])
        opt2.load_state_dict(restored["opt_state"])

    def test_manager_keep_n(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), num_to_keep=2)
        for i in range(4):
            p = mgr.next_checkpoint_path()
            os.makedirs(p)
            open(os.path.join(p, "data"), "w").write(str(i))
            mgr.register(Checkpoint(p), {"i": i})
        assert len(mgr.all()) == 2
        assert mgr.latest is not None

    def test_manager_best_by_score(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), num_to_keep=None,
                                score_attribute="acc")
        for acc in [0.1, 0.9, 0.5]:
            p = mgr.next_checkpoint_path()
            os.makedirs(p)
            mgr.register(Checkpoint(p), {"acc": acc})
        best_metrics = [m for c, m in mgr.all() if c.path == mgr.best.path]
        assert best_metrics[0]["acc"] == 0.9


class TestDataParallelTrainer:
    def test_basic_fit(self, cluster, tmp_path):
        def loop(config):
            for i in range(3):
                train.report({"loss": 10.0 - i, "iter": i})

        result = DataParallelTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name="basic", storage_path=str(tmp_path)),
        ).fit()
        assert result.error is None
        assert result.metrics["iter"] == 2

    def test_context(self, cluster, tmp_path):
        def loop(config):
            ctx = train.get_context()
            train.report({"rank": ctx.world_rank, "ws": ctx.world_size,
                          "cuda": os.environ.get("CUDA_VISIBLE_DEVICES")})

        result = DataParallelTrainer(
            loop, train_loop_config={"lr": 0.125},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name="ctx", storage_path=str(tmp_path)),
        ).fit()
        assert result.error is None
        assert (result.metrics["ws"], result.metrics["rank"]) == (2, 0)
        # A worker that reserves no GPU sees none.
        assert result.metrics["cuda"] == ""

    def test_checkpoint_flow(self, cluster, tmp_path):
        def loop(config):
            import tempfile

            import torch
            ctx = train.get_context()
            start = 0
            ckpt = train.get_checkpoint()
            if ckpt is not None:
                start = int(ckpt.to_state()["step"])
            for step in range(start, start + 2):
                if ctx.world_rank == 0:
                    c = Checkpoint.from_state(
                        {"step": torch.tensor(step + 1)}, tempfile.mkdtemp())
                    train.report({"step": step + 1}, checkpoint=c)
                else:
                    train.report({"step": step + 1})

        result = DataParallelTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name="ck", storage_path=str(tmp_path)),
        ).fit()
        assert result.error is None
        assert int(result.checkpoint.to_state()["step"]) == 2
        result2 = DataParallelTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(name="ck2", storage_path=str(tmp_path)),
            resume_from_checkpoint=result.checkpoint,
        ).fit()
        assert int(result2.checkpoint.to_state()["step"]) == 4

    def test_worker_error_surfaces(self, cluster, tmp_path):
        def loop(config):
            raise RuntimeError("train-loop-failure")

        result = TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name="err", storage_path=str(tmp_path)),
        ).fit()
        assert result.error is not None
        assert "train-loop-failure" in str(result.error)

    def test_failure_retry_recovers(self, cluster, tmp_path):
        marker = str(tmp_path / "attempted")

        def loop(config):
            import os
            if not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("first attempt dies")
            train.report({"ok": 1})

        trainer = TorchTrainer(
            loop, train_loop_config={"marker": marker},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(
                name="retry", storage_path=str(tmp_path),
                failure_config=FailureConfig(max_failures=1)))
        result = trainer.fit()
        assert result.error is None
        assert result.metrics["ok"] == 1
        states = [s for s, _ in trainer._controller.state_log]
        assert states == ["INITIALIZING", "SCHEDULING", "RUNNING",
                          "RESTARTING", "SCHEDULING", "RUNNING", "FINISHED"]

    def test_elastic_sizes_gang_to_cluster(self, cluster, tmp_path):
        trainer = DataParallelTrainer(
            lambda config: train.report({"ws": train.get_world_size()}),
            scaling_config=ScalingConfig(
                num_workers=64, min_workers=1, max_workers=64,
                resources_per_worker={"CPU": 1}),
            run_config=RunConfig(name="el", storage_path=str(tmp_path)))
        result = trainer.fit()
        assert result.error is None
        sizes = trainer._controller.world_sizes
        assert 1 <= sizes[0] <= 4  # the cluster has 4 CPUs
        assert result.metrics["ws"] == sizes[0]
