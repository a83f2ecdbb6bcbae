"""Trainables that ``tests/test_torch_tune.py`` runs in the trial actors
of both packages.

The trial processes import this module by name, so it imports neither
JAX nor either package at module level: each trainable takes the package
whose session it reports to (``package``, bound with
``tune.with_parameters``), and the GPT trials import their framework
inside the call (JAX in ``ray_tpu``'s trial processes, torch in the
port's).
"""

import importlib
import json
import os
import shutil
import tempfile


def _tune(package):
    return importlib.import_module(package + ".tune")


def _checkpoint(package, state: dict):
    """A checkpoint directory holding ``state`` as JSON (the session
    copies it into the trial's directory)."""
    cls = importlib.import_module(package + ".train.checkpoint").Checkpoint
    path = tempfile.mkdtemp(prefix="tune_ckpt_")
    with open(os.path.join(path, "state.json"), "w") as f:
        json.dump(state, f)
    return cls.from_directory(path)


def _report_with_state(package, metrics: dict, state: dict) -> None:
    ckpt = _checkpoint(package, state)
    try:
        _tune(package).report(metrics, checkpoint=ckpt)
    finally:
        shutil.rmtree(ckpt.path, ignore_errors=True)


def _restored(package):
    ckpt = _tune(package).get_checkpoint()
    if ckpt is None:
        return None
    with open(os.path.join(ckpt.path, "state.json")) as f:
        return json.load(f)


def curve(config, package, iters=8):
    """``score = quality * i`` at i = 1..iters: ASHA, HyperBand and the
    median rule cut the low-quality trials."""
    tune = _tune(package)
    for i in range(1, iters + 1):
        tune.report({"score": config["quality"] * i})


def bump(config, package, iters=8):
    """BOHB's objective: a score growing with the budget, peaked at
    x = 0.3."""
    tune = _tune(package)
    for i in range(1, iters + 1):
        tune.report({"score": i * (1.0 - (config["x"] - 0.3) ** 2),
                     "training_iteration": i})


def growth(config, package, iters=6):
    """PBT's and PB2's objective: the score grows at a rate peaked at
    lr = 0.7, and each iteration checkpoints (x, i), from which an
    exploited trial resumes."""
    x, start = 0.0, 1
    state = _restored(package)
    if state is not None:
        x, start = state["x"], state["iter"] + 1
    for i in range(start, iters + 1):
        x += max(0.0, 1.0 - 3.0 * abs(config["lr"] - 0.7))
        _report_with_state(package, {"score": x, "training_iteration": i},
                           {"x": x, "iter": i})


def quadratic(config, package, offset=0.0):
    """One report of ``-(x - 3)^2 + offset``; x = 13 raises."""
    if config["x"] == 13:
        raise RuntimeError("unlucky trial")
    _tune(package).report({"score": -(config["x"] - 3) ** 2 + offset})


def counting(config, package, iters=3, fail_at=None, marker=None):
    """Counts to ``iters``, checkpointing each count; with ``fail_at``,
    the first run to reach it (no ``marker`` file yet) raises after its
    checkpoint, and a retry resumes from that checkpoint."""
    state = _restored(package)
    start = state["iter"] + 1 if state else 1
    for i in range(start, iters + 1):
        _report_with_state(package, {"count": i * config["step"],
                                     "training_iteration": i,
                                     "resumed_at": start},
                           {"iter": i})
        if i == fail_at and not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("planted failure after a checkpoint")


def accumulator(package):
    """A class trainable of ``package``: adds ``x`` (plus a ``bonus``
    bound with ``with_parameters``) each step, checkpoints its total,
    and is done after three steps."""
    base = _tune(package).Trainable

    class Accumulator(base):
        def setup(self, config, bonus=0):
            self.step_size = config["x"] + bonus
            self.total = 0

        def step(self):
            self.total += self.step_size
            return {"total": self.total,
                    "done": self.training_iteration >= 2}

        def save_checkpoint(self, checkpoint_dir):
            with open(os.path.join(checkpoint_dir, "total.txt"), "w") as f:
                f.write(str(self.total))
            return checkpoint_dir

        def load_checkpoint(self, checkpoint_dir):
            with open(os.path.join(checkpoint_dir, "total.txt")) as f:
                self.total = int(f.read())

    return Accumulator


def air_report(config, package):
    """Reports through ``air.session``, which inside a trial forwards to
    Tune's session."""
    session = importlib.import_module(package + ".air").session
    session.report({"y": config["x"] * 2})


def where(config, package):
    """The cards this trial sees and the resources it was granted."""
    ray = importlib.import_module(package)
    _tune(package).report({
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "gpu_ids": [int(i) for i in ray.get_gpu_ids()],
        "resources": _tune(package).get_trial_resources(),
        "pid": os.getpid()})


def gpt_jax(config, package, params, batch, fields, steps):
    """``steps`` of ``ray_tpu``'s GPT train step (AdamW at ``config["lr"]``,
    weight decay 0.01) from the numpy ``params`` on ``batch``, each
    step's loss reported."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import GPTConfig
    from ray_tpu.models.gpt import make_train_step

    cfg = dataclasses.replace(GPTConfig.tiny(), dtype=jnp.float32, **fields)
    optimizer = optax.adamw(config["lr"], weight_decay=0.01)
    _, train_step = make_train_step(cfg, optimizer=optimizer, donate=False)
    p = jax.tree.map(jnp.asarray, params)
    state = {"params": p, "opt_state": optimizer.init(p),
             "step": jnp.zeros((), dtype=jnp.int32)}
    tokens = tuple(jnp.asarray(x) for x in batch)
    tune = _tune(package)
    for i in range(1, steps + 1):
        state, m = train_step(state, tokens)
        tune.report({"loss": float(m["loss"]), "training_iteration": i})


def gpt_torch(config, package, params, batch, fields, steps):
    """The port's counterpart of ``gpt_jax`` on the CPU: its train step on
    ``from_jax_params`` of the same numpy ``params``, AdamW with optax's
    b1, b2 and eps."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import GPTConfig, from_jax_params
    from ray_tpu_torch.models import make_train_step

    torch.set_num_threads(1)
    cfg = dataclasses.replace(GPTConfig.tiny(), dtype=torch.float32,
                              **fields)

    def adamw(ps):
        return torch.optim.AdamW(ps, lr=config["lr"], betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=0.01)

    init_state, train_step = make_train_step(cfg, optimizer=adamw,
                                             device="cpu")
    state = init_state(params=from_jax_params(params, "cpu"))
    tokens = tuple(torch.from_numpy(x) for x in batch)
    tune = _tune(package)
    for i in range(1, steps + 1):
        state, m = train_step(state, tokens)
        tune.report({"loss": float(m["loss"]), "training_iteration": i})
