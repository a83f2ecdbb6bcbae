"""BC / MARWIL — offline policy learning from experience datasets.

Reference parity: rllib/algorithms/bc/ (behavior cloning) and marwil/
(advantage-weighted BC — MARWIL's beta=0 reduces to BC, the same
relationship the reference implements). Training consumes an offline
DatasetReader instead of env runners; evaluation rolls out the learned
policy on the configured env. Ported from the JAX package's
``ray_tpu/rllib/algorithms/bc.py``.
"""
from typing import Dict

import torch
import torch.nn.functional as F

from ..core.learner import TorchLearner
from ..core.rl_module import PPOModule
from ..offline import resolve_offline_reader
from .algorithm import Algorithm, AlgorithmConfig
from .ppo import taken


def make_marwil_loss(beta: float, vf_coeff: float = 1.0):
    """Advantage-weighted imitation (MARWIL eq. 4); beta=0 -> plain BC.

    Expects batch columns obs / actions / value_targets (monte-carlo
    returns; ignored when beta == 0).
    """

    def marwil_loss(params, module, batch):
        logits, values = module.apply(params, batch["obs"])
        logp = taken(F.log_softmax(logits, dim=-1), batch["actions"])
        if beta > 0:
            adv = batch["value_targets"] - values
            weight = torch.exp(torch.clamp(
                beta * adv.detach(), -10.0, 10.0))
            policy_loss = -torch.mean(weight * logp)
            vf_loss = torch.mean(adv ** 2)
        else:
            policy_loss = -torch.mean(logp)
            vf_loss = torch.zeros((), device=logp.device)
        total = policy_loss + vf_coeff * vf_loss
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "logp_mean": torch.mean(logp)}

    return marwil_loss


class MARWIL(Algorithm):
    """Offline algorithm: no env runners (num_env_runners=0);
    `offline_data` (a Dataset or DatasetReader) supplies training
    batches. Monte-Carlo value targets are computed ONCE by the reader
    over episode-ordered rows — never on shuffled minibatches."""

    _beta = 1.0

    def __init__(self, config):
        beta = float(config.extra.get("beta", self._beta))
        reader = resolve_offline_reader(
            config, type(self).__name__,
            compute_returns=config.gamma if beta > 0 else None)
        if beta > 0 and reader._rows and \
                "value_targets" not in reader._rows[0]:
            # User-built reader without returns: compute them here (over
            # episode order) rather than KeyError deep in the loss.
            reader._add_value_targets(config.gamma)
        self.reader = reader
        super().__init__(config)

    def _build_module(self, obs_dim, num_actions):
        return PPOModule(obs_dim, num_actions, self.config.hidden,
                         model_config=self.config.model)

    def _build_learner(self):
        cfg = self.config
        beta = float(cfg.extra.get("beta", self._beta))
        return TorchLearner(
            self.module,
            make_marwil_loss(beta, float(cfg.extra.get("vf_coeff", 1.0))),
            lr=cfg.lr, seed=cfg.seed, device=cfg.learner_device)

    def training_step(self) -> Dict:
        cfg = self.config
        stats: Dict = {}
        n = 0
        for batch in self.reader.iter_batches(
                epochs=int(cfg.extra.get("epochs_per_iter", 1))):
            stats.update(self.learner.update(batch))
            n += len(batch["actions"])
        self._total_steps += n
        if self.env_runner_group is not None:
            self.env_runner_group.sync_weights(self.learner.get_weights())
        return stats


class BC(MARWIL):
    """Plain behavior cloning (reference: rllib/algorithms/bc)."""

    _beta = 0.0


class MARWILConfig(AlgorithmConfig):
    ALGO_CLS = MARWIL

    def __init__(self):
        super().__init__()
        self.num_env_runners = 0
        self.train_batch_size = 256


class BCConfig(MARWILConfig):
    ALGO_CLS = BC
