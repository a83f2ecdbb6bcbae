"""IMPALA — importance-weighted actor-learner with V-trace.

Reference parity: rllib/algorithms/impala/ (impala.py, vtrace) and appo/
(APPO = IMPALA + PPO-style clipping). The reference's async actor-learner
queues collapse here into the standard EnvRunnerGroup fan-out: runners
sample with a (possibly stale) behavior policy while the learner updates —
V-trace corrects exactly that staleness, so the decoupling the reference
gets from its aggregator/learner threads is preserved without them.
Ported from the JAX package's ``ray_tpu/rllib/algorithms/impala.py``.
"""
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core.learner import TorchLearner
from ..core.rl_module import PPOModule
from .algorithm import Algorithm, AlgorithmConfig
from .ppo import entropy_of, taken


def vtrace(behavior_logp, target_logp, rewards, values, bootstrap_value,
           terminateds, gamma: float, clip_rho: float = 1.0,
           clip_c: float = 1.0):
    """V-trace targets and policy-gradient advantages (IMPALA eq. 1-2).

    All inputs [T] tensors (time-major single trajectory fragment);
    returns (vs [T], pg_advantages [T]). The JAX package's reverse
    ``lax.scan`` is a loop over reversed time here.
    """
    rho = torch.exp(target_logp - behavior_logp)
    rho_bar = torch.clamp(rho, max=clip_rho)
    c_bar = torch.clamp(rho, max=clip_c)
    nonterm = 1.0 - terminateds.to(values.dtype)
    bootstrap = torch.as_tensor(bootstrap_value, dtype=values.dtype,
                                device=values.device).reshape(1)
    # Terminal steps bootstrap from 0, and corrections stop at episode
    # boundaries.
    values_next = torch.cat([values[1:], bootstrap]) * nonterm
    deltas = rho_bar * (rewards + gamma * values_next - values)
    acc = torch.zeros((), dtype=values.dtype, device=values.device)
    dv = [acc] * len(deltas)
    for t in reversed(range(len(deltas))):
        acc = deltas[t] + gamma * nonterm[t] * c_bar[t] * acc
        dv[t] = acc
    vs = values + torch.stack(dv)
    vs_next = torch.cat([vs[1:], bootstrap]) * nonterm
    pg_adv = rho_bar * (rewards + gamma * vs_next - values)
    return vs, pg_adv


def make_impala_loss(gamma: float, vf_coeff: float = 0.5,
                     entropy_coeff: float = 0.01,
                     clip_rho: float = 1.0, clip_c: float = 1.0):
    def impala_loss(params, module, batch):
        logits, values = module.apply(params, batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        target_logp = taken(logp_all, batch["actions"])
        vs, pg_adv = vtrace(
            batch["action_logp"], target_logp.detach(),
            batch["rewards"], values.detach(),
            batch["bootstrap_value"], batch["terminateds"], gamma,
            clip_rho, clip_c)
        policy_loss = -torch.mean(target_logp * pg_adv.detach())
        vf_loss = 0.5 * torch.mean((values - vs.detach()) ** 2)
        entropy = torch.mean(entropy_of(logp_all))
        total = policy_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": entropy,
                       "mean_vtrace_adv": torch.mean(pg_adv)}

    return impala_loss


def make_appo_loss(gamma: float, clip: float = 0.2, vf_coeff: float = 0.5,
                   entropy_coeff: float = 0.01):
    """PPO-clip surrogate on the v-trace advantages (APPO's loss)."""

    def appo_loss(params, module, batch):
        logits, values = module.apply(params, batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        target_logp = taken(logp_all, batch["actions"])
        vs, pg_adv = vtrace(
            batch["action_logp"], target_logp.detach(),
            batch["rewards"], values.detach(),
            batch["bootstrap_value"], batch["terminateds"], gamma)
        ratio = torch.exp(target_logp - batch["action_logp"])
        adv = pg_adv.detach()
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        policy_loss = -torch.mean(surrogate)
        vf_loss = 0.5 * torch.mean((values - vs.detach()) ** 2)
        entropy = torch.mean(entropy_of(logp_all))
        total = policy_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        return total, {"policy_loss": policy_loss,
                       "vf_loss": vf_loss, "entropy": entropy}

    return appo_loss


class IMPALA(Algorithm):
    def _build_module(self, obs_dim, num_actions):
        return PPOModule(obs_dim, num_actions, self.config.hidden,
                         model_config=self.config.model)

    def _build_learner(self):
        cfg = self.config
        return TorchLearner(
            self.module,
            make_impala_loss(
                cfg.gamma,
                vf_coeff=float(cfg.extra.get("vf_loss_coeff", 0.5)),
                entropy_coeff=float(cfg.extra.get("entropy_coeff", 0.01)),
                clip_rho=float(cfg.extra.get("vtrace_clip_rho", 1.0)),
                clip_c=float(cfg.extra.get("vtrace_clip_c", 1.0))),
            lr=cfg.lr, seed=cfg.seed, device=cfg.learner_device)

    def training_step(self) -> Dict:
        cfg = self.config
        # Sample with the CURRENT weights as behavior policy, then run
        # several updates on the same data — V-trace corrects the
        # policy lag of the later epochs (the async-queue staleness of
        # the reference, reproduced synchronously).
        frags = self.env_runner_group.sample(cfg.rollout_fragment_length)
        stats: Dict = {}
        for frag in frags:
            self._total_steps += len(frag["rewards"])
        for _ in range(int(cfg.extra.get("num_epochs", 2))):
            for frag in frags:
                bootstrap = 0.0
                if not frag["terminateds"][-1]:
                    # V(next_obs) on the learner's own params and device.
                    with torch.no_grad():
                        _, v = self.module.apply(
                            self.learner.params, frag["next_obs"][-1:])
                    bootstrap = float(v[0])
                batch = dict(frag)
                batch["bootstrap_value"] = np.float32(bootstrap)
                stats.update(self.learner.update(batch))
        self.env_runner_group.sync_weights(self.learner.get_weights())
        return stats


class IMPALAConfig(AlgorithmConfig):
    ALGO_CLS = IMPALA

    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.rollout_fragment_length = 256


class APPO(IMPALA):
    """APPO = IMPALA machinery + PPO-style clipping (reference:
    rllib/algorithms/appo/)."""

    def _build_learner(self):
        cfg = self.config
        return TorchLearner(
            self.module,
            make_appo_loss(
                cfg.gamma, clip=float(cfg.extra.get("clip_param", 0.2)),
                vf_coeff=float(cfg.extra.get("vf_loss_coeff", 0.5)),
                entropy_coeff=float(cfg.extra.get("entropy_coeff", 0.01))),
            lr=cfg.lr, seed=cfg.seed, device=cfg.learner_device)


class APPOConfig(IMPALAConfig):
    ALGO_CLS = APPO
