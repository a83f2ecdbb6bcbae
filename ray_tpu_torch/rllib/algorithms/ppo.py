"""PPO (reference: rllib/algorithms/ppo/ — ppo.py, ppo_learner,
default PPO RLModule): clipped surrogate objective + GAE, minibatch
epochs, the losses' math on the learner's device. Ported from the JAX
package's ``ray_tpu/rllib/algorithms/ppo.py``.
"""
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core.learner import TorchLearner
from ..core.rl_module import PPOModule, RecurrentPPOModule
from .algorithm import Algorithm, AlgorithmConfig


def taken(logp_all, actions):
    """Each row's entry at its action (take_along_axis on the last dim)."""
    return torch.gather(logp_all, -1, actions.long()[..., None])[..., 0]


def entropy_of(logp_all):
    """Per-row entropy of a categorical from its log-probs."""
    return -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)


def make_ppo_loss(clip: float = 0.2, vf_coeff: float = 0.5,
                  entropy_coeff: float = 0.01):
    """Clipped surrogate + value + entropy (reference: ppo_torch_learner
    compute_loss_for_module; coefficients match PPOConfig.training)."""

    def ppo_loss(params, module, batch):
        logits, values = module.apply(params, batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = taken(logp_all, batch["actions"])
        ratio = torch.exp(logp - batch["action_logp"])
        adv = batch["advantages"]
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        policy_loss = -torch.mean(surrogate)
        vf_loss = 0.5 * torch.mean((values - batch["value_targets"]) ** 2)
        entropy = torch.mean(entropy_of(logp_all))
        # Scheduled entropy coefficient rides the batch as a scalar
        # (reference: entropy_coeff_schedule resolved by Scheduler per
        # update) — absent, the constructor constant applies.
        ec = batch.get("entropy_coeff", entropy_coeff)
        total = policy_loss + vf_coeff * vf_loss - ec * entropy
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    return ppo_loss


ppo_loss = make_ppo_loss()  # default-coefficient loss (tests, docs)


def make_recurrent_ppo_loss(clip: float = 0.2, vf_coeff: float = 0.5,
                            entropy_coeff: float = 0.01):
    """Sequence PPO loss for use_lstm modules: the LSTM re-runs from the
    recorded rollout carry at each chunk start, padded steps masked out
    (reference: ppo loss + rllib sequence masking via seq_lens)."""

    def loss(params, module, batch):
        logits, values = module.seq_forward(
            params, batch["obs"],
            (batch["carry_c"], batch["carry_h"]), batch["resets"])
        mask = batch["mask"]
        msum = torch.clamp(mask.sum(), min=1.0)
        logp_all = F.log_softmax(logits, dim=-1)
        logp = taken(logp_all, batch["actions"])
        ratio = torch.exp(logp - batch["action_logp"])
        adv = batch["advantages"]
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        policy_loss = -torch.sum(surrogate * mask) / msum
        vf_loss = 0.5 * torch.sum(
            (values - batch["value_targets"]) ** 2 * mask) / msum
        entropy = torch.sum(entropy_of(logp_all) * mask) / msum
        total = policy_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    return loss


def _chunk_fragments(frags, max_seq_len: int) -> Dict[str, np.ndarray]:
    """Cut GAE'd rollout fragments into (num_seqs, max_seq_len) rows for
    truncated BPTT: each row carries the TRUE rollout LSTM state at its
    start (`state_in_*` recorded per step) plus in-row episode-boundary
    resets; short tails are zero-padded with mask=0 (reference: the
    max_seq_len chunking + padding in rllib's sequence handling)."""
    keys = ("obs", "actions", "advantages", "value_targets", "action_logp")
    rows: Dict[str, list] = {k: [] for k in
                             keys + ("resets", "mask", "carry_c", "carry_h")}
    L = int(max_seq_len)
    for b in frags:
        t0 = len(b["rewards"])
        done = np.logical_or(b["terminateds"], b["truncateds"])
        resets = np.zeros(t0, np.float32)
        resets[1:] = done[:-1].astype(np.float32)
        for s in range(0, t0, L):
            e = min(s + L, t0)
            pad = L - (e - s)

            def cut(x):
                x = np.asarray(x[s:e])
                if pad:
                    x = np.concatenate(
                        [x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                return x

            for k in keys:
                rows[k].append(cut(b[k]))
            # The recorded carry supplies cross-chunk state, so the
            # chunk's first step never resets.
            r = cut(resets)
            r[0] = 0.0
            rows["resets"].append(r)
            m = np.zeros(L, np.float32)
            m[:e - s] = 1.0
            rows["mask"].append(m)
            rows["carry_c"].append(b["state_in_c"][s])
            rows["carry_h"].append(b["state_in_h"][s])
    return {k: np.stack(v) for k, v in rows.items()}


def compute_gae(batch: Dict[str, np.ndarray], gamma: float,
                lam: float = 0.95, bootstrap_value: float = 0.0,
                trunc_next_values: "np.ndarray" = None
                ) -> Dict[str, np.ndarray]:
    """Generalized advantage estimation over a rollout fragment
    (reference: rllib/evaluation/postprocessing.py compute_advantages).

    `bootstrap_value` is V(s_N) for a fragment cut mid-episode — without
    it the last transitions see a zero future and targets bias low.
    `trunc_next_values[t]` (optional, full-length) supplies V(next_obs_t)
    for steps truncated mid-fragment, whose successor row belongs to the
    NEXT episode."""
    rewards = batch["rewards"]
    values = batch["vf_preds"]
    terminated = batch["terminateds"].astype(np.float32)
    truncated = np.logical_and(batch["truncateds"],
                               ~batch["terminateds"])
    trunc_or_term = np.logical_or(
        batch["terminateds"], batch["truncateds"]).astype(np.float32)
    n = len(rewards)
    adv = np.zeros(n, np.float32)
    last = 0.0
    # Bootstrap with V(s_{t+1}) within the fragment; episode boundaries
    # cut the recursion. Truncations bootstrap, terminations don't.
    next_values = np.append(values[1:], np.float32(bootstrap_value))
    if trunc_next_values is not None:
        next_values = np.where(truncated, trunc_next_values, next_values)
    for t in reversed(range(n)):
        nonterm = 1.0 - terminated[t]
        boundary = 1.0 - trunc_or_term[t]
        delta = rewards[t] + gamma * next_values[t] * nonterm - values[t]
        last = delta + gamma * lam * boundary * last
        adv[t] = last
    targets = adv + values
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    out = dict(batch)
    out["advantages"] = adv
    out["value_targets"] = targets.astype(np.float32)
    return out


class PPO(Algorithm):
    def _build_module(self, obs_dim, num_actions):
        cls = RecurrentPPOModule if self.config.model.get("use_lstm") \
            else PPOModule
        return cls(obs_dim, num_actions, self.config.hidden,
                   model_config=self.config.model)

    def _build_learner(self):
        ex = self.config.extra
        make = make_recurrent_ppo_loss \
            if getattr(self.module, "recurrent", False) else make_ppo_loss
        loss = make(
            clip=float(ex.get("clip_param", 0.2)),
            vf_coeff=float(ex.get("vf_loss_coeff", 0.5)),
            entropy_coeff=float(ex.get("entropy_coeff", 0.01)))
        # PPO applies the learner connector to fragments BEFORE GAE
        # (training_step) — clipping rewards after advantages are
        # computed would be a silent no-op, since the loss reads only
        # advantages/value_targets.
        self._learner_conn = (self.config.learner_connector()
                              if self.config.learner_connector else None)
        return TorchLearner(self.module, loss, lr=self.config.lr,
                            seed=self.config.seed,
                            device=self.config.learner_device)

    def training_step(self) -> Dict:
        if getattr(self.module, "recurrent", False):
            return self._training_step_recurrent()
        cfg = self.config
        frags = self.env_runner_group.sample(cfg.rollout_fragment_length)
        if self._learner_conn is not None:
            frags = [self._learner_conn(dict(b), module=self.module)
                     for b in frags]
        params = self.learner.get_weights()

        @torch.no_grad()
        def _gae(b):
            bootstrap = 0.0
            if not (b["terminateds"][-1] or b["truncateds"][-1]):
                _, v = self.module.apply(
                    params, b["next_obs"][-1:].astype(np.float32))
                bootstrap = float(v[0])
            trunc_nv = None
            trunc = np.logical_and(b["truncateds"], ~b["terminateds"])
            if trunc.any():
                _, v_all = self.module.apply(
                    params, b["next_obs"].astype(np.float32))
                trunc_nv = v_all.numpy()
            return compute_gae(b, cfg.gamma, cfg.extra.get("lambda_", 0.95),
                               bootstrap_value=bootstrap,
                               trunc_next_values=trunc_nv)

        frags = [_gae(b) for b in frags]
        batch = {k: np.concatenate([f[k] for f in frags])
                 for k in frags[0]}
        self._total_steps += len(batch["rewards"])
        ec_sched = cfg.extra.get("entropy_coeff_schedule")
        ec_now = None
        if ec_sched is not None:
            from ..utils.schedules import Scheduler
            ec_now = np.float32(
                Scheduler(ec_sched).value(self._total_steps))
        n = len(batch["rewards"])
        idx = np.arange(n)
        rng = np.random.default_rng(cfg.seed + self.iteration)
        num_epochs = int(cfg.extra.get("num_epochs", 4))
        minibatch = int(cfg.extra.get("minibatch_size", 128))
        stats = {}
        for _ in range(num_epochs):
            rng.shuffle(idx)
            for s in range(0, n, minibatch):
                mb = idx[s:s + minibatch]
                if len(mb) < 2:
                    continue
                mb_batch = {k: v[mb] for k, v in batch.items()}
                if ec_now is not None:
                    mb_batch["entropy_coeff"] = ec_now
                stats = self.learner.update(mb_batch)
        self.env_runner_group.sync_weights(self.learner.get_weights())
        return dict(stats)

    def _training_step_recurrent(self) -> Dict:
        """use_lstm path: GAE bootstraps from the recorded post-step
        carries, then minibatches are (sequence-chunk)-level, never
        shuffled within time."""
        cfg = self.config
        frags = self.env_runner_group.sample(cfg.rollout_fragment_length)
        if self._learner_conn is not None:
            frags = [self._learner_conn(dict(b), module=self.module)
                     for b in frags]
        params = self.learner.get_weights()
        mod = self.module

        def _gae(b):
            bootstrap = 0.0
            if not (b["terminateds"][-1] or b["truncateds"][-1]):
                v = mod.value_with_state(
                    params, b["next_obs"][-1:].astype(np.float32),
                    (b["state_out_c"][-1:], b["state_out_h"][-1:]))
                bootstrap = float(v[0])
            trunc = np.logical_and(b["truncateds"], ~b["terminateds"])
            trunc_nv = None
            if trunc.any():
                trunc_nv = np.asarray(mod.value_with_state(
                    params, b["next_obs"].astype(np.float32),
                    (b["state_out_c"], b["state_out_h"])))
            return compute_gae(b, cfg.gamma,
                               cfg.extra.get("lambda_", 0.95),
                               bootstrap_value=bootstrap,
                               trunc_next_values=trunc_nv)

        frags = [_gae(b) for b in frags]
        self._total_steps += sum(len(b["rewards"]) for b in frags)
        batch = _chunk_fragments(frags, mod.max_seq_len)
        n = len(batch["mask"])
        mb_seqs = max(1, int(cfg.extra.get("minibatch_size", 128))
                      // mod.max_seq_len)
        idx = np.arange(n)
        rng = np.random.default_rng(cfg.seed + self.iteration)
        stats: Dict = {}
        for _ in range(int(cfg.extra.get("num_epochs", 4))):
            rng.shuffle(idx)
            for s in range(0, n, mb_seqs):
                mb = idx[s:s + mb_seqs]
                stats = self.learner.update(
                    {k: v[mb] for k, v in batch.items()})
        self.env_runner_group.sync_weights(self.learner.get_weights())
        return dict(stats)


class PPOConfig(AlgorithmConfig):
    ALGO_CLS = PPO
