"""RLModule: the model abstraction.

Reference parity: rllib/core/rl_module/rl_module.py:260 (RLModule with
forward_inference / forward_exploration / forward_train), ported from the
JAX package's flax modules (``ray_tpu/rllib/core/rl_module.py``): a
module is a torch network applied to explicit params, a plain dict whose
keys mirror the flax tree (``torch.func.functional_call``), so the same
definition runs in env-runner actors (numpy in, actions out, on the CPU)
and in the learner's update on its device. Inputs go to the device of the
params they meet.
"""
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..._tree import tree_paths
from .catalog import (Catalog, LSTMEncoder, MLPEncoder, init_flax_style,
                      merge_model_config)


def params_of(net: nn.Module) -> Dict[str, Any]:
    """``net``'s own params as a nested dict of detached CPU copies, keyed
    as the flax tree is (a shared submodule once, under its first name)."""
    out: Dict[str, Any] = {}
    for name, p in net.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().clone()
    return out


def _leaf_of(params) -> torch.Tensor:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params


def _device_of(params) -> torch.device:
    return _leaf_of(params).device


def _writable(a: np.ndarray) -> np.ndarray:
    """``a``, copied if it is read-only (an array over the object
    store's pages): torch has no read-only tensor."""
    return a if a.flags.writeable else a.copy()


def _input(x, device: torch.device,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An observation batch (numpy or tensor) as ``dtype`` (f32) on
    ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(_writable(np.asarray(x)),
                           device=device).to(dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def apply_net(net: nn.Module, params, *args):
    """``net`` run on ``params``, whose keys must be exactly its own.

    A submodule held twice (the recurrent net's encoder, at the top as
    flax keeps it and inside its LSTM encoder) is one object: it gets
    its params once, under its first name. torch's tie_weights would
    swap that object's tensors once a name and so put its own back."""
    flat = tree_paths(params)
    names = getattr(net, "_param_names", None)
    if names is None:
        names = net._param_names = frozenset(
            n for n, _ in net.named_parameters())
    if flat.keys() != names:
        raise KeyError(f"params do not match the net: missing "
                       f"{sorted(names - flat.keys())}, unexpected "
                       f"{sorted(flat.keys() - names)}")
    return functional_call(net, flat, args, tie_weights=False)


class ActorCriticNet(nn.Module):
    """Policy logits + value head (PPO-style). `encoder` is any torso
    from the Catalog (MLP for vector obs, CNN for images)."""

    def __init__(self, num_actions: int, encoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.Dense_0 = nn.Linear(encoder.out_dim, num_actions)
        self.Dense_1 = nn.Linear(encoder.out_dim, 1)

    def forward(self, obs):
        z = self.encoder(obs)
        return self.Dense_0(z), self.Dense_1(z).squeeze(-1)


class QNet(nn.Module):
    """Q-values per action (DQN-style)."""

    def __init__(self, num_actions: int, encoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.Dense_0 = nn.Linear(encoder.out_dim, num_actions)

    def forward(self, obs):
        return self.Dense_0(self.encoder(obs))


class GaussianActorNet(nn.Module):
    """Squashed-Gaussian policy head (SAC-style): mean + log_std."""

    def __init__(self, action_dim: int, encoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.Dense_0 = nn.Linear(encoder.out_dim, action_dim)
        self.Dense_1 = nn.Linear(encoder.out_dim, action_dim)

    def forward(self, obs):
        z = self.encoder(obs)
        return self.Dense_0(z), torch.clamp(self.Dense_1(z), -10.0, 2.0)


class TwinQNet(nn.Module):
    """Two independent Q(s, a) critics (clipped double-Q, SAC/TD3).

    Vector obs: MLP over concat(obs, action). Image obs (an `encoder` is
    set) encode first, then concat the latent with the action —
    convolving an action-broadcast image would be meaningless."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64), activation: str = "tanh",
                 encoder: Optional[nn.Module] = None):
        super().__init__()
        if encoder is not None:
            self.encoder = encoder
            obs_dim = encoder.out_dim
        else:
            self.encoder = None
        width = (int(obs_dim) + int(action_dim),)
        self.MLPEncoder_0 = MLPEncoder(width, hidden, activation)
        self.Dense_0 = nn.Linear(self.MLPEncoder_0.out_dim, 1)
        self.MLPEncoder_1 = MLPEncoder(width, hidden, activation)
        self.Dense_1 = nn.Linear(self.MLPEncoder_1.out_dim, 1)

    def forward(self, obs, action):
        z = self.encoder(obs) if self.encoder is not None else obs
        x = torch.cat([z, action], dim=-1)
        q1 = self.Dense_0(self.MLPEncoder_0(x)).squeeze(-1)
        q2 = self.Dense_1(self.MLPEncoder_1(x)).squeeze(-1)
        return q1, q2


def _sample_discrete(logits: np.ndarray, rng: np.random.Generator
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Categorical sample + log-prob from raw logits (shared by the
    feed-forward and recurrent exploration paths)."""
    z = logits - logits.max(-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(-1, keepdims=True)
    n = p.shape[-1]
    actions = np.array([rng.choice(n, p=pi) for pi in p])
    logp = np.log(p[np.arange(len(actions)), actions] + 1e-12)
    return actions, logp


class RecurrentActorCriticNet(nn.Module):
    """LSTM torso + policy/value heads (reference: the use_lstm-wrapped
    default module). Sequence-shaped: obs (B, T, *obs), carry (c, h)
    each (B, cell), resets (B, T). The encoder's params sit at the top
    (``encoder``), as flax binds the encoder to this module."""

    def __init__(self, num_actions: int, encoder: nn.Module,
                 cell_size: int = 128):
        super().__init__()
        self.encoder = encoder
        self.LSTMEncoder_0 = LSTMEncoder(encoder, cell_size)
        self.Dense_0 = nn.Linear(cell_size, num_actions)
        self.Dense_1 = nn.Linear(cell_size, 1)

    def forward(self, obs, carry, resets):
        feats, carry = self.LSTMEncoder_0(obs, carry, resets)
        return self.Dense_0(feats), self.Dense_1(feats).squeeze(-1), carry


class RLModule:
    """Reference: rl_module.py:260. Stateless apply + explicit params.

    `obs_dim` accepts an int (flat vector obs, the common case) or a
    shape tuple — rank-3 `(H, W, C)` shapes get a Catalog CNN encoder
    and set `preserve_obs_shape` so the default FlattenObservations
    connector passes images through unflattened."""

    # Discrete action space by default; continuous modules (SAC) set
    # False so env runners pass float action vectors to env.step.
    discrete = True
    # Recurrent modules (RecurrentPPOModule) carry rollout state and
    # accept use_lstm=True; everything else rejects it loudly.
    recurrent = False

    def __init__(self, obs_dim: Union[int, Sequence[int]], num_actions: int,
                 hidden: Sequence[int] = (64, 64),
                 model_config: Optional[Dict[str, Any]] = None):
        if isinstance(obs_dim, (int, np.integer)):
            self.obs_shape: Tuple[int, ...] = (int(obs_dim),)
        else:
            self.obs_shape = tuple(int(d) for d in obs_dim)
        self.obs_dim = int(np.prod(self.obs_shape))
        self.num_actions = num_actions
        self.model_config = dict(model_config) if model_config else None
        cfg = merge_model_config(self.model_config)
        mc = self.model_config or {}
        if "fcnet_hiddens" not in mc and "hidden" not in mc:
            # Constructor arg wins when the model config doesn't speak.
            cfg["fcnet_hiddens"] = list(hidden)
        self.hidden = tuple(cfg["fcnet_hiddens"])
        self._cfg = cfg
        if cfg["use_lstm"] and not self.recurrent:
            raise NotImplementedError(
                f"{type(self).__name__} does not support use_lstm=True "
                "(recurrent policies are supported for PPO; see "
                "RecurrentPPOModule)")
        self.preserve_obs_shape = Catalog.is_image(self.obs_shape, cfg)
        self.net = self._build_net()

    def _make_encoder(self) -> nn.Module:
        """Catalog torso for this module's obs shape + model config."""
        return Catalog.build_encoder(self.obs_shape, self._cfg)

    def _build_net(self) -> nn.Module:
        raise NotImplementedError

    def init_params(self, seed: int = 0):
        """Fresh params on the CPU, drawn as flax draws them from a
        generator seeded with ``seed`` (torch's stream, not jax's)."""
        init_flax_style(self.net, torch.Generator().manual_seed(int(seed)))
        return params_of(self.net)

    def apply(self, params, obs):
        return apply_net(self.net, params, _input(obs, _device_of(params)))

    # -- the three forward modes (reference naming) ------------------------
    def forward_inference(self, params, obs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def forward_exploration(self, params, obs: np.ndarray, rng: np.random
                            .Generator, **kw) -> Tuple[np.ndarray, Dict]:
        raise NotImplementedError

    def __reduce__(self):
        return (type(self), (self.obs_shape, self.num_actions, self.hidden,
                             self.model_config))


class PPOModule(RLModule):
    """Reference: rllib/algorithms/ppo default module."""

    def _build_net(self):
        return ActorCriticNet(self.num_actions, self._make_encoder())

    @torch.no_grad()
    def forward_inference(self, params, obs):
        logits, _ = self.apply(params, obs)
        return _numpy(torch.argmax(logits, dim=-1))

    @torch.no_grad()
    def forward_exploration(self, params, obs, rng, **kw):
        logits, value = self.apply(params, obs)
        actions, logp = _sample_discrete(_numpy(logits), rng)
        return actions, {"vf_preds": _numpy(value), "action_logp": logp}


class RecurrentPPOModule(PPOModule):
    """use_lstm PPO module (reference: the rllib use_lstm auto-wrapper;
    model config keys lstm_cell_size / max_seq_len).

    Rollout state lives on the module instance per process (each env
    runner actor holds its own pickled copy); `on_episode_end` resets
    it, matching the reference's state-reset connector. Every
    exploration step records the PRE-step carry (`state_in_c/h`) in the
    sample batch, so the learner re-runs the LSTM from the TRUE rollout
    state at each max_seq_len chunk start instead of zeros."""

    recurrent = True

    def __init__(self, obs_dim, num_actions, hidden=(64, 64),
                 model_config=None):
        super().__init__(obs_dim, num_actions, hidden, model_config)
        self._carry = None

    @property
    def cell_size(self) -> int:
        return int(self._cfg["lstm_cell_size"])

    @property
    def max_seq_len(self) -> int:
        return int(self._cfg["max_seq_len"])

    def _build_net(self):
        return RecurrentActorCriticNet(
            self.num_actions, encoder=self._make_encoder(),
            cell_size=int(self._cfg["lstm_cell_size"]))

    def _zero_carry(self, batch: int):
        z = np.zeros((batch, int(self._cfg["lstm_cell_size"])), np.float32)
        return (z, z)

    # -- sequence/step primitives -----------------------------------------
    def seq_forward(self, params, obs, carry, resets):
        """(B, T, *obs) -> logits (B, T, A), values (B, T)."""
        device = _device_of(params)
        logits, value, _ = apply_net(
            self.net, params, _input(obs, device),
            (_input(carry[0], device), _input(carry[1], device)),
            _input(resets, device))
        return logits, value

    def _step(self, params, obs_b, carry):
        device = _device_of(params)
        obs = _input(obs_b, device)
        logits, value, new_carry = apply_net(
            self.net, params, obs[:, None],
            (_input(carry[0], device), _input(carry[1], device)),
            torch.zeros((obs.shape[0], 1), device=device))
        return logits[:, 0], value[:, 0], new_carry

    @torch.no_grad()
    def value_with_state(self, params, obs, carry):
        """V(obs) from an explicit carry (bootstrap values at fragment
        ends / truncation points)."""
        _, value, _ = self._step(params, obs, carry)
        return _numpy(value)

    def apply(self, params, obs):
        """Stateless zero-carry T=1 shim (the recurrent training path in
        PPO never uses it; kept for API compatibility)."""
        logits, value, _ = self._step(params, obs,
                                      self._zero_carry(len(obs)))
        return logits, value

    # -- rollout-facing forwards (stateful carry) --------------------------
    def _rollout_carry(self, batch: int):
        if self._carry is None or self._carry[0].shape[0] != batch:
            self._carry = self._zero_carry(batch)
        return self._carry

    @torch.no_grad()
    def forward_inference(self, params, obs):
        carry = self._rollout_carry(len(obs))
        logits, _, carry = self._step(params, obs, carry)
        self._carry = (_numpy(carry[0]), _numpy(carry[1]))
        return _numpy(torch.argmax(logits, dim=-1))

    @torch.no_grad()
    def forward_exploration(self, params, obs, rng, **kw):
        state_in = self._rollout_carry(len(obs))
        logits, value, carry = self._step(params, obs, state_in)
        self._carry = (_numpy(carry[0]), _numpy(carry[1]))
        actions, logp = _sample_discrete(_numpy(logits), rng)
        return actions, {"vf_preds": _numpy(value),
                         "action_logp": logp,
                         "state_in_c": state_in[0],
                         "state_in_h": state_in[1],
                         # post-step carry: the learner's bootstrap
                         # state for V(next_obs) at fragment ends and
                         # truncation rows.
                         "state_out_c": self._carry[0],
                         "state_out_h": self._carry[1]}

    def on_episode_end(self):
        self._carry = None


class SACModule(RLModule):
    """Squashed-Gaussian actor + twin critics (reference:
    rllib/algorithms/sac default module). Params:
    {"actor": ..., "q": ...}; actions squashed to [-1, 1] via tanh
    (callers scale to the env's action bounds)."""

    discrete = False

    def _build_net(self):
        return GaussianActorNet(self.num_actions, self._make_encoder())

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64),
                 model_config: Optional[Dict[str, Any]] = None):
        super().__init__(obs_dim, num_actions, hidden, model_config)
        # Critics get their own encoder params for image obs (separate
        # instance -> separate init; vector obs keep the flat concat).
        self.q_net = TwinQNet(
            self.obs_dim, self.num_actions, self.hidden,
            activation=self._cfg["fcnet_activation"],
            encoder=self._make_encoder() if self.preserve_obs_shape
            else None)

    def init_params(self, seed: int = 0):
        gen = torch.Generator().manual_seed(int(seed))
        init_flax_style(self.net, gen)
        init_flax_style(self.q_net, gen)
        return {"actor": params_of(self.net), "q": params_of(self.q_net)}

    # Inputs take the params' device and dtype: float32 as the JAX
    # package runs, float64 where a test holds the update in it.
    def apply_actor(self, params, obs):
        leaf = _leaf_of(params)
        return apply_net(self.net, params["actor"],
                         _input(obs, leaf.device, leaf.dtype))

    def apply_q(self, params, obs, action):
        leaf = _leaf_of(params)
        return apply_net(self.q_net, params["q"],
                         _input(obs, leaf.device, leaf.dtype),
                         _input(action, leaf.device, leaf.dtype))

    def apply(self, params, obs):
        return self.apply_actor(params, obs)

    def sample_action(self, params, obs,
                      noise: Union[torch.Generator, torch.Tensor]):
        """Reparameterized squashed-Gaussian sample -> (action, logp).
        ``noise`` is the standard normal ``eps`` itself (a tensor shaped
        like the action batch, as the updates take it, so that a test can
        hand in the JAX package's draw), or a ``torch.Generator`` on the
        params' device to draw it from (the runners): the JAX package
        draws it from a jax.random key, another stream."""
        mean, log_std = self.apply_actor(params, obs)
        std = torch.exp(log_std)
        if torch.is_tensor(noise):
            eps = noise.to(device=mean.device, dtype=mean.dtype)
        else:
            eps = torch.randn(mean.shape, generator=noise,
                              device=mean.device, dtype=mean.dtype)
        pre = mean + std * eps
        action = torch.tanh(pre)
        # log prob with tanh change-of-variables (SAC appendix C)
        logp = torch.sum(
            -0.5 * (eps ** 2) - log_std - 0.5 * np.log(2 * np.pi)
            - torch.log(1 - action ** 2 + 1e-6), dim=-1)
        return action, logp

    @torch.no_grad()
    def forward_inference(self, params, obs):
        mean, _ = self.apply_actor(params, obs)
        return _numpy(torch.tanh(mean))

    @torch.no_grad()
    def forward_exploration(self, params, obs, rng, **kw):
        gen = torch.Generator(device=_device_of(params)).manual_seed(
            int(rng.integers(0, 2 ** 31)))
        action, _ = self.sample_action(params, obs, gen)
        return _numpy(action), {}


class DQNModule(RLModule):
    """Reference: rllib/algorithms/dqn default module."""

    def _build_net(self):
        return QNet(self.num_actions, self._make_encoder())

    @torch.no_grad()
    def forward_inference(self, params, obs):
        q = self.apply(params, obs)
        return _numpy(torch.argmax(q, dim=-1))

    def forward_exploration(self, params, obs, rng, epsilon: float = 0.1,
                            **kw):
        greedy = self.forward_inference(params, obs)
        explore = rng.integers(0, self.num_actions, size=greedy.shape)
        mask = rng.random(greedy.shape) < epsilon
        return np.where(mask, explore, greedy), {}


class MultiRLModule:
    """Container of named RLModules (reference:
    rllib/core/rl_module/multi_rl_module.py MultiRLModule — dict of
    module_id → RLModule sharing the Checkpointable surface). Params are a
    dict keyed the same way, so a single learner-state blob round-trips
    all policies."""

    def __init__(self, modules: Dict[str, RLModule]):
        self.modules = dict(modules)

    def __getitem__(self, module_id: str) -> RLModule:
        return self.modules[module_id]

    def __contains__(self, module_id: str) -> bool:
        return module_id in self.modules

    def keys(self):
        return self.modules.keys()

    def items(self):
        return self.modules.items()

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        return {mid: m.init_params(seed + i)
                for i, (mid, m) in enumerate(sorted(self.modules.items()))}

    def __reduce__(self):
        return (type(self), (self.modules,))
