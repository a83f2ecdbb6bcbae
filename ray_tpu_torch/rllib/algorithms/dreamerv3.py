"""DreamerV3 — model-based RL via latent imagination (compact).

Reference parity: rllib/algorithms/dreamerv3/ (the last algorithm family
of the reference's in-tree set), ported from the JAX package's
``ray_tpu/rllib/algorithms/dreamerv3.py``: the DreamerV3 recipe for
vector or image observations and discrete actions:

  * RSSM world model: GRU deterministic state + categorical stochastic
    latents (straight-through gradients), prior/posterior heads.
  * Decoder/reward heads in SYMLOG space; Bernoulli continue head.
  * KL balancing with free bits (dyn 0.5 / rep 0.1 as in the paper).
  * Actor-critic trained entirely on IMAGINED rollouts from posterior
    states: lambda-returns, reinforce actor gradient with critic
    baseline + entropy bonus, EMA return normalizer.

The params are the JAX package's plain tree, leaf for leaf and in its
layouts: dense ``w`` as (in, out) (``x @ w + b``), conv and deconv ``w``
as HWIO. The convolutions run on NHWC tensors through a channels-last
view (no copy); the kernels are laid out for torch at call time: a conv's
HWIO -> OIHW, and a deconv's HWIO flipped in both spatial dims -> (I, O,
kh, kw), since ``jax.lax.conv_transpose`` does not flip its kernel and
``F.conv_transpose2d`` does (``DreamerModule.deconv_kernel``).

The reference's two scans (the posterior over the sequence, the
imagination over the horizon) are Python loops of small launches, and its
three optax.adam states are bare Adam steps (``core/optim.py``). The
update takes its noise as tensors: the Gumbel noise of each posterior
step's latents, and of each imagined step's action and latents, as
``jax.random.categorical`` draws it (``argmax(logits + gumbel)``), so the
JAX package's draws can be handed in unchanged. Remaining omission vs the
full reference implementation (documented, not hidden): the EMA critic
regularizer.
"""
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..._device import DeviceLike, resolve_device
from ..._tree import tree_map
from ..core.learner import (clone_tree, device_batch, gradients,
                            load_state, scalars, trainable)
from ..core.optim import adam_init, adam_step
from ..core.rl_module import _input
from .algorithm import Algorithm, AlgorithmConfig
from .sac import OffPolicyTraining

# Every conv and deconv level: a 4x4 kernel, stride 2. The conv plan only
# halves even sizes, where flax's SAME pads one pixel on each side, and
# the transposed conv's SAME output is twice its input: padding 1 both.
KERNEL, STRIDE, PADDING = 4, 2, 1


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def gumbel(shape, generator: torch.Generator,
           device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise, as ``jax.random.gumbel`` draws it from a
    uniform bounded below by the smallest normal float32."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))


# ---------------------------------------------------------------------------
# parameter init / primitive nets (plain trees of tensors)
# ---------------------------------------------------------------------------
def _dense(gen, n_in, n_out):
    scale = np.sqrt(2.0 / n_in)
    return {"w": torch.randn((n_in, n_out), generator=gen) * scale,
            "b": torch.zeros((n_out,))}


def _mlp(gen, sizes):
    return [_dense(gen, sizes[i], sizes[i + 1])
            for i in range(len(sizes) - 1)]


def _apply_mlp(layers, x, final_act=None):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            x = F.silu(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def _gru_init(gen, n_in, n_h):
    return {"wi": _dense(gen, n_in, 3 * n_h), "wh": _dense(gen, n_h, 3 * n_h)}


def _gru(p, x, h):
    gates_x = x @ p["wi"]["w"] + p["wi"]["b"]
    gates_h = h @ p["wh"]["w"] + p["wh"]["b"]
    xr, xz, xn = torch.chunk(gates_x, 3, dim=-1)
    hr, hz, hn = torch.chunk(gates_h, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _conv_init(gen, c_in, c_out, k=KERNEL):
    scale = np.sqrt(2.0 / (k * k * c_in))
    return {"w": torch.randn((k, k, c_in, c_out), generator=gen) * scale,
            "b": torch.zeros((c_out,))}


def _nchw(x):
    """An NHWC tensor as NCHW, a channels-last view of the same memory."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv(p, x):
    """flax's Conv(SAME, stride 2) on NHWC ``x`` with an HWIO kernel."""
    return _nhwc(F.conv2d(_nchw(x), p["w"].permute(3, 2, 0, 1), p["b"],
                          stride=STRIDE, padding=PADDING))


class DreamerModule:
    """World model + actor + critic parameter factory and pure apply fns.

    Latent: deter `h` (n_deter) + stochastic `z` of `n_cat` categorical
    distributions with `n_classes` classes each (flattened one-hots).

    Observations: vector obs use MLP encoder/decoder; rank-3 `(H, W,
    C)` obs use a strided-conv encoder and a mirrored conv-transpose
    decoder (reference: dreamerv3's CNN encoder, NHWC). H and W must be
    divisible by 2 per conv level (levels auto-chosen down to a 4-6 px
    core).
    """

    discrete = True

    def __init__(self, obs_dim, num_actions: int, n_deter=256,
                 n_cat=8, n_classes=8, hidden=256, cnn_depth=16,
                 n_bins=41):
        self._args = (obs_dim, num_actions, n_deter, n_cat, n_classes,
                      hidden, cnn_depth, n_bins)
        self.is_image = isinstance(obs_dim, (tuple, list))
        # FlattenObservations connector opt-out: a flattened image
        # can't reach the conv stack.
        self.preserve_obs_shape = self.is_image
        if self.is_image:
            self.obs_shape = tuple(int(d) for d in obs_dim)
            self.obs_dim = int(np.prod(self.obs_shape))
            # Conv plan: halve the spatial dims per level until the
            # core is <= 6 px (or parity breaks), doubling depth.
            h, w, c = self.obs_shape
            self.conv_shapes = [(h, w, c)]
            depth = cnn_depth
            while (h > 6 and w > 6 and h % 2 == 0 and w % 2 == 0
                   and len(self.conv_shapes) < 5):
                h, w = h // 2, w // 2
                self.conv_shapes.append((h, w, depth))
                depth *= 2
            if len(self.conv_shapes) < 2:
                raise ValueError(
                    f"obs shape {self.obs_shape} too small for the CNN "
                    "encoder (needs even H/W > 6)")
            self.enc_flat = int(np.prod(self.conv_shapes[-1]))
        else:
            self.obs_shape = (int(obs_dim),)
            self.obs_dim = int(obs_dim)
        self.num_actions = num_actions
        self.n_deter = n_deter
        self.n_cat = n_cat
        self.n_classes = n_classes
        self.n_stoch = n_cat * n_classes
        self.hidden = hidden
        # Two-hot critic (paper: return distribution over symlog-spaced
        # bins; the value is the symexp of the expected bin).
        self.n_bins = int(n_bins)
        self.bins_symlog = torch.linspace(-20.0, 20.0, self.n_bins)
        # Acting state (per env-runner process; reset via the runner's
        # on_episode_end hook).
        self._h = None
        self._z = None

    def __reduce__(self):
        # Rebuilt from the constructor's arguments: no acting state.
        return (type(self), self._args)

    def _bins(self, like: torch.Tensor) -> torch.Tensor:
        """The bins on ``like``'s device, in its dtype."""
        if self.bins_symlog.device != like.device:
            self.bins_symlog = self.bins_symlog.to(like.device)
        return self.bins_symlog.to(like.dtype)

    # -- params ---------------------------------------------------------
    def init_params(self, seed: int = 0) -> Dict:
        """Fresh params on the CPU in the reference's tree and layouts,
        drawn from a torch generator seeded with ``seed`` (torch's
        stream, not jax's)."""
        gen = torch.Generator().manual_seed(int(seed))
        feat = self.n_deter + self.n_stoch
        if self.is_image:
            n_lv = len(self.conv_shapes) - 1
            embed = {"convs": [
                _conv_init(gen, self.conv_shapes[i][2],
                           self.conv_shapes[i + 1][2])
                for i in range(n_lv)],
                "out": _dense(gen, self.enc_flat, self.hidden)}
            # Mirror: dense to the conv core, then conv-transpose back
            # up; the last level outputs the obs channels directly.
            decoder_in = _dense(gen, feat, self.enc_flat)
            deconvs = [_conv_init(gen, self.conv_shapes[i][2],
                                  self.conv_shapes[i - 1][2])
                       for i in range(n_lv, 0, -1)]
            decoder = {"in": decoder_in, "deconvs": deconvs}
        else:
            embed = _mlp(gen, [self.obs_dim, self.hidden, self.hidden])
            decoder = _mlp(gen, [feat, self.hidden, self.obs_dim])
        critic = _mlp(gen, [feat, self.hidden, self.n_bins])
        # Zero-init the critic output layer (paper: the return
        # distribution starts uniform, stabilizing early training).
        critic[-1]["w"] = torch.zeros_like(critic[-1]["w"])
        return {
            "embed": embed,
            "gru": _gru_init(gen, self.n_stoch + self.num_actions,
                             self.n_deter),
            "prior": _mlp(gen, [self.n_deter, self.hidden, self.n_stoch]),
            "post": _mlp(gen, [self.n_deter + self.hidden, self.hidden,
                               self.n_stoch]),
            "decoder": decoder,
            "reward": _mlp(gen, [feat, self.hidden, 1]),
            "cont": _mlp(gen, [feat, self.hidden, 1]),
            "actor": _mlp(gen, [feat, self.hidden, self.num_actions]),
            "critic": critic,
        }

    # -- obs codec -------------------------------------------------------
    def encode(self, params, obs_symlog):
        """[..., *obs_shape] (already symlog'd) -> [..., hidden] for
        image obs, [..., obs_dim] embedding for vector obs."""
        if not self.is_image:
            return _apply_mlp(params["embed"], obs_symlog)
        lead = obs_symlog.shape[:-3]
        x = obs_symlog.reshape((-1,) + self.obs_shape)
        for cp in params["embed"]["convs"]:
            x = F.silu(_conv(cp, x))
        # H·W·C order, as the reference flattens NHWC.
        x = x.reshape(x.shape[0], -1)
        out = params["embed"]["out"]
        x = F.silu(x @ out["w"] + out["b"])
        return x.reshape(lead + (self.hidden,))

    @staticmethod
    def deconv_kernel(w):
        """An HWIO kernel of ``jax.lax.conv_transpose`` (which does not
        flip it) as ``F.conv_transpose2d``'s weight (I, O, kh, kw), which
        that call flips: flipped here first, in both spatial dims."""
        return w.flip(0, 1).permute(2, 3, 0, 1)

    def _deconv(self, p, x):
        """``jax.lax.conv_transpose(SAME, stride 2)`` on NHWC ``x``."""
        return _nhwc(F.conv_transpose2d(
            _nchw(x), self.deconv_kernel(p["w"]), p["b"], stride=STRIDE,
            padding=PADDING))

    def decode(self, params, feat):
        """[..., feat] -> reconstruction in symlog obs space
        ([..., *obs_shape] for images, [..., obs_dim] for vectors)."""
        if not self.is_image:
            return _apply_mlp(params["decoder"], feat)
        lead = feat.shape[:-1]
        dp = params["decoder"]
        x = feat.reshape(-1, feat.shape[-1]) @ dp["in"]["w"] \
            + dp["in"]["b"]
        x = x.reshape((-1,) + self.conv_shapes[-1])
        for i, cp in enumerate(dp["deconvs"]):
            x = self._deconv(cp, x)
            if i + 1 < len(dp["deconvs"]):
                x = F.silu(x)   # last level: raw pixel regression
        return x.reshape(lead + self.obs_shape)

    # -- two-hot critic ---------------------------------------------------
    def bin_index(self, y):
        """The bin at or below each ``y`` (``searchsorted(side="right")
        - 1``)."""
        return torch.searchsorted(self._bins(y), y, right=True) - 1

    def twohot(self, y_symlog):
        """Two-hot encoding of symlog targets over the critic bins
        (paper: the two nearest bins share the mass linearly)."""
        bins = self._bins(y_symlog)
        y = torch.clamp(y_symlog, bins[0], bins[-1])
        idx = torch.clamp(self.bin_index(y.contiguous()), 0,
                          self.n_bins - 2)
        lo, hi = bins[idx], bins[idx + 1]
        frac = (y - lo) / (hi - lo)
        oh_lo = F.one_hot(idx, self.n_bins) * (1.0 - frac[..., None])
        oh_hi = F.one_hot(idx + 1, self.n_bins) * frac[..., None]
        return oh_lo + oh_hi

    def critic_value(self, critic, feats):
        """Expected return: symexp of the distribution's mean bin."""
        p = torch.softmax(_apply_mlp(critic, feats), -1)
        return symexp(p @ self._bins(p))

    # -- latent machinery ------------------------------------------------
    @staticmethod
    def straight_through(one_hot, probs):
        """The sample forward, the probabilities' gradient backward."""
        return one_hot + probs - probs.detach()

    def _sample_cat(self, logits, noise):
        """Straight-through one-hot sample over n_cat categoricals
        (paper: unimix 1% uniform for exploration-stable gradients);
        ``noise`` is the Gumbel noise of shape [..., n_cat, n_classes]."""
        shape = logits.shape[:-1] + (self.n_cat, self.n_classes)
        lg = logits.reshape(shape)
        probs = 0.99 * torch.softmax(lg, -1) + 0.01 / self.n_classes
        logp = torch.log(probs)
        idx = torch.argmax(logp + noise, dim=-1)
        one_hot = F.one_hot(idx, self.n_classes).to(probs.dtype)
        st = self.straight_through(one_hot, probs)
        return st.reshape(logits.shape), logp

    def obs_step(self, params, h, z_prev, a_prev, obs_emb, noise):
        """One posterior step: (h', z', prior_logits, post_logits)."""
        x = torch.cat([z_prev, a_prev], -1)
        h = _gru(params["gru"], x, h)
        prior = _apply_mlp(params["prior"], h)
        post = _apply_mlp(params["post"], torch.cat([h, obs_emb], -1))
        z, _ = self._sample_cat(post, noise)
        return h, z, prior, post

    def img_step(self, params, h, z, a, noise):
        """One prior (imagination) step."""
        x = torch.cat([z, a], -1)
        h = _gru(params["gru"], x, h)
        prior = _apply_mlp(params["prior"], h)
        z2, _ = self._sample_cat(prior, noise)
        return h, z2

    def feat(self, h, z):
        return torch.cat([h, z], -1)

    # -- acting (runner-side, numpy in/out) ------------------------------
    @torch.no_grad()
    def _act(self, params, obs, rng, greedy: bool):
        leaf = params["actor"][0]["w"]
        device, dtype = leaf.device, leaf.dtype
        obs = _input(obs, device, dtype)
        B = obs.shape[0]
        if self._h is None or self._h.shape[0] != B:
            zeros = lambda n: torch.zeros((B, n), device=device,  # noqa: E731
                                          dtype=dtype)
            self._h, self._z = zeros(self.n_deter), zeros(self.n_stoch)
            self._a = zeros(self.num_actions)
        gen = torch.Generator(device=device).manual_seed(
            int(rng.integers(0, 2**31 - 1)))
        emb = self.encode(params, symlog(obs))
        h, z, _, _ = self.obs_step(
            params, self._h, self._z, self._a, emb,
            gumbel((B, self.n_cat, self.n_classes), gen, device))
        logits = _apply_mlp(params["actor"], self.feat(h, z))
        if greedy:
            a = torch.argmax(logits, -1)
        else:
            a = torch.argmax(logits + gumbel(logits.shape, gen, device), -1)
        self._h, self._z = h, z
        self._a = F.one_hot(a, self.num_actions).to(dtype)
        return a.cpu().numpy()

    def forward_inference(self, params, obs):
        return self._act(params, obs, np.random.default_rng(0), True)

    def forward_exploration(self, params, obs, rng, **kw):
        return self._act(params, obs, rng, False), {}

    def on_episode_end(self):
        self._h = self._z = None

    def get_initial_state(self):
        return {}


WM_KEYS = ("embed", "gru", "prior", "post", "decoder", "reward", "cont")


class DreamerUpdate:
    """One DreamerV3 train step on a [B, L, ...] sequence batch, over
    state = {params, wm_opt, actor_opt, critic_opt, ret_scale, step}
    (``make_dreamer_update`` in the JAX package): the world model's step,
    then the actor's and the critic's on imagination from the posterior
    states, rolled forward with the UPDATED world model."""

    def __init__(self, module: DreamerModule, *, horizon=15, gamma=0.997,
                 lam=0.95, wm_lr=4e-4, ac_lr=1e-4, free_bits=1.0,
                 entropy_coef=3e-3, device: DeviceLike = None):
        self.module = module
        self.horizon = int(horizon)
        self.gamma, self.lam = float(gamma), float(lam)
        self.wm_lr, self.ac_lr = float(wm_lr), float(ac_lr)
        self.free_bits = float(free_bits)
        self.entropy_coef = float(entropy_coef)
        self.device = resolve_device(device)

    @staticmethod
    def split(params):
        wm = {k: params[k] for k in WM_KEYS}
        return wm, params["actor"], params["critic"]

    def init_state(self, seed: int = 0, params=None) -> Dict[str, Any]:
        if params is None:
            params = self.module.init_params(seed)
        params = trainable(clone_tree(params, self.device))
        wm, actor, critic = self.split(params)
        return {"params": params, "wm_opt": adam_init(wm),
                "actor_opt": adam_init(actor),
                "critic_opt": adam_init(critic),
                "ret_scale": torch.ones((), device=self.device,
                                        dtype=actor[0]["w"].dtype),
                "step": 0}

    def noise(self, batch_size: int, seq_len: int,
              generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Gumbel noise: each posterior step's latents [L, B, n_cat,
        n_classes] (the reference's ``split(k1, L)``), and each imagined
        step's action [H, B·L, A] and latents [H, B·L, n_cat, n_classes]
        (``split(k2, H)[t]`` and its ``fold_in(., 1)``)."""
        m, n = self.module, batch_size * seq_len
        cat = (m.n_cat, m.n_classes)
        draw = lambda shape: gumbel(shape, generator,  # noqa: E731
                                    self.device)
        return {"post": draw((seq_len, batch_size) + cat),
                "act": draw((self.horizon, n, m.num_actions)),
                "latent": draw((self.horizon, n) + cat)}

    def kl_cat(self, lhs_logits, rhs_logits):
        """KL(lhs || rhs) over the factorized categoricals, summed."""
        m = self.module
        shape = lhs_logits.shape[:-1] + (m.n_cat, m.n_classes)
        lp = torch.log_softmax(lhs_logits.reshape(shape), -1)
        rp = torch.log_softmax(rhs_logits.reshape(shape), -1)
        return torch.sum(torch.exp(lp) * (lp - rp), dim=(-1, -2))

    def world_model_loss(self, wm, batch, noise):
        m = self.module
        obs = symlog(batch["obs"])      # [B, L, D] or [B, L, H, W, C]
        B, L = obs.shape[:2]
        emb = m.encode(wm, obs)
        actions = F.one_hot(batch["actions"].long(),
                            m.num_actions).to(obs.dtype)
        a_prev = torch.cat([torch.zeros_like(actions[:, :1]),
                            actions[:, :-1]], 1)
        first = batch["is_first"].to(obs.dtype)  # [B, L]
        h = obs.new_zeros((B, m.n_deter))
        z = obs.new_zeros((B, m.n_stoch))
        hs, zs, priors, posts = [], [], [], []
        for t in range(L):
            # Timeline break: reset the latent (paper is_first masking).
            keep = (1.0 - first[:, t])[:, None]
            h = h * keep
            z = z * keep
            a = a_prev[:, t] * keep
            h, z, prior, post = m.obs_step(wm, h, z, a, emb[:, t],
                                           noise["post"][t])
            hs.append(h)
            zs.append(z)
            priors.append(prior)
            posts.append(post)
        hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)      # [B, L, ...]
        priors, posts = torch.stack(priors, 1), torch.stack(posts, 1)
        feat = m.feat(hs, zs)
        recon = m.decode(wm, feat)
        rew_hat = _apply_mlp(wm["reward"], feat)[..., 0]
        cont_hat = _apply_mlp(wm["cont"], feat)[..., 0]
        # Sum the squared error over ALL obs dims (pixels included),
        # mean over batch and time.
        err = (recon - obs).reshape(B, L, -1)
        recon_loss = torch.mean(torch.sum(err ** 2, -1))
        reward_loss = torch.mean((rew_hat - symlog(batch["rewards"])) ** 2)
        cont = 1.0 - batch["terminateds"].to(obs.dtype)
        cont_loss = torch.mean(F.binary_cross_entropy_with_logits(
            cont_hat, cont, reduction="none"))
        # KL balancing (paper: dyn 0.5 toward the posterior, rep 0.1
        # toward the prior) with free bits.
        dyn = self.kl_cat(posts.detach(), priors)
        rep = self.kl_cat(posts, priors.detach())
        kl = 0.5 * torch.mean(torch.clamp(dyn, min=self.free_bits)) + \
            0.1 * torch.mean(torch.clamp(rep, min=self.free_bits))
        loss = recon_loss + reward_loss + cont_loss + kl
        metrics = {"wm_recon": recon_loss, "wm_reward": reward_loss,
                   "wm_cont": cont_loss, "wm_kl": torch.mean(dyn)}
        return loss, (hs, zs, metrics)

    def imagine(self, wm, actor, hs, zs, noise):
        """Roll the prior forward `horizon` steps from every posterior
        state, acting with the CURRENT actor: [H, N, ...] feats, actions
        and the actor's logits."""
        m = self.module
        h = hs.reshape(-1, m.n_deter).detach()
        z = zs.reshape(-1, m.n_stoch).detach()
        feats, acts, logits = [], [], []
        for t in range(self.horizon):
            f = m.feat(h, z)
            lg = _apply_mlp(actor, f)
            a = torch.argmax(lg.detach() + noise["act"][t], -1)
            a1 = F.one_hot(a, m.num_actions).to(h.dtype)
            h, z = m.img_step(wm, h, z, a1, noise["latent"][t])
            feats.append(f)
            acts.append(a)
            logits.append(lg)
        return torch.stack(feats), torch.stack(acts), torch.stack(logits)

    def lambda_returns(self, rewards, conts, values):
        """TD(lambda) over the imagined trajectory (paper eq. 7). At the
        last step the reference reads ``values[t + 1]``, one past the end,
        and JAX clamps that index to ``values[H - 1]``: so here too."""
        last = self.horizon - 1
        nxt = values[-1]
        rets = [None] * self.horizon
        for t in range(last, -1, -1):
            nxt = rewards[t] + self.gamma * conts[t] * (
                (1 - self.lam) * values[min(t + 1, last)] + self.lam * nxt)
            rets[t] = nxt
        return torch.stack(rets)

    def ac_loss(self, actor, critic, wm, hs, zs, noise, ret_scale):
        m = self.module
        feats, acts, logits = self.imagine(wm, actor, hs, zs, noise)
        rew = symexp(_apply_mlp(wm["reward"], feats)[..., 0])
        cont = torch.sigmoid(_apply_mlp(wm["cont"], feats)[..., 0])
        values = m.critic_value(critic, feats)     # [H, N]
        rets = self.lambda_returns(rew, cont, values)        # [H, N]
        # Return normalizer (paper: scale by the 5th-95th percentile
        # range, EMA'd outside).
        norm = torch.clamp(ret_scale, min=1.0)
        adv = ((rets - values) / norm).detach()
        logp = torch.log_softmax(logits, -1)
        taken = torch.gather(logp, -1, acts[..., None])[..., 0]
        entropy = -torch.sum(torch.exp(logp) * logp, -1)
        weight = torch.cumprod(
            torch.cat([torch.ones_like(cont[:1]), cont[:-1]], 0), 0)
        weight = weight.detach()
        actor_loss = -torch.mean(
            weight * (taken * adv + self.entropy_coef * entropy))
        # Two-hot critic loss (paper: cross-entropy against the
        # two-hot encoding of the symlog return).
        critic_logits = _apply_mlp(critic, feats.detach())
        target = m.twohot(symlog(rets)).detach()         # [H, N, bins]
        logp_bins = torch.log_softmax(critic_logits, -1)
        critic_loss = torch.mean(
            weight * -torch.sum(target * logp_bins, -1))
        flat = rets.detach().reshape(-1)
        stats = {"actor_loss": actor_loss, "critic_loss": critic_loss,
                 "imag_return": torch.mean(rets),
                 "actor_entropy": torch.mean(entropy),
                 "ret_raw": torch.quantile(flat, 0.95)
                 - torch.quantile(flat, 0.05)}
        return actor_loss + critic_loss, stats

    def _step(self, state, batch, noise):
        """The update in place: (metrics, grads of the world model, the
        actor and the critic)."""
        params = state["params"]
        wm, actor, critic = self.split(params)
        wm_l, (hs, zs, wm_m) = self.world_model_loss(wm, batch, noise)
        wm_g = gradients(wm_l, wm)
        adam_step(wm, wm_g, state["wm_opt"], self.wm_lr)
        # The updated world model, held: imagination reads it, and the
        # actor-critic loss takes no gradient into it.
        wm_new = tree_map(lambda t, _: t.detach(), wm)
        ac_l, ac_m = self.ac_loss(actor, critic, wm_new, hs.detach(),
                                  zs.detach(), noise, state["ret_scale"])
        ac_g = gradients(ac_l, {"actor": actor, "critic": critic})
        adam_step(actor, ac_g["actor"], state["actor_opt"], self.ac_lr)
        adam_step(critic, ac_g["critic"], state["critic_opt"], self.ac_lr)
        state["ret_scale"] = (0.99 * state["ret_scale"]
                              + 0.01 * ac_m["ret_raw"]).detach()
        state["step"] += 1
        metrics = {"wm_loss": wm_l, **wm_m, **ac_m}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, {"wm": wm_g, **ac_g}

    def gradients(self, state, batch, noise):
        """(metrics, grads) of one update from ``state``, which stays as
        it was (the step runs on a copy): grads {"wm", "actor",
        "critic"}, the actor's and critic's taken on the updated world
        model, as the update takes them."""
        return self._step(load_state(state, self.device), batch, noise)

    def __call__(self, state, batch, noise):
        """One step, in place: (state, metrics as 0-dim tensors)."""
        metrics, _ = self._step(state, batch, noise)
        return state, metrics


make_dreamer_update = DreamerUpdate  # the JAX package's name


class SequenceReplayBuffer:
    """Stores contiguous fragments; samples [B, L] subsequences
    (reference: dreamerv3's episode replay)."""

    def __init__(self, capacity_steps: int = 100_000, seed: int = 0):
        self.capacity = capacity_steps
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._size

    def add_fragment(self, batch: Dict[str, np.ndarray]):
        n = len(batch["rewards"])
        if not self._cols:
            for k in ("obs", "actions", "rewards", "terminateds"):
                v = np.asarray(batch[k])
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         v.dtype)
            # is_first marks timeline breaks: fragment starts (each
            # fragment may come from a different env runner) and the
            # step after a terminal. The world model RESETS its latent
            # there (the paper's is_first masking), so spliced
            # subsequences never fabricate cross-episode dynamics.
            self._cols["is_first"] = np.zeros((self.capacity,), bool)
        prev_done = True
        for i in range(n):
            for k in ("obs", "actions", "rewards", "terminateds"):
                self._cols[k][self._next] = batch[k][i]
            self._cols["is_first"][self._next] = prev_done or (i == 0)
            prev_done = bool(batch["terminateds"][i])
            self._next = (self._next + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def sample_sequences(self, batch_size: int, length: int):
        # Offsets from the OLDEST element so sequences follow time order
        # even when the ring has wrapped (index wrap != time break).
        oldest = self._next % self.capacity \
            if self._size == self.capacity else 0
        offs = self._rng.integers(0, self._size - length,
                                  size=batch_size)
        idx = (oldest + offs[:, None]
               + np.arange(length)[None, :]) % self.capacity
        return {k: v[idx] for k, v in self._cols.items()}


class DreamerV3(OffPolicyTraining, Algorithm):
    _STATE_KEY = "dreamer_state"

    def __init__(self, config):
        super().__init__(config)
        self.buffer = SequenceReplayBuffer(
            int(config.extra.get("buffer_capacity", 100_000)),
            seed=config.seed)
        self._update = make_dreamer_update(
            self.module,
            horizon=int(config.extra.get("horizon", 15)),
            gamma=config.gamma,
            wm_lr=float(config.extra.get("wm_lr", 4e-4)),
            ac_lr=float(config.extra.get("ac_lr", 1e-4)),
            device=self._device)
        self._state = self._update.init_state(config.seed)
        self._generator = torch.Generator(
            device=self._device).manual_seed(int(config.seed))
        # No TorchLearner (three optimizers of its own): the base
        # __init__ couldn't seed the runners with weights — do it now.
        if self.env_runner_group is not None:
            self.env_runner_group.sync_weights(self.get_weights())

    def _build_module(self, obs_dim, num_actions):
        ex = self.config.extra
        # Vector obs -> MLP codec; (H, W, C) obs -> CNN encoder +
        # conv-transpose decoder (reference: dreamerv3's CNN path).
        return DreamerModule(
            obs_dim, num_actions,
            n_deter=int(ex.get("n_deter", 256)),
            n_cat=int(ex.get("n_cat", 8)),
            n_classes=int(ex.get("n_classes", 8)),
            hidden=self.config.hidden[0] if self.config.hidden else 256,
            cnn_depth=int(ex.get("cnn_depth", 16)),
            n_bins=int(ex.get("critic_bins", 41)))

    def sample_batch(self) -> Dict[str, torch.Tensor]:
        """A [B, L] batch of subsequences from the replay, on the
        update's device."""
        ex = self.config.extra
        batch = self.buffer.sample_sequences(
            int(ex.get("batch_sequences", 8)), int(ex.get("seq_len", 16)))
        return device_batch(batch, self._device)

    def training_step(self) -> Dict:
        cfg = self.config
        seq_len = int(cfg.extra.get("seq_len", 16))
        for frag in self.env_runner_group.sample(
                cfg.rollout_fragment_length):
            self.buffer.add_fragment(frag)
            self._total_steps += len(frag["rewards"])
        stats: Dict = {}
        warmup = int(cfg.extra.get("learning_starts", 1000))
        if len(self.buffer) >= max(warmup, seq_len * 2):
            for _ in range(int(cfg.extra.get("updates_per_iter", 4))):
                batch = self.sample_batch()
                noise = self._update.noise(batch["rewards"].shape[0],
                                           seq_len, self._generator)
                self._state, m = self._update(self._state, batch, noise)
            stats.update(scalars(m))
        self.env_runner_group.sync_weights(self.get_weights())
        return stats


class DreamerV3Config(AlgorithmConfig):
    ALGO_CLS = DreamerV3

    def __init__(self):
        super().__init__()
        self.gamma = 0.997
        self.rollout_fragment_length = 64
        self.train_batch_size = 128

