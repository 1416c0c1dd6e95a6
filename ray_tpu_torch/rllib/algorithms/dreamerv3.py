"""DreamerV3-lite — model-based RL on latent imagination.

Reference: `rllib/algorithms/dreamerv3/dreamerv3.py:1` (the reference's only
model-based algorithm). The JAX reference (`ray_tpu/rllib/algorithms/
dreamerv3.py`), a compact re-derivation of the DreamerV3 recipe (Hafner et
al. 2023), runs the whole update — world-model sequence learning, latent
imagination, λ-returns, the three optimizers — as one jit-compiled
`lax.scan`. The port runs the same gradient steps in order on the learner's
device, each step (the world-model step, imagination, the behaviour step,
the three Adam chains, the EMA critic and the return scale) one CUDA graph
on the card (`optim.step_program`); on the CPU the steps run eagerly.

Kept from the paper (the load-bearing pieces):
  * RSSM world model: deterministic GRU path + categorical stochastic
    latents (straight-through gradients, 1% unimix), KL balancing with
    free bits.
  * Heads: decoder (symlog MSE), reward (symlog MSE), continue (BCE).
  * Behavior learned purely in imagination: actor-critic on H-step latent
    rollouts from replayed posterior starts; λ-returns; percentile return
    normalization; EMA critic for bootstrap values.
Dropped for "lite": image encoders (vector obs only), twohot critic bins,
per-dim reward clipping schedules.

Every categorical draw is a Gumbel argmax (`jax.random.categorical` is
argmax(logits + Gumbel noise)), and the noise is drawn apart from the
computation that uses it: `act` draws it from the runner's generator
(`act_with_draws` takes it), `update` from the learner's
(`update.with_draws` takes it), so a test hands in JAX's own noise.

Acting is RECURRENT (h carried across env steps) via the EnvRunner's
stateful-module protocol (`act`/`initial_state`).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..core.catalog import orthogonal
from ..core.learner import Learner
from ..core.rl_module import RLModule, _mlp_apply, _mlp_init
from ..env.spaces import Discrete
from ..utils import optim
from ..utils.tree import tree_leaves, tree_map
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig
from .dqn import polyak


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise of `shape` on the generator's device: JAX's
    `-log(-log(u))`, u uniform in [tiny, 1) (`jax.random.gumbel`)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.nn.one_hot(idx, n)` in f32, by comparison with arange (no host
    check of the indices, so a CUDA graph can capture it)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.percentile(x, q)` (linear interpolation over the flattened x),
    as JAX computes it: sort, then low·(1 - w) + high·w at the indices and
    weight that x's static size gives, in f32; NaN if x holds one. No
    host sync, so a CUDA graph can capture it."""
    x = x.reshape(-1)
    n = x.shape[0]
    pos = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(n - 1)
    low, high = int(np.floor(pos)), int(np.ceil(pos))
    high_w = np.float32(pos - np.float32(low))
    low_w = np.float32(np.float32(1.0) - high_w)
    s = torch.sort(x).values
    out = s[low] * float(low_w) + s[high] * float(high_w)
    return torch.where(torch.isnan(x).any(), torch.full_like(out, float("nan")), out)


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4                 # world model
        self.actor_lr = 1e-4
        self.critic_lr = 1e-4
        self.rollout_fragment_length = 64
        self.replay_capacity = 500     # fragments ([T, N] rollouts)
        self.seq_len = 16              # training sequence length
        self.batch_size_seqs = 32      # sequences per grad step
        self.num_grad_steps = 8        # grad steps per training_step
        self.horizon = 15              # imagination depth
        self.deter_dim = 128
        self.stoch_groups = 8          # categorical groups ...
        self.stoch_classes = 8         # ... x classes each
        self.units = 128
        self.free_bits = 1.0
        self.kl_dyn = 0.5              # KL(sg(post) || prior) weight
        self.kl_rep = 0.1              # KL(post || sg(prior)) weight
        self.gamma = 0.997
        self.lam = 0.95
        self.entropy_coef = 1e-3
        self.critic_ema = 0.02         # Polyak rate for the bootstrap critic
        self.learning_starts = 1024    # env steps before updates begin
        self.grad_clip = 100.0


class DreamerV3Module(RLModule):
    """params = {"wm": {enc, gru, prior, post, dec, rew, cont},
    "actor": mlp, "critic": mlp, "critic_t": mlp, "ret_scale": 0-d tensor}."""

    def __init__(self, obs_dim: int, act_n: int, cfg: DreamerV3Config):
        self.obs_dim = obs_dim
        self.act_n = act_n              # discrete action count
        self.deter = cfg.deter_dim
        self.G = cfg.stoch_groups
        self.C = cfg.stoch_classes
        self.units = cfg.units
        self.z_dim = self.G * self.C
        self._act_graphs: dict = {}     # (greedy, device, obs shape) -> _GraphedAct

    def __getstate__(self):
        # A module crosses to remote runners by pickle; CUDA graphs do not.
        return {**self.__dict__, "_act_graphs": {}}

    # ------------------------------------------------------------- params
    def init(self, gen):
        # reference: ten keys split from one (`dreamerv3.py:93`), critic_t
        # drawn from critic's key (`:111-112`); the port draws each part
        # from one generator in order and starts critic_t as critic's copy.
        U, D, Z = self.units, self.deter, self.z_dim
        gin = Z + self.act_n  # GRU input: [z, action one-hot]
        dev = gen.device
        wm = {
            "enc": _mlp_init(gen, (self.obs_dim, U, U), scale_last=1.0),
            "gru": {
                # jax.nn.initializers.orthogonal(): scale 1
                "wx": orthogonal(gen, (gin, 3 * D), 1.0),
                "wh": orthogonal(gen, (D, 3 * D), 1.0),
                "b": torch.zeros((3 * D,), dtype=torch.float32, device=dev),
            },
            "prior": _mlp_init(gen, (D, U, Z), scale_last=1.0),
            "post": _mlp_init(gen, (D + U, U, Z), scale_last=1.0),
            "dec": _mlp_init(gen, (D + Z, U, self.obs_dim), scale_last=1.0),
            "rew": _mlp_init(gen, (D + Z, U, 1), scale_last=0.0),
            "cont": _mlp_init(gen, (D + Z, U, 1), scale_last=1.0),
        }
        actor = _mlp_init(gen, (D + Z, U, self.act_n), scale_last=0.01)
        critic = _mlp_init(gen, (D + Z, U, 1), scale_last=0.0)
        return {
            "wm": wm,
            "actor": actor,
            "critic": critic,
            "critic_t": tree_map(torch.clone, critic),
            "ret_scale": torch.ones((), dtype=torch.float32, device=dev),
        }

    # ---------------------------------------------------------------- rssm
    def _gru(self, p, h, x):
        D = self.deter
        gates = x @ p["wx"][:, : 2 * D] + h @ p["wh"][:, : 2 * D] + p["b"][: 2 * D]
        r, u = torch.chunk(torch.sigmoid(gates), 2, dim=-1)
        cand = torch.tanh(
            x @ p["wx"][:, 2 * D:] + (r * h) @ p["wh"][:, 2 * D:] + p["b"][2 * D:]
        )
        return u * h + (1.0 - u) * cand

    def _logits(self, mlp, x):
        return _mlp_apply(mlp, x, activation=F.silu).reshape(
            x.shape[:-1] + (self.G, self.C)
        )

    def _probs(self, logits):
        # 1% unimix: keeps KL finite and exploration alive (DreamerV3 §2).
        return 0.99 * torch.softmax(logits, -1) + 0.01 / self.C

    def _sample_z(self, noise, logits):
        """Straight-through categorical sample → flat [.., G*C], given the
        Gumbel noise `noise` (logits' shape; reference: `_sample_z(rng,
        logits)` draws it inside, `dreamerv3.py:135-141`)."""
        probs = self._probs(logits)
        idx = torch.argmax(noise + torch.log(probs), -1)
        hard = one_hot(idx, self.C)
        z = hard + probs - probs.detach()
        return z.reshape(z.shape[:-2] + (self.z_dim,))

    def _mode_z(self, logits):
        probs = self._probs(logits)
        hard = one_hot(torch.argmax(probs, -1), self.C)
        return hard.reshape(hard.shape[:-2] + (self.z_dim,))

    def _kl(self, post_logits, prior_logits):
        p = self._probs(post_logits)
        q = self._probs(prior_logits)
        return torch.sum(p * (torch.log(p) - torch.log(q)), dim=(-2, -1))

    def encode(self, wm, obs):
        return _mlp_apply(wm["enc"], symlog(obs), activation=F.silu)

    def head(self, mlp, h, z, activation=F.silu):
        return _mlp_apply(mlp, torch.cat([h, z], -1), activation=activation)

    # --------------------------------------- EnvRunner stateful protocol
    def initial_state(self, n: int):
        return (
            torch.zeros((n, self.deter), dtype=torch.float32),
            torch.zeros((n, self.z_dim), dtype=torch.float32),
            torch.zeros((n, self.act_n), dtype=torch.float32),
        )

    def act(self, params, obs, state, gen, greedy: bool = False):
        """One recurrent acting step: advance h with (z, a) from the LAST
        step, infer the posterior over z from the new observation, sample an
        action from the actor on (h, z). The step's Gumbel noise ([N, G, C]
        for z, [N, A] for the action; reference: `kz, ka = split(rng)`,
        `dreamerv3.py:176`) is drawn from `gen`. On the card the step after
        the draws replays one CUDA graph (`_GraphedAct`), on the CPU it runs
        eagerly."""
        n = obs.shape[0]
        draws = {"z": gumbel(gen, (n, self.G, self.C)), "a": gumbel(gen, (n, self.act_n))}
        if obs.device.type != "cuda":
            return self.act_with_draws(params, obs, state, draws, greedy)
        args = (params, obs, state, draws)
        key = (greedy, obs.device, tuple(obs.shape))
        if key not in self._act_graphs:
            self._act_graphs[key] = _GraphedAct(self, greedy, args)
        return self._act_graphs[key](args)

    def act_with_draws(self, params, obs, state, draws, greedy: bool = False):
        """`act` given its Gumbel noise ({"z": [N, G, C], "a": [N, A]})."""
        wm = params["wm"]
        h, z_prev, a_prev = state
        h = self._gru(wm["gru"], h, torch.cat([z_prev, a_prev], -1))
        embed = self.encode(wm, obs.to(torch.float32))
        post = self._logits(wm["post"], torch.cat([h, embed], -1))
        z = self._sample_z(draws["z"], post)
        logits = self.head(params["actor"], h, z)
        if greedy:
            action = torch.argmax(logits, -1)
        else:
            action = torch.argmax(draws["a"] + logits, -1)
        logp = torch.log_softmax(logits, -1)[
            torch.arange(logits.shape[0], device=logits.device), action
        ]
        value = self.head(params["critic"], h, z)[..., 0]
        a_onehot = one_hot(action, self.act_n)
        return action.to(torch.int32), logp, value, (h, z, a_onehot)


class _GraphedAct:
    """`act_with_draws` captured once as a CUDA graph over static copies of
    its arguments (params, observations, state, draws). A call copies its
    arguments in, replays, and returns copies of the outputs, which the
    next replay overwrites. The draws are arguments: the graph holds no
    RNG. A capture or replay that fails raises; nothing runs eagerly in its
    place."""

    def __init__(self, module: DreamerV3Module, greedy: bool, args):
        self.inputs = tree_map(lambda t: t.detach().clone(), args)
        device = tree_leaves(args)[0].device

        def step():
            return module.act_with_draws(*self.inputs, greedy)

        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(3):  # lazy set-up (cuBLAS handles, workspaces) outside the capture
                step()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), optim.graph_capture(self.graph):
            self.outputs = step()

    def __call__(self, args):
        torch._foreach_copy_(tree_leaves(self.inputs), tree_leaves(args))
        self.graph.replay()
        return tree_map(torch.clone, self.outputs)


def make_dreamer_update(module: DreamerV3Module, wm_opt, actor_opt, critic_opt,
                        cfg: DreamerV3Config):
    """update(state, batches, gen) -> (state, metrics) over [k, L, B]
    stacked sequences: each gradient step's Gumbel noise ("obs_z" [k, L, B,
    G, C] for the posterior samples, "img_a" [k, H, S, A] and "img_z" [k,
    H, S, G, C] for imagination's actions and prior samples, S = L·B) drawn
    from `gen` (`update.draw(batches, gen)`), then `update.with_draws(state,
    batches, draws)`, the update given it (the reference's `k_wm, k_im =
    split(key_i)`, `dreamerv3.py:326`). `update.step` is one gradient step,
    `update.program` its `optim.step_program` and `update.scan_inputs(
    batches, draws)` their (inputs, variants); `update.observe`,
    `update.wm_loss`, `update.imagine` and `update.behavior_loss` are the
    reference's closures of those names, given draws in place of keys, and
    `update.lambda_returns` the λ-return scan of `behavior_loss`."""
    G, C = module.G, module.C
    H = cfg.horizon

    def observe(wm, seq, noise):
        """Run the RSSM over a [L, B] sequence; returns losses + posterior
        (h, z) features for every step (imagination starts). `noise`: the
        posterior samples' Gumbel noise, [L, B, G, C]."""
        obs = seq["obs"]          # [L, B, obs]
        acts = one_hot(seq["actions"], module.act_n)
        is_first = seq["is_first"][..., None]  # [L, B, 1]
        L, B = obs.shape[0], obs.shape[1]
        embed = module.encode(wm, obs)
        a_prev = torch.cat([torch.zeros_like(acts[:1]), acts[:-1]], 0)
        # reference: lax.scan over (embed, a_prev, is_first, keys) (`:207-222`)
        h = torch.zeros((B, module.deter), dtype=torch.float32, device=obs.device)
        z = torch.zeros((B, module.z_dim), dtype=torch.float32, device=obs.device)
        hs, zs, priors, posts = [], [], [], []
        for t in range(L):
            keep = 1.0 - is_first[t]
            h, z, a_t = h * keep, z * keep, a_prev[t] * keep
            h = module._gru(wm["gru"], h, torch.cat([z, a_t], -1))
            prior = module._logits(wm["prior"], h)
            post = module._logits(wm["post"], torch.cat([h, embed[t]], -1))
            z = module._sample_z(noise[t], post)
            for out, x in zip((hs, zs, priors, posts), (h, z, prior, post)):
                out.append(x)
        return torch.stack(hs), torch.stack(zs), torch.stack(priors), torch.stack(posts)

    def wm_loss(wm, seq, noise):
        hs, zs, priors, posts = observe(wm, seq, noise)
        obs_hat = module.head(wm["dec"], hs, zs)
        rew_hat = module.head(wm["rew"], hs, zs)[..., 0]
        cont_logit = module.head(wm["cont"], hs, zs)[..., 0]

        recon = torch.mean(torch.sum((obs_hat - symlog(seq["obs"])) ** 2, -1))
        rew_l = torch.mean((rew_hat - symlog(seq["rewards"])) ** 2)
        cont_target = 1.0 - seq["dones"]
        # reference: optax.sigmoid_binary_cross_entropy (`:235`), its formula
        cont_l = torch.mean(
            -cont_target * F.logsigmoid(cont_logit) - (1.0 - cont_target) * F.logsigmoid(-cont_logit)
        )
        kl_dyn = module._kl(posts.detach(), priors)
        kl_rep = module._kl(posts, priors.detach())
        fb = torch.full((), cfg.free_bits, dtype=torch.float32, device=kl_dyn.device)
        kl = cfg.kl_dyn * torch.mean(torch.maximum(kl_dyn, fb)) + cfg.kl_rep * torch.mean(
            torch.maximum(kl_rep, fb)
        )
        loss = recon + rew_l + cont_l + kl
        aux = {
            "wm_loss": loss, "recon": recon, "reward_loss": rew_l,
            "cont_loss": cont_l, "kl": torch.mean(kl_dyn),
            # reference: "starts": (sg(hs), sg(zs)) (`:247`); value_and_grad's
            # aux holds tensors, each detached
            "starts_h": hs, "starts_z": zs,
        }
        return loss, aux

    def imagine(params, h0, z0, noise_a, noise_z):
        """Roll the actor through the world model PRIOR for H steps, given
        the actions' Gumbel noise [H, S, A] and the prior samples' [H, S,
        G, C] (reference: `ka, kz = split(key)` per step, `:257`)."""
        wm = params["wm"]
        h, z = h0, z0
        hs, zs, logps, ents = [h0], [z0], [], []
        for t in range(H):
            logits = module.head(params["actor"], h, z)
            a = torch.argmax(noise_a[t] + logits, -1)
            log_pi = torch.log_softmax(logits, -1)
            logp = torch.gather(log_pi, -1, a[..., None])[..., 0]
            ent = -torch.sum(torch.softmax(logits, -1) * log_pi, -1)
            a1 = one_hot(a, module.act_n)
            h = module._gru(wm["gru"], h, torch.cat([z, a1], -1))
            z = module._sample_z(noise_z[t], module._logits(wm["prior"], h))
            for out, x in zip((hs, zs, logps, ents), (h, z, logp, ent)):
                out.append(x)
        # Include the start state's features at index 0 for value/reward.
        return torch.stack(hs), torch.stack(zs), torch.stack(logps), torch.stack(ents)

    def lambda_returns(rew, disc, v_t):
        """λ-returns, reverse scan: R_k = r_k + d_k((1-λ)v_{k+1} + λR_{k+1})
        (reference: `lax.scan(back, ...)`, `:291-301`)."""
        acc = v_t[-1]
        Rs = []
        for k in reversed(range(rew.shape[0] - 1)):
            acc = rew[k] + disc[k] * ((1.0 - cfg.lam) * v_t[k + 1] + cfg.lam * acc)
            Rs.append(acc)
        return torch.stack(Rs[::-1])                   # [H, S]

    def behavior_loss(ac_params, params, h0, z0, noise_a, noise_z, ret_scale):
        params = {**params, "actor": ac_params["actor"], "critic": ac_params["critic"]}
        hs, zs, logps, ents = imagine(params, h0, z0, noise_a, noise_z)
        wm = params["wm"]
        # Rewards/continues predicted from each imagined state; v from the
        # EMA critic for stable bootstraps.
        rew = symexp(module.head(wm["rew"], hs, zs)[..., 0])          # [H+1, S]
        cont = torch.sigmoid(module.head(wm["cont"], hs, zs)[..., 0])
        v_t = module.head(params["critic_t"], hs, zs)[..., 0]
        disc = cfg.gamma * cont
        R = lambda_returns(rew, disc, v_t)

        # Imagination weights: stop counting past a predicted termination.
        w = torch.cat(
            [torch.ones_like(disc[:1]), torch.cumprod(disc[:-1], 0)], 0
        )[:-1]
        w = w.detach()

        v = module.head(params["critic"], hs[:-1], zs[:-1])[..., 0]    # [H, S]
        adv = ((R - v_t[:-1]) / ret_scale).detach()
        actor_l = -torch.mean(w * (logps * adv + cfg.entropy_coef * ents))
        critic_l = torch.mean(w * (v - R.detach()) ** 2)
        aux = {
            "actor_loss": actor_l, "critic_loss": critic_l,
            "return_mean": torch.mean(R), "entropy": torch.mean(ents),
            "R": R,
        }
        return actor_l + critic_l, aux

    wm_vg = optim.value_and_grad(wm_loss)
    behavior_vg = optim.value_and_grad(behavior_loss)

    def grad_step(state, inp, variant=None):
        """One step of the reference's scan (`dreamerv3.py:323-364`): the
        world model, then the actor and the critic on imagination from its
        new posterior states, then the EMA critic and the return scale."""
        params, (wm_os, a_os, c_os) = state
        seq = inp["seq"]

        (wm, wm_os), wm_aux = optim.gradient_step(wm_opt, wm_vg, (params["wm"], wm_os), seq, inp["obs_z"])
        params = {**params, "wm": wm}

        # Every posterior state is an imagination start ([L*B, ...]).
        hs, zs = wm_aux.pop("starts_h"), wm_aux.pop("starts_z")
        h0 = hs.reshape(-1, hs.shape[-1])
        z0 = zs.reshape(-1, zs.shape[-1])

        ac = {"actor": params["actor"], "critic": params["critic"]}
        b_aux, ac_grads = behavior_vg(ac, params, h0, z0, inp["img_a"], inp["img_z"], params["ret_scale"])
        with torch.no_grad():
            a_up, a_os = actor_opt.update(ac_grads["actor"], a_os, params["actor"])
            c_up, c_os = critic_opt.update(ac_grads["critic"], c_os, params["critic"])
            params = {
                **params,
                "actor": optim.apply_updates(params["actor"], a_up),
                "critic": optim.apply_updates(params["critic"], c_up),
            }
            # EMA critic + percentile return normalization (DreamerV3 §4).
            R = b_aux.pop("R")
            spread = percentile(R, 95) - percentile(R, 5)
            params = {
                **params,
                "critic_t": polyak(params["critic_t"], params["critic"], cfg.critic_ema),
                "ret_scale": torch.clamp_min(0.99 * params["ret_scale"] + 0.01 * spread, 1.0),
            }
            aux = {**wm_aux, **b_aux, "ret_scale": params["ret_scale"]}
        return (params, (wm_os, a_os, c_os)), aux

    program = optim.step_program(grad_step)

    def draw(batches, gen):
        k, L, B = batches["rewards"].shape
        S = L * B
        return {
            "obs_z": gumbel(gen, (k, L, B, G, C)),
            "img_a": gumbel(gen, (k, H, S, module.act_n)),
            "img_z": gumbel(gen, (k, H, S, G, C)),
        }

    def scan_inputs(batches, draws):
        return {"seq": batches, **draws}, [None] * batches["rewards"].shape[0]

    def with_draws(state, batches, draws):
        return program(state, *scan_inputs(batches, draws))

    def update(state, batches, gen):
        return with_draws(state, batches, draw(batches, gen))

    update.with_draws = with_draws
    update.draw = draw
    update.step = grad_step
    update.program = program
    update.scan_inputs = scan_inputs
    update.observe = observe
    update.wm_loss = wm_loss
    update.imagine = imagine
    update.lambda_returns = lambda_returns
    update.behavior_loss = behavior_loss
    return update


class _FragmentReplay:
    """Ring buffer of time-major rollout fragments; samples [B, L] windows
    (time-major [L, B] out) with is_first derived from dones."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.frags: List[Dict[str, np.ndarray]] = []
        self.steps = 0

    def add(self, frag: Dict[str, np.ndarray]):
        keep = {k: frag[k] for k in ("obs", "actions", "rewards", "dones")}
        self.frags.append(keep)
        self.steps += keep["rewards"].size
        while len(self.frags) > self.capacity:
            old = self.frags.pop(0)
            self.steps -= old["rewards"].size

    def sample(self, rng: np.random.Generator, n_batches: int, batch_seqs: int,
               seq_len: int) -> Dict[str, np.ndarray]:
        out = {k: [] for k in ("obs", "actions", "rewards", "dones", "is_first")}
        for _ in range(n_batches * batch_seqs):
            f = self.frags[rng.integers(len(self.frags))]
            T, N = f["rewards"].shape
            env = int(rng.integers(N))
            t0 = int(rng.integers(max(1, T - seq_len + 1)))
            sl = slice(t0, t0 + seq_len)
            if T - t0 < seq_len:  # short fragment: pad by wrapping (rare)
                idx = np.arange(seq_len) % (T - t0)
                pick = lambda a: a[sl][idx]  # noqa: E731
            else:
                pick = lambda a: a[sl]  # noqa: E731
            d = pick(f["dones"][:, env])
            is_first = np.zeros(seq_len, np.float32)
            is_first[0] = 1.0
            is_first[1:] = d[:-1]  # step after a done starts a new episode
            out["obs"].append(pick(f["obs"][:, env]))
            out["actions"].append(pick(f["actions"][:, env]))
            out["rewards"].append(pick(f["rewards"][:, env]))
            out["dones"].append(d)
            out["is_first"].append(is_first)
        # [k, L, B, ...] time-major per grad step.
        def stack(key):
            a = np.stack(out[key])  # [k*B, L, ...]
            a = a.reshape(n_batches, batch_seqs, seq_len, *a.shape[2:])
            return np.swapaxes(a, 1, 2)  # [k, L, B, ...]

        return {k: stack(k) for k in out}


class DreamerV3(Algorithm):
    config_class = DreamerV3Config

    def setup(self):
        super().setup()
        cfg = self.config
        self._replay = _FragmentReplay(cfg.replay_capacity)
        self._np_rng = np.random.default_rng(cfg.seed)

    def _make_module(self):
        if not isinstance(self.action_space, Discrete):
            raise TypeError("DreamerV3-lite supports discrete action spaces")
        obs_dim = int(np.prod(self.observation_space.shape))
        return DreamerV3Module(obs_dim, self.action_space.n, self.config)

    def _make_learner(self) -> Learner:
        cfg = self.config

        def opt(lr):
            tx = optim.adam(lr)
            if cfg.grad_clip:
                tx = optim.chain(optim.clip_by_global_norm(cfg.grad_clip), tx)
            return tx

        wm_opt, actor_opt, critic_opt = opt(cfg.lr), opt(cfg.actor_lr), opt(cfg.critic_lr)
        learner = Learner(
            self.module,
            make_dreamer_update(self.module, wm_opt, actor_opt, critic_opt, cfg),
            seed=cfg.seed, device=cfg.device,
        )
        learner.opt_state = (
            wm_opt.init(learner.params["wm"]),
            actor_opt.init(learner.params["actor"]),
            critic_opt.init(learner.params["critic"]),
        )
        return learner

    def training_step(self) -> Dict:
        cfg = self.config
        batches = self._sample_batches()
        env_steps = 0
        for b in batches:
            env_steps += b["rewards"].size
            self._replay.add(b)

        metrics: Dict = {}
        if self._replay.steps >= cfg.learning_starts:
            seqs = self._replay.sample(
                self._np_rng, cfg.num_grad_steps, cfg.batch_size_seqs, cfg.seq_len
            )
            metrics = self.learner_group.update(seqs)
            self._weights = self.learner_group.get_weights()
        return {"_env_steps_this_iter": env_steps, "info": {"learner": metrics}}


DreamerV3Config.algo_class = DreamerV3
