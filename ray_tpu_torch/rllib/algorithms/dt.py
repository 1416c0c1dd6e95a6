"""Decision Transformer — offline RL as sequence modeling.

Reference analog: `rllib/algorithms/dt/dt.py` + `dt_torch_model.py` —
return-conditioned behavior cloning: interleave (return-to-go, state,
action) tokens, train a causal transformer to predict actions, act at eval
time by conditioning on a target return. As in the JAX reference
(`ray_tpu/rllib/algorithms/dt.py`), the transformer reuses this
framework's GPT block stack (`models/gpt._block`: the same norms and
attention the LLM path uses, here the plain attention in f32) under
custom continuous-input embeddings, and the update is BC's
`make_supervised_update`, eager on the learner's device with its
permutations drawn apart (`update.with_perms`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...device import resolve_device
from ...models.gpt import GPTConfig, _LAYER_KEYS, _block, _layer, _norm, init_params
from ..core.learner import Learner
from ..offline import EpisodeDataset
from ..utils import optim
from ..utils.tree import to_device
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig
from .bc import make_supervised_update


class DTConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.context_length: int = 20      # K timesteps (3K tokens)
        self.embed_dim: int = 128
        self.num_layers: int = 3
        self.num_heads: int = 4
        self.train_batch_size = 512        # subsequences per iteration
        self.minibatch_size = 128
        self.num_epochs = 2
        self.target_return: Optional[float] = None  # eval conditioning
        self.rtg_scale: float = 100.0      # normalize returns-to-go
        self.max_ep_len: int = 1000        # timestep-embedding table size
        self.dataset: Optional[EpisodeDataset] = None
        self.num_env_runners = 0           # offline: env used for eval only

    def offline_data(self, dataset: EpisodeDataset) -> "DTConfig":
        self.dataset = dataset
        return self

    def validate(self):
        super().validate()
        if self.dataset is None:
            raise ValueError("DT needs offline_data(dataset=EpisodeDataset)")
        if self.target_return is None:
            raise ValueError("DT needs training(target_return=...) for eval")
        if self.train_batch_size % self.minibatch_size != 0:
            raise ValueError("train_batch_size must divide into minibatches")


class DTModule:
    """Return-conditioned causal transformer over (rtg, obs, act) tokens,
    discrete actions. Satisfies the Learner contract (init/forward)."""

    def __init__(self, obs_dim: int, n_actions: int, cfg: DTConfig):
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.K = cfg.context_length
        self.max_ep_len = cfg.max_ep_len
        D = cfg.embed_dim
        # The GPT block stack config: ref attention (3K tokens is tiny),
        # f32 masters, no remat.
        self.block_cfg = GPTConfig(
            vocab_size=128, n_layers=cfg.num_layers, d_model=D,
            n_heads=cfg.num_heads, d_head=D // cfg.num_heads, d_mlp=4 * D,
            max_seq=3 * cfg.context_length, attn_impl="ref", remat=False,
            dtype=torch.float32,
        )

    def init(self, gen):
        D = self.block_cfg.d_model
        # reference: init_params(k[0], cfg) of 8 split keys (`dt.py:80-82`);
        # the port's init_params(cfg, seed) draws from the one generator.
        gpt_params = init_params(self.block_cfg, gen, device=gen.device)
        blocks = {key: gpt_params[key] for key in _LAYER_KEYS if key in gpt_params}

        def n(shape, s=0.02):
            return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * s

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=gen.device)

        return {
            "blocks": blocks,
            "w_rtg": n((1, D)),
            "w_obs": n((self.obs_dim, D)),
            "b_tok": zeros((D,)),
            "act_embed": n((self.n_actions, D)),
            "time_embed": n((self.max_ep_len, D)),
            "ln_f_w": torch.ones((D,), dtype=torch.float32, device=gen.device),
            "ln_f_b": zeros((D,)),
            "w_head": n((D, self.n_actions)),
            "b_head": zeros((self.n_actions,)),
        }

    def forward(self, params, rtg, obs, actions, timesteps):
        """rtg/obs/actions/timesteps [B, K] (+obs_dim) -> action logits at
        every STATE token [B, K, A]."""
        B, K = rtg.shape
        # reference: `time_embed[timesteps]` (`dt.py:104`), a JAX gather: an
        # index past the table (a demo longer than max_ep_len) reads the last
        # row, and its gradient is dropped. torch indexing would raise, so the
        # port clamps, and detaches the rows read out of range.
        rows = params["time_embed"][timesteps.clamp(max=self.max_ep_len - 1)]
        te = torch.where((timesteps < self.max_ep_len)[..., None], rows, rows.detach())  # [B, K, D]
        h_rtg = rtg[..., None] @ params["w_rtg"] + params["b_tok"] + te
        h_obs = obs @ params["w_obs"] + params["b_tok"] + te
        h_act = params["act_embed"][actions] + te
        # Interleave to (rtg_0, s_0, a_0, rtg_1, s_1, a_1, ...).
        x = torch.stack([h_rtg, h_obs, h_act], dim=2).reshape(B, 3 * K, -1)

        positions = torch.arange(3 * K, device=x.device)
        # reference: a lax.scan of `_block(cfg, None, None, x, layer, positions)`
        # over the stacked layers (`dt.py:114-118`); the port's `_block` takes
        # no mesh and returns (out, aux, k, v).
        for i in range(self.block_cfg.n_layers):
            x = _block(self.block_cfg, None, x, _layer(params["blocks"], self.block_cfg, i), positions)[0]
        x = _norm(x, params["ln_f_w"], params["ln_f_b"], "layernorm")
        h_state = x[:, 1::3]  # the state-token positions predict actions
        return h_state @ params["w_head"] + params["b_head"]


def make_dt_update(module: DTModule, opt, cfg: DTConfig):
    def loss_fn(params, mb):
        logits = module.forward(
            params, mb["rtg"], mb["obs"], mb["actions"], mb["timesteps"]
        )
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, mb["actions"].long()[..., None])[..., 0]
        mask = mb["mask"]
        loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        acc = ((logits.argmax(dim=-1) == mb["actions"]) * mask).sum() / torch.clamp(
            mask.sum(), min=1.0
        )
        return loss, {"dt_loss": loss, "action_accuracy": acc}

    return make_supervised_update(opt, cfg, loss_fn)


class DT(Algorithm):
    config_class = DTConfig

    def setup(self):
        self._np_rng = np.random.default_rng(self.config.seed)
        super().setup()
        # reference: one jax.jit of the forward for the algorithm's lifetime
        # (`dt.py:160-162`); the port's evaluation forward runs without
        # autograd on the learner's device, one CUDA graph on the card
        # (`_eval_forward`).
        self._device = resolve_device(self.config.device)
        self._fwd = torch.no_grad()(self.module.forward)

    def _make_module(self):
        obs_dim = int(np.prod(self.observation_space.shape))
        return DTModule(obs_dim, self.action_space.n, self.config)

    def _make_learner(self) -> Learner:
        from ..utils.optim import make_optimizer

        cfg = self.config
        opt = make_optimizer(cfg)
        learner = Learner(
            self.module, make_dt_update(self.module, opt, cfg), seed=cfg.seed,
            device=cfg.device,
        )
        learner.opt_state = opt.init(learner.params)
        return learner

    def training_step(self) -> Dict:
        cfg = self.config
        batch = cfg.dataset.sample_subsequences(
            self._np_rng, cfg.train_batch_size, cfg.context_length
        )
        batch["rtg"] = batch["rtg"] / cfg.rtg_scale
        batch["actions"] = batch["actions"].astype(np.int32)
        metrics = self.learner_group.update(batch)
        self._weights = self.learner_group.get_weights()
        ev = self.evaluate()
        if "episode_reward_mean" in ev:
            self._episode_returns.append(ev["episode_reward_mean"])
        return {
            "_env_steps_this_iter": 0,
            "num_offline_transitions_this_iter": cfg.train_batch_size,
            "info": {"learner": metrics},
            "evaluation": ev,
        }

    def _eval_forward(self, params):
        """`fwd(r, o, a, ts) -> logits` of one evaluation's params over
        [1, K] numpy contexts: on the card a CUDA graph of the forward over
        static inputs, captured for the evaluation and replayed each step
        (the logits it returns are overwritten by the next call); on the
        CPU the forward itself."""
        K, dev = self.config.context_length, self._device
        if dev.type != "cuda":
            return lambda *ctx: self._fwd(params, *to_device(ctx, dev))
        static = [torch.zeros((1, K), dtype=torch.float32, device=dev),
                  torch.zeros((1, K, self.module.obs_dim), dtype=torch.float32, device=dev),
                  torch.zeros((1, K), dtype=torch.int32, device=dev),
                  torch.zeros((1, K), dtype=torch.int32, device=dev)]
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._fwd(params, *static)  # lazy set-up outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with optim.graph_capture(graph):
            logits = self._fwd(params, *static)

        def fwd(*ctx):
            for s, x in zip(static, ctx):
                s.copy_(torch.from_numpy(x))
            graph.replay()
            return logits

        return fwd

    # DT acting is HISTORY-conditioned — the stateless eval-runner path
    # can't serve it, so evaluation is a local conditioned rollout
    # (reference: `dt.py` get_next_action on a running context).
    def evaluate(self, n_episodes: int = 5) -> Dict:
        from ..env import make_env

        cfg = self.config
        K = cfg.context_length
        # reference: the numpy weights straight into the jitted forward
        # (`dt.py:194`); the port moves them to the learner's device once.
        params = to_device(self._weights, self._device)
        fwd = self._eval_forward(params)
        env = make_env(cfg.env, 1, **cfg.env_config)
        returns, lengths = [], []
        for ep in range(n_episodes):
            obs, _ = env.reset(seed=1000 + ep)
            obs_h = [np.asarray(obs[0], np.float32)]
            act_h: list = []
            rtg_h = [cfg.target_return]
            total, t = 0.0, 0
            while t < cfg.max_ep_len - 1:
                n = min(len(obs_h), K)
                o = np.zeros((1, K, self.module.obs_dim), np.float32)
                a = np.zeros((1, K), np.int32)
                r = np.zeros((1, K), np.float32)
                ts = np.zeros((1, K), np.int32)
                o[0, K - n:] = np.stack(obs_h[-n:])
                # Action slots: past actions; the CURRENT step's action slot
                # is a placeholder the causal mask keeps invisible to its
                # own state token.
                past = (act_h + [0])[-n:]
                a[0, K - n:] = past
                r[0, K - n:] = np.asarray(rtg_h[-n:]) / cfg.rtg_scale
                ts[0, K - n:] = np.arange(max(0, t - n + 1), t + 1)
                # reference: fwd(params, r, o, a, ts) on numpy, argmax in numpy
                # (`dt.py:215-216`); the port's inputs go to the device.
                logits = fwd(r, o, a, ts)
                action = int(logits[0, -1].argmax())
                obs, rew, term, trunc, _ = env.step(np.array([action]))
                reward = float(rew[0])
                total += reward
                act_h.append(action)
                rtg_h.append(rtg_h[-1] - reward)
                obs_h.append(np.asarray(obs[0], np.float32))
                t += 1
                if bool(term[0] or trunc[0]):
                    break
            returns.append(total)
            lengths.append(t)
        env.close()
        return {
            "episode_reward_mean": float(np.mean(returns)),
            "episode_len_mean": float(np.mean(lengths)),
            "episodes_this_eval": n_episodes,
        }


DTConfig.algo_class = DT
