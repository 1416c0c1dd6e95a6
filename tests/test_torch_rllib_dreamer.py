"""The port's DreamerV3 (`ray_tpu_torch/rllib/algorithms/dreamerv3.py`)
against the JAX reference's (`ray_tpu/rllib/algorithms/dreamerv3.py`): the
same params (a reference-shaped tree carried across by `to_torch`) give the
same module outputs (the GRU, the unimix probabilities, the KL, the heads, a
straight-through sample given its Gumbel noise, one acting step), the same
world-model and behaviour loss terms and gradients, the same λ-returns,
return spread and return scale, and the same state after an update of 2
gradient steps, given JAX's Gumbel noise rebuilt from the reference's key
tree (`update.with_draws`); every categorical index sampled on the way is
the reference's. The replay samples the reference's windows from the same
fragments and seed; the EnvRunner's stateful path steps, resets and records
as the reference's; the reference's world-model smoke runs on the port;
save -> restore; a Box action space refused.

The reference's closures (`observe`, `wm_loss`, `imagine`,
`behavior_loss`, and `grad_step`, the body of its update's scan) are taken
from its update as it defines them, unchanged, and jitted once for the file.

Tolerances: TOL (1e-6, of 1 + each leaf's largest entry) for module
outputs and loss terms, GRAD_TOL (1e-5) for gradients, UPDATE_TOL (1e-5)
for the state and metrics after an update."""

import contextlib
import functools
import gc
import inspect
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib.algorithms import dreamerv3 as ref_d
from ray_tpu.rllib.env.env_runner import EnvRunner as RefEnvRunner
from ray_tpu_torch.rllib import DreamerV3Config, EnvRunner
from ray_tpu_torch.rllib.algorithms import dreamerv3 as d
from ray_tpu_torch.rllib.utils import optim
from ray_tpu_torch.rllib.utils.tree import tree_leaves
from torch_rl import close, metrics_close, to_jax, to_torch

TOL = 1e-6
GRAD_TOL = 1e-5
UPDATE_TOL = 1e-5
OBS, ACT = 4, 2
G, C, H = 4, 4, 4
SIZES = dict(deter_dim=16, stoch_groups=G, stoch_classes=C, units=16, horizon=H)
K, L, B = 2, 5, 3
S = L * B


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread for each test: the port's CPU path is thousands of
    small ops, which a loaded machine's oversubscribed thread pool slows by
    orders of magnitude (the smoke: 3.5 s on one thread, 310 s on eight
    beside a busy test run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs():
    ref_cfg, cfg = ref_d.DreamerV3Config(), DreamerV3Config()
    for c in (ref_cfg, cfg):
        for name, value in SIZES.items():
            setattr(c, name, value)
    return ref_cfg, cfg


def _closures(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _ref_grad_step(ref_update):
    """The reference's scan body `grad_step` (`dreamerv3.py:323-364`), built
    from its code object and its enclosing cells, unchanged."""
    code = next(c for c in ref_update.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "grad_step")
    cells = dict(zip(ref_update.__code__.co_freevars, ref_update.__closure__))
    return types.FunctionType(code, ref_update.__globals__, "grad_step", None,
                              tuple(cells[n] for n in code.co_freevars))


def _opts(lib, cfg):
    """The three optimizers of `_make_learner` (`dreamerv3.py:443-449`):
    clip_by_global_norm(100) chained to Adam at each learning rate."""
    return [lib.chain(lib.clip_by_global_norm(cfg.grad_clip), lib.adam(lr))
            for lr in (cfg.lr, cfg.actor_lr, cfg.critic_lr)]


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's module, optimizers and update closures, jitted."""
    ref_cfg, _ = _cfgs()
    ref = ref_d.DreamerV3Module(OBS, ACT, ref_cfg)
    opts = _opts(optax, ref_cfg)
    update = ref_d.make_dreamer_update(ref, *opts, ref_cfg)
    wm_loss, behavior_loss = _closures(update)["wm_loss"], _closures(update)["behavior_loss"]
    return types.SimpleNamespace(
        cfg=ref_cfg, module=ref, opts=opts,
        observe=jax.jit(_closures(wm_loss)["observe"]),
        imagine=jax.jit(_closures(behavior_loss)["imagine"]),
        wm_vg=jax.jit(jax.value_and_grad(wm_loss, has_aux=True)),
        behavior_vg=jax.jit(jax.value_and_grad(behavior_loss, has_aux=True)),
        grad_step=jax.jit(_ref_grad_step(update)),
        head=jax.jit(ref.head),
        # One acting step, sampled and greedy, from the same key.
        act=jax.jit(lambda *a: (ref.act(*a, greedy=False), ref.act(*a, greedy=True))),
    )


def _port():
    _, cfg = _cfgs()
    mod = d.DreamerV3Module(OBS, ACT, cfg)
    opts = _opts(optim, cfg)
    return cfg, mod, opts, d.make_dreamer_update(mod, *opts, cfg)


@functools.lru_cache(maxsize=None)
def _params():
    """A reference-shaped params tree (numpy): the port's init from seed 0
    (its tree is the reference's, `test_module_pieces_match_the_references`),
    moved off its zeros: the reward head, the critics and the GRU bias take
    noise, the target critic departs from the critic, the actor's head is
    scaled up from its 0.01, and the return scale is 5 so the spread moves it."""
    _, mod, _, _ = _port()
    params = jax.tree.map(lambda t: t.numpy(), mod.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)

    def shake(a, s):
        return (a + s * rng.standard_normal(a.shape)).astype(np.float32)

    params["actor"][-1]["w"] *= 100.0
    params["wm"]["rew"][-1]["w"] = shake(params["wm"]["rew"][-1]["w"], 0.3)
    params["wm"]["gru"]["b"] = shake(params["wm"]["gru"]["b"], 0.1)
    for key in ("critic", "critic_t"):
        params[key] = jax.tree.map(lambda a: shake(a, 0.2), params[key])
    params["ret_scale"] = np.asarray(5.0, np.float32)
    return params


def _seqs(k, seed=0):
    """[k, L, B] replayed windows: CartPole-sized observations, actions,
    rewards, dones, and is_first from the dones as the replay sets it."""
    rng = np.random.default_rng(seed)
    dones = (rng.uniform(size=(k, L, B)) < 0.25).astype(np.float32)
    is_first = np.zeros((k, L, B), np.float32)
    is_first[:, 0] = 1.0
    is_first[:, 1:] = dones[:, :-1]
    return {
        "obs": rng.standard_normal((k, L, B, OBS)).astype(np.float32),
        "actions": rng.integers(0, ACT, (k, L, B)).astype(np.int32),
        "rewards": np.where(rng.uniform(size=(k, L, B)) < 0.8, 1.0, -0.5).astype(np.float32),
        "dones": dones,
        "is_first": is_first,
    }


# --------------------------------------------------- the reference's noise
@jax.jit
def _observe_noise(key):
    """The posterior samples' noise of `observe(wm, seq, key)`: one Gumbel
    draw per step of `split(key, L)` (`dreamerv3.py:205,215,138`), [L, B, G, C]."""
    return jnp.stack([jax.random.gumbel(k, (B, G, C)) for k in jax.random.split(key, L)])


@jax.jit
def _imagine_noise(key):
    """Imagination's: `ka, kz = split(k)` for k in `split(key, H)`
    (`:271,257`), the actions' [H, S, A] and the prior samples' [H, S, G, C]."""
    pairs = [jax.random.split(k) for k in jax.random.split(key, H)]
    return (jnp.stack([jax.random.gumbel(p[0], (S, ACT)) for p in pairs]),
            jnp.stack([jax.random.gumbel(p[1], (S, G, C)) for p in pairs]))


def _update_noise(rng, k):
    """The update's: `k_wm, k_im = split(key_i)` for `split(rng, k)`
    (`:367,326`), stacked [k, ...] as `update.with_draws` takes them."""
    steps = [jax.random.split(key) for key in jax.random.split(rng, k)]
    img = [_imagine_noise(k_im) for _, k_im in steps]
    return {"obs_z": torch.from_numpy(np.stack([np.asarray(_observe_noise(k_wm)) for k_wm, _ in steps])),
            "img_a": torch.from_numpy(np.stack([np.asarray(a) for a, _ in img])),
            "img_z": torch.from_numpy(np.stack([np.asarray(z) for _, z in img]))}


def _idx(z):
    """The categorical indices of flat straight-through samples [..., G*C]."""
    z = np.asarray(z)
    return z.reshape(z.shape[:-1] + (-1, C)).argmax(-1)


def _same_indices(got, want, scores, what):
    """Equal indices, or every differing one a near tie: its two scores
    (log-probability + noise, the port's) within 1e-5 of each other
    (reported)."""
    scores = np.asarray(scores)
    diff = np.argwhere(got != want)
    gaps = [float(abs(scores[tuple(i)][got[tuple(i)]] - scores[tuple(i)][want[tuple(i)]])) for i in diff]
    assert all(g < 1e-5 for g in gaps), f"{what}: {len(diff)} indices differ, gaps {gaps}"
    if gaps:
        print(f"{what}: {len(gaps)} near-tie flips, gaps {gaps}")


def _scores(mod, logits, noise):
    with torch.no_grad():
        return (torch.log(mod._probs(logits)) + noise).numpy()


# ------------------------------------------------------------------ module
def test_module_pieces_match_the_references():
    ref = _reference().module
    cfg, mod, _, _ = _port()
    params = _params()
    tparams = to_torch(params)
    rng = np.random.default_rng(3)
    n, D, Z = 7, cfg.deter_dim, mod.z_dim
    h = rng.standard_normal((n, D)).astype(np.float32)
    x = rng.standard_normal((n, Z + ACT)).astype(np.float32)
    z = rng.standard_normal((n, Z)).astype(np.float32)
    obs = (3 * rng.standard_normal((n, OBS))).astype(np.float32)
    logits = (2 * rng.standard_normal((n, G, C))).astype(np.float32)
    logits2 = (2 * rng.standard_normal((n, G, C))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.gumbel(key, logits.shape))

    @jax.jit
    def reference(params, h, x, z, obs, logits, logits2, key):
        wm = params["wm"]
        return {
            "gru": ref._gru(wm["gru"], h, x), "probs": ref._probs(logits), "kl": ref._kl(logits, logits2),
            "mode_z": ref._mode_z(logits), "encode": ref.encode(wm, obs), "prior": ref._logits(wm["prior"], h),
            "heads": [ref.head(params[k], h, z) for k in ("actor", "critic", "critic_t")]
            + [ref.head(wm[k], h, z) for k in ("dec", "rew", "cont")],
            "symlog": ref_d.symlog(obs), "symexp": ref_d.symexp(obs), "sample_z": ref._sample_z(key, logits),
            # The straight-through gradient reaches the logits through the probabilities.
            "sample_z_grad": jax.grad(lambda lo: jnp.sum(ref._sample_z(key, lo) * z))(logits),
        }

    want = reference(params, h, x, z, obs, logits, logits2, key)
    T = torch.from_numpy
    wm = tparams["wm"]
    lg = T(logits).requires_grad_()
    sample = mod._sample_z(T(noise), lg)
    (sample_grad,) = torch.autograd.grad((sample * T(z)).sum(), lg)
    got = {
        "gru": mod._gru(wm["gru"], T(h), T(x)), "probs": mod._probs(T(logits)), "kl": mod._kl(T(logits), T(logits2)),
        "mode_z": mod._mode_z(T(logits)), "encode": mod.encode(wm, T(obs)), "prior": mod._logits(wm["prior"], T(h)),
        "heads": [mod.head(tparams[k], T(h), T(z)) for k in ("actor", "critic", "critic_t")]
        + [mod.head(wm[k], T(h), T(z)) for k in ("dec", "rew", "cont")],
        "symlog": d.symlog(T(obs)), "symexp": d.symexp(T(obs)), "sample_z": sample, "sample_z_grad": sample_grad,
    }
    for name in want:
        close(got[name], want[name], GRAD_TOL if name.endswith("grad") else TOL, name)
    close(got["mode_z"], want["mode_z"], 0.0, "mode_z")
    # The init's tree: the reference's leaves and shapes; critic_t a copy of critic; ret_scale 0-d.
    own = mod.init(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, own)) == jax.tree.structure(jax.tree.map(lambda s: 0, shapes))
    assert [tuple(t.shape) for t in tree_leaves(own)] == [s.shape for s in jax.tree.leaves(shapes)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(own["critic"]), tree_leaves(own["critic_t"])))
    assert own["ret_scale"].shape == () and float(own["ret_scale"]) == 1.0
    wx = own["wm"]["gru"]["wx"]  # orthogonal on a non-square shape: orthonormal rows
    torch.testing.assert_close(wx @ wx.T, torch.eye(wx.shape[0]), atol=1e-5, rtol=0)
    assert float(own["wm"]["rew"][-1]["w"].abs().max()) == 0.0 == float(own["critic"][-1]["w"].abs().max())


@pytest.mark.parametrize("greedy", [False, True])
def test_act_matches_the_references_given_its_draws(greedy):
    cfg, mod, _, _ = _port()
    params = _params()
    tparams = to_torch(params)
    rng = np.random.default_rng(4)
    n = 6
    obs = rng.standard_normal((n, OBS)).astype(np.float32)
    state = (rng.standard_normal((n, cfg.deter_dim)).astype(np.float32),
             np.eye(C, dtype=np.float32)[rng.integers(0, C, (n, G))].reshape(n, G * C),
             np.eye(ACT, dtype=np.float32)[rng.integers(0, ACT, n)])
    key = jax.random.PRNGKey(9)
    kz, ka = jax.random.split(key)  # `dreamerv3.py:176`
    draws = {"z": torch.from_numpy(np.array(jax.random.gumbel(kz, (n, G, C)))),
             "a": torch.from_numpy(np.array(jax.random.gumbel(ka, (n, ACT))))}
    want = _reference().act(params, obs, state, key)[int(greedy)]
    tstate = tuple(map(torch.from_numpy, state))
    got = mod.act_with_draws(tparams, torch.from_numpy(obs), tstate, draws, greedy)
    assert got[0].dtype == torch.int32 and np.array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[1:], want[1:], TOL, "logp, value, new state")
    if not greedy:
        assert len(set(got[0].tolist())) == 2  # the actor's head spreads the actions
    # act(gen) is act_with_draws given the generator's two draws, z's first.
    a1 = mod.act(tparams, torch.from_numpy(obs), tstate, torch.Generator().manual_seed(2), greedy)
    again = torch.Generator().manual_seed(2)
    mine = {"z": d.gumbel(again, (n, G, C)), "a": d.gumbel(again, (n, ACT))}
    a2 = mod.act_with_draws(tparams, torch.from_numpy(obs), tstate, mine, greedy)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a1), tree_leaves(a2)))


def test_gumbel_noise_is_standard_gumbel():
    g = d.gumbel(torch.Generator().manual_seed(0), (200_000,)).double()
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772156649) < 0.01 and abs(float(g.var()) - np.pi ** 2 / 6) < 0.03


# ------------------------------------------------------------ the world model
def test_observe_and_world_model_loss_match_the_references():
    r = _reference()
    _, mod, _, update = _port()
    params = _params()
    tparams = to_torch(params)
    seq = {k: v[0] for k, v in _seqs(1, seed=6).items()}
    assert float(seq["is_first"][1:].sum()) > 0  # a mid-window episode start resets h, z and a
    key = jax.random.PRNGKey(21)
    noise = torch.from_numpy(np.array(_observe_noise(key)))
    want = r.observe(params["wm"], to_jax(seq), key)
    got = update.observe(tparams["wm"], to_torch(seq), noise)
    close(got, want, TOL, "observe: hs, zs, priors, posts")
    _same_indices(_idx(got[1].detach()), _idx(want[1]), _scores(mod, got[3], noise), "posterior samples")
    (_, ref_aux), ref_grads = r.wm_vg(params["wm"], to_jax(seq), key)
    aux, grads = optim.value_and_grad(update.wm_loss)(tparams["wm"], to_torch(seq), noise)
    close((aux.pop("starts_h"), aux.pop("starts_z")), ref_aux.pop("starts"), TOL, "starts")
    metrics_close(aux, ref_aux, TOL, "world-model loss terms")
    close(grads, ref_grads, GRAD_TOL, "world-model gradients")


# --------------------------------------------------------------- behaviour
def test_imagination_and_behaviour_loss_match_the_references():
    r = _reference()
    cfg, mod, _, update = _port()
    params = _params()
    tparams = to_torch(params)
    rng = np.random.default_rng(7)
    h0 = rng.standard_normal((S, cfg.deter_dim)).astype(np.float32)
    z0 = np.eye(C, dtype=np.float32)[rng.integers(0, C, (S, G))].reshape(S, G * C)
    key = jax.random.PRNGKey(22)
    na, nz = (torch.from_numpy(np.array(x)) for x in _imagine_noise(key))
    T = torch.from_numpy
    want = r.imagine(params, h0, z0, key)
    got = update.imagine(tparams, T(h0), T(z0), na, nz)
    close(got, want, TOL, "imagine: hs, zs, logps, ents")
    hs, zs = got[0], got[1]
    with torch.no_grad():
        prior = mod._logits(tparams["wm"]["prior"], hs[1:])
        logits = (mod.head(tparams["actor"], hs[:-1], zs[:-1]) + na).numpy()
    _same_indices(_idx(zs[1:]), _idx(np.asarray(want[1])[1:]), _scores(mod, prior, nz), "imagined prior samples")
    ref_logits = np.asarray(r.head(params["actor"], want[0][:-1], want[1][:-1])) + na.numpy()
    _same_indices(logits.argmax(-1), ref_logits.argmax(-1), logits, "imagined actions")
    assert 0 < logits.argmax(-1).mean() < 1

    ac = {"actor": params["actor"], "critic": params["critic"]}
    (_, ref_aux), ref_grads = r.behavior_vg(ac, params, (h0, z0), key, params["ret_scale"])
    tac = {"actor": tparams["actor"], "critic": tparams["critic"]}
    aux, grads = optim.value_and_grad(update.behavior_loss)(tac, tparams, T(h0), T(z0), na, nz,
                                                             tparams["ret_scale"])
    close(aux.pop("R"), ref_aux.pop("R"), TOL, "λ-returns")
    metrics_close(aux, ref_aux, TOL, "behaviour loss terms")
    close(grads, ref_grads, GRAD_TOL, "actor and critic gradients")


def test_lambda_returns_are_the_recursion():
    """R_k = r_k + d_k((1-λ)v_{k+1} + λR_{k+1}) from R_H = v_H (the
    reference's reverse scan, `dreamerv3.py:290-301`)."""
    cfg, _, _, update = _port()
    rng = np.random.default_rng(8)
    rew, disc, v_t = (rng.uniform(-1, 1, (H + 1, S)).astype(np.float32) for _ in range(3))
    R = update.lambda_returns(*map(torch.from_numpy, (rew, disc, v_t)))
    expect = [v_t[-1]]
    for k in reversed(range(H)):
        expect.append(rew[k] + disc[k] * ((1 - cfg.lam) * v_t[k + 1] + cfg.lam * expect[-1]))
    close(R, np.stack(expect[1:][::-1]), TOL, "λ-returns")


@pytest.mark.parametrize("shape", [(7,), (4, 15), (15, 256)])
def test_percentile_spread_matches_jax(shape):
    """`jnp.percentile` on sizes with and without a whole index (the last
    R's [H, S] at the reference test's sizes), and NaN in, NaN out."""
    rng = np.random.default_rng(shape[0])
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 10)).astype(np.float32)
    qs = (95, 5, 50, 0, 100)
    want = np.asarray(jnp.percentile(x, jnp.asarray(qs, jnp.float32)))
    got = [d.percentile(torch.from_numpy(x), q) for q in qs]
    assert all(g.shape == () for g in got)
    close(torch.stack(got), want, TOL, "percentiles")
    close(got[0] - got[1], want[0] - want[1], TOL, "the 95-5 spread")
    x.reshape(-1)[3] = np.nan
    assert np.isnan(float(d.percentile(torch.from_numpy(x), 95))) and np.isnan(float(jnp.percentile(x, 95)))


# ------------------------------------------------------------------ updates
def test_update_of_two_gradient_steps_matches_the_references():
    """Two steps with the three clipped Adams from the same state, given the
    update's noise: params, optimizer states and metrics (each averaged over
    the steps, `ret_scale` included) against the reference's scan body run
    twice on `split(rng, 2)`, as its update scans it (`dreamerv3.py:366-371`);
    each step's sampled indices (posterior, imagined prior, imagined
    actions) the reference's, from the reference's state before it."""
    r = _reference()
    cfg, mod, opts, update = _port()
    params = _params()
    tparams = to_torch(params)
    init = lambda os, p: tuple(o.init(p[k]) for o, k in zip(os, ("wm", "actor", "critic")))  # noqa: E731
    ref_state, state = (params, init(r.opts, params)), (tparams, init(opts, tparams))
    seqs = _seqs(K, seed=9)
    rng = jax.random.PRNGKey(41)
    draws = _update_noise(rng, K)
    (p, s), m = update.with_draws(state, to_torch(seqs), draws)

    st, auxs = ref_state, []
    for i, key in enumerate(jax.random.split(rng, K)):
        seq = jax.tree.map(lambda a: a[i], to_jax(seqs))
        new, aux = r.grad_step(st, (seq, key))
        auxs.append(aux)
        k_wm, k_im = jax.random.split(key)
        wm0, wm1 = st[0]["wm"], new[0]["wm"]
        hs, zs, _, _ = r.observe(wm0, seq, k_wm)
        t_hs, t_zs, _, t_posts = update.observe(to_torch(wm0), to_torch(seq), draws["obs_z"][i])
        _same_indices(_idx(t_zs.detach()), _idx(zs), _scores(mod, t_posts, draws["obs_z"][i]),
                      f"step {i} posterior samples")
        img = {**st[0], "wm": wm1}  # imagination runs on the new world model, the old actor
        h0, z0 = np.array(hs).reshape(S, -1), np.array(zs).reshape(S, -1)
        ihs, izs, _, _ = r.imagine(img, h0, z0, k_im)
        t_ihs, t_izs, _, _ = update.imagine(to_torch(img), torch.from_numpy(h0), torch.from_numpy(z0),
                                            draws["img_a"][i], draws["img_z"][i])
        timg = to_torch(img)
        with torch.no_grad():
            prior = mod._logits(timg["wm"]["prior"], t_ihs[1:])
            logits = (mod.head(timg["actor"], t_ihs[:-1], t_izs[:-1]) + draws["img_a"][i]).numpy()
        _same_indices(_idx(t_izs[1:]), _idx(np.asarray(izs)[1:]), _scores(mod, prior, draws["img_z"][i]),
                      f"step {i} imagined prior samples")
        ref_logits = np.asarray(r.head(img["actor"], ihs[:-1], izs[:-1])) + draws["img_a"][i].numpy()
        _same_indices(logits.argmax(-1), ref_logits.argmax(-1), logits, f"step {i} imagined actions")
        st = new
    ref_p, ref_s = st
    metrics_close(m, {k: np.mean([np.asarray(a[k]) for a in auxs]) for k in auxs[0]}, UPDATE_TOL)
    close(p, ref_p, UPDATE_TOL, "params")
    close(s, ref_s, UPDATE_TOL, "optimizer states")
    assert [int(x[1].count) for x in s] == [int(x[1][0].count) for x in ref_s] == [K] * 3
    assert float(m["ret_scale"]) > 4.9  # 0.99·5 + 0.01·spread, then again

    # update(state, batches, gen) is with_draws given the generator's draws, in draw()'s order.
    (p1, _), m1 = update(state, to_torch(seqs), torch.Generator().manual_seed(3))
    mine = update.draw(seqs, torch.Generator().manual_seed(3))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: tuple(v.shape) for k, v in draws.items()}
    (p2, _), m2 = update.with_draws(state, to_torch(seqs), mine)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((p1, m1)), tree_leaves((p2, m2))))
    # On the CPU the program is optim.scan_steps of the step, eagerly.
    (p3, _), m3 = optim.scan_steps(update.step, state, *update.scan_inputs(to_torch(seqs), mine))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((p2, m2)), tree_leaves((p3, m3))))


# ------------------------------------------------------------------ replay
def test_fragment_replay_is_the_references():
    assert inspect.getsource(d._FragmentReplay) == inspect.getsource(ref_d._FragmentReplay)
    rng = np.random.default_rng(0)

    def frag(T, N):
        return {"obs": rng.standard_normal((T, N, OBS)).astype(np.float32),
                "actions": rng.integers(0, ACT, (T, N)).astype(np.int32),
                "rewards": rng.standard_normal((T, N)).astype(np.float32),
                "dones": (rng.uniform(size=(T, N)) < 0.1).astype(np.float32), "logp": np.zeros((T, N))}

    frags = [frag(64, 8), frag(10, 8), frag(64, 8), frag(64, 8)]  # one shorter than a window
    mine, theirs = d._FragmentReplay(3), ref_d._FragmentReplay(3)
    for f in frags:
        mine.add(f)
        theirs.add(f)
    assert mine.steps == theirs.steps == 10 * 8 + 2 * 64 * 8 and len(mine.frags) == 3
    a = mine.sample(np.random.default_rng(5), 4, 16, 16)
    b = theirs.sample(np.random.default_rng(5), 4, 16, 16)
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    assert a["obs"].shape == (4, 16, 16, OBS) and a["is_first"][:, 0].all()


# ------------------------------------------------------ the stateful runner
class _RecurrentStub:
    """A deterministic recurrent module for the EnvRunner's stateful
    protocol: h ← 0.5·h + obs, action = [Σh < 0], value = the incoming
    state's sum (so each step records the state it got). Its init is 1, not
    0, so a reset row shows."""

    def __init__(self, xp):
        self.xp = xp

    def initial_state(self, n):
        return (np.ones((n, OBS), np.float32), np.zeros((n, 1), np.float32))

    def act(self, params, obs, state, rng, greedy=False):
        h, steps = state
        value = h.sum(-1) + steps[:, 0]
        h = 0.5 * h + obs
        action = self.xp.asarray(h.sum(-1) < 0, dtype=self.xp.int32)  # pushes the pole over
        return action, 0.0 * value, value, (h, steps + 1.0)


def test_env_runner_stateful_path_matches_the_references():
    ref = RefEnvRunner(env_name="CartPole-v1", num_envs=4, module=_RecurrentStub(jnp), rollout_len=48, seed=3)
    mine = EnvRunner(env_name="CartPole-v1", num_envs=4, module=_RecurrentStub(torch), rollout_len=48, seed=3,
                     device="cpu")
    for _ in range(2):  # the state carries across fragments
        want, got = ref.sample({}), mine.sample({})
        for key in ("obs", "actions", "rewards", "dones", "last_obs", "episode_returns", "episode_lengths"):
            assert np.array_equal(got[key], want[key]), key
        np.testing.assert_allclose(got["values"], want["values"], rtol=1e-6)
        dones = got["dones"]
        assert dones.sum() >= 4
        # Every row after a done starts from the init again: its step count reads 0 (sum of ones = 4).
        after = np.argwhere(dones[:-1] > 0)
        assert np.all(got["values"][after[:, 0] + 1, after[:, 1]] == float(OBS))
    close(mine._state, ref._state, TOL, "the state after two fragments")


# -------------------------------------------------------------- algorithm
def _algo(**training):
    return (DreamerV3Config().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=8, rollout_fragment_length=64)
            .training(**training).debugging(seed=0).resources(device="cpu").build())


def test_the_references_world_model_smoke_on_the_port():
    """`tests/test_rllib_dreamer.py:28-52` on the port: recon falls within
    6 iterations and every loss stays finite."""
    algo = _algo(num_grad_steps=4, batch_size_seqs=16)
    recons = []
    try:
        for _ in range(6):
            info = algo.train()["info"]["learner"]
            if info:
                recons.append(info["recon"])
                assert np.isfinite(info["wm_loss"]) and np.isfinite(info["actor_loss"])
                assert np.isfinite(info["critic_loss"])
    finally:
        algo.stop()
    assert len(recons) >= 3
    assert recons[-1] < recons[0], f"world model not learning: {recons}"
    assert set(info) == {"wm_loss", "recon", "reward_loss", "cont_loss", "kl", "actor_loss", "critic_loss",
                         "return_mean", "entropy", "ret_scale"}


def test_save_restore(tmp_path):
    small = dict(num_grad_steps=2, batch_size_seqs=4, learning_starts=512, **SIZES)
    algo = _algo(**small)
    other = _algo(**small)
    try:
        for _ in range(2):
            algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        other.restore(path)
        a, b = algo.learner_group.local_learner, other.learner_group.local_learner
        assert int(a.opt_state[0][1].count) == 4  # two updates of two steps
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.state), tree_leaves(b.state)))
        assert torch.equal(a._gen.get_state(), b._gen.get_state())
        # The module crosses to remote runners by pickle, without its acting graphs.
        algo.module._act_graphs["marker"] = object()
        assert pickle.loads(pickle.dumps(algo.module))._act_graphs == {}
    finally:
        algo.stop()
        other.stop()


def test_a_box_action_space_is_refused():
    with pytest.raises(TypeError, match="discrete"):
        DreamerV3Config().environment("Pendulum-v1").resources(device="cpu").build()


def test_graph_capture_keeps_the_garbage_collector_off(monkeypatch):
    """The acting and update graphs capture through `optim.graph_capture`:
    the cyclic collector is off inside (a dead graph destroyed mid-capture
    would invalidate it) and back on after, an error included."""
    seen = []

    @contextlib.contextmanager
    def graph(g):
        seen.append(gc.isenabled())
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    assert gc.isenabled()
    with optim.graph_capture(object()):
        seen.append(gc.isenabled())
    assert seen == [False, False] and gc.isenabled()
    with pytest.raises(RuntimeError, match="in the capture"):
        with optim.graph_capture(object()):
            raise RuntimeError("in the capture")
    assert gc.isenabled()
