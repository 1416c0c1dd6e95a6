"""The port's Tune (`ray_tpu_torch.tune`, a copy of the reference's):

* the searchers and schedulers against the reference's, with no runtime:
  the same seeds and the same synthetic result streams give the same
  suggestions, decisions and exploit/explore configs;
* the HyperBand cases of `tests/test_rllib_offline.py:56-166`;
* the cases of `tests/test_tune.py` on the port's local runtime;
* a `TorchTrainer` on the CPU as a trainable (`tuner.py`'s
  Trainer-as-trainable path);
* a trial's GPU share placed with `num_gpus=` (the reference places its TPU
  share with `num_tpus=`).

One local runtime for the module; one torch thread."""

import random

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.tune import ASHAScheduler, PopulationBasedTraining, TuneConfig, Tuner


@pytest.fixture(scope="module")
def local_rt():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rt.init(local_mode=True, num_gpus=1)  # one advertised GPU share pool, no card
    try:
        yield
    finally:
        rt.shutdown()
        torch.set_num_threads(threads)


class _T:
    def __init__(self, tid):
        self.trial_id = tid


# ------------------------------------------------ reference vs port, no runtime
def _space(t):
    return {"a": t.grid_search([1, 2, 3]), "b": t.grid_search(["x", "y"]), "lr": t.loguniform(1e-5, 1e-1),
            "n": t.randint(1, 10), "q": t.quniform(0.0, 1.0, 0.1), "c": t.choice(["relu", "gelu", "tanh"]),
            "r": t.randn(0.0, 2.0), "l": t.lograndint(1, 100), "nested": {"u": t.uniform(-1.0, 1.0)}}


def _grid(t):
    gen = t.BasicVariantGenerator({"a": t.grid_search([1, 2, 3]), "b": t.grid_search(["x", "y"])}, num_samples=2,
                                  seed=5)
    return [gen.suggest(f"t{i}") for i in range(gen.total + 1)]


def _random(t):
    gen = t.BasicVariantGenerator(_space(t), num_samples=3, seed=11)
    return [gen.suggest(f"t{i}") for i in range(gen.total + 1)]


def _model_search(t, cls):
    """A TPE-style searcher over a 2-d space, each suggestion scored by a
    fixed function; BOHB also hears each trial's rung reports."""
    space = {"x": t.uniform(-10.0, 10.0), "k": t.choice([1, 2, 4]), "m": {"y": t.loguniform(1e-3, 1.0)}}
    s = cls(space, num_samples=14, seed=7, min_observations=4)
    s.set_objective("score", "max")
    out = []
    for i in range(15):
        cfg = s.suggest(f"t{i}")
        out.append(cfg)
        if cfg is None:
            break
        score = -(cfg["x"] - 3.0) ** 2 - cfg["k"] + cfg["m"]["y"]
        if hasattr(s, "on_trial_result"):
            for it in (1, 3):
                s.on_trial_result(f"t{i}", {"score": score * it / 3, "training_iteration": it})
        s.on_trial_complete(f"t{i}", {"score": score})
    return out


def _stream(seed, n_trials, n_iters):
    """(trial index, iteration, score) in an interleaved order: every trial
    reports its iterations in order, the trials in a seeded shuffle."""
    rng = random.Random(seed)
    slopes = [rng.uniform(-1.0, 2.0) for _ in range(n_trials)]
    left = {i: 1 for i in range(n_trials)}
    out = []
    while left:
        i = rng.choice(sorted(left))
        it = left[i]
        out.append((i, it, slopes[i] * it + rng.gauss(0.0, 0.5)))
        if it == n_iters:
            del left[i]
        else:
            left[i] += 1
    return out


def _run_scheduler(sched, n_trials, n_iters, seed, add=False, no_more=False):
    sched.set_objective("score", "max")
    trials = [_T(f"t{i}") for i in range(n_trials)]
    if add:
        for t in trials:
            sched.on_trial_add(t)
    if no_more:
        sched.on_no_more_trials()
    stopped, out = set(), []
    for i, it, score in _stream(seed, n_trials, n_iters):
        if i in stopped:
            continue
        d = sched.on_trial_result(trials[i], {"score": score, "training_iteration": it})
        out.append((i, it, d))
        if d == "STOP":
            stopped.add(i)
            sched.on_trial_complete(trials[i], {"score": score})
    return out


def _pbt(t):
    pbt = t.PopulationBasedTraining(perturbation_interval=2,
                                    hyperparam_mutations={"lr": t.uniform(1e-4, 1e-1), "bs": [16, 32, 64],
                                                          "mom": t.choice([0.8, 0.9, 0.99])},
                                    quantile_fraction=0.25, resample_probability=0.25, seed=3)
    pbt.set_objective("score", "max")
    trials = [_T(f"t{i}") for i in range(8)]
    configs = {t.trial_id: {"lr": 0.01 * (k + 1), "bs": 32, "mom": 0.9} for k, t in enumerate(trials)}
    out = []
    for i, it, score in _stream(4, 8, 12):
        trial = trials[i]
        result = {"score": score, "training_iteration": it}
        out.append(pbt.on_trial_result(trial, result))
        if pbt.should_perturb(trial, result):
            target = pbt.exploit_target(trial)
            out.append((trial.trial_id, target))
            if target is not None:
                configs[trial.trial_id] = pbt.explore(dict(configs[target]))
                out.append(dict(configs[trial.trial_id]))
    return out


CASES = {
    "grid": _grid,
    "random": _random,
    "tpe": lambda t: _model_search(t, t.TPESearch),
    "bohb": lambda t: _model_search(t, t.BOHBSearch),
    "asha": lambda t: _run_scheduler(t.AsyncHyperBandScheduler(grace_period=1, reduction_factor=2, max_t=8), 10, 8,
                                     seed=1),
    "hyperband": lambda t: _run_scheduler(t.HyperBandScheduler(max_t=9, reduction_factor=3), 12, 9, seed=2,
                                          add=True, no_more=True),
    "median": lambda t: _run_scheduler(t.MedianStoppingRule(grace_period=2, min_samples_required=3), 7, 8, seed=3),
    "pbt": _pbt,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_searchers_and_schedulers_match_the_reference(case):
    from ray_tpu import tune as ref_tune

    want, got = CASES[case](ref_tune), CASES[case](tune)
    assert got == want
    assert len(got) > 5


def test_the_parity_streams_exercise_each_branch():
    """The synthetic streams reach the decisions they are meant to compare:
    stops and continues, perturbations with an exploit target."""
    for case in ("asha", "hyperband", "median"):
        decisions = {d for _, _, d in CASES[case](tune)}
        assert decisions == {"CONTINUE", "STOP"}, case
    pbt = CASES["pbt"](tune)
    assert sum(isinstance(x, dict) for x in pbt) >= 2
    variants = CASES["random"](tune)
    assert variants[-1] is None and len({repr(sorted(c.items())) for c in variants[:-1]}) == 18


# ------------------------------------ HyperBand (tests/test_rllib_offline.py:56-166)
def test_hyperband_bracket_capacities_and_fill_order():
    from ray_tpu_torch.tune.schedulers import HyperBandScheduler

    sched = HyperBandScheduler(max_t=9, reduction_factor=3)
    assert sched._bracket_budgets == [9, 3, 1]
    assert sched._bracket_capacity == [3, 6, 9]
    trials = [_T(f"t{i}") for i in range(18)]
    for t in trials:
        sched.on_trial_add(t)
    assert [sched._assign[t.trial_id] for t in trials[:9]] == [2] * 9
    assert [sched._assign[t.trial_id] for t in trials[9:15]] == [1] * 6
    assert [sched._assign[t.trial_id] for t in trials[15:]] == [0] * 3


def test_hyperband_synchronous_halving_waits_for_full_rung():
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, HyperBandScheduler

    sched = HyperBandScheduler(max_t=9, reduction_factor=3)
    sched.set_objective("score", "max")
    b2 = [_T(f"b{i}") for i in range(9)]
    for t in b2:
        sched.on_trial_add(t)
    for i, t in enumerate(b2[:8]):
        assert sched.on_trial_result(t, {"training_iteration": 1, "score": float(i)}) == CONTINUE
    assert sched.on_trial_result(b2[8], {"training_iteration": 1, "score": 8.0}) == CONTINUE
    assert sched.on_trial_result(b2[0], {"training_iteration": 2, "score": 0.0}) == STOP
    assert sched.on_trial_result(b2[7], {"training_iteration": 2, "score": 7.0}) == CONTINUE
    assert sched.on_trial_result(b2[7], {"training_iteration": 9, "score": 99.0}) == STOP


def test_hyperband_partial_bracket_resolves_on_exhaustion():
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, HyperBandScheduler

    sched = HyperBandScheduler(max_t=9, reduction_factor=3)
    sched.set_objective("score", "max")
    trials = [_T(f"t{i}") for i in range(4)]
    for t in trials:
        sched.on_trial_add(t)
    for i, t in enumerate(trials):
        assert sched.on_trial_result(t, {"training_iteration": 1, "score": float(i)}) == CONTINUE
    sched.on_no_more_trials()
    assert sched.on_trial_result(trials[0], {"training_iteration": 2, "score": 0.0}) == STOP
    assert sched.on_trial_result(trials[3], {"training_iteration": 2, "score": 3.0}) == CONTINUE


def test_hyperband_completed_trial_does_not_wedge_rung():
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, HyperBandScheduler

    sched = HyperBandScheduler(max_t=9, reduction_factor=3)
    sched.set_objective("score", "max")
    b2 = [_T(f"x{i}") for i in range(9)]
    for t in b2:
        sched.on_trial_add(t)
    sched.on_trial_complete(b2[0], {})
    for i, t in enumerate(b2[1:8], start=1):
        assert sched.on_trial_result(t, {"training_iteration": 1, "score": float(i)}) == CONTINUE
    sched.on_trial_result(b2[8], {"training_iteration": 1, "score": 8.0})
    assert sched.on_trial_result(b2[1], {"training_iteration": 2, "score": 1.0}) == STOP


# ------------------------------------------ tests/test_tune.py on the port
def test_grid_search_finds_best(local_rt):
    def objective(config):
        tune.report({"score": -((config["x"] - 3) ** 2)})

    results = Tuner(objective, param_space={"x": tune.grid_search([0, 1, 2, 3, 4])},
                    tune_config=TuneConfig(metric="score", mode="max")).fit()
    assert len(results) == 5
    assert results.get_best_result().metrics["score"] == 0


def test_random_sampling_num_samples(local_rt):
    def objective(config):
        tune.report({"val": config["lr"]})

    results = Tuner(objective, param_space={"lr": tune.loguniform(1e-5, 1e-1)},
                    tune_config=TuneConfig(metric="val", mode="max", num_samples=6)).fit()
    vals = [r.metrics["val"] for r in results]
    assert len(results) == 6 and all(1e-5 <= v <= 1e-1 for v in vals) and len(set(vals)) > 1


def test_trial_error_isolated(local_rt):
    def objective(config):
        if config["x"] == 1:
            raise ValueError("bad trial")
        tune.report({"score": config["x"]})

    results = Tuner(objective, param_space={"x": tune.grid_search([0, 1, 2])},
                    tune_config=TuneConfig(metric="score", mode="max")).fit()
    assert len(results.errors) == 1
    assert results.get_best_result().metrics["score"] == 2


def test_asha_stops_bad_trials(local_rt):
    def objective(config):
        import time

        for i in range(1, 20):
            tune.report({"score": config["slope"] * i, "training_iteration": i})
            time.sleep(0.05)

    results = Tuner(objective, param_space={"slope": tune.grid_search([2.0, 1.0, 0.2, 0.1])},
                    tune_config=TuneConfig(metric="score", mode="max",
                                           scheduler=ASHAScheduler(grace_period=2, reduction_factor=2, max_t=19),
                                           max_concurrent_trials=4)).fit()
    iters = {r.metrics.get("training_iteration", 0) for r in results}
    assert min(iters) < 19


def test_stop_criteria(local_rt):
    def objective(config):
        for i in range(100):
            tune.report({"reward": i})

    results = tune.run(objective, config={}, metric="reward", mode="max", stop={"reward": 10})
    assert results.get_best_result().metrics["reward"] == 10


def test_pbt_exploits_checkpoints(local_rt):
    def objective(config):
        ckpt = tune.get_checkpoint()
        start = ckpt.to_dict()["step"] if ckpt else 0
        for i in range(start + 1, 25):
            tune.report({"score": config["theta"] * i, "training_iteration": i},
                        checkpoint=tune.Checkpoint.from_dict({"step": i}))

    results = Tuner(objective, param_space={"theta": tune.grid_search([0.1, 1.0])},
                    tune_config=TuneConfig(metric="score", mode="max",
                                           scheduler=PopulationBasedTraining(
                                               perturbation_interval=5,
                                               hyperparam_mutations={"theta": tune.uniform(0.5, 2.0)}),
                                           max_concurrent_trials=2)).fit()
    assert len(results) == 2 and not results.errors


def test_tpe_search_converges_better_than_worst(local_rt):
    from ray_tpu_torch.tune import TPESearch

    def objective(config):
        tune.report({"score": -(config["x"] - 3.0) ** 2})

    results = Tuner(objective, param_space={"x": tune.uniform(-10.0, 10.0)},
                    tune_config=TuneConfig(metric="score", mode="max",
                                           search_alg=TPESearch({"x": tune.uniform(-10.0, 10.0)}, num_samples=20,
                                                                seed=7, min_observations=5),
                                           max_concurrent_trials=1)).fit()
    assert len(results) == 20 and not results.errors
    assert results.get_best_result().metrics["score"] > -4.0


def test_bohb_with_hyperband_scheduler(local_rt):
    from ray_tpu_torch.tune import BOHBSearch
    from ray_tpu_torch.tune.schedulers import AsyncHyperBandScheduler

    def objective(config):
        for i in range(1, 9):
            tune.report({"score": config["lr"] * i, "training_iteration": i})

    results = Tuner(objective, param_space={"lr": tune.uniform(0.1, 1.0)},
                    tune_config=TuneConfig(metric="score", mode="max",
                                           search_alg=BOHBSearch({"lr": tune.uniform(0.1, 1.0)}, num_samples=8,
                                                                 seed=3),
                                           scheduler=AsyncHyperBandScheduler(max_t=8, grace_period=2),
                                           max_concurrent_trials=2)).fit()
    assert len(results) == 8 and results.get_best_result().metrics["score"] > 0


def test_concurrency_limiter_caps_in_flight(local_rt):
    from ray_tpu_torch.tune import ConcurrencyLimiter
    from ray_tpu_torch.tune.search import BasicVariantGenerator

    def objective(config):
        import time as _t

        start = _t.time()
        _t.sleep(0.25)
        tune.report({"score": config["x"], "start": start, "end": _t.time()})

    space = {"x": tune.uniform(0, 1)}
    results = Tuner(objective, param_space=space,
                    tune_config=TuneConfig(metric="score", mode="max",
                                           search_alg=ConcurrencyLimiter(BasicVariantGenerator(space, num_samples=6),
                                                                         max_concurrent=2),
                                           max_concurrent_trials=4)).fit()
    assert len(results) == 6 and not results.errors
    spans = [(r.metrics["start"], r.metrics["end"]) for r in results]
    live = peak = 0
    for _, delta in sorted([(s, 1) for s, _ in spans] + [(e, -1) for _, e in spans]):
        live += delta
        peak = max(peak, live)
    assert peak <= 2


def test_tuner_restore_resumes_incomplete(local_rt, tmp_path):
    import cloudpickle

    from ray_tpu_torch.train.config import RunConfig

    def objective(config):
        ckpt = tune.get_checkpoint()
        start = ckpt.to_dict()["step"] if ckpt else 0
        for i in range(start + 1, 6):
            tune.report({"score": config["x"] * i, "training_iteration": i},
                        checkpoint=tune.Checkpoint.from_dict({"step": i}))

    rc = RunConfig(name="restore_exp", storage_path=str(tmp_path))
    results = Tuner(objective, param_space={"x": tune.grid_search([1.0, 2.0])},
                    tune_config=TuneConfig(metric="score", mode="max"), run_config=rc).fit()
    assert len(results) == 2 and not results.errors
    state_file = tmp_path / "restore_exp" / "experiment_state.pkl"
    state = cloudpickle.loads(state_file.read_bytes())
    assert len(state["trials"]) == 2
    state["trials"][1]["state"] = "RUNNING"
    state["trials"][1]["results"] = state["trials"][1]["results"][:2]
    state["trials"][1]["latest_checkpoint"] = tune.Checkpoint.from_dict({"step": 2})
    state_file.write_bytes(cloudpickle.dumps(state))
    restored = Tuner.restore(str(tmp_path / "restore_exp"), objective, run_config=rc).fit()
    assert len(restored) == 2 and not restored.errors
    assert [r for r in restored if r.metrics.get("training_iteration") == 5]


# ------------------------------------------------- the port's own paths
def test_torch_trainer_as_a_trainable(local_rt, tmp_path):
    """A CPU `TorchTrainer` handed to `Tuner` runs once per config: each
    trial's history is the inner fit's (a least-squares fit of one weight
    by SGD at the trial's lr), and the best trial is the lr that fits it."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def loop(config):
        import torch

        from ray_tpu_torch import train

        x = torch.linspace(-1.0, 1.0, 16, dtype=torch.float64)
        y = 3.0 * x
        w = torch.zeros((), dtype=torch.float64, requires_grad=True)
        for i in range(4):
            loss = ((w * x - y) ** 2).mean()
            (g,) = torch.autograd.grad(loss, w)
            with torch.no_grad():
                w -= config["lr"] * g
            train.report({"loss": loss.item(), "lr": config["lr"], "w": w.item()})

    trainer = TorchTrainer(loop, train_loop_config={"lr": 0.0}, scaling_config=ScalingConfig(num_workers=1),
                           run_config=RunConfig(storage_path=str(tmp_path), name="inner"))
    results = Tuner(trainer, param_space={"lr": tune.grid_search([0.01, 0.5])},
                    tune_config=TuneConfig(metric="loss", mode="min")).fit()
    assert len(results) == 2 and not results.errors
    for r in results:
        assert [m["training_iteration"] for m in r.metrics_history] == [1, 2, 3, 4]
        losses = [m["loss"] for m in r.metrics_history]
        assert losses == sorted(losses, reverse=True)
    best = results.get_best_result()
    assert best.metrics["lr"] == 0.5 and abs(best.metrics["w"] - 3.0) < 0.5


def test_a_trials_gpu_share_is_placed_with_num_gpus(local_rt, monkeypatch):
    """`trial_resources={"GPU": x}` reaches the trial actor's `num_gpus`
    (the reference's `{"TPU": x}` reaches `num_tpus`), and a trial without
    a GPU share asks for none."""
    from ray_tpu_torch.core import api

    placed = []
    remote = api.remote

    def recording_remote(cls):
        actor_cls = remote(cls)
        options = actor_cls.options

        def recording_options(**kw):
            placed.append(kw)
            return options(**kw)

        actor_cls.options = recording_options
        return actor_cls

    monkeypatch.setattr(api, "remote", recording_remote)

    def objective(config):
        tune.report({"score": config["x"]})

    for resources in ({"CPU": 1, "GPU": 0.5}, {"CPU": 1}):
        results = Tuner(objective, param_space={"x": tune.grid_search([1, 2])},
                        tune_config=TuneConfig(metric="score", mode="max", trial_resources=resources)).fit()
        assert len(results) == 2 and not results.errors
    assert placed == [{"num_cpus": 1, "num_gpus": 0.5}] * 2 + [{"num_cpus": 1, "num_gpus": None}] * 2
