"""The port's HF GPT-2 interop (`ray_tpu_torch.train.huggingface`) against
the reference's (`ray_tpu.train.huggingface`), after
`tests/test_hf_interop.py`, f32 on the CPU:

* `config_from_hf` and `params_from_hf` of a tiny `GPT2LMHeadModel`: the
  same config and every array equal to the reference's conversion;
* the port's logits on the converted params against HF's torch forward and
  the JAX forward (plain and flash attention; 1e-3 relative / 2e-4
  absolute against HF, as the reference's test; 1e-4 / 1e-5 against JAX);
* the export round trip: the port's state dict equals the reference's, and
  a fresh HF model loaded with it gives the original logits;
* `TransformersTrainer(train_loop_config={"device": "cpu", ...})` in a
  cluster's CPU worker (the params through the object store) against the
  reference's `TransformersTrainer` on the same rows, f32: every reported
  loss within 1e-4 relative (f32 sums in another order over 6 AdamW steps),
  and the checkpoint's params within 1e-3 of each tensor's 6-step update
  (AdamW divides near-zero gradients by their own size, so a param whose
  gradient is noise moves by about lr either way);
* a raw state dict built by torch with HF's names and a config object with
  GPT-2's fields, no transformers: the conversion equals the reference's,
  and `params_to_hf_state_dict(params_from_hf(sd))` gives `sd` back bit
  for bit.

Only the cases that build an HF model need `transformers`."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import ray_tpu
import ray_tpu.data
import ray_tpu_torch as rt
from ray_tpu.models import gpt as jg
from ray_tpu.train import RunConfig as RefRunConfig
from ray_tpu.train import ScalingConfig as RefScalingConfig
from ray_tpu.train import huggingface as ref_hf
from ray_tpu_torch import data as tdata
from ray_tpu_torch.models import gpt as tg
from ray_tpu_torch.train import RunConfig, ScalingConfig
from ray_tpu_torch.train import huggingface as hf

HF_CFG = dict(vocab_size=100, n_positions=64, n_embd=32, n_layer=2, n_head=2, n_inner=64)


def _tiny_hf_model(seed=0):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.GPT2Config(**HF_CFG, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _hf_logits(model, tokens):
    with torch.no_grad():
        return model(torch.from_numpy(tokens)).logits.numpy()


def _raw_state_dict(seed=0):
    """An HF GPT-2 state dict made by torch from a seed (the chip smoke's:
    HF's names, Conv1D [in, out] layouts, tied lm_head) and a config object
    with GPT-2's fields."""
    return chip_smoke._hf_state_dict(HF_CFG, seed, "cpu"), types.SimpleNamespace(**HF_CFG)


def _assert_same_params(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


# ------------------------------------------------------------ conversions
def test_config_from_hf_is_the_references():
    model = _tiny_hf_model()
    cfg, ref = hf.config_from_hf(model.config), ref_hf.config_from_hf(model.config)
    assert cfg.vocab_size == 128 and (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head) == (2, 32, 2, 16)
    for field in ("vocab_size", "n_layers", "d_model", "n_heads", "d_head", "d_mlp", "max_seq", "norm",
                  "activation", "pos", "tie_embeddings", "attn_impl", "remat", "remat_policy"):
        assert getattr(cfg, field) == getattr(ref, field), field
    assert cfg.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


def test_params_from_hf_equal_the_references():
    model = _tiny_hf_model()
    params, cfg = hf.params_from_hf(model)
    ref, _ = ref_hf.params_from_hf(model)
    _assert_same_params(params, ref)
    assert cfg.vocab_size == 128 and params["tok_embed"].shape == (128, 32)
    assert not params["tok_embed"][100:].any()


@pytest.mark.parametrize("attn_impl", ["ref", "flash"])
def test_logits_match_hf_and_the_jax_forward(attn_impl):
    """The converted params reproduce HF's torch forward and the reference's
    JAX forward (f32): every weight landed in its slot."""
    model = _tiny_hf_model()
    over = dict(attn_impl=attn_impl, remat=False)
    params, cfg = hf.params_from_hf(model, hf.config_from_hf(model.config, **over, dtype=torch.float32))
    jparams, jcfg = ref_hf.params_from_hf(model, ref_hf.config_from_hf(model.config, attn_impl="ref", remat=False,
                                                                      dtype=jnp.float32))
    tokens = np.random.default_rng(0).integers(0, 100, (2, 16))
    with torch.no_grad():
        ours = tg.forward({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(tokens),
                          cfg).numpy()[:, :, :100]
    np.testing.assert_allclose(ours, _hf_logits(model, tokens), rtol=1e-3, atol=2e-4)
    jax_logits = np.asarray(jg.forward({k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(tokens),
                                       jcfg))[:, :, :100]
    np.testing.assert_allclose(ours, jax_logits, rtol=1e-4, atol=1e-5)


def test_export_round_trip():
    model = _tiny_hf_model()
    params, cfg = hf.params_from_hf(model)
    sd = hf.params_to_hf_state_dict(params, cfg, hf_vocab_size=100)
    ref = ref_hf.params_to_hf_state_dict(params, cfg, hf_vocab_size=100)
    assert list(sd) == list(ref) and all(torch.equal(sd[k], ref[k]) for k in ref)
    fresh = _tiny_hf_model(seed=123)
    missing, unexpected = fresh.load_state_dict(sd, strict=False)
    assert not unexpected and all("attn.bias" in k or "masked_bias" in k for k in missing)
    tokens = np.random.default_rng(1).integers(0, 100, (2, 12))
    np.testing.assert_allclose(_hf_logits(fresh, tokens), _hf_logits(model, tokens), rtol=1e-4, atol=1e-5)


def test_raw_state_dict_needs_no_transformers():
    """A state dict of torch tensors and a config with GPT-2's fields: the
    conversion equals the reference's, and the export gives the state dict
    back bit for bit (vocab padding sliced off)."""
    sd, hf_cfg = _raw_state_dict()
    cfg = hf.config_from_hf(hf_cfg)
    with pytest.raises(ValueError, match="cfg="):
        hf.params_from_hf(sd)
    params, _ = hf.params_from_hf(sd, cfg)
    ref, _ = ref_hf.params_from_hf(sd, ref_hf.config_from_hf(hf_cfg))
    _assert_same_params(params, ref)
    back = hf.params_to_hf_state_dict(params, cfg, hf_vocab_size=hf_cfg.vocab_size)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape and torch.equal(back[k], v), k


# ----------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def runtimes():
    """The port's cluster (its worker takes the params from the object
    store) beside the reference in local mode."""
    rt.init(num_cpus=4)
    ray_tpu.init(local_mode=True)
    try:
        yield
    finally:
        ray_tpu.shutdown()
        rt.shutdown()


def test_transformers_trainer_matches_the_references(runtimes, tmp_path):
    sd, hf_cfg = _raw_state_dict(seed=3)
    rows = ((np.random.default_rng(0).integers(0, 50, (48, 1)) + np.arange(17)) % 50).astype(np.int32)
    loop = {"steps": 6, "batch_size": 8, "lr": 3e-3}
    over = dict(attn_impl="ref", remat=False)
    params, cfg = hf.params_from_hf(sd, hf.config_from_hf(hf_cfg, **over, dtype=torch.float32))
    jparams, jcfg = ref_hf.params_from_hf(sd, ref_hf.config_from_hf(hf_cfg, **over, dtype=jnp.float32))

    got = hf.TransformersTrainer(
        model=(params, cfg), datasets={"train": tdata.from_numpy(rows, column="tokens")},
        train_loop_config={**loop, "device": "cpu"}, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path / "port"))).fit()
    want = ref_hf.TransformersTrainer(
        model=(jparams, jcfg), datasets={"train": ray_tpu.data.from_numpy(rows, column="tokens")},
        train_loop_config=loop, scaling_config=RefScalingConfig(num_workers=1),
        run_config=RefRunConfig(storage_path=str(tmp_path / "ref"))).fit()
    assert got.error is None and want.error is None
    losses = [(m["step"], m["loss"]) for m in got.metrics_history]
    ref_losses = [(m["step"], m["loss"]) for m in want.metrics_history]
    assert [s for s, _ in losses] == [s for s, _ in ref_losses] == [1, 2, 3, 4, 5, 6, 6]
    np.testing.assert_allclose([x for _, x in losses], [x for _, x in ref_losses], rtol=1e-4)
    assert losses[-1][1] < losses[0][1]
    out, ref = got.checkpoint.to_dict(), want.checkpoint.to_dict()
    assert out["hf_state_dict_ready"] and set(out["params"]) == set(ref["params"])
    for k, v in ref["params"].items():
        update = np.abs(np.asarray(v) - jparams[k]).max()
        assert np.abs(out["params"][k] - np.asarray(v)).max() <= 1e-3 * update, k
    exported = hf.params_to_hf_state_dict(out["params"], cfg, hf_vocab_size=hf_cfg.vocab_size)
    assert {k: v.shape for k, v in exported.items()} == {k: v.shape for k, v in sd.items()}


def test_transformers_trainer_raises_on_an_empty_shard(runtimes, tmp_path):
    sd, hf_cfg = _raw_state_dict()
    params, cfg = hf.params_from_hf(sd, hf.config_from_hf(hf_cfg, attn_impl="ref", remat=False,
                                                         dtype=torch.float32))
    rows = np.zeros((3, 9), np.int32)
    result = hf.TransformersTrainer(
        model=(params, cfg), datasets={"train": tdata.from_numpy(rows, column="tokens")},
        train_loop_config={"device": "cpu", "steps": 2, "batch_size": 8},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is not None and "yields no batches" in str(result.error)
