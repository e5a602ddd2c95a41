"""The port's model stack against the JAX package, on the CPU: configs,
parameter carry-over, blocks, ``Model.apply`` / ``prefill`` /
``decode_step``.

The reduced models are ``reduced(arch, d_model=64, layers_per_stage=2,
vocab=128)`` of ``rwkv6-3b`` and ``llama3.2-3b`` in float32, with the JAX
weights carried across by ``model_params_from``. Tolerance rtol = atol =
2e-5: the reference's RWKV prefill runs its chunked scan, which agrees
with the step recurrence to about 1e-6 at the decays of freshly
initialised layers (w >= 0.5), and sums run in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_transformer
from repro.sharding.specs import ShardCtx
from repro_torch import build_model, get_config, reduced
from repro_torch.configs import base
from repro_torch.convert import model_params_from
from repro_torch.models import transformer

TOL = dict(rtol=2e-5, atol=2e-5)
REDUCED = dict(d_model=64, layers_per_stage=2, vocab=128)
ARCHS = ("rwkv6-3b", "llama3.2-3b")


def _as_dict(obj):
    """A config as nested plain data, class names included."""
    if dataclasses.is_dataclass(obj):
        return {"class": type(obj).__name__,
                **{f.name: _as_dict(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple):
        return [_as_dict(o) for o in obj]
    return obj


@pytest.mark.parametrize("kw", [{}, REDUCED, dict(d_model=128)])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_by_field(arch, kw):
    ref = ref_get_config(arch)
    got = get_config(arch)
    if kw:
        ref, got = ref_reduced(ref, **kw), reduced(got, **kw)
    assert _as_dict(got) == _as_dict(ref)
    assert got.param_count() == ref.param_count()
    assert got.num_layers == ref.num_layers


def _hybrid_config(m):
    """A config with every dataclass of the config module ``m``."""
    return m.ModelConfig(
        name="x", arch_type="hybrid", d_model=32, vocab_size=64, d_ff=64,
        stages=(m.Stage((m.Block("rwkv", "mlp"), m.Block("mamba", "moe")),
                        3),),
        attn=m.AttnConfig(4, 2, 8), ssm=m.SSMConfig(kind="mamba"),
        moe=m.MoEConfig(8, 2, 16, num_shared_experts=1, d_shared=16),
        mlp_act="swiglu", norm="layernorm", pos_embed="learned")


def test_config_classes_built_from_the_same_arguments_are_equal():
    ref, got = _hybrid_config(ref_base), _hybrid_config(base)
    assert _as_dict(got) == _as_dict(ref)
    assert got.param_count() == ref.param_count()
    assert _as_dict(reduced(got)) == _as_dict(ref_reduced(ref))


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="rwkv6-3b"):
        get_config("granite-8b")


def _pair(arch, cfg_kw=None, seed=0):
    """The reference model with its params, and the port's with the same
    weights carried across."""
    ref_cfg = ref_reduced(ref_get_config(arch), **REDUCED)
    cfg = reduced(get_config(arch), **REDUCED)
    if cfg_kw:
        ref_cfg = dataclasses.replace(ref_cfg, **cfg_kw)
        cfg = dataclasses.replace(cfg, **cfg_kw)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init_params(jax.random.key(seed))
    params = model_params_from(jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    return ref_model, ref_params, build_model(cfg), params


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 128, size=(B, S))


@pytest.mark.parametrize("arch", ARCHS)
def test_carry_over_unstacks_every_stage(arch):
    ref_model, ref_params, model, params = _pair(arch)
    (stage,) = params["stages"]
    assert len(stage) == 2
    leaf = "rwkv_r" if arch == "rwkv6-3b" else "wq"
    ref_leaf = np.asarray(ref_params["stages"][0]["b0"]["mixer"][leaf])
    for i in range(2):
        assert np.array_equal(stage[i]["b0"]["mixer"][leaf].numpy(),
                              ref_leaf[i])
    # the port's own init builds the same tree, leaf for leaf
    own = model.init_params(torch.Generator().manual_seed(0))
    flat = lambda t: sorted(  # noqa: E731
        (k, tuple(v.shape), v.dtype) for k, v in _leaves(t))
    assert flat(own) == flat(params)


def test_carry_over_keeps_bfloat16_bits():
    ref = {"embed": {"embed": jnp.arange(6, dtype=jnp.bfloat16)
                     .reshape(2, 3) / 3},
           "final_norm": {"scale": jnp.ones(3, jnp.bfloat16)},
           "stages": [{"b0": {"w": jnp.full((2, 3), 0.1, jnp.bfloat16)}}]}
    got = model_params_from(jax.tree.map(np.asarray, ref), device="cpu")
    assert got["embed"]["embed"].dtype == torch.bfloat16
    assert np.array_equal(got["embed"]["embed"].float().numpy(),
                          np.asarray(ref["embed"]["embed"], np.float32))
    assert [u["b0"]["w"].shape for u in got["stages"][0]] == [(3,), (3,)]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_reference(arch):
    ref_model, ref_params, model, params = _pair(arch)
    ref_cfg, cfg = ref_model.cfg, model.cfg
    block = cfg.stages[0].pattern[0]
    x = np.random.default_rng(1).normal(size=(2, 30, 64)).astype(np.float32)
    unit = jax.tree.map(lambda a: a[1], ref_params["stages"][0])["b0"]
    want, _ = ref_transformer._block_apply(unit, jnp.asarray(x), block,
                                           ShardCtx.null(), ref_cfg)
    got = transformer._block_apply(params["stages"][0][1]["b0"],
                                   torch.tensor(x), block, cfg, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, _ = ref_transformer.stage_apply(ref_params["stages"][0],
                                          jnp.asarray(x), ref_cfg.stages[0],
                                          ShardCtx.null(), ref_cfg)
    got = transformer.stage_apply(params["stages"][0], torch.tensor(x),
                                  cfg.stages[0], cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [1, 33, 70])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_prefill_match_reference(arch, S):
    ref_model, ref_params, model, params = _pair(arch)
    tok = _tokens(2, S, seed=S)
    want, _ = ref_model.apply(ref_params, jnp.asarray(tok))
    got, aux = model.apply(params, torch.tensor(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0
    got = model.prefill(params, torch.tensor(tok))
    want = np.asarray(ref_model.prefill(ref_params, jnp.asarray(tok)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref_path = model.prefill(params, torch.tensor(tok), impl="ref")
    np.testing.assert_allclose(ref_path.numpy(), want, **TOL)
    if arch == "rwkv6-3b":
        # on the CPU both paths run the plain scan; attention's default
        # runs the kernel's plain version, "ref" the reference's ref branch
        assert torch.equal(ref_path, got)


@pytest.mark.parametrize("cfg_kw", [None, {"pos_embed": "learned",
                                           "tie_embeddings": True,
                                           "norm": "layernorm"}])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_and_prefill(arch, cfg_kw):
    ref_model, ref_params, model, params = _pair(arch, cfg_kw, seed=3)
    B, S = 2, 12
    tok = _tokens(B, S, seed=4)
    ref_cache = ref_model.init_cache(B, 64)
    cache = model.init_cache(B, 64, device="cpu")
    for t in range(S):
        want, ref_cache = ref_model.decode_step(
            ref_params, jnp.asarray(tok[:, t:t + 1]), ref_cache)
        got, cache = model.decode_step(params, torch.tensor(tok[:, t:t + 1]),
                                       cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache["len"] == S
    np.testing.assert_allclose(
        got.numpy(), model.prefill(params, torch.tensor(tok)).numpy(), **TOL)


@pytest.mark.parametrize("block", [("attn", "moe"), ("mamba", "mlp"),
                                   ("rwkv", "moe"), ("cross", "none")])
def test_blocks_not_yet_ported_raise(block):
    cfg = reduced(get_config("rwkv6-3b"), **REDUCED)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.init_block(torch.Generator(), cfg, base.Block(*block))


@pytest.mark.parametrize("arch", ARCHS)
def test_training_and_extra_inputs_raise(arch):
    _, _, model, params = _pair(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.loss(params, {})
    with pytest.raises(NotImplementedError):
        model.apply(params, torch.zeros((1, 2), dtype=torch.long),
                    frames=torch.zeros(1))
