"""The port's serving engine against the JAX package's, on the CPU, on
``reduced(arch, d_model=64, layers_per_stage=2, vocab=128)`` of
``rwkv6-3b`` and of ``llama3.2-3b`` in float32, with the JAX weights
carried across.

Greedy tokens are compared wherever the reference's top-2 logit gap
exceeds 1e-4; below that the two may pick either token, and the rest of
that request is not compared. Logits: rtol = atol = 2e-5, as in
``test_torch_model.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import Request, ServeEngine, build_model, get_config, reduced
from repro_torch.convert import model_params_from

REDUCED = dict(d_model=64, layers_per_stage=2, vocab=128)
GAP = 1e-4


@pytest.fixture(scope="module", params=("rwkv6-3b", "llama3.2-3b"))
def pair(request):
    arch = request.param
    ref_model = ref_build_model(ref_reduced(ref_get_config(arch), **REDUCED))
    ref_params = ref_model.init_params(jax.random.key(11))
    model = build_model(reduced(get_config(arch), **REDUCED))
    params = model_params_from(jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    return ref_model, ref_params, model, params


def _prompts(lengths, seed=0):
    g = np.random.default_rng(seed)
    return [g.integers(0, 128, size=n) for n in lengths]


def _ref_step_logits(ref_model, ref_params, prompt, out):
    """The reference's logits before each generated token, replayed
    through its decode step."""
    step = jax.jit(lambda tok, cache: ref_model.decode_step(ref_params, tok,
                                                            cache))
    cache = ref_model.init_cache(1, 64)
    logits = []
    for i, t in enumerate(list(prompt) + list(out[:-1])):
        lg, cache = step(jnp.asarray([[t]], jnp.int32), cache)
        if i >= len(prompt) - 1:
            logits.append(np.asarray(lg[0]))
    return logits


def test_greedy_generate_matches_reference(pair):
    ref_model, ref_params, model, params = pair
    prompts = _prompts([5, 9, 3])
    ref_reqs = [RefRequest(prompt=p, max_new_tokens=6) for p in prompts]
    RefServeEngine(ref_model, ref_params, batch_size=2,
                   max_len=64).generate(ref_reqs)
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    ServeEngine(model, params, batch_size=2, max_len=64).generate(reqs)
    compared = 0
    for ref_req, req in zip(ref_reqs, reqs):
        assert req.done and len(req.out_tokens) == 6
        logits = _ref_step_logits(ref_model, ref_params, ref_req.prompt,
                                  ref_req.out_tokens)
        np.testing.assert_allclose(req.first_logits.numpy(), logits[0],
                                   rtol=2e-5, atol=2e-5)
        for lg, want, got in zip(logits, ref_req.out_tokens, req.out_tokens):
            top2 = np.sort(lg)[-2:]
            if top2[1] - top2[0] <= GAP:
                break
            assert got == want
            compared += 1
    assert compared >= 12


def test_first_logits_are_the_prefill_logits(pair):
    _, _, model, params = pair
    prompts = _prompts([1, 4, 17], seed=1)
    reqs = [Request(prompt=p, max_new_tokens=2) for p in prompts]
    ServeEngine(model, params, batch_size=2).generate(reqs)
    for req in reqs:
        want = model.prefill(params, torch.tensor(req.prompt[None]))[0]
        np.testing.assert_allclose(req.first_logits.numpy(), want.numpy(),
                                   rtol=2e-5, atol=2e-5)
        assert req.out_tokens[0] == int(req.first_logits.argmax())


def test_slot_refill_gives_the_same_tokens(pair):
    """Each slot keeps its own batch-1 cache, so the tokens do not depend
    on how many slots there are or which slot a request lands in."""
    _, _, model, params = pair
    prompts = _prompts([6, 2, 8, 4], seed=2)
    outs = []
    for batch_size in (1, 3, 4):
        reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts]
        ServeEngine(model, params, batch_size=batch_size).generate(reqs)
        assert all(r.done for r in reqs)
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1] == outs[2]


def test_eos_ends_a_request_early(pair):
    _, _, model, params = pair
    (prompt,) = _prompts([5], seed=3)
    greedy = Request(prompt=prompt, max_new_tokens=5)
    ServeEngine(model, params, batch_size=1).generate([greedy])
    eos = greedy.out_tokens[1]
    req = Request(prompt=prompt, max_new_tokens=5)
    ServeEngine(model, params, batch_size=1, eos_id=eos).generate([req])
    assert req.done
    stop = greedy.out_tokens.index(eos) + 1
    assert req.out_tokens == greedy.out_tokens[:stop]


def test_temperature_sampling_is_seeded(pair):
    _, _, model, params = pair
    prompts = _prompts([3, 7], seed=4)

    def sample(seed):
        reqs = [Request(prompt=p, max_new_tokens=8, temperature=2.0)
                for p in prompts]
        ServeEngine(model, params, batch_size=2, seed=seed).generate(reqs)
        return [r.out_tokens for r in reqs]

    first = sample(0)
    assert sample(0) == first
    assert all(0 <= t < 128 for out in first for t in out)
    assert any(sample(s) != first for s in (1, 2, 3))


@pytest.mark.parametrize("bad", ["empty", "too_long", "no_slots"])
def test_bad_requests_raise(pair, bad):
    _, _, model, params = pair
    prompt = {"empty": np.zeros(0, np.int64)}.get(bad, np.arange(10))
    kw = {"no_slots": {"batch_size": 0}}.get(bad, {"max_len": 12})
    with pytest.raises(ValueError):
        ServeEngine(model, params, **kw).generate(
            [Request(prompt=prompt, max_new_tokens=4)])
