"""The port's VLM prefix embeddings (paligemma) against the JAX package.

``paligemma-smoke`` (2 layers, d_model 128, 4 query heads over 1 KV head
of 32, ``embed_scale``, 16 prefix positions) in float32, weights from the
reference ``Model.init`` through ``params_from_jax``; prefix embeddings,
tokens and block tables are numpy draws from fixed seeds.

Tolerances: the loss and tap 2e-5 relative to their scale; gradients
1e-5 plus 1e-4 of the largest of their leaf (as in
``tests/test_torch_training.py``); logits and probe outputs 1e-4; the
prompt-tap sums, which add up P + C rows, 1e-4 relative to their scale;
greedy tokens, lengths and the engines' tokens and counts exactly equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from repro.config import get_smoke_config
from repro.models.model import Model as JaxModel
from repro.serving import engine as jax_engine
from repro.serving import kv_cache as jax_kv
from repro.serving import predictors as jax_predictors
from repro.serving import workload as jax_workload
from repro_torch.config import get_smoke_config as port_smoke_config
from repro_torch.models.model import Model, params_from_jax, params_to_jax
from repro_torch.serving import engine as port_engine
from repro_torch.serving import predictors as port_predictors
from repro_torch.serving import workload as port_workload

ARCH = "paligemma-3b"
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def pair():
    """(jax cfg, jax model, jax params, port model, float32 masters)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jm = JaxModel(cfg)
    params = jm.init(jax.random.key(0))
    tcfg = dataclasses.replace(port_smoke_config(ARCH), dtype="float32")
    masters = params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(masters)
    return cfg, jm, params, tm, masters


def err(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def scale_of(x) -> float:
    return max(float(np.max(np.abs(np.asarray(x, np.float32)))), 1.0)


def test_forward_train_with_prefix_embeds():
    """Loss, label count, tap (B, P + S, d) and every gradient with a
    16-row prefix: the prefix is prepended after the scaled token
    embedding and takes no loss."""
    cfg, jm, params, tm, masters = pair()
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    prefix = rng.standard_normal(
        (2, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jm.forward_train, has_aux=True))(
            params, {"tokens": jnp.asarray(tokens),
                     "labels": jnp.asarray(labels),
                     "prefix_embeds": jnp.asarray(prefix)})
    live = {k: v.clone().requires_grad_() for k, v in masters.items()}
    tloss, taux = functional_call(tm, live, ({
        "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
        "prefix_embeds": torch.from_numpy(prefix)},))
    g = torch.autograd.grad(tloss, list(live.values()), allow_unused=True)
    tgrads = params_to_jax(tm.cfg, {
        k: gi if gi is not None else torch.zeros_like(live[k])
        for k, gi in zip(live, g)})
    assert abs(float(jloss) - float(tloss.detach())) <= 2e-5 * float(jloss)
    assert float(jaux["n_tok"]) == float(taux["n_tok"]) == 2 * 31
    assert tuple(taux["tap"].shape) == (2, cfg.num_prefix_tokens + 32,
                                        cfg.d_model)
    assert err(jaux["tap"], taux["tap"]) <= 2e-5 * scale_of(jaux["tap"])
    jl, tl = jax.tree.leaves(jgrads), jax.tree.leaves(tgrads)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape)
        assert err(j, t) <= 1e-5 + 1e-4 * float(jnp.max(jnp.abs(j)))


@pytest.mark.parametrize("kv_layout", ["contig", "paged"])
def test_prefill_with_prefix_then_decode(kv_layout):
    """``prefill_chunk(prefix_embeds=...)`` over a chunk with one padded
    row, then a second chunk without a prefix, 2 decode steps and a
    megastep of 4 with an inactive row, under both layouts (paged:
    scrambled block tables): logits, prompt-tap sums, probe outputs,
    lengths and greedy tokens against the reference."""
    cfg, _, params, tm, _ = pair()
    jm = JaxModel(cfg, use_kernels=False)
    rng = np.random.default_rng(7)
    B, P, C = 3, cfg.num_prefix_tokens, 24
    tokens = rng.integers(4, cfg.vocab_size, (B, C)).astype(np.int32)
    valid = np.ones((B, C), bool)
    valid[1, 17:] = False
    prefix = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    jc = jm.init_cache(B, 96, kv_layout=kv_layout, page_size=16)
    tc = tm.init_cache(B, 96, kv_layout=kv_layout, page_size=16)
    if kv_layout == "paged":
        bt = (rng.permutation(B * 6) + 1).astype(np.int32).reshape(B, 6)
        jc["block_table"] = jnp.asarray(bt)
        tc["block_table"].copy_(torch.from_numpy(bt))
    prefill = jax.jit(jm.prefill_chunk)
    jl, jc, jts, jn = prefill(params, jc, jnp.asarray(tokens),
                              valid=jnp.asarray(valid),
                              prefix_embeds=jnp.asarray(prefix))
    tl, tc, tts, tn = tm.prefill_chunk(tc, torch.from_numpy(tokens),
                                       torch.from_numpy(valid),
                                       prefix_embeds=torch.from_numpy(prefix))
    assert err(jl, tl) < TOL
    assert err(jts, tts) <= TOL * scale_of(jts)
    assert np.array_equal(np.asarray(jn), tn.numpy())
    assert tn.tolist() == [P + C, P + 17, P + C]
    more = rng.integers(4, cfg.vocab_size, (B, 8)).astype(np.int32)
    jl, jc, _, _ = prefill(params, jc, jnp.asarray(more))
    tl, tc, _, _ = tm.prefill_chunk(tc, torch.from_numpy(more))
    assert err(jl, tl) < TOL
    tok = tl.argmax(-1).to(torch.int32)[:, None]
    assert np.array_equal(np.asarray(jnp.argmax(jl, -1)), tok[:, 0].numpy())
    step = jax.jit(jm.decode_step)
    for _ in range(2):
        jl, jc, _, jpl = step(params, jc, jnp.asarray(tok.numpy()))
        tl, tc, _, tpl = tm.decode_step(tc, tok)
        assert err(jl, tl) < TOL and err(jpl, tpl) < TOL
        tok = tl.argmax(-1).to(torch.int32)[:, None]
    active = np.array([True, False, True])
    jt, jc, jp, _ = jax.jit(jm.decode_multi, static_argnames=("k",))(
        params, jc, jnp.asarray(tok.numpy()), jnp.asarray(active), k=4)
    tt, tc, tp, _ = tm.decode_multi(tc, tok, torch.from_numpy(active), k=4)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert err(jp, tp) < TOL
    assert np.array_equal(np.asarray(jc["lengths"]), tc["lengths"].numpy())


@pytest.mark.parametrize("kv_layout", ["contig", "paged"])
def test_real_mode_engine_matches_jax(kv_layout):
    """The real-mode engine on paligemma-smoke under both layouts: neither
    engine passes prefix embeddings (the served model is text only in
    both packages), and every request's tokens equal, with the same
    preemptions, recomputed and prefilled tokens and steps."""
    cfg, _, params, tm, _ = pair()
    jm = JaxModel(cfg, use_kernels=False)
    wl = dict(n_requests=8, request_rate=3000.0, seed=2, prompt_mean=10.0,
              out_median=12.0, max_out=24, vocab=cfg.vocab_size)
    jreqs = jax_workload.generate(jax_workload.WorkloadConfig(**wl))
    preqs = port_workload.generate(port_workload.WorkloadConfig(**wl))
    budget = (jax_kv.paged_bytes_for_context(cfg, 24, 8)
              if kv_layout == "paged" else jax_kv.bytes_for_context(cfg, 24))
    kn = dict(policy="trail", max_batch=2, c_limit=1.0, mode="real",
              kv_layout=kv_layout, probe_interval=4, max_len=48,
              page_size=8, prefill_chunk=16, mem_budget=3 * budget)
    jeng = jax_engine.Engine(
        cfg, jax_engine.EngineConfig(**kn),
        predictor=jax_predictors.ProbePredictor(
            cfg.probe, probe_params=params["probe"],
            embed_table=params["embed"]),
        model=jm, params=params)
    peng = port_engine.Engine(
        tm.cfg, port_engine.EngineConfig(**kn),
        predictor=port_predictors.ProbePredictor(
            tm.cfg.probe, probe_params=tm.probe, embed_table=tm.embed),
        model=tm, device="cpu")
    js, ps = jeng.run(jreqs), peng.run(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == r.true_out_len for r in preqs)
    assert ps.n_preemptions == js.n_preemptions
    assert ps.recomputed_tokens == js.recomputed_tokens
    assert ps.iterations == js.iterations
    assert ps.prefilled_tokens == js.prefilled_tokens
