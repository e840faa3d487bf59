"""The port's encoder-decoder (whisper) against the JAX package.

Weights come from the reference ``Model.init`` of ``whisper-smoke`` (2
encoder and 2 decoder layers, d_model 128, 4/4 heads, 64 encoder frames)
with every LayerNorm gain, LayerNorm bias and MLP bias redrawn from a
numpy seed (the reference initialises them to 1 and 0, which would hide a
missing bias), and cross over with ``params_from_jax``. Inputs (tokens,
frame embeddings, hidden states) are numpy draws from fixed seeds.

Tolerances: modules (LayerNorm, the GELU MLP, cross K/V and
cross-attention, the encoder, the cross caches) 1e-5 in float32; the
model and the engine in float32, greedy tokens exactly equal and logits
within 1e-4; bfloat16 modules within ``tests/test_kernels.py``'s TOL of
2e-2 of the float32 reference on the same inputs. Gradients as in
``tests/test_torch_training.py``: 1e-5 plus 1e-4 of the largest of their
leaf.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from repro.config import get_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import Model as JaxModel
from repro.serving import engine as jax_engine
from repro.serving import kv_cache as jax_kv
from repro.serving import predictors as jax_predictors
from repro.serving import workload as jax_workload
from repro.training import checkpoint as jckpt
from repro_torch.config import get_smoke_config as port_smoke_config
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import FlashAttention
from repro_torch.models.model import (Model, load_npz, params_from_jax,
                                      params_to_jax)
from repro_torch.serving import engine as port_engine
from repro_torch.serving import kv_cache as port_kv
from repro_torch.serving import predictors as port_predictors
from repro_torch.serving import workload as port_workload
from repro_torch.training import checkpoint as tckpt

ARCH = "whisper-tiny"
TOL_F32 = 1e-4
TOL_MODULE = 1e-5
TOL_BF16 = 2e-2


def _redraw(path, leaf, rng):
    """LayerNorm gains near 1, LayerNorm and MLP biases near 0."""
    keys = [getattr(k, "key", None) for k in path]
    x = np.asarray(leaf)
    if keys[-1] == "scale":
        return (1.0 + 0.2 * rng.standard_normal(x.shape)).astype(x.dtype)
    if keys[-1] in ("bias", "b_up", "b_down"):
        return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
    return x


@functools.lru_cache(maxsize=None)
def pair(dtype="float32"):
    """(jax cfg, jax model, jax params, port model, float32 masters)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    jm = JaxModel(cfg)
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: _redraw(p, x, rng), jm.init(jax.random.key(0)))
    params = jax.tree.map(jnp.asarray, params)
    tcfg = dataclasses.replace(port_smoke_config(ARCH), dtype=dtype)
    masters = params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(masters)
    return cfg, jm, params, tm, masters


def err(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(jnp.asarray(b, jnp.float32))
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def frames(cfg, B, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


def ns(tree) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{k: torch.from_numpy(np.array(v))
                                    for k, v in tree.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_mlp(dtype):
    """LayerNorm (population variance, gain and bias) and the biased GELU
    MLP (tanh approximation) of decoder layer 0, on the same inputs."""
    cfg, _, params, tm, _ = pair()
    p = jax.tree.map(lambda x: x[0], params["layers"][0][0])
    x = np.random.default_rng(1).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32) * 3 + 1
    jdt = jnp.dtype(dtype)
    tdt = tlayers.torch_dtype(dtype)
    want_n = jlayers.apply_norm(cfg, p["norm1"], jnp.asarray(x, jdt))
    got_n = tlayers.apply_norm(tm.cfg, tm.layers[0].norm1,
                               torch.from_numpy(x).to(tdt),
                               tm.layers[0].norm1_bias)
    want_m = jlayers.apply_mlp(cfg, p["mlp"], jnp.asarray(x, jdt))
    got_m = tfm.mlp(tm.cfg, ns(p["mlp"]), torch.from_numpy(x).to(tdt))
    assert got_n.dtype == got_m.dtype == tdt
    tol = TOL_MODULE * 10 if dtype == "float32" else TOL_BF16
    assert err(want_n, got_n) <= tol
    assert err(want_m, got_m) <= tol * max(1.0, float(jnp.abs(
        want_m.astype(jnp.float32)).max()))


def test_cross_kv_and_cross_attention():
    cfg, _, params, tm, _ = pair()
    # decoder layer 1 is run 1's only block (the tap ends run 0)
    p = jax.tree.map(lambda x: np.asarray(x[0]), params["layers"][1][0])
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    h = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    jk, jv = jattn.cross_kv(cfg, p["cross"], jnp.asarray(enc))
    cw = tfm.cross_weights(tm.layers[1])
    tk, tv = tattn.cross_kv(tm.cfg, cw, torch.from_numpy(enc))
    assert err(jk, tk) <= TOL_MODULE and err(jv, tv) <= TOL_MODULE
    want = jattn.cross_attention(cfg, p["cross"], jnp.asarray(h), jk, jv)
    got = tattn.cross_attention(tm.cfg, cw, torch.from_numpy(h), tk, tv)
    assert got.shape == (2, 7, cfg.d_model)
    assert err(want, got) <= TOL_MODULE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_build_cross_cache(dtype):
    """The encoder (non-causal self-attention through the
    ``flash_attention`` wrapper, here its plain version) and every
    decoder layer's cross K/V; bfloat16 against the float32 reference."""
    cfg, jm, params, _, _ = pair()
    tm = pair(dtype)[3]
    enc = frames(cfg, 2)
    want = jm.encode(params, jnp.asarray(enc))
    got = tm.encode(torch.from_numpy(enc))
    assert got.dtype == tlayers.torch_dtype(dtype)
    tol = TOL_MODULE if dtype == "float32" else TOL_BF16
    scale = max(1.0, float(jnp.abs(want).max()))
    assert err(want, got) <= tol * scale
    jc = jm.build_cross_cache(params, jm.init_cache(2, 16), want)
    tc = tm.build_cross_cache(tm.init_cache(2, 16), got)
    for ri in range(len(tm.runs)):
        for js, ts in zip(jc[f"run_{ri}"], tc[f"run_{ri}"]):
            for leaf in ("ck", "cv"):
                assert tuple(ts[leaf].shape) == tuple(js[leaf].shape)
                assert err(js[leaf], ts[leaf]) <= tol * scale * 4


def test_non_causal_flash_attention_gradient():
    """The ``FlashAttention`` Function with ``causal=False``: the forward
    (the plain version on the CPU) and dq, dk, dv against ``jax.grad`` of
    the reference's plain non-causal ``attend`` and against plain
    autograd."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    rng = np.random.default_rng(4)
    B, S, H, hd = 2, 48, cfg.num_heads, cfg.head_dim
    q, k, v, dout = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
                     for _ in range(4))
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def jloss(q, k, v):
        out = jattn.attend(cfg, q, k, v, pos, pos, causal=False)
        return jnp.sum(out * dout), out
    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = FlashAttention.apply(*ins, 0, 0.0, False)
    tg = torch.autograd.grad(out, ins, torch.from_numpy(dout))
    plain_ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    pg = torch.autograd.grad(ref.flash_attention_ref(*plain_ins,
                                                     causal=False),
                             plain_ins, torch.from_numpy(dout))
    assert err(jout, out) <= TOL_MODULE
    for j, t, p in zip(jg, tg, pg):
        assert err(j, t) <= TOL_MODULE * 10
        assert torch.equal(t, p)


def assert_grads_match(jgrads, tgrads):
    jl, tl = jax.tree.leaves(jgrads), jax.tree.leaves(tgrads)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape)
        assert err(j, t) <= 1e-5 + 1e-4 * float(jnp.max(jnp.abs(j)))


def test_forward_train_with_enc_embeds():
    """Loss, tap and every gradient (encoder, cross-attention, LayerNorm
    biases included) with the encoder pass, remat on."""
    cfg, jm, params, tm, masters = pair()
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    enc = frames(cfg, 2, seed=6)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jm.forward_train, has_aux=True))(
            params, {"tokens": jnp.asarray(tokens),
                     "labels": jnp.asarray(labels),
                     "enc_embeds": jnp.asarray(enc)})
    live = {k: v.clone().requires_grad_() for k, v in masters.items()}
    tloss, taux = functional_call(tm, live, ({
        "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
        "enc_embeds": torch.from_numpy(enc)},))
    g = torch.autograd.grad(tloss, list(live.values()), allow_unused=True)
    tgrads = params_to_jax(tm.cfg, {
        k: gi if gi is not None else torch.zeros_like(live[k])
        for k, gi in zip(live, g)})
    assert tm.cfg.remat
    assert err(jloss, tloss) <= 2e-5 * max(1.0, abs(float(jloss)))
    assert err(jaux["tap"], taux["tap"]) <= 2e-5 * max(
        1.0, float(jnp.abs(jaux["tap"]).max()))
    assert float(taux["aux_loss"]) == 0.0
    assert_grads_match(jgrads, tgrads)
    enc_grads = jax.tree.leaves(tgrads["encoder"])
    assert all(float(x.abs().max()) > 0 for x in enc_grads)


def _prefill_then_decode(kv_layout):
    """``prefill_chunk(enc_embeds=...)`` and decode under ``kv_layout``
    (paged: scrambled block tables), held against the reference."""
    cfg, jm, params, tm, _ = pair()
    rng = np.random.default_rng(7)
    B = 3
    tokens = rng.integers(4, cfg.vocab_size, (B, 8)).astype(np.int32)
    valid = np.ones((B, 8), bool)
    valid[1, 5:] = False
    enc = frames(cfg, B, seed=8)
    jc = jm.init_cache(B, 32, kv_layout=kv_layout, page_size=8)
    tc = tm.init_cache(B, 32, kv_layout=kv_layout, page_size=8)
    if kv_layout == "paged":
        bt = (rng.permutation(B * 4) + 1).astype(np.int32).reshape(B, 4)
        jc["block_table"] = jnp.asarray(bt)
        tc["block_table"].copy_(torch.from_numpy(bt))
    jl, jc, jts, jn = jax.jit(jm.prefill_chunk)(
        params, jc, jnp.asarray(tokens), valid=jnp.asarray(valid),
        enc_embeds=jnp.asarray(enc))
    tl, tc, tts, tn = tm.prefill_chunk(tc, torch.from_numpy(tokens),
                                       torch.from_numpy(valid),
                                       enc_embeds=torch.from_numpy(enc))
    assert err(jl, tl) < TOL_F32 and err(jts, tts) < TOL_F32
    assert np.array_equal(np.asarray(jn), tn.numpy())
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    assert np.array_equal(tok[:, 0], tl.argmax(-1).numpy())
    jl2, jc, jtap, jpl = jax.jit(jm.decode_step)(params, jc, jnp.asarray(tok))
    tl2, tc, ttap, tpl = tm.decode_step(tc, torch.from_numpy(tok))
    assert err(jl2, tl2) < TOL_F32 and err(jpl, tpl) < TOL_F32
    tok2 = np.asarray(jnp.argmax(jl2, -1)).astype(np.int32)[:, None]
    active = np.array([True, False, True])
    budget = np.array([6, 6, 3], np.int32)
    jt, jc, jp, je = jax.jit(jm.decode_multi, static_argnames=("k",))(
        params, jc, jnp.asarray(tok2), jnp.asarray(active),
        jnp.asarray(budget), k=6)
    tt, tc, tp, te = tm.decode_multi(tc, torch.from_numpy(tok2),
                                     torch.from_numpy(active),
                                     torch.from_numpy(budget), k=6)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(je), te.numpy())
    assert err(jp, tp) < TOL_F32
    assert np.array_equal(np.asarray(jc["lengths"]), tc["lengths"].numpy())
    return tc


def test_prefill_with_enc_embeds_then_decode():
    """``prefill_chunk(enc_embeds=...)`` (encoder, cross caches, the
    decoder over a padded chunk), a decode step and a megastep with an
    inactive row: tokens equal, logits and probe outputs within 1e-4."""
    _prefill_then_decode("contig")


def test_paged_prefill_with_enc_embeds_then_decode():
    """The same under the paged layout: self-attention K/V in pages
    (through the paged kernels' plain versions), the cross caches per
    slot beside them, as in the reference."""
    tc = _prefill_then_decode("paged")
    sub = tc["run_0"][0]
    assert {"pk", "pv", "pkpos", "ck", "cv"} <= set(sub)
    assert float(sub["ck"].abs().max()) > 0


def _engines(kv_layout):
    """The JAX and the port real-mode engine on whisper-smoke, and the
    same 8 requests for each."""
    cfg, jm, params, tm, _ = pair()
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
    return jeng, jreqs, peng, preqs


def test_real_mode_engine_matches_jax():
    """The contiguous real-mode engine: neither engine passes frame
    embeddings, so both decoders attend over the zeroed cross caches of
    ``init_cache``; every request's tokens equal, and the same
    preemptions, recomputed and prefilled tokens and steps."""
    _engine_parity("contig")


def test_paged_real_mode_engine_matches_jax():
    """The same under the paged layout (pages of 8, no page retention in
    either package)."""
    _engine_parity("paged")


def _engine_parity(kv_layout):
    jeng, jreqs, peng, preqs = _engines(kv_layout)
    js, ps = jeng.run(jreqs), peng.run(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == r.true_out_len for r in preqs)
    assert ps.n_preemptions == js.n_preemptions
    assert ps.recomputed_tokens == js.recomputed_tokens
    assert ps.iterations == js.iterations
    assert ps.prefilled_tokens == js.prefilled_tokens
    cache = peng.pool.cache
    assert all(float(sub[leaf].abs().max()) == 0.0
               for key in cache if key.startswith("run_")
               for sub in cache[key] for leaf in ("ck", "cv"))


def test_paged_layout_and_page_retention_are_refused():
    """Cross caches are per slot, so neither package retains pages across
    a preemption: the paged engine's pool keeps none. The paged layout
    itself is served, as in the reference: its cache holds the page pool
    and the per-slot cross caches, each leaf the reference's shape."""
    cfg, jm, _, tm, _ = pair()
    assert not port_kv.supports_page_retention(tm.cfg)
    assert not jax_kv.supports_page_retention(cfg)
    _, _, peng, _ = _engines("paged")
    assert type(peng.pool) is port_kv.PagedSlotPool and not peng.pool.retain
    jc = jm.init_cache(2, 32, kv_layout="paged", page_size=8)
    tc = tm.init_cache(2, 32, kv_layout="paged", page_size=8)
    for key, jsub in jc["run_0"][0].items():
        assert tuple(tc["run_0"][0][key].shape) == jsub.shape, key


def test_npz_round_trip_with_encoder_and_cross_leaves(tmp_path):
    """The port's checkpoint restores in the reference (every leaf,
    ``encoder``, ``cross`` and ``norm_cross`` and the LayerNorm biases
    included) and the reference's loads in the port."""
    cfg, _, params, tm, masters = pair()
    path = str(tmp_path / "port.npz")
    tckpt.save(path, params_to_jax(tm.cfg, masters))
    restored = jckpt.restore(path)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(restored))
    assert len(got) == len(want)
    for p, leaf in want:
        assert np.array_equal(np.asarray(leaf), np.asarray(got[p])), p
    assert {"encoder", "layers"} <= set(restored)
    assert {"cross", "norm_cross"} <= set(restored["layers"][0][0])
    back = str(tmp_path / "ref.npz")
    jckpt.save(back, params)
    loaded = params_from_jax(tm.cfg, load_npz(back))
    assert set(loaded) == set(tm.state_dict())
    for k, v in loaded.items():
        assert torch.equal(v, masters[k]), k
