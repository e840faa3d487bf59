"""The port's int8 KV cache (``ModelConfig.kv_quant``) against the JAX package.

Float32 variants of the smoke configs with ``kv_quant=True``; weights come
from the reference ``Model.init`` through ``params_from_jax``, inputs are
numpy draws from fixed seeds. Greedy tokens are exactly equal. The
quantiser gives the reference's int8 payloads and scales bit for bit on
the same float input. Inside the model the two packages' float32 K/V
differ in their last bits (matmuls and RoPE summed in another order):
layer 0's by a few ulp, so its payloads are equal and its scales within
1e-6 relative; a deeper layer's by up to ~30 ulp, so its scales are held
to 1e-5 relative and a value on a rounding tie may land one step apart:
at most 1, in at most one element in a thousand. Logits and probe
outputs are within 1e-4 while the two caches' payloads are equal; once a
tie has landed apart, that one element moves by a whole quantisation
step (max |x| / 127) and the logits by up to ~6e-4, so they are held to
1e-3 from then on. The paged layout with ``kv_quant`` raises in both
packages.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke_config
from repro.models import attention as jattn
from repro.models.model import Model as JaxModel
from repro.serving import engine as jax_engine
from repro.serving import kv_cache as jax_kv
from repro.serving import predictors as jax_predictors
from repro.serving import workload as jax_workload
from repro_torch.config import get_smoke_config as port_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model, params_from_jax
from repro_torch.serving import engine as port_engine
from repro_torch.serving import kv_cache as port_kv
from repro_torch.serving import predictors as port_predictors
from repro_torch.serving import workload as port_workload

TOL = 1e-4
TOL_TIE = 1e-3          # once a payload landed one step apart (see above)


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(jax cfg, jax model, jax params, port model), float32, kv_quant on."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              kv_quant=True)
    pcfg = dataclasses.replace(port_smoke_config(arch), dtype="float32",
                               kv_quant=True)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.key(0))
    tm = Model(pcfg, device="cpu")
    tm.load_state_dict(params_from_jax(pcfg, jax.tree.map(np.asarray,
                                                          params)))
    return cfg, jm, params, tm


def err(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.max(np.abs(a.astype(np.float32) - b.astype(np.float32))))


def test_int8_kv_cache_close_to_fp():
    """The reference's own test, on the port: with ``kv_quant`` the decode
    logits stay within 0.05 x their scale + 0.3 of the float cache's, the
    top-1 token is the same, the cache is int8 with scales, and the byte
    count is below 0.6 x the float one's."""
    cfg = port_smoke_config("granite-3-8b")
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    m_fp = Model(cfg, device="cpu").init(seed=0)
    m_q = Model(qcfg, device="cpu")
    m_q.load_state_dict(m_fp.state_dict())
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    nt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
    outs = {}
    for name, m in (("fp", m_fp), ("q", m_q)):
        cache = m.init_cache(2, 64)
        _, cache, *_ = m.prefill_chunk(cache, tokens)
        outs[name], cache, *_ = m.decode_step(cache, nt)
        if name == "q":
            run0 = cache["run_0"][0]
            assert run0["k"].dtype == torch.int8
            assert "k_scale" in run0 and run0["k_scale"].dtype == torch.float32
    diff = err(outs["fp"], outs["q"])
    scale = float(outs["fp"].abs().max())
    assert diff < 0.05 * scale + 0.3, (diff, scale)
    assert torch.equal(outs["fp"].argmax(-1), outs["q"].argmax(-1))
    assert (port_kv.bytes_for_context(qcfg, 1024)
            < 0.6 * port_kv.bytes_for_context(cfg, 1024))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_the_reference_bit_for_bit(dtype):
    """``_quantize`` and ``dequantize`` on the same input: payloads, scales
    and dequantised values equal the reference's exactly, a row of zeros
    (scale floored at 1e-12) and values on rounding ties included."""
    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal((3, 20, 4, 32))).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # scale 1e-12
    x[1, 1, 1] = np.arange(32) - 16.0                  # max 16
    x[1, 1, 1, 0] = 127.0 * 0.5                        # a tie: 63.5 -> 64
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    tq, ts = tattn._quantize(xt)
    jq, js = jattn._quantize(xj)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tattn.dequantize(tq, ts).numpy(),
                          np.asarray(jattn.dequantize(jq, js)))
    assert float(ts[0, 0, 0]) == np.float32(1e-12)


def _payload_check(jsub, tsub, exact: bool):
    """int8 payloads and scales of one run's slot cache: ``exact`` (layer
    0) payloads equal and scales within 1e-6 relative, else payloads at
    most one step apart in at most 1e-3 of the elements and scales within
    1e-5 relative; the port's sink slot is left out."""
    M = jsub["k"].shape[2]
    for leaf in ("k", "v"):
        jv = np.asarray(jsub[leaf]).astype(np.int32)
        tv = tsub[leaf][:, :, :M].numpy().astype(np.int32)
        assert tsub[leaf].dtype == torch.int8
        if exact:
            assert np.array_equal(jv, tv), leaf
        else:
            assert np.abs(jv - tv).max() <= 1, leaf
            assert (jv != tv).mean() <= 1e-3, leaf
        js = np.asarray(jsub[leaf + "_scale"])
        ts = tsub[leaf + "_scale"][:, :, :M].numpy()
        rel = 1e-6 if exact else 1e-5
        assert np.all(np.abs(js - ts) <= rel * np.abs(js) + 1e-30), leaf
    assert np.array_equal(np.asarray(jsub["kpos"]),
                          tsub["kpos"][:, :, :M].numpy())


def _check_caches(jc, tc, tm) -> float:
    """Check every run's slot cache; returns the logit tolerance: 1e-4
    while every payload is equal, else 1e-3."""
    apart = 0
    for ri in range(len(tm.runs)):
        for j, tsub in enumerate(tc[f"run_{ri}"]):
            if "k" in tsub:
                jsub = jc[f"run_{ri}"][j]
                _payload_check(jsub, tsub, exact=ri == 0)
                M = jsub["k"].shape[2]
                apart += sum(int((np.asarray(jsub[leaf])
                                  != tsub[leaf][:, :, :M].numpy()).sum())
                             for leaf in ("k", "v"))
    return TOL if apart == 0 else TOL_TIE


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-9b", "hymba-1.5b"])
def test_int8_model_matches_jax(arch):
    """Two prefill chunks (24 and 20 tokens: gemma2's and hymba's rings of
    16 wrap; one row padded in the first, except for hymba, whose
    reference leaks padding into the SSM state), then 4 decode steps and
    a megastep of 4 with an inactive row: payloads and scales after each
    call, logits and probe outputs within 1e-4 (1e-3 once a payload
    landed apart), greedy tokens equal. The megastep's posteriors are held
    where the row took part in the step, the only ones the engine reads: a
    row that takes no part gets no SSM output (hymba's state update skips
    it), where the reference computes one from an update it discards."""
    cfg, jm, params, tm = pair(arch)
    rng = np.random.default_rng(4)
    B = 3
    chunks = [rng.integers(1, cfg.vocab_size, (B, w)).astype(np.int32)
              for w in (24, 20)]
    valid = np.ones((B, 24), bool)
    if arch != "hymba-1.5b":
        valid[1, 19:] = False
    jc, tc = jm.init_cache(B, 64), tm.init_cache(B, 64)
    prefill = jax.jit(jm.prefill_chunk)
    jl, jc, jts, _ = prefill(params, jc, jnp.asarray(chunks[0]),
                             valid=jnp.asarray(valid))
    tl, tc, tts, _ = tm.prefill_chunk(tc, torch.from_numpy(chunks[0]),
                                      torch.from_numpy(valid))
    assert err(jl, tl) < TOL
    tol = _check_caches(jc, tc, tm)
    jl, jc, _, _ = prefill(params, jc, jnp.asarray(chunks[1]))
    tl, tc, _, _ = tm.prefill_chunk(tc, torch.from_numpy(chunks[1]))
    assert err(jl, tl) < tol
    tol = max(tol, _check_caches(jc, tc, tm))
    tok = tl.argmax(-1).to(torch.int32)[:, None]
    assert np.array_equal(np.asarray(jnp.argmax(jl, -1)), tok[:, 0].numpy())
    step = jax.jit(jm.decode_step)
    for _ in range(4):
        jl, jc, _, jpl = step(params, jc, jnp.asarray(tok.numpy()))
        tl, tc, _, tpl = tm.decode_step(tc, tok)
        tol = max(tol, _check_caches(jc, tc, tm))
        assert err(jl, tl) < tol and err(jpl, tpl) < tol
        tok = tl.argmax(-1).to(torch.int32)[:, None]
        assert np.array_equal(np.asarray(jnp.argmax(jl, -1)),
                              tok[:, 0].numpy())
    active = np.array([True, False, True])
    jt, jc, jp, _ = jax.jit(jm.decode_multi, static_argnames=("k",))(
        params, jc, jnp.asarray(tok.numpy()), jnp.asarray(active), k=4)
    tt, tc, tp, _ = tm.decode_multi(tc, tok, torch.from_numpy(active), k=4)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    acted = tt.numpy() >= 0
    assert not acted.all()
    assert err(np.asarray(jp)[acted], tp.numpy()[acted]) < max(
        tol, _check_caches(jc, tc, tm))
    assert np.array_equal(np.asarray(jc["lengths"]), tc["lengths"].numpy())


def _int8_slot_cache(seed, B, H, KH, hd, M, window):
    """A random int8 slot cache with its scales, laid out as ``cache_write``
    lays one out (a ring when windowed), and queries at each row's last
    position (row 1 inactive)."""
    rng = np.random.default_rng(seed)
    k, ks = tattn._quantize(torch.from_numpy(
        rng.standard_normal((B, M, KH, hd)).astype(np.float32)))
    v, vs = tattn._quantize(torch.from_numpy(
        (2 * rng.standard_normal((B, M, KH, hd))).astype(np.float32)))
    lengths = rng.integers(1, 3 * M if window else M, size=B)
    kpos = np.full((B, M), -1, np.int32)
    for b, n in enumerate(lengths):
        pos = np.arange(max(0, int(n) - M), int(n))
        kpos[b, pos % M if window else pos] = pos
    q_pos = (lengths - 1).astype(np.int32)
    q_pos[1] = -1
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    return q, k, v, ks, vs, torch.from_numpy(kpos), torch.from_numpy(q_pos)


@pytest.mark.parametrize("B,H,KH,hd,M,window,cap", [
    (3, 4, 4, 32, 40, 0, 0.0),          # qwen-smoke: MHA
    (3, 4, 2, 32, 16, 16, 50.0),        # gemma2-smoke ring, softcap
    (2, 8, 1, 64, 33, 0, 0.0),          # MQA
])
def test_decode_attention_ref_with_scales(B, H, KH, hd, M, window, cap):
    """The plain version with scales against the reference's ``attend`` on
    the same int8 cache and scales, and against itself on the
    dequantised cache; the inactive row is 0."""
    q, k, v, ks, vs, kpos, q_pos = _int8_slot_cache(M + hd, B, H, KH, hd, M,
                                                    window)
    got = ops.decode_attention(q, k, v, kpos, q_pos, window=window,
                               softcap=cap, k_scale=ks, v_scale=vs)
    deq = ref.decode_attention_ref(q, tattn.dequantize(k, ks),
                                   tattn.dequantize(v, vs), kpos, q_pos,
                                   window=window, softcap=cap)
    assert err(got, deq) <= 1e-6
    jcfg = dataclasses.replace(get_smoke_config("granite-3-8b"),
                               attn_logit_softcap=cap)
    want = jattn.attend(jcfg, jnp.asarray(q.numpy())[:, None],
                        jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                        jnp.asarray(q_pos.numpy())[:, None],
                        jnp.asarray(kpos.numpy()), window=window,
                        k_scale=jnp.asarray(ks.numpy()),
                        v_scale=jnp.asarray(vs.numpy()))[:, 0]
    assert err(got, want) <= 1e-5
    assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("fault", [None, "scale_in_l", "no_v_scale"])
def test_factored_scales_equal_dequantising(fault):
    """The kernel's arithmetic over int8 rows, in float32: the key scale
    multiplies the dot (s = k_scale * q.k_int8) and p * v_scale weights
    the V row, while l sums p alone. That equals the plain version on the
    dequantised cache within 1e-5; folding the V scale into l, or leaving
    it out, does not."""
    q, k, v, ks, vs, kpos, q_pos = _int8_slot_cache(7, 3, 8, 4, 64, 48, 0)
    B, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    want = ref.decode_attention_ref(q, k, v, kpos, q_pos, k_scale=ks,
                                    v_scale=vs)
    valid = (kpos >= 0) & (kpos <= q_pos[:, None])
    qg = q.reshape(B, KH, G, hd)
    s = torch.einsum("bkgh,bmkh->bkgm", qg, k.float())
    s = s * ks.permute(0, 2, 1)[:, :, None] * hd ** -0.5
    s = s.masked_fill(~valid[:, None, None], ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid[:, None, None]
    w = p * vs.permute(0, 2, 1)[:, :, None]
    l = (w if fault == "scale_in_l" else p).sum(-1, keepdim=True)
    acc = torch.einsum("bkgm,bmkh->bkgh", p if fault == "no_v_scale" else w,
                       v.float())
    got = (acc / l.clamp_min(1e-30)).reshape(B, H, hd)
    active = q_pos >= 0
    if fault is None:
        assert err(got[active], want[active]) <= 1e-5
    else:
        assert err(got[active], want[active]) > 1e-3


def test_real_mode_engine_matches_jax():
    """The contiguous real-mode engine with ``kv_quant`` on granite-smoke:
    every request's tokens equal the JAX engine's, with the same
    preemptions, recomputed and prefilled tokens and steps; the pool's
    cache is int8."""
    cfg, jm, params, tm = pair("granite-3-8b")
    wl = dict(n_requests=8, request_rate=3000.0, seed=2, prompt_mean=10.0,
              out_median=12.0, max_out=24, vocab=cfg.vocab_size)
    jreqs = jax_workload.generate(jax_workload.WorkloadConfig(**wl))
    preqs = port_workload.generate(port_workload.WorkloadConfig(**wl))
    kn = dict(policy="trail", max_batch=2, c_limit=1.0, mode="real",
              kv_layout="contig", probe_interval=4, max_len=48,
              prefill_chunk=16,
              mem_budget=3 * jax_kv.bytes_for_context(cfg, 24))
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
    assert peng.pool.cache["run_0"][0]["k"].dtype == torch.int8


def test_paged_layout_with_kv_quant_raises_as_in_the_reference():
    """Both packages refuse the paged layout under ``kv_quant`` and keep no
    pages across preemption for such a config."""
    cfg, jm, _, tm = pair("granite-3-8b")
    with pytest.raises(NotImplementedError):
        jm.init_cache(2, 32, kv_layout="paged")
    with pytest.raises(NotImplementedError):
        tm.init_cache(2, 32, kv_layout="paged")
    assert not jax_kv.supports_page_retention(cfg)
    assert not port_kv.supports_page_retention(tm.cfg)
