"""The port's mixture-of-experts against the JAX package.

Modules (``expert_capacity``, the router, the sort dispatch and its dense
oracle) run on the reference's ``init_moe`` weights of ``olmoe-smoke``
(4 experts, top 2) and numpy hidden states; the models (``olmoe-smoke``,
and ``arctic-smoke`` with its dense residual MLP) on the reference's
``Model.init`` weights through ``params_from_jax``.

Tolerances: float32 modules 1e-5 (the router's aux loss 1e-6 relative),
expert indices exactly equal; the models in float32, greedy tokens exactly
equal and logits within 1e-4; losses and taps 2e-5 relative, gradients
1e-5 plus 1e-4 of the largest of their leaf (as in
``tests/test_torch_training.py``); bfloat16 within
``tests/test_kernels.py``'s TOL of 2e-2.
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
from repro.models import moe as jmoe
from repro.models.model import Model as JaxModel
from repro.serving import engine as jax_engine
from repro.serving import kv_cache as jax_kv
from repro.serving import predictors as jax_predictors
from repro.serving import workload as jax_workload
from repro_torch.config import get_smoke_config as port_smoke_config
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model, params_from_jax, params_to_jax
from repro_torch.serving import engine as port_engine
from repro_torch.serving import kv_cache as port_kv
from repro_torch.serving import predictors as port_predictors
from repro_torch.serving import workload as port_workload

ARCHS = ("olmoe-1b-7b", "arctic-480b")
TOL_F32 = 1e-4
TOL_MODULE = 1e-5
TOL_BF16 = 2e-2


def err(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(jnp.asarray(b, jnp.float32))
    return float(np.max(np.abs(a - b))) if a.size else 0.0


class Weights:
    """The reference's MoE leaves under the port's block names."""

    def __init__(self, p):
        for name in ("router", "w_gate", "w_up", "w_down"):
            setattr(self, "moe_" + name,
                    torch.from_numpy(np.array(p[name], np.float32)))


def moe_pair(capacity_factor=1.25, seed=0):
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                              capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(port_smoke_config("olmoe-1b-7b"),
                               capacity_factor=capacity_factor)
    p = jmoe.init_moe(jax.random.key(seed), cfg)
    return cfg, tcfg, p, Weights(p)


def hidden(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("n_tokens", [1, 2, 7, 16, 64, 255, 4096])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.01, 1.25, 2.0])
def test_expert_capacity(arch, n_tokens, capacity_factor):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(port_smoke_config(arch),
                               capacity_factor=capacity_factor)
    assert (tmoe.expert_capacity(tcfg, n_tokens)
            == jmoe.expert_capacity(cfg, n_tokens))


def test_route_matches_and_breaks_ties_by_lower_index():
    """Probabilities, expert indices and aux loss of the router; two
    router columns made equal give ties, which both send to the lower
    expert index first (``jax.lax.top_k``'s order)."""
    cfg, tcfg, p, w = moe_pair()
    p = dict(p)
    p["router"] = p["router"].at[:, 3].set(p["router"][:, 1])
    w.moe_router = torch.from_numpy(np.array(p["router"]))
    hf = hidden((40, cfg.d_model))
    jp, ji, ja = jmoe._route(cfg, p, jnp.asarray(hf)[None])
    tp, ti, ta = tmoe.route(tcfg, w.moe_router, torch.from_numpy(hf))
    assert np.array_equal(np.asarray(ji[0]), ti.numpy())
    assert err(jp[0], tp) <= TOL_MODULE
    assert abs(float(ja) - float(ta)) <= 1e-6 * abs(float(ja))
    tied = (ti == 1) | (ti == 3)
    assert bool(tied.all(dim=1).any())      # some token picks both tied
    both = tied.all(dim=1)
    assert bool((ti[both, 0] == 1).all())


@pytest.mark.parametrize("capacity_factor,drops", [(4.0, False),
                                                   (0.25, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_jax(capacity_factor, drops, dtype):
    """The sort dispatch, expert products and combine, with and without
    tokens dropped past capacity."""
    cfg, tcfg, p, w = moe_pair(capacity_factor)
    h = hidden((2, 32, cfg.d_model))
    jdt = jnp.dtype(dtype)
    want, jaux = jmoe.moe_mlp(cfg, p, jnp.asarray(h, jdt))
    got, taux = tmoe.moe_mlp(tcfg, w, torch.from_numpy(h).to(
        getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = TOL_MODULE if dtype == "float32" else TOL_BF16
    assert err(want, got) <= tol * max(1.0, float(jnp.abs(
        want.astype(jnp.float32)).max()))
    assert abs(float(jaux) - float(taux)) <= 1e-5 * abs(float(jaux))
    dense, _ = tmoe.moe_mlp_dense(tcfg, w, torch.from_numpy(h))
    sparse = got.float() if dtype == "float32" else tmoe.moe_mlp(
        tcfg, w, torch.from_numpy(h))[0]
    assert (err(dense, sparse) > 1e-3) is drops


def test_sort_dispatch_equals_dense_when_nothing_drops():
    """The reference's ``test_moe_sort_matches_dense_dropless`` on the
    port: bf16, capacity 2.0, the dense oracle within 3e-2 and the same
    aux loss (at least 1, Switch's bound at balance); and in float32 the
    port's dense oracle equals the reference's."""
    cfg, tcfg, p, w = moe_pair(2.0)
    h = hidden((2, 16, cfg.d_model), seed=2)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    y1, a1 = tmoe.moe_mlp(tcfg, w, hb)
    y2, a2 = tmoe.moe_mlp_dense(tcfg, w, hb)
    assert err(y1, y2) < 3e-2
    assert float(a1) == pytest.approx(float(a2), rel=1e-5)
    assert float(a1) >= 1.0 - 1e-3
    jd, _ = jmoe.moe_mlp_dense(cfg, p, jnp.asarray(h))
    td, _ = tmoe.moe_mlp_dense(tcfg, w, torch.from_numpy(h))
    assert err(jd, td) <= TOL_MODULE


def test_dropped_tokens_contribute_zero():
    """The reference's ``test_moe_capacity_drops_are_identity``: with a
    capacity of 4 slots an expert (the floor) over 64 routed tokens, a
    token whose experts are all full gets exactly 0, and the output's
    mean size is below the input's."""
    cfg, tcfg, p, w = moe_pair(0.01)
    h = hidden((1, 32, cfg.d_model), seed=3)
    y, _ = tmoe.moe_mlp(tcfg, w, torch.from_numpy(h))
    want, _ = jmoe.moe_mlp(cfg, p, jnp.asarray(h))
    assert err(want, y) <= TOL_MODULE
    assert float(y.abs().mean()) < float(np.abs(h).mean())
    zero_rows = (y[0].abs().amax(dim=-1) == 0).sum()
    assert int(zero_rows) >= 32 - 4 * cfg.num_experts   # 16 slots in all


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(jax cfg, jax model, jax params, port model, float32 masters)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jm = JaxModel(cfg)
    params = jm.init(jax.random.key(0))
    tcfg = dataclasses.replace(port_smoke_config(arch), dtype="float32")
    masters = params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(masters)
    return cfg, jm, params, tm, masters


@pytest.mark.parametrize("kv_layout", ["contig", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, kv_layout):
    """A padded prefill chunk, a decode step and a megastep with an
    inactive row (both rows inactive and padded take capacity, as in the
    reference): tokens equal, logits and probe outputs within 1e-4. The
    megastep's 3 tokens a step are a dropless call (capacity 4 an
    expert), which routes the rows that hold a token alone: its
    posteriors are held where the row took part in the step, the only
    ones the engine reads, since a row that takes none gets no routed
    output, where the reference computes one it then discards."""
    cfg, jm, params, tm, _ = pair(arch)
    rng = np.random.default_rng(7)
    B, ps = 3, 8
    tokens = rng.integers(4, cfg.vocab_size, (B, 12)).astype(np.int32)
    valid = np.ones((B, 12), bool)
    valid[1, 7:] = False
    jc = jm.init_cache(B, 32, kv_layout=kv_layout, page_size=ps)
    tc = tm.init_cache(B, 32, kv_layout=kv_layout, page_size=ps)
    if kv_layout == "paged":
        table = np.array([[3, 5, 9, 0], [1, 7, 0, 0], [12, 2, 4, 0]],
                         np.int32)
        jc["block_table"] = jnp.asarray(table)
        tc["block_table"].copy_(torch.from_numpy(table))
    jl, jc, jts, _ = jax.jit(jm.prefill_chunk)(
        params, jc, jnp.asarray(tokens), valid=jnp.asarray(valid))
    tl, tc, tts, _ = tm.prefill_chunk(tc, torch.from_numpy(tokens),
                                      torch.from_numpy(valid))
    assert err(jl, tl) < TOL_F32 and err(jts, tts) < TOL_F32
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    jl2, jc, _, jpl = jax.jit(jm.decode_step)(params, jc, jnp.asarray(tok))
    tl2, tc, _, tpl = tm.decode_step(tc, torch.from_numpy(tok))
    assert err(jl2, tl2) < TOL_F32 and err(jpl, tpl) < TOL_F32
    tok2 = np.asarray(jnp.argmax(jl2, -1)).astype(np.int32)[:, None]
    active = np.array([True, True, False])
    budget = np.array([6, 4, 6], np.int32)
    jt, jc, jp, je = jax.jit(jm.decode_multi, static_argnames=("k",))(
        params, jc, jnp.asarray(tok2), jnp.asarray(active),
        jnp.asarray(budget), k=6)
    tt, tc, tp, te = tm.decode_multi(tc, torch.from_numpy(tok2),
                                     torch.from_numpy(active),
                                     torch.from_numpy(budget), k=6)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(je), te.numpy())
    acted = tt.numpy() >= 0
    assert acted.sum() == int(te.sum()) and not acted.all()
    assert err(np.asarray(jp)[acted], tp[torch.from_numpy(acted)]) < TOL_F32


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_aux_loss_and_gradients(arch):
    """``forward_train``: the loss with ``router_aux_weight`` times the
    summed router aux losses, the aux loss itself, the tap, and every
    gradient (router and experts included; arctic's dense MLP too)."""
    cfg, jm, params, tm, masters = pair(arch)
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jm.forward_train, has_aux=True))(
            params, {"tokens": jnp.asarray(tokens),
                     "labels": jnp.asarray(labels)})
    live = {k: v.clone().requires_grad_() for k, v in masters.items()}
    tloss, taux = functional_call(tm, live, ({
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)},))
    g = torch.autograd.grad(tloss, list(live.values()), allow_unused=True)
    tgrads = params_to_jax(tm.cfg, {
        k: gi if gi is not None else torch.zeros_like(live[k])
        for k, gi in zip(live, g)})
    assert err(jloss, tloss) <= 2e-5 * max(1.0, abs(float(jloss)))
    assert float(taux["aux_loss"]) > 0
    assert err(jaux["aux_loss"], taux["aux_loss"]) <= 2e-5 * float(
        jaux["aux_loss"])
    assert err(jaux["tap"], taux["tap"]) <= 2e-5 * max(
        1.0, float(jnp.abs(jaux["tap"]).max()))
    jl, tl = jax.tree.leaves(jgrads), jax.tree.leaves(tgrads)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape)
        assert err(j, t) <= 1e-5 + 1e-4 * float(jnp.max(jnp.abs(j)))
    router = tgrads["layers"][0][0]["moe"]["router"]
    assert float(router.abs().max()) > 0


@pytest.mark.parametrize("kv_layout", ["contig", "paged"])
def test_real_mode_engine_matches_jax(kv_layout):
    """olmoe-smoke served by both engines under a budget that preempts:
    every request's tokens and the engines' bookkeeping equal."""
    cfg, jm, params, tm, _ = pair("olmoe-1b-7b")
    wl = dict(n_requests=10, request_rate=3000.0, seed=2, prompt_mean=10.0,
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
    assert ps.n_preemptions == js.n_preemptions > 0
    assert ps.recomputed_tokens == js.recomputed_tokens
    assert ps.iterations == js.iterations
    assert ps.prefilled_tokens == js.prefilled_tokens
    assert port_kv.supports_page_retention(tm.cfg)


def _solo_and_batched(prefill, multi, cache_of, prompt):
    """Greedy tokens of one 12-token prompt served alone (1 row) and in
    slot 1 of 4 rows whose other rows are idle (padding), 13 tokens each,
    as (first logits, tokens)."""
    out = []
    for B, slot in ((1, 0), (4, 1)):
        tokens = np.zeros((B, 16), np.int32)
        valid = np.zeros((B, 16), bool)
        tokens[slot, :12] = prompt
        valid[slot, :12] = True
        logits, cache = prefill(cache_of(B), tokens, valid)
        tok = np.asarray(logits).argmax(-1).astype(np.int32)[:, None]
        toks = multi(cache, tok, valid.any(1))
        out.append((np.asarray(logits)[slot],
                    [int(tok[slot, 0])] + np.asarray(toks)[slot].tolist()))
    return out


def test_tokens_depend_on_batch_mates_as_in_the_reference():
    """Pins an open fault of the reference (ROADMAP Queue 3): expert
    capacity comes from all B * S routed tokens of a call, and idle rows'
    padding routes too (every padded token alike, so to the same experts),
    so a request's tokens change with the rows beside it. The port keeps
    the reference's rule: its tokens equal the JAX model's alone and in
    the batch, and the two differ."""
    cfg, jm, params, tm, _ = pair("olmoe-1b-7b")
    prompt = np.random.default_rng(0).integers(4, cfg.vocab_size, 12)
    jpre = jax.jit(jm.prefill_chunk)
    jmulti = jax.jit(jm.decode_multi, static_argnames=("k",))

    def jax_prefill(cache, tokens, valid):
        logits, cache, _, _ = jpre(params, cache, jnp.asarray(tokens),
                                   valid=jnp.asarray(valid))
        return logits, cache

    def port_prefill(cache, tokens, valid):
        logits, cache, _, _ = tm.prefill_chunk(
            cache, torch.from_numpy(tokens), torch.from_numpy(valid))
        return logits.numpy(), cache

    want = _solo_and_batched(
        jax_prefill,
        lambda c, t, a: jmulti(params, c, jnp.asarray(t), jnp.asarray(a),
                               k=12)[0],
        lambda B: jm.init_cache(B, 64), prompt)
    got = _solo_and_batched(
        port_prefill,
        lambda c, t, a: tm.decode_multi(c, torch.from_numpy(t),
                                        torch.from_numpy(a), k=12)[0].numpy(),
        lambda B: tm.init_cache(B, 64), prompt)
    for (jl, jt), (tl, tt) in zip(want, got):
        assert jt == tt
        assert err(jl, torch.from_numpy(tl)) < TOL_F32
    (solo_logits, solo), (batch_logits, batched) = got
    assert solo != batched
    assert float(np.abs(solo_logits - batch_logits).max()) > 0.1


#: dropless configurations (capacity_factor >= E / k): granite-4.0-h's
#: smoke model (8 experts, top 3, a shared expert), the benchmark's olmoe
#: smoke model (4, top 2, at 2.0) and arctic's smoke model at E / k
DROPLESS = {"granite-4.0-h-small": None, "olmoe-1b-7b": 2.0,
            "arctic-480b": 2.0}
#: (B, S) and the positions that hold a token: a decode step with
#: inactive rows, a prefill chunk with padded positions and an idle row
LIVE_SHAPES = {"decode": ((6, 1), [[1], [0], [1], [1], [0], [1]]),
               "prefill": ((3, 8), [[1] * 8, [1] * 5 + [0] * 3, [0] * 8])}


def dropless_pair(arch, dtype, seed=0):
    """(port config, weights) of a dropless MoE layer: numpy draws, the
    router float32, the experts (and the shared expert) in ``dtype``."""
    cfg = port_smoke_config(arch)
    if DROPLESS[arch] is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=DROPLESS[arch])
    rng = np.random.default_rng(seed)
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) / np.sqrt(shape[-2])).to(getattr(torch, dtype))

    w = Weights.__new__(Weights)
    w.moe_router = draw(d, E).float()
    w.moe_w_gate, w.moe_w_up, w.moe_w_down = (draw(E, d, ff), draw(E, d, ff),
                                              draw(E, ff, d))
    if cfg.shared_expert_ff:
        sf = cfg.shared_expert_ff
        w.shared_w_gate, w.shared_w_up, w.shared_w_down = (
            draw(d, sf), draw(d, sf), draw(sf, d))
    return cfg, w


def live_case(cfg, shape, dtype):
    (B, S), mask = LIVE_SHAPES[shape]
    h = torch.from_numpy(hidden((B, S, cfg.d_model), seed=4)).to(
        getattr(torch, dtype))
    return h, torch.tensor(mask, dtype=torch.bool)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(LIVE_SHAPES))
@pytest.mark.parametrize("arch", sorted(DROPLESS))
def test_live_tokens_alone_equal_the_sort_dispatch_and_the_dense_oracle(
        arch, shape, dtype):
    """A dropless call with the live mask (the cached path): each live
    token's output equals ``moe_mlp`` over the live tokens alone (the sort
    dispatch) and, routed part alone, the dense oracle; a dead position's
    routed output is exactly 0 (granite's shared expert still adds its
    own there)."""
    cfg, w = dropless_pair(arch, dtype)
    h, live = live_case(cfg, shape, dtype)
    assert tmoe.dropless(cfg, live.numel())
    got, _ = tmoe.moe_mlp(cfg, w, h, live=live)
    assert got.dtype == h.dtype and got.shape == h.shape
    alone, _ = tmoe.moe_mlp(cfg, w, h[live][None])
    tol = TOL_MODULE if dtype == "float32" else TOL_BF16
    scale = max(1.0, float(alone.float().abs().max()))
    assert err(got[live], alone[0]) <= tol * scale
    routed, _ = tmoe.moe_live_tokens(cfg, w, h.reshape(-1, cfg.d_model),
                                     live.reshape(-1))
    routed = routed.reshape(h.shape)
    dense, _ = tmoe.moe_mlp_dense(cfg, w, h)
    assert err(routed[live], dense[live]) <= tol * scale
    assert bool((routed[~live] == 0).all())
    shared = (tmoe.shared_expert(w, h) if cfg.shared_expert_ff
              else torch.zeros_like(h))
    assert torch.equal(got[~live], shared[~live])


@pytest.mark.parametrize("shape", sorted(LIVE_SHAPES))
@pytest.mark.parametrize("arch", sorted(DROPLESS))
def test_without_a_mask_or_where_tokens_can_drop_moe_mlp_is_unchanged(
        arch, shape):
    """``live=None`` (training, and any caller without a mask) and a call
    whose capacity can drop (the reference's batch-mate rule) take the
    sort dispatch over every position, bit for bit."""
    cfg, w = dropless_pair(arch, "float32")
    h, live = live_case(cfg, shape, "float32")
    hf = h.reshape(-1, cfg.d_model)
    routed, aux = tmoe.moe_tokens(cfg, w, hf)
    want = routed.reshape(h.shape)
    if cfg.shared_expert_ff:
        want = want + tmoe.shared_expert(w, h)
    got, gaux = tmoe.moe_mlp(cfg, w, h)
    assert torch.equal(got, want) and torch.equal(gaux, aux)
    tight = dataclasses.replace(cfg, capacity_factor=1.25)
    assert not tmoe.dropless(tight, live.numel())
    got, _ = tmoe.moe_mlp(tight, w, h, live=live)
    assert torch.equal(got, tmoe.moe_mlp(tight, w, h)[0])
    assert (err(got[~live], 0 * got[~live]) > 0) or not bool((~live).any())


@pytest.mark.parametrize("arch", sorted(DROPLESS))
def test_group_sorts_live_entries_by_expert_in_token_order(arch):
    """``group``: the live tokens' entries sorted by expert, in token order
    within an expert, dead tokens' entries after them; each expert's
    offsets; the kernel's tile count within its static bound."""
    from repro_torch.kernels import moe_experts as kmoe
    cfg, w = dropless_pair(arch, "float32")
    h, live = live_case(cfg, "prefill", "float32")
    hf, lf = h.reshape(-1, cfg.d_model), live.reshape(-1)
    _, top_i, _ = tmoe.route(cfg, w.moe_router, hf)
    entry, offsets = tmoe.group(cfg, top_i, lf)
    k, E = cfg.experts_per_token, cfg.num_experts
    assert entry.dtype == offsets.dtype == torch.int32
    want = sorted((int(top_i[q // k, q % k]), q) for q in range(hf.shape[0] * k)
                  if lf[q // k])
    n = int(offsets[E])
    assert n == len(want) == int(lf.sum()) * k
    assert entry[:n].tolist() == [q for _, q in want]
    assert sorted(entry[n:].tolist()) == [q for q in range(hf.shape[0] * k)
                                          if not lf[q // k]]
    for e in range(E):
        assert [q for x, q in want if x == e] == entry[
            int(offsets[e]):int(offsets[e + 1])].tolist()
    tiles = sum(-(-int(offsets[e + 1] - offsets[e]) // kmoe.TILE)
                for e in range(E))
    assert tiles <= kmoe.max_tiles(hf.shape[0], k, E)
