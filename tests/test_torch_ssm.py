"""The port's Mamba-2 (``mamba2-smoke``) and hybrid (``hymba-smoke``) models
against the JAX package on the same weights and inputs.

Weights come from the reference ``Model.init`` and cross over with
``params_from_jax``; inputs are made with numpy from fixed seeds. The
models are float32 variants of the smoke configs (2 layers, d_model 128;
``dataclasses.replace(cfg, dtype="float32")``), run on the CPU, where the
port's ``ssd_scan`` is its plain chunked version.

The port advances each row's SSM state by exactly its valid tokens; the
reference runs every row over every position of a chunk, padding
included (ROADMAP Queue 3). So chunks that are fully valid are held
against the reference as it is, and padded chunks against the reference
fed each row's valid tokens alone (B=1). One test pins the reference's
fault.

Tolerances: float32 greedy tokens and ``n_emitted`` exactly; logits,
probe posteriors, SSM states and conv buffers within 1e-4 of their scale
(float32 sums in another order and another chunking of the scan); taps
2e-5 of their scale as in ``tests/test_torch_training.py``. States that
must not move are compared bit for bit.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke_config
from repro.models import ssm as jssm
from repro.models.model import Model as JaxModel
from repro.training import checkpoint as jckpt
from repro.training.data import harvest_probe_data as jax_harvest
from repro_torch.config import get_smoke_config as port_smoke_config
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model, params_from_jax, params_to_jax
from repro_torch.models.transformer import layer_slots
from repro_torch.serving import engine as port_engine
from repro_torch.serving import kv_cache as port_kv
from repro_torch.serving import predictors as port_predictors
from repro_torch.serving import workload as port_workload
from repro_torch.training import checkpoint as tckpt
from repro_torch.training.data import DataConfig, harvest_probe_data

ARCHS = ("mamba2-370m", "hymba-1.5b")
TOL = 1e-4
B, MAX_LEN = 3, 64


@functools.lru_cache(maxsize=None)
def pair(arch, dtype="float32"):
    """(jax cfg, jax model, jax params, jitted jax passes, port model,
    port float32 masters) on the reference's weights."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.key(0))
    jits = dict(prefill=jax.jit(jm.prefill_chunk),
                multi=jax.jit(jm.decode_multi,
                              static_argnames=("k", "eos_id")),
                step=jax.jit(jm.decode_step))
    tcfg = dataclasses.replace(port_smoke_config(arch), dtype=dtype)
    masters = params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(masters)
    return cfg, jm, params, jits, tm, masters


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def rel_err(a, b) -> float:
    """Max |a - b| over the scale of b (at least 1)."""
    a, b = np32(a), np32(b)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.abs(b).max()))


def ssm_leaves(cache):
    """(run, position, leaf) -> array of every SSM state and conv buffer."""
    out = {}
    for key in cache:
        if key.startswith("run_"):
            for j, sub in enumerate(cache[key]):
                for leaf in ("ssm_state", "conv_buf"):
                    if leaf in sub:
                        out[(key, j, leaf)] = sub[leaf]
    return out


def layer_params(arch, li):
    """Layer ``li``'s SSM weights: (jax cfg, jax dict, port cfg, port
    block)."""
    cfg, _, params, _, tm, _ = pair(arch)
    ri, j, i = layer_slots(tm.cfg)[li]
    jp = jax.tree.map(lambda a: a[i], params["layers"][ri][j]["ssm"])
    return cfg, jp, tm.cfg, tm.layers[li]


def layer_inputs(cfg, L, seed):
    rng = np.random.default_rng(seed)
    d_in, nh, conv_ch = jssm.ssm_dims(cfg)
    N = cfg.ssm_groups * cfg.ssm_state
    f = np.float32
    return (rng.standard_normal((2, L, cfg.d_model)).astype(f),
            (0.5 * rng.standard_normal((2, nh, cfg.ssm_head_dim, N))).astype(f),
            rng.standard_normal((2, cfg.ssm_conv - 1, conv_ch)).astype(f))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("L", [24, 64])
def test_ssm_forward_matches_jax(arch, L):
    """One SSM mixer over a chunk from a carried state and conv buffer
    (chunk 24, then two chunks of 32): output, new state, new buffer."""
    cfg, jp, tcfg, tp = layer_params(arch, 1)
    h, st, cb = layer_inputs(cfg, L, L)
    jy, (js, jb) = jssm.ssm_forward(cfg, jp, jnp.asarray(h),
                                    state=jnp.asarray(st),
                                    conv_buf=jnp.asarray(cb))
    ty, (ts, tb) = tssm.ssm_forward(tcfg, tp, torch.from_numpy(h),
                                    torch.from_numpy(st), torch.from_numpy(cb))
    assert rel_err(ty, jy) < TOL
    assert rel_err(ts, js) < TOL
    assert rel_err(tb, jb) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_step_matches_jax(arch):
    cfg, jp, tcfg, tp = layer_params(arch, 0)
    h, st, cb = layer_inputs(cfg, 1, 5)
    jy, (js, jb) = jssm.ssm_decode_step(cfg, jp, jnp.asarray(h),
                                        jnp.asarray(st), jnp.asarray(cb))
    ty, (ts, tb) = tssm.ssm_decode_step(tcfg, tp, torch.from_numpy(h),
                                        torch.from_numpy(st),
                                        torch.from_numpy(cb))
    assert rel_err(ty, jy) < TOL
    assert rel_err(ts, js) < TOL
    assert rel_err(tb, jb) < TOL


def test_causal_conv_buffer_ends_at_the_last_valid_token():
    """The new conv buffer is the W-1 inputs before each row's n_valid-th
    position of [old buffer; chunk]; a row with none keeps its buffer."""
    p = types.SimpleNamespace(conv_w=torch.ones(4, 2), conv_b=torch.zeros(2))
    old = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 2)
    xbc = 100 + torch.arange(2 * 5 * 2, dtype=torch.float32).reshape(2, 5, 2)
    _, buf = tssm._causal_conv(p, xbc, old, torch.tensor([0, 2]))
    assert torch.equal(buf[0], old[0])
    assert torch.equal(buf[1], torch.cat([old[1, 2:], xbc[1, :2]]))
    _, full = tssm._causal_conv(p, xbc, old)
    assert torch.equal(full, xbc[:, 2:])


def chunks(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, (B, w)).astype(np.int32) for w in (24, 16)]


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_model_matches_jax(arch):
    """Two fully valid prefill chunks (24 and 16 tokens: hymba-smoke's
    window of 16 wraps), a decode step, and a megastep with a short budget
    and an inactive row: equal tokens and ``n_emitted``; logits, probe
    posteriors, SSM states and conv buffers within 1e-4. The megastep's
    posteriors are held where the row took part in the step, the only ones
    the engine reads: a row that takes no part gets no SSM output (the
    state update skips it, y = 0), where the reference computes one from a
    state update it then discards."""
    cfg, jm, params, jits, tm, _ = pair(arch)
    jc, tc = jm.init_cache(B, MAX_LEN), tm.init_cache(B, MAX_LEN)
    for toks in chunks(cfg.vocab_size):
        jl, jc, jts, _ = jits["prefill"](params, jc, jnp.asarray(toks))
        tl, tc, tts, _ = tm.prefill_chunk(tc, torch.from_numpy(toks))
        assert rel_err(tl, jl) < TOL
        assert rel_err(tts, jts) < 2e-5
    for key, leaf in ssm_leaves(tc).items():
        assert rel_err(leaf, ssm_leaves(jc)[key]) < TOL, key
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    active = np.array([True, False, True])
    budget = np.array([6, 6, 2], np.int32)
    jl1, _, _, jpl = jits["step"](params, jc, jnp.asarray(tok))
    tl1, _, _, tpl = tm.decode_step(_clone(tc), torch.from_numpy(tok))
    assert rel_err(tl1, jl1) < TOL and rel_err(tpl, jpl) < TOL
    jt, jc, jp, jn = jits["multi"](params, jc, jnp.asarray(tok),
                                   jnp.asarray(active), jnp.asarray(budget),
                                   k=6)
    tt, tc, tp, tn = tm.decode_multi(tc, torch.from_numpy(tok),
                                     torch.from_numpy(active),
                                     torch.from_numpy(budget), k=6)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(jn), tn.numpy())
    acted = tt.numpy() >= 0
    assert acted.sum() == int(tn.sum()) and not acted.all()
    assert rel_err(tp.numpy()[acted], np.asarray(jp)[acted]) < TOL
    for key, leaf in ssm_leaves(tc).items():
        assert rel_err(leaf, ssm_leaves(jc)[key]) < TOL, key


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_model_matches_jax_within_tolerance(arch):
    """bf16 smoke configs: the two frameworks round at other places, so
    logits are held within 2e-2 of their scale (``tests/test_kernels.py``
    TOL) after a fully valid chunk."""
    cfg, jm, params, jits, tm, _ = pair(arch, "bfloat16")
    toks = chunks(cfg.vocab_size, seed=4)[0]
    jl, jc, _, _ = jits["prefill"](params, jm.init_cache(B, MAX_LEN),
                                   jnp.asarray(toks))
    tl, _, _, _ = tm.prefill_chunk(tm.init_cache(B, MAX_LEN),
                                   torch.from_numpy(toks))
    assert rel_err(tl, jl) < 2e-2


def _clone(cache):
    return {k: (tuple({n: t.clone() for n, t in sub.items()} for sub in v)
                if k.startswith("run_") else v.clone())
            for k, v in cache.items()}


def padded_chunks(vocab):
    """Two chunks with ragged valid prefixes: row 0 full then 8 of 16, row 1
    10 of 24 then full, row 2 nothing then 5 of 16."""
    toks = chunks(vocab, seed=2)
    valid = [np.zeros((B, 24), bool), np.zeros((B, 16), bool)]
    for v, n in zip(valid, ((24, 10, 0), (8, 16, 5))):
        for b, nb in enumerate(n):
            v[b, :nb] = True
    return toks, valid


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_chunks_advance_each_row_by_its_own_tokens(arch):
    """Each row's logits, tap sum, SSM states and conv buffers after two
    padded chunks equal the JAX model fed exactly that row's valid tokens
    (B=1, the same chunk boundaries)."""
    cfg, jm, params, jits, tm, _ = pair(arch)
    toks, valid = padded_chunks(cfg.vocab_size)
    tc = tm.init_cache(B, MAX_LEN)
    tls, tsums = [], []
    for t, v in zip(toks, valid):
        tl, tc, tts, _ = tm.prefill_chunk(tc, torch.from_numpy(t),
                                          torch.from_numpy(v))
        tls.append(tl)
        tsums.append(tts)
    for b in range(B):
        jc = jm.init_cache(1, MAX_LEN)
        for ci, (t, v) in enumerate(zip(toks, valid)):
            n = int(v[b].sum())
            if not n:
                continue
            jl, jc, jts, _ = jits["prefill"](params, jc,
                                             jnp.asarray(t[b:b + 1, :n]))
            assert rel_err(tls[ci][b], jl[0]) < TOL
            assert rel_err(tsums[ci][b], jts[0]) < 2e-5
        for key, leaf in ssm_leaves(tc).items():
            assert rel_err(leaf[:, b], ssm_leaves(jc)[key][:, 0]) < TOL, key


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_padding_fault_is_pinned(arch):
    """The reference's prefill runs every row's SSM over every position of
    the chunk (ROADMAP Queue 3): a row with no valid token moves its state
    and a row with 10 of 24 valid ends away from its exact-token state. The
    port leaves the first row's state and buffer bit for bit as they were,
    and puts the second on its exact-token state."""
    cfg, jm, params, jits, tm, _ = pair(arch)
    toks, valid = padded_chunks(cfg.vocab_size)
    t, v = toks[0], valid[0]              # row 2: no token; row 1: 10 of 24
    jc = jm.init_cache(B, MAX_LEN)
    tc = tm.init_cache(B, MAX_LEN)
    before = {k: x.clone() for k, x in ssm_leaves(tc).items()}
    _, jc, _, _ = jits["prefill"](params, jc, jnp.asarray(t),
                                  valid=jnp.asarray(v))
    _, tc, _, _ = tm.prefill_chunk(tc, torch.from_numpy(t),
                                   torch.from_numpy(v))
    solo = jits["prefill"](params, jm.init_cache(1, MAX_LEN),
                           jnp.asarray(t[1:2, :10]))[1]
    key = ("run_0", 0, "ssm_state")
    jstate, tstate = np32(ssm_leaves(jc)[key][0]), ssm_leaves(tc)[key][0]
    want = np32(ssm_leaves(solo)[key][0, 0])
    assert float(np.abs(jstate[2]).max()) > 1e-2          # idle row moved
    assert rel_err(jstate[1], want) > 1e-2                 # padding leaked
    for k, x in ssm_leaves(tc).items():
        assert torch.equal(x[:, 2], before[k][:, 2]), k
    assert rel_err(tstate[1], want) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_inactive_and_halted_rows_keep_their_ssm_state(arch):
    """decode_multi: an inactive row's SSM state and conv buffer are bit
    for bit unchanged, and a row halted on its budget (2 of 4) ends where
    two steps leave it."""
    cfg, _, _, _, tm, _ = pair(arch)
    tc = tm.init_cache(B, MAX_LEN)
    _, tc, _, _ = tm.prefill_chunk(tc, torch.from_numpy(
        chunks(cfg.vocab_size)[0]))
    tok = torch.tensor([[5], [6], [7]], dtype=torch.int32)
    active = torch.tensor([True, False, True])
    short = _clone(tc)
    before = {k: x.clone() for k, x in ssm_leaves(tc).items()}
    tm.decode_multi(tc, tok, active, torch.tensor([4, 4, 2]), k=4)
    tm.decode_multi(short, tok, active, torch.tensor([2, 2, 2]), k=2)
    for k, x in ssm_leaves(tc).items():
        assert torch.equal(x[:, 1], before[k][:, 1]), k
        assert torch.equal(x[:, 2], ssm_leaves(short)[k][:, 2]), k
        assert not torch.equal(x[:, 0], before[k][:, 0]), k


@pytest.mark.parametrize("kv_layout", ["contig", "paged"])
def test_flush_resets_zeroes_the_released_slots_ssm_state(kv_layout):
    """A released slot's SSM state and conv buffer go to 0 on the next
    flush (one repair for both pools); other slots keep theirs."""
    cfg, _, _, _, tm, _ = pair("hymba-1.5b")
    pool = (port_kv.SlotPool(tm, 3, 32) if kv_layout == "contig" else
            port_kv.PagedSlotPool(tm, 3, 32, page_size=8))
    for rid in (10, 11, 12):
        pool.assign(rid)
    tm.prefill_chunk(pool.cache, torch.from_numpy(chunks(cfg.vocab_size)[1]))
    before = {k: x.clone() for k, x in ssm_leaves(pool.cache).items()}
    slot = pool.release(11)
    pool.flush_resets()
    for k, x in ssm_leaves(pool.cache).items():
        assert float(before[k][:, slot].abs().max()) > 0, k
        assert float(x[:, slot].abs().max()) == 0.0, k
        others = [s for s in range(3) if s != slot]
        assert torch.equal(x[:, others], before[k][:, others]), k


@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_function_gradients_match_jax_grad(init):
    """``SSDScan`` (the scan with the plain version's backward) against
    ``jax.grad`` of the reference's ``ssd_chunked``, float32, from an
    initial state and from zeros: every input's gradient within 1e-5 plus
    1e-4 of the largest gradient of that input, both outputs weighted."""
    rng = np.random.default_rng(21)
    Bs, L, nh, hp, N, chunk = 2, 32, 3, 8, 6, 8
    f = np.float32
    ins = [rng.standard_normal((Bs, L, nh, hp)).astype(f),
           (0.3 * rng.random((Bs, L, nh)) + 0.01).astype(f),
           -np.exp(0.5 * rng.standard_normal(nh)).astype(f),
           rng.standard_normal((Bs, L, N)).astype(f),
           rng.standard_normal((Bs, L, N)).astype(f)]
    if init:
        ins.append((0.5 * rng.standard_normal((Bs, nh, hp, N))).astype(f))
    wy = rng.standard_normal((Bs, L, nh, hp)).astype(f)
    ws = rng.standard_normal((Bs, nh, hp, N)).astype(f)

    def jloss(*a):
        y, s = jssm.ssd_chunked(*a[:5], chunk,
                                init_state=a[5] if init else None)
        return jnp.sum(y * wy) + jnp.sum(s * ws)
    jgrads = jax.grad(jloss, argnums=tuple(range(len(ins))))(*ins)
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, s = tssm.SSDScan.apply(*leaves[:5], leaves[5] if init else None,
                              chunk)
    loss = (y * torch.from_numpy(wy)).sum() + (s * torch.from_numpy(ws)).sum()
    assert abs(float(loss.detach()) - float(jloss(*ins))) <= (
        1e-5 * abs(float(jloss(*ins))))
    tgrads = torch.autograd.grad(loss, leaves)
    for j, t in zip(jgrads, tgrads):
        assert t.shape == j.shape and t.dtype == torch.float32
        top = float(np.abs(np32(j)).max())
        assert float(np.abs(np32(t) - np32(j)).max()) <= 1e-5 + 1e-4 * top


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_all_taps_match_jax(arch):
    """The training forward (chunked scan, no cache) and the profiling
    pass at S=64: loss 2e-5 relative, taps 2e-5 of their scale."""
    cfg, jm, params, _, tm, _ = pair(arch)
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, cfg.vocab_size, (2, 64)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens).long(),
          "labels": torch.from_numpy(labels).long()}
    jl, jaux = jax.jit(jm.forward_train)(params, jb)
    with torch.no_grad():
        tl, taux = tm.forward_train(tb)
        taps = tm.forward_all_taps(tb)
    assert abs(float(tl) - float(jl)) <= 2e-5 * abs(float(jl))
    assert rel_err(taux["tap"], jaux["tap"]) < 2e-5
    assert rel_err(taps, jax.jit(jm.forward_all_taps)(params, jb)) < 2e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_in_jax(arch, tmp_path):
    """``params_to_jax`` + ``save`` write what the reference's ``restore``
    reads back into the tree of its ``Model.init`` (SSM leaves and the
    learned positions included), exactly."""
    _, _, params, _, tm, masters = pair(arch)
    path = str(tmp_path / "p.npz")
    tckpt.save(path, {"params": params_to_jax(tm.cfg, masters)})
    restored = jckpt.restore(path)["params"]
    assert jax.tree.structure(restored) == jax.tree.structure(params)
    for j, r in zip(jax.tree.leaves(params), jax.tree.leaves(restored)):
        assert r.dtype == j.dtype and np.array_equal(np.asarray(j), r)


def test_harvest_probe_data_on_mamba2():
    cfg, jm, params, _, tm, _ = pair("mamba2-370m")
    dc = DataConfig(vocab=cfg.vocab_size, seq_len=64, batch=4,
                    prompt_mean=10, max_out=40, seed=3)
    jx, jy = jax_harvest(jm, params, dc, 2)
    tx, ty = harvest_probe_data(tm, dc, 2)
    assert np.array_equal(jy, ty) and len(ty) > 0
    assert rel_err(tx, jx) < 2e-5


def test_init_is_seeded_with_the_reference_distributions():
    cfg = port_smoke_config("mamba2-370m")
    m = Model(cfg, device="cpu").init(seed=3)
    blk = m.layers[0]
    d_in = cfg.ssm_expand * cfg.d_model
    assert abs(float(m.pos_embed.std()) - 0.02) < 2e-3
    assert m.pos_embed.shape == (32768, cfg.d_model)
    assert abs(float(blk.in_proj.float().std()) - cfg.d_model ** -0.5) < 0.01
    assert abs(float(blk.out_proj.float().std()) - d_in ** -0.5) < 0.01
    assert abs(float(blk.conv_w.std()) - cfg.ssm_conv ** -0.5) < 0.05
    assert float(blk.D.min()) == 1.0 == float(blk.D.max())
    for name in ("conv_b", "dt_bias", "A_log", "norm_scale", "norm1"):
        assert float(getattr(blk, name).abs().max()) == 0.0, name
    assert blk.in_proj.dtype == torch.bfloat16
    assert blk.A_log.dtype == blk.conv_w.dtype == torch.float32


def _solo_greedy(arch, prompt, n):
    """The JAX model's greedy tokens for one request alone: the prompt but
    its last token prefilled, then ``n`` decode steps from that token (as
    the engine feeds them)."""
    cfg, jm, params, jits, _, _ = pair(arch)
    jc = jm.init_cache(1, MAX_LEN)
    _, jc, _, _ = jits["prefill"](params, jc,
                                  jnp.asarray([prompt[:-1]], jnp.int32))
    tok, out = prompt[-1], []
    for _ in range(n):
        logits, jc, _, _ = jits["step"](params, jc,
                                        jnp.asarray([[tok]], jnp.int32))
        tok = int(jnp.argmax(logits[0]))
        out.append(tok)
    return out


@pytest.mark.parametrize("kv_layout", ["contig", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_real_mode_engine_gives_each_request_its_solo_tokens(arch,
                                                              kv_layout):
    """The port's real-mode engine (chunks of 16, 3 slots, so prefill
    chunks carry padding and rows in mid-decode) on the float32 smoke
    model, under either layout (the SSM state and the hybrid's rings stay
    per slot under both): each request's tokens are those of its greedy
    run alone under the JAX model."""
    cfg, _, _, _, tm, _ = pair(arch)
    reqs = port_workload.generate(port_workload.WorkloadConfig(
        n_requests=6, request_rate=3000.0, seed=4, prompt_mean=14.0,
        out_median=8.0, max_out=12, vocab=cfg.vocab_size))
    eng = port_engine.Engine(
        tm.cfg, port_engine.EngineConfig(
            policy="trail", max_batch=3, c_limit=1.0, mode="real",
            kv_layout=kv_layout, probe_interval=4, max_len=MAX_LEN,
            prefill_chunk=16, page_size=8),
        predictor=port_predictors.ProbePredictor(
            tm.cfg.probe, probe_params=tm.probe, embed_table=tm.embed),
        model=tm, device="cpu")
    eng.run(reqs)
    assert all(len(r.generated) == r.true_out_len for r in reqs)
    for r in reqs:
        assert r.generated == _solo_greedy(arch, r.prompt,
                                           len(r.generated)), r.rid
