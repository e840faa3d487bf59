"""The port's model against the JAX model on the same weights and inputs.

Weights come from the reference ``Model.init`` and cross over with
``params_from_jax`` (or through an ``.npz`` checkpoint and ``load_npz``);
inputs are made with numpy from fixed seeds. The paged layout uses the
scrambled block tables of ``tests/test_megastep.py``.

Tolerances: in float32 (``dataclasses.replace(cfg, dtype="float32")``)
greedy tokens and ``n_emitted`` match exactly, logits and probe
posteriors within 1e-4. In bfloat16 the two frameworks round at other
places (XLA keeps excess precision inside fusions), so greedy tokens may
part after a near-tie; logits and probe posteriors are held within
``TOL_BF16`` = 2e-2 (``tests/test_kernels.py`` TOL) given the same inputs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ARCH_IDS, get_smoke_config
from repro.models.model import Model as JaxModel
from repro.training import checkpoint
from repro_torch.config import get_smoke_config as port_smoke_config
from repro_torch.models.model import Model, load_npz, params_from_jax

TOL_F32 = 1e-4
TOL_BF16 = 2e-2
B, MAX_LEN, PS = 3, 32, 8


@functools.lru_cache(maxsize=None)
def jax_model(arch, dtype, use_kernels):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    m = JaxModel(cfg, use_kernels=use_kernels)
    params = m.init(jax.random.key(0))
    return cfg, m, params, jax.jit(m.prefill_chunk), jax.jit(
        m.decode_multi, static_argnames=("k", "eos_id")), jax.jit(
        m.decode_step)


def port_model(arch, dtype, params):
    cfg = dataclasses.replace(port_smoke_config(arch), dtype=dtype)
    m = Model(cfg, device="cpu")
    m.load_state_dict(params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, params)))
    return m


def table():
    """Disjoint scrambled pages, 2 per row (8 prompt + up to 8 new tokens)."""
    t = np.zeros((B, MAX_LEN // PS), np.int32)
    t[0, :2] = [3, 5]
    t[1, :2] = [1, 7]
    t[2, :2] = [12, 2]
    return t


def inputs(vocab, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, vocab, (B, 8)).astype(np.int32)
    valid = np.ones((B, 8), bool)
    valid[1, 6:] = False                    # a shorter row
    return tokens, valid


def caches(jm, tm):
    jc = jm.init_cache(B, MAX_LEN, kv_layout="paged", page_size=PS)
    jc["block_table"] = jnp.asarray(table())
    tc = tm.init_cache(B, MAX_LEN, page_size=PS)
    tc["block_table"].copy_(torch.from_numpy(table()))
    return jc, tc


def err(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a, jnp.float32))
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(
        jnp.asarray(b, jnp.float32))
    return float(np.max(np.abs(a - b)))


def assert_caches_match(jc, tc, tol):
    assert np.array_equal(np.asarray(jc["lengths"]), tc["lengths"].numpy())
    for key in jc:
        if key.startswith("run_"):
            for js, ts in zip(jc[key], tc[key]):
                assert np.array_equal(np.asarray(js["pkpos"]),
                                      ts["pkpos"].numpy())
                assert err(js["pk"], ts["pk"]) < tol
                assert err(js["pv"], ts["pv"]) < tol


@pytest.mark.parametrize("arch,jax_kernels", [
    ("trail-llama", True), ("granite-3-8b", True),
    ("trail-llama", False),     # JAX's plain gather-and-attend path
    ("granite-3-8b", False),
])
def test_float32_matches_jax(arch, jax_kernels):
    """prefill_chunk, decode_step and decode_multi (with a short budget and
    an inactive row) on scrambled pages: exact tokens, 1e-4 elsewhere. The
    port's one path is held against both of the reference's paths (its
    Pallas kernels in interpret mode, and its plain gather-and-attend)."""
    cfg, jm, params, jpre, jmulti, jstep = jax_model(arch, "float32",
                                                      jax_kernels)
    tm = port_model(arch, "float32", params)
    tokens, valid = inputs(cfg.vocab_size)
    jc, tc = caches(jm, tm)
    jl, jc, jts, jn = jpre(params, jc, jnp.asarray(tokens),
                           valid=jnp.asarray(valid))
    tl, tc, tts, tn = tm.prefill_chunk(tc, torch.from_numpy(tokens),
                                       torch.from_numpy(valid))
    assert err(jl, tl) < TOL_F32
    assert err(jts, tts) < TOL_F32
    assert np.array_equal(np.asarray(jn), tn.numpy())
    assert_caches_match(jc, tc, 1e-5)

    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    assert np.array_equal(tok[:, 0], tl.argmax(-1).numpy())
    active = np.array([True, True, False])
    budget = np.array([5, 2, 5], np.int32)
    jt, jc2, jp, je = jmulti(params, jc, jnp.asarray(tok),
                             jnp.asarray(active), jnp.asarray(budget), k=5)
    tt, tc2, tp, te = tm.decode_multi(tc, torch.from_numpy(tok),
                                      torch.from_numpy(active),
                                      torch.from_numpy(budget), k=5)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(je), te.numpy())
    assert te.tolist() == [5, 2, 0]
    assert torch.all(tt[1, 2:] == -1) and torch.all(tt[2] == -1)
    assert err(jp, tp) < TOL_F32
    assert_caches_match(jc2, tc2, 1e-5)

    # one more plain decode step on the advanced caches
    nxt = np.asarray(jt)[:, -1:].clip(0).astype(np.int32)
    jl, _, jtap, jpl = jstep(params, jc2, jnp.asarray(nxt))
    tl, _, ttap, tpl = tm.decode_step(tc2, torch.from_numpy(nxt))
    assert err(jl, tl) < TOL_F32
    assert err(jtap, ttap) < TOL_F32
    assert err(jpl, tpl) < TOL_F32


@pytest.mark.parametrize("arch", ["trail-llama", "granite-3-8b"])
def test_bfloat16_matches_jax_within_tolerance(arch):
    cfg, jm, params, jpre, _, jstep = jax_model(arch, "bfloat16", True)
    tm = port_model(arch, "bfloat16", params)
    tokens, valid = inputs(cfg.vocab_size, seed=2)
    jc, tc = caches(jm, tm)
    jl, jc, jts, jn = jpre(params, jc, jnp.asarray(tokens),
                           valid=jnp.asarray(valid))
    tl, tc, tts, tn = tm.prefill_chunk(tc, torch.from_numpy(tokens),
                                       torch.from_numpy(valid))
    assert err(jl, tl) < TOL_BF16
    n = valid.sum(1, keepdims=True)
    assert err(np.asarray(jts) / n, tts / torch.from_numpy(n)) < TOL_BF16
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    jl, _, _, jpl = jstep(params, jc, jnp.asarray(tok))
    tl, _, _, tpl = tm.decode_step(tc, torch.from_numpy(tok))
    assert err(jl, tl) < TOL_BF16
    assert err(jax.nn.softmax(jpl, -1), torch.softmax(tpl, -1)) < TOL_BF16


def test_eos_halting_matches_jax():
    """A row that emits ``eos_id`` halts there in both frameworks."""
    cfg, jm, params, jpre, jmulti, _ = jax_model("trail-llama", "float32",
                                                 True)
    tm = port_model("trail-llama", "float32", params)
    tokens, _ = inputs(cfg.vocab_size, seed=3)
    jc, tc = caches(jm, tm)
    jl, jc, *_ = jpre(params, jc, jnp.asarray(tokens))
    tl, tc, *_ = tm.prefill_chunk(tc, torch.from_numpy(tokens))
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    free, *_ = jmulti(params, jc, jnp.asarray(tok), k=5)
    eos = int(np.asarray(free)[0, 2])           # row 0's 3rd token as EOS
    jt, jc, _, je = jmulti(params, jc, jnp.asarray(tok), k=5, eos_id=eos)
    tt, tc, _, te = tm.decode_multi(tc, torch.from_numpy(tok), k=5,
                                    eos_id=eos)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(np.asarray(je), te.numpy())
    assert int(te[0]) == 3 and tt[0, 2] == eos and torch.all(tt[0, 3:] == -1)
    assert np.array_equal(np.asarray(jc["lengths"]), tc["lengths"].numpy())


def _clone(cache):
    return {k: (tuple({n: t.clone() for n, t in sub.items()} for sub in v)
                if k.startswith("run_") else v.clone())
            for k, v in cache.items()}


def test_decode_multi_equals_sequential_decode_steps():
    """The megastep is k decode steps with the same halting, bit for bit."""
    cfg = dataclasses.replace(port_smoke_config("granite-3-8b"),
                              dtype="float32")
    m = Model(cfg, device="cpu").init(seed=3)
    cache = m.init_cache(B, MAX_LEN, page_size=PS)
    cache["block_table"].copy_(torch.from_numpy(table()))
    tokens, valid = inputs(cfg.vocab_size, seed=4)
    logits, cache, *_ = m.prefill_chunk(cache, torch.from_numpy(tokens),
                                        torch.from_numpy(valid))
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    active = torch.tensor([True, False, True])
    budget = torch.tensor([4, 4, 2], dtype=torch.int32)
    seq = _clone(cache)
    toks, cache, probs, n = m.decode_multi(cache, tok, active, budget, k=4)
    emitted = torch.zeros(B, dtype=torch.int32)
    cur = tok
    for step in range(4):
        act = active & (emitted < budget)
        lg, seq, _, pl = m.decode_step(seq, cur, act)
        nxt = lg.argmax(-1).to(torch.int32)
        assert torch.equal(toks[:, step], torch.where(act, nxt, -1))
        assert torch.equal(probs[:, step], torch.softmax(pl, -1))
        cur = torch.where(act, nxt, cur[:, 0])[:, None]
        emitted += act.to(torch.int32)
    assert torch.equal(n, emitted)
    for key in cache:
        if key.startswith("run_"):
            for a, b in zip(cache[key], seq[key]):
                assert all(torch.equal(a[leaf], b[leaf]) for leaf in a)
        else:
            assert torch.equal(cache[key], seq[key])


def test_npz_checkpoint_crosses_over(tmp_path):
    """The reference's .npz checkpoint (with bf16 leaves stored as uint16
    views) loads with numpy alone and gives the same state dict."""
    cfg, _, params, *_ = jax_model("granite-3-8b", "float32", True)
    tree = dict(params)
    tree["embed"] = params["embed"].astype(jnp.bfloat16)
    path = tmp_path / "ckpt.npz"
    checkpoint.save(str(path), tree)
    direct = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, tree))
    loaded = params_from_jax(cfg, load_npz(path))
    assert direct.keys() == loaded.keys()
    assert loaded["embed"].dtype == torch.bfloat16
    for name in direct:
        assert torch.equal(direct[name], loaded[name]), name
    m = Model(port_smoke_config("granite-3-8b"), device="cpu")
    m.load_state_dict(loaded)
    assert torch.equal(m.embed, loaded["embed"].float())


def test_init_is_seeded_with_the_reference_distributions():
    cfg = port_smoke_config("trail-llama")
    a = Model(cfg, device="cpu").init(seed=5)
    b = Model(cfg, device="cpu").init(seed=5)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    blk = a.layers[0]
    assert abs(float(a.embed.std()) - 0.02) < 2e-3
    assert abs(float(blk.wq.float().std()) - cfg.d_model ** -0.5) < 0.01
    assert abs(float(blk.wo.float().std()) - cfg.q_dim ** -0.5) < 0.01
    assert abs(float(blk.w_down.float().std()) - cfg.d_ff ** -0.5) < 0.01
    assert float(blk.norm1.abs().max()) == 0 == float(a.probe["b1"].abs().max())
    assert blk.wq.dtype == torch.bfloat16 and a.embed.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCH_IDS + ("trail-llama",))
def test_only_attention_stacks_are_ported(arch):
    cfg = port_smoke_config(arch)
    supported = (set(cfg.layer_kinds) == {"attn"} and not cfg.kv_quant
                 and not cfg.cross_attention and not cfg.num_prefix_tokens
                 and cfg.use_rope and cfg.family != "audio")
    if supported:
        Model(cfg, device="cpu")
    else:
        with pytest.raises(NotImplementedError):
            Model(cfg, device="cpu")
