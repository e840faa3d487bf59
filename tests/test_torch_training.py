"""The port's offline path against the JAX package: the training forward,
AdamW, the LM and probe trainers, the probe-data harvest, checkpoints and
the training launcher.

Weights come from the reference ``Model.init`` and cross over with
``params_from_jax``; inputs are the synthetic batches of
``training.data`` (numpy, the same in both packages) or numpy draws from
fixed seeds. The models are float32 variants of the smoke configs
(``dataclasses.replace(cfg, dtype="float32")``): in bfloat16 the two
frameworks round at other places. ``gemma2-smoke`` runs at S=64 with its
window of 16, so the window binds, and with its attention softcap of 50.

Tolerances (max absolute error unless stated): losses, taps and
attention outputs 2e-5 relative to their scale (float32 sums over d and
the vocabulary in another order); gradients 1e-5 plus 1e-4 of the
largest gradient of their leaf; optimizer trajectories 1e-6 (elementwise
float32 arithmetic, the global norm summed in another order); the LM
trainer's loss history 1e-4 relative over 3 steps.
"""

import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from repro.config import get_smoke_config
from repro.core.predictor import init_probe as jax_init_probe
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models.model import Model as JaxModel
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro.training.data import harvest_probe_data as jax_harvest
from repro_torch.config import get_smoke_config as port_smoke_config
from repro_torch.core.bins import bin_means
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models.model import (Model, load_npz, params_from_jax,
                                      params_to_jax)
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain
from repro_torch.training.data import DataConfig, batches, harvest_probe_data

ARCHS = ("trail-llama", "gemma2-9b")
# the training forward also of the Mamba-2 and hybrid stacks (the SSM
# layers' gradient through ``models.ssm.SSDScan``)
TRAIN_ARCHS = ARCHS + ("mamba2-370m", "hymba-1.5b")


@functools.lru_cache(maxsize=None)
def pair(arch):
    """The float32 smoke model in both packages on the reference's weights:
    (jax cfg, jax model, jax params, port model, float32 masters)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jm = JaxModel(cfg)
    params = jm.init(jax.random.key(0))
    tcfg = dataclasses.replace(port_smoke_config(arch), dtype="float32")
    masters = params_from_jax(tcfg, jax.tree.map(np.asarray, params))
    tm = Model(tcfg, device="cpu")
    tm.load_state_dict(masters)
    return cfg, jm, params, tm, masters


def data_config(cfg, seq=64, batch=2, seed=0):
    return DataConfig(vocab=cfg.vocab_size, seq_len=seq, batch=batch,
                      prompt_mean=8, max_out=seq // 2, seed=seed)


def one_batch(cfg, seed=0):
    b = next(batches(data_config(cfg, seed=seed), 1))
    return b["tokens"], b["labels"]


def err(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a, jnp.float32))
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(jnp.asarray(b, jnp.float32))
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def scale_of(x) -> float:
    return max(float(np.max(np.abs(np.asarray(x, np.float32)))), 1.0)


def assert_grads_match(jgrads, tgrads):
    """Leaf by leaf (the same tree: ``params_to_jax`` of the port's)."""
    jl, tl = jax.tree.leaves(jgrads), jax.tree.leaves(tgrads)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape)
        assert err(j, t) <= 1e-5 + 1e-4 * float(jnp.max(jnp.abs(j)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layer", [0, 1])
def test_self_attention_full(arch, layer):
    """Forward and gradients (w.r.t. h and every projection) of one
    layer's causal full-sequence attention; gemma2-smoke's layer 0 is its
    local layer (window 16), layer 1 global."""
    cfg, _, params, tm, _ = pair(arch)
    kind = cfg.layer_kinds[layer]
    window = cfg.sliding_window if kind == "local" else 0
    p = jax.tree.map(lambda x: x[0], params["layers"][layer][0]["attn"])
    rng = np.random.default_rng(layer)
    h = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)

    def jloss(p, h):
        out = jattn.self_attention_full(cfg, p, h, window=window)
        return jnp.sum(out * r), out
    (_, jout), (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(p, h)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in p.items()}
    th = torch.from_numpy(h).requires_grad_()
    tout = tattn.self_attention_full(tm.cfg, types.SimpleNamespace(**tp), th,
                                     window=window)
    assert err(jout, tout) <= 2e-5 * scale_of(jout)
    grads = torch.autograd.grad((tout * torch.from_numpy(r)).sum(),
                                [th, *tp.values()])
    assert_grads_match([jgh, *(jgp[k] for k in tp)], list(grads))


@functools.lru_cache(maxsize=None)
def train_forward(arch):
    """``forward_train`` with gradients in both packages on one batch."""
    cfg, jm, params, tm, masters = pair(arch)
    tokens, labels = one_batch(cfg)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        jm.forward_train, has_aux=True))(
            params, {"tokens": jnp.asarray(tokens),
                     "labels": jnp.asarray(labels)})
    live = {k: v.clone().requires_grad_() for k, v in masters.items()}
    tloss, taux = functional_call(tm, live, ({
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)},))
    g = torch.autograd.grad(tloss, list(live.values()), allow_unused=True)
    tgrads = {k: torch.zeros_like(live[k]) if gi is None else gi
              for k, gi in zip(live, g)}
    return (jloss, jaux, jgrads), (tloss, taux, params_to_jax(tm.cfg, tgrads))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_forward_train_loss_and_tap(arch):
    (jloss, jaux, _), (tloss, taux, _) = train_forward(arch)
    assert abs(float(jloss) - float(tloss.detach())) <= 2e-5 * float(jloss)
    assert float(jaux["n_tok"]) == float(taux["n_tok"]) > 0
    assert err(jaux["tap"], taux["tap"]) <= 2e-5 * scale_of(jaux["tap"])
    assert float(taux["aux_loss"]) == 0.0


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_forward_train_gradients(arch):
    """Every parameter's gradient; the probe's is 0 in both (the LM loss
    does not reach it), remat on (each block recomputed in the
    backward)."""
    (_, _, jgrads), (_, _, tgrads) = train_forward(arch)
    assert pair(arch)[3].cfg.remat
    assert_grads_match(jgrads, tgrads)
    assert all(float(t.abs().max()) == 0.0 for t in tgrads["probe"].values())


def test_forward_train_rejects_frontend_embeds():
    """Frontend embeddings the reference knows are taken: trail-llama with
    ``prefix_embeds`` (4 rows, labels -1 there) gives the reference's
    loss, label count and tap. A batch key the reference does not know is
    still refused."""
    cfg, jm, params, tm, _ = pair("trail-llama")
    tokens, labels = one_batch(tm.cfg)
    prefix = np.random.default_rng(2).standard_normal(
        (tokens.shape[0], 4, cfg.d_model)).astype(np.float32)
    jloss, jaux = jax.jit(jm.forward_train)(params, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
        "prefix_embeds": jnp.asarray(prefix)})
    with torch.no_grad():
        tloss, taux = tm.forward_train({
            "tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels),
            "prefix_embeds": torch.from_numpy(prefix)})
    assert abs(float(jloss) - float(tloss)) <= 2e-5 * float(jloss)
    assert float(jaux["n_tok"]) == float(taux["n_tok"]) > 0
    assert tuple(taux["tap"].shape) == tuple(jaux["tap"].shape)
    assert err(jaux["tap"], taux["tap"]) <= 2e-5 * scale_of(jaux["tap"])
    with pytest.raises(NotImplementedError):
        tm.forward_train({"tokens": torch.from_numpy(tokens),
                          "labels": torch.from_numpy(labels),
                          "image_embeds": torch.zeros(2, 4, 128)})


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_all_taps(arch):
    cfg, jm, params, tm, _ = pair(arch)
    tokens, _ = one_batch(cfg, seed=1)
    want = jax.jit(jm.forward_all_taps)(params,
                                        {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = tm.forward_all_taps({"tokens": torch.from_numpy(tokens)})
    assert got.shape == (cfg.num_layers, *tokens.shape, cfg.d_model)
    assert err(want, got) <= 2e-5 * scale_of(want)


@pytest.mark.parametrize("ocfg", [
    dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0),
    dict(lr=3e-3, warmup_steps=0, total_steps=5, clip_norm=0.0,
         weight_decay=0.1, min_lr_frac=0.1, moment_dtype="bfloat16"),
])
def test_adamw_trajectory(ocfg):
    """``lr_at`` over a schedule and six ``update`` steps: a matrix, a
    vector and a rank-3 leaf, one leaf without a gradient in the port
    (``None``) and zeros in the reference, gradients large enough that the
    clip binds."""
    jc, tc = jopt.AdamWConfig(**ocfg), topt.AdamWConfig(**ocfg)
    for step in range(0, 9):
        assert abs(float(jopt.lr_at(jc, step))
                   - float(topt.lr_at(tc, step))) <= 1e-9
    rng = np.random.default_rng(4)
    shapes = {"w": (4, 3), "b": (3,), "t": (2, 2, 2), "frozen": (3, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jopt.init(jc, jp), topt.init(tc, tp)
    for _ in range(6):
        g = {k: 3 * rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        g["frozen"] = np.zeros(shapes["frozen"], np.float32)
        jp, js, jm = jopt.update(jc, {k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        tg["frozen"] = None
        tp, ts, tm = topt.update(tc, tg, ts, tp)
        assert int(ts["step"]) == int(js["step"])
        for key in ("grad_norm", "lr"):
            assert abs(float(jm[key]) - float(tm[key])) <= 1e-6
        for k in shapes:
            assert err(jp[k], tp[k]) <= 1e-6
            assert err(js["mu"][k], ts["mu"][k]) <= 1e-6
            assert ts["mu"][k].dtype == getattr(torch, tc.moment_dtype)
    assert err(jp["frozen"], params["frozen"]) > 0     # decayed, no grad


def test_train_lm_loss_history():
    """Three steps of ``train_lm`` (AdamW, warmup, clipping, remat) from the
    same weights on the same batches: the logged loss, grad norm and lr of
    every step, and the final weights."""
    cfg, jm, params, tm, masters = pair("trail-llama")
    dc = data_config(cfg, seed=5)
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    jp, _, jh = jtrain.train_lm(jm, params, batches(dc, 3),
                                jopt.AdamWConfig(**ocfg), 3, log_every=1)
    tp, _, th = ttrain.train_lm(tm, masters, batches(dc, 3),
                                topt.AdamWConfig(**ocfg), 3, log_every=1)
    assert [r["step"] for r in th] == [r["step"] for r in jh] == [0, 1, 2]
    for j, t in zip(jh, th):
        assert abs(j["loss"] - t["loss"]) <= 1e-4 * j["loss"]
        assert abs(j["grad_norm"] - t["grad_norm"]) <= 1e-4 * j["grad_norm"]
        assert abs(j["lr"] - t["lr"]) <= 1e-9 and j["n_tok"] == t["n_tok"]
    jl = jax.tree.leaves(jp)
    tl = jax.tree.leaves(params_to_jax(tm.cfg, tp))
    assert max(err(j, t) for j, t in zip(jl, tl)) <= 1e-4


@functools.lru_cache(maxsize=None)
def harvested():
    cfg, jm, params, tm, _ = pair("trail-llama")
    dc = DataConfig(vocab=cfg.vocab_size, seq_len=96, batch=4,
                    prompt_mean=10, max_out=60, seed=3)
    return jax_harvest(jm, params, dc, 2), harvest_probe_data(tm, dc, 2)


def test_harvest_probe_data():
    (jx, jy), (tx, ty) = harvested()
    assert tx.dtype == np.float32 and tx.shape == jx.shape
    assert np.array_equal(jy, ty) and len(ty) > 0
    assert float(np.max(np.abs(jx - tx))) <= 2e-5 * scale_of(jx)


def test_train_probe_and_mae():
    """``train_probe`` from the reference's initial probe weights (random
    draws do not cross frameworks), on the harvested taps: per-epoch loss
    and accuracy, the final weights and ``probe_mae``."""
    cfg = pair("trail-llama")[0]
    _, (taps, rem) = harvested()
    init = jax_init_probe(jax.random.key(1), cfg.d_model, cfg.probe)
    tc = dict(epochs=3, batch=32, lr=0.01, seed=2)
    jpp, jh = jtrain.train_probe(taps, rem, cfg.probe, cfg.d_model,
                                 jtrain.ProbeTrainConfig(**tc),
                                 probe_params=init)
    tpp, th = ttrain.train_probe(
        taps, rem, cfg.probe, cfg.d_model, ttrain.ProbeTrainConfig(**tc),
        probe_params={k: np.array(v) for k, v in init.items()},
        device="cpu")
    for j, t in zip(jh, th):
        assert j["epoch"] == t["epoch"]
        assert abs(j["loss"] - t["loss"]) <= 1e-5
        assert abs(j["acc"] - t["acc"]) <= 1e-6
    for k in ("w1", "b1", "w2", "b2"):
        assert err(jpp[k], tpp[k]) <= 1e-5
    jm = jtrain.probe_mae(jpp, taps, rem, cfg.probe)
    tm = ttrain.probe_mae(tpp, taps, rem, cfg.probe)
    assert abs(jm - tm) <= 1e-4 * jm
    uniform = float(np.mean(np.abs(np.mean(bin_means(cfg.probe)) - rem)))
    assert tm < uniform


def test_train_probe_draws_its_own_init():
    cfg = pair("trail-llama")[0]
    _, (taps, rem) = harvested()
    pp, hist = ttrain.train_probe(taps, rem, cfg.probe, cfg.d_model,
                                  ttrain.ProbeTrainConfig(epochs=2),
                                  device="cpu")
    assert len(hist) == 2 and hist[-1]["loss"] < hist[0]["loss"]
    assert pp["w1"].shape == (cfg.d_model, cfg.probe.hidden)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_in_jax(arch, tmp_path):
    """``params_to_jax`` + ``save`` write what the reference's ``restore``
    reads back into the tree of its ``Model.init``, exactly; and the port
    reads the file back with ``load_npz``. A bfloat16 leaf keeps its
    dtype both ways."""
    cfg, _, params, tm, masters = pair(arch)
    path = str(tmp_path / "ckpt" / "p.npz")
    tree = {"params": params_to_jax(tm.cfg, masters),
            "extra": [torch.ones(3, dtype=torch.bfloat16), torch.arange(4)]}
    tckpt.save(path, tree)
    assert os.listdir(tmp_path / "ckpt") == ["p.npz"]    # no temp file left
    restored = jckpt.restore(path)
    assert (jax.tree.structure(restored["params"])
            == jax.tree.structure(params))
    for j, r in zip(jax.tree.leaves(params),
                    jax.tree.leaves(restored["params"])):
        assert r.dtype == j.dtype and np.array_equal(np.asarray(j), r)
    assert restored["extra"][0].dtype == jnp.bfloat16
    assert isinstance(restored["extra"], list)
    back = load_npz(path)
    assert back["extra"][0].dtype == torch.bfloat16
    for k, v in params_from_jax(tm.cfg, back["params"]).items():
        assert torch.equal(v, masters[k])


def test_restore_is_load_npz(tmp_path):
    """The port reads a checkpoint under the reference's name, ``restore``,
    into the same tree as ``load_npz``: here one the reference wrote."""
    path = str(tmp_path / "r.npz")
    jckpt.save(path, {"a": jnp.arange(3, dtype=jnp.bfloat16),
                      "b": (np.ones((2, 2), np.float32), [np.int32(7)])})
    got, want = tckpt.restore(path), tckpt.load_npz(path)
    assert isinstance(got["b"], tuple) and isinstance(got["b"][1], list)
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"], want["a"])
    assert torch.equal(got["b"][0], want["b"][0])
    assert torch.equal(got["b"][1][0], want["b"][1][0])


def test_default_opt_config_and_train_step_for():
    for arch in ("trail-llama", "arctic-480b"):
        from repro.config import get_config
        from repro_torch.config import get_config as port_config
        assert (dataclasses.asdict(jsteps.default_opt_config(get_config(arch)))
                == dataclasses.asdict(
                    tsteps.default_opt_config(port_config(arch))))
    cfg, _, _, tm, masters = pair("trail-llama")
    step = tsteps.make_train_step_for(tm)
    tokens, labels = one_batch(cfg)
    opt_state = topt.init(tsteps.default_opt_config(tm.cfg), masters)
    new, opt_state, m = step(masters, opt_state, {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)})
    assert int(opt_state["step"]) == 1 and torch.isfinite(m["loss"])
    assert set(new) == set(masters)


def test_launch_train_main(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu``, run
    in-process: one JSON line per logged step, the weights loaded into
    the returned model, and a checkpoint the reference restores into the
    tree of its ``Model.init``."""
    path = str(tmp_path / "t.npz")
    before = dict(ops.launches)
    model, params, hist = tlaunch.main([
        "--arch", "trail-llama", "--smoke", "--steps", "3", "--batch", "2",
        "--seq", "96", "--device", "cpu", "--ckpt", path])
    assert ops.launches == before          # no kernel launched on the CPU
    out = capsys.readouterr().out.splitlines()
    assert len(hist) == 2 and [r["step"] for r in hist] == [0, 2]
    assert out[-1] == f"saved {path}" and len(out) == 3
    assert all(np.isfinite(r["loss"]) for r in hist)
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k].to(v.dtype))
    cfg = get_smoke_config("trail-llama")
    ref_tree = jax.eval_shape(JaxModel(cfg).init, jax.random.key(0))
    restored = jckpt.restore(path)["params"]
    assert jax.tree.structure(restored) == jax.tree.structure(ref_tree)
    for r, s in zip(jax.tree.leaves(restored), jax.tree.leaves(ref_tree)):
        assert r.shape == s.shape and r.dtype == s.dtype


def test_launch_train_main_trains_mamba2_on_the_cpu():
    """The launcher trains the Mamba-2 smoke model (the SSM layers'
    backward through ``SSDScan``) on the CPU: finite losses, the weights
    in the returned model, no kernel launched."""
    before = dict(ops.launches)
    model, params, hist = tlaunch.main([
        "--arch", "mamba2-370m", "--smoke", "--steps", "4", "--batch", "2",
        "--seq", "96", "--device", "cpu"])
    assert ops.launches == before
    assert [r["step"] for r in hist] == [0, 3]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k].to(v.dtype))
