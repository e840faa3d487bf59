"""The port's fused serve step against the reference ``make_serve_step``.

Same weights (``params_from_jax``), same numpy inputs, float32 smoke
configs: after a prefill, several serve steps each give equal greedy
tokens, and posteriors and predicted remaining lengths within 1e-4 (the
probe and filter run in one ``ops.probe_update`` call in the port, as
plain jnp in the reference). The prefill step is the model's chunked
prefill.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke_config
from repro.launch import steps as jax_steps
from repro.models.model import Model as JaxModel
from repro_torch.config import get_smoke_config as port_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.model import Model, params_from_jax

B, MAX_LEN = 3, 48


@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-3-8b"])
def test_serve_step_matches_jax(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jm = JaxModel(cfg)
    params = jm.init(jax.random.key(0))
    pcfg = dataclasses.replace(port_smoke_config(arch), dtype="float32")
    tm = Model(pcfg, device="cpu")
    tm.load_state_dict(params_from_jax(
        pcfg, jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(7)
    tokens = rng.integers(4, cfg.vocab_size, (B, 20)).astype(np.int32)
    jl, jc, _, _ = jax.jit(jm.prefill_chunk)(
        params, jm.init_cache(B, MAX_LEN), jnp.asarray(tokens))
    tl, tc, _, _ = steps.make_prefill_step(tm)(tm.init_cache(B, MAX_LEN),
                                               torch.from_numpy(tokens))
    assert float(np.abs(np.asarray(jl) - tl.numpy()).max()) < 1e-4
    k = cfg.probe.num_bins
    q_prev = rng.dirichlet(np.ones(k), size=B).astype(np.float32)
    jstep = jax.jit(jax_steps.make_serve_step(jm))
    tstep = steps.make_serve_step(tm)
    jtok = jnp.asarray(np.asarray(jnp.argmax(jl, -1))[:, None], jnp.int32)
    ttok = tl.argmax(-1).to(torch.int32)[:, None]
    jq, tq = jnp.asarray(q_prev), torch.from_numpy(q_prev)
    for _ in range(4):
        jn, jc, jq, jr = jstep(params, jc, jtok, jq)
        tn, tc, tq, tr = tstep(tc, ttok, tq)
        assert np.array_equal(np.asarray(jn), tn.numpy())
        assert float(np.abs(np.asarray(jq) - tq.numpy()).max()) < 1e-4
        assert float(np.abs(np.asarray(jr) - tr.numpy()).max()) < 1e-4
        assert torch.isfinite(tr).all()
        jtok, ttok = jn[:, None], tn[:, None]
    assert tc["lengths"].tolist() == [24] * B


def test_serve_step_runs_the_probe_once_through_the_fused_op(monkeypatch):
    """The step's probe MLP, softmax and filter are one probe_update call
    on the decode tap; the plain probe of decode_step does not also run."""
    from repro_torch.core import predictor
    cfg = dataclasses.replace(port_smoke_config("granite-3-8b"),
                              dtype="float32")
    m = Model(cfg, device="cpu").init(seed=2)
    calls = []
    real = ops.probe_update
    monkeypatch.setattr(ops, "probe_update",
                        lambda *a: calls.append(a) or real(*a))
    monkeypatch.setattr(predictor, "apply_probe", lambda *a: pytest.fail(
        "the plain probe ran in the serve step"))
    cache = m.init_cache(2, 16)
    q = torch.full((2, cfg.probe.num_bins), 1.0 / cfg.probe.num_bins)
    nxt, cache, q_new, pred = steps.make_serve_step(m)(
        cache, torch.tensor([[5], [9]], dtype=torch.int32), q)
    assert len(calls) == 1 and calls[0][0].shape == (2, cfg.d_model)
    assert torch.allclose(q_new.sum(-1), torch.ones(2))
    assert nxt.dtype == torch.int32 and pred.shape == (2,)
