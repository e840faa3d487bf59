"""The port's probe math (bins, Bayes filter, probe MLP, scheduler copy)
against the JAX package on the same numpy inputs. All float32; tolerance
1e-6 (one float32 rounding of O(1) values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ProbeConfig
from repro.core import bins as jbins
from repro.core import predictor as jpred
from repro.core import scheduler as jsched
from repro.core import smoothing as jsmooth
from repro_torch.config import ProbeConfig as PortProbeConfig
from repro_torch.core import bins, predictor, scheduler, smoothing

PCS = [(10, 512), (5, 64), (16, 1024)]


def pcs(k, max_len):
    return (ProbeConfig(num_bins=k, max_len=max_len),
            PortProbeConfig(num_bins=k, max_len=max_len))


@pytest.mark.parametrize("k,max_len", PCS)
def test_bins_and_transition_matrix(k, max_len):
    jpc, pc = pcs(k, max_len)
    assert np.array_equal(bins.bin_means(pc), jbins.bin_means(jpc))
    assert np.array_equal(bins.log_bin_edges(pc), jbins.log_bin_edges(jpc))
    assert np.array_equal(smoothing.transition_matrix(pc),
                          jsmooth.transition_matrix(jpc))
    lengths = np.array([0, 1, 50, 63, 64, 500, 2000])
    assert np.array_equal(bins.bin_index(torch.from_numpy(lengths), pc),
                          np.asarray(jbins.bin_index(lengths, jpc)))
    assert np.array_equal(bins.bin_index_log(torch.from_numpy(lengths), pc),
                          np.asarray(jbins.bin_index_log(lengths, jpc)))


@pytest.mark.parametrize("k,max_len", PCS)
def test_bayes_filter_and_expected_length(k, max_len):
    jpc, pc = pcs(k, max_len)
    rng = np.random.default_rng(k)
    q = rng.dirichlet(np.ones(k), size=4).astype(np.float32)
    p = rng.dirichlet(np.ones(k), size=4).astype(np.float32)
    p[1] = 0.0                      # posterior mass 0 -> the prior
    T = smoothing.transition_matrix(pc)
    got = smoothing.bayes_update(torch.from_numpy(q), torch.from_numpy(p), T)
    want = jsmooth.bayes_update(jnp.asarray(q), jnp.asarray(p), T)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6
    assert np.abs(smoothing.expected_length(got, pc).numpy()
                  - np.asarray(jsmooth.expected_length(want, jpc))).max() < 1e-3
    seq = rng.dirichlet(np.ones(k), size=6).astype(np.float32)
    assert np.abs(smoothing.refine_sequence(torch.from_numpy(seq), pc).numpy()
                  - np.asarray(jsmooth.refine_sequence(jnp.asarray(seq),
                                                       jpc))).max() < 1e-6


def test_probe_mlp_matches_jax():
    jpc, pc = pcs(10, 512)
    jp = jpred.init_probe(jax.random.key(0), 64, jpc)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32)
    assert np.abs(predictor.apply_probe(p, torch.from_numpy(x)).numpy()
                  - np.asarray(jpred.apply_probe(jp, x))).max() < 1e-5
    assert np.abs(predictor.probe_probs(p, torch.from_numpy(x)).numpy()
                  - np.asarray(jpred.probe_probs(jp, x))).max() < 1e-6
    labels = np.array([0, 3, 9, 2, 2], np.int32)
    assert abs(float(predictor.probe_loss(p, torch.from_numpy(x),
                                          torch.from_numpy(labels)))
               - float(jpred.probe_loss(jp, x, jnp.asarray(labels)))) < 1e-5
    mine = predictor.init_probe(torch.Generator().manual_seed(0), 64, pc,
                                device="cpu")
    assert {k: v.shape for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}


def test_scheduler_is_a_copy():
    """Same ranking and batch selection on the same entries."""
    rng = np.random.default_rng(3)

    def entries(mod):
        out = {}
        for rid in range(12):
            e = mod.SchedEntry(rid=rid, arrival=float(rid) * 0.1,
                               prompt_len=int(rng.integers(5, 50)))
            e.r0 = e.pred_remaining = float(rng.integers(1, 200))
            e.finish_len = int(rng.integers(1, 200))
            e.state = mod.ReqState.RUNNING if rid % 3 == 0 else \
                mod.ReqState.WAITING
            e.age = int(rng.integers(0, 20))
            out[rid] = e
        return out

    state = rng.bit_generator.state
    a = entries(jsched)
    rng.bit_generator.state = state
    b = entries(scheduler)
    for policy in ("fcfs", "srpt", "trail", "trail-bert", "sjf", "mlfq"):
        da = jsched.select_batch(a, policy=policy, max_batch=4,
                                 mem_budget=1 << 30, bytes_fn=lambda e: 1)
        db = scheduler.select_batch(b, policy=policy, max_batch=4,
                                    mem_budget=1 << 30, bytes_fn=lambda e: 1)
        assert (da.scheduled, da.preempted, da.admitted) == (
            db.scheduled, db.preempted, db.admitted), policy
