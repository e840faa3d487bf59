"""The port's ``core/queueing.py`` (Lemma 1's closed form) and
``core/simulation.py`` (the discrete-event M/G/1 simulator) against the
reference's at a few (lambda, C) points: pure numpy and ``random`` on
both sides, so the results are equal exactly. One cross-check of the
port's closed form against its own simulator, at the reference suite's
15% tolerance."""

import dataclasses

import pytest

from repro.core import queueing as jq
from repro.core import simulation as jsim
from repro_torch.core import queueing as tq
from repro_torch.core import simulation as tsim

POINTS = [(0.3, 0.2), (0.5, 0.8), (0.7, 1.0), (0.85, 0.5)]


@pytest.mark.parametrize("prediction", ["exponential", "perfect"])
@pytest.mark.parametrize("lam,C", POINTS)
def test_mean_response_equals_the_reference(lam, C, prediction):
    """On a coarser grid than the default (120 points, 12 sizes), which
    both packages take alike, so the exponential model stays quick."""
    kw = dict(lam=lam, C=C, prediction=prediction, n_grid=120)
    want = jq.mean_response(jq.MG1Config(**kw), n_xr=12)
    got = tq.mean_response(tq.MG1Config(**kw), n_xr=12)
    assert got == want and got > 0.5
    jl, tl = jq.Lemma1(jq.MG1Config(**kw)), tq.Lemma1(tq.MG1Config(**kw))
    for x, r in ((0.5, 0.5), (1.0, 2.0), (3.0, 0.7)):
        assert tl.response_xr(x, r) == jl.response_xr(x, r)


def test_sweep_c_equals_the_reference():
    cs = (0.1, 0.5, 1.0)
    assert (tq.sweep_C(0.6, cs, prediction="perfect")
            == jq.sweep_C(0.6, cs, prediction="perfect"))


@pytest.mark.parametrize("policy", ["fcfs", "sjf", "srpt", "sprpt-lp"])
@pytest.mark.parametrize("lam,C", POINTS)
def test_simulate_equals_the_reference(policy, lam, C):
    kw = dict(C=C, n_jobs=3000, prediction="exponential", seed=4)
    want = jsim.simulate(policy, lam, **kw)
    got = tsim.simulate(policy, lam, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_lemma1_matches_the_ports_simulator():
    th = tq.mean_response(tq.MG1Config(lam=0.5, C=0.8,
                                       prediction="perfect"))
    sim = tsim.simulate("sprpt-lp", 0.5, C=0.8, n_jobs=30000,
                        prediction="perfect", seed=5).mean_response
    assert sim == pytest.approx(th, rel=0.15)
