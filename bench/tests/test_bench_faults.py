"""A run whose timed path is broken underneath comes out not correct: once
for each fault a served cell can have. (There is no exchange between chips
to leave out: every cell runs on one.)"""

import pytest
import torch
from test_bench_rehearsal import MIX, rehearse


def state_unchanged(run):
    """Each decode megastep hands the next one the cache lengths it was
    given: the step's keys and values are written, then forgotten."""
    orig = run.model.decode_multi

    def step(cache, *a, **k):
        keep = cache["lengths"].clone()
        out = orig(cache, *a, **k)
        cache["lengths"].copy_(keep)
        return out
    run.model.decode_multi = step


def half_batch(run):
    """Every other row of the batch (of the rows decoding) is left out of
    every decode megastep."""
    orig = run.model.decode_multi

    def step(cache, tokens, active, budget, **k):
        rows = active.nonzero()[:, 0]
        active = active.clone()
        active[rows[1::2]] = False
        return orig(cache, tokens, active, budget, **k)
    run.model.decode_multi = step


def token_altered(run):
    """The first token of every row of every megastep is replaced by the
    next id where it is produced."""
    orig = run.model.decode_multi
    vocab = run.vocab

    def step(*a, **k):
        toks, cache, probs, n = orig(*a, **k)
        first = toks[:, :1]
        toks = torch.cat([torch.where(first >= 0, (first + 1) % vocab,
                                      first), toks[:, 1:]], dim=1)
        return toks, cache, probs, n
    run.model.decode_multi = step


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered])
@pytest.mark.parametrize("workload", sorted(MIX))
def test_a_broken_step_is_not_correct(workload, fault):
    line = rehearse(workload, fault=fault)
    assert line["correct"] is False
    bad = [n for n, c in line["checks"].items() if c["value"] > c["limit"]]
    assert bad, line["checks"]
