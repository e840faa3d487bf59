"""What decides ``correct``: a sample of the served requests against the
plain reference.

Once the window has closed, a sample drawn from the seed of the requests
the run finished, the longest among them, is run through the reference
over each prompt and the tokens it was served. Two numbers are compared:

* ``logit_gap``: the widest gap by which a served token's logit lies below
  the reference's best at that position (greedy serving: 0 where the
  program and the reference agree; larger where rounding, or a fault,
  made the program pick another token);
* ``probe_gap``: the largest difference, in any bin, between the probe
  posterior the program handed its predictor and the reference's at the
  same position;
* ``logit_gap_mean`` and ``probe_gap_mean``: the same gaps averaged over
  the served tokens and over the probe's positions. Where a mixture of
  experts routes each token to its top k, a rounding that swaps the k-th
  and the next expert changes a token's output by a whole expert's share,
  in bfloat16 as in float8, so the widest gap is set by the largest such
  swap; how often swaps happen still follows the precision.

A cell's limits file names the numbers it compares. The reference is the
cell's: ``reference.Reference``, or the ``Reference`` of the model module
its configuration names (``harness.Models``).

The control (``quant="fp8"``) is the reference put in the program's place
one precision lower: its own first token at each position of the same
prompts and served tokens is read in the reference's logits, and its probe
posterior at the same positions.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def choose(reqs: list, seed: int, tokens: int, most: int) -> list:
    """The longest finished request (by tokens served, then the earliest),
    then others in an order drawn from the seed, until the sample holds
    ``tokens`` served tokens or ``most`` requests."""
    if not reqs:
        return []
    reqs = sorted(reqs, key=lambda r: (-len(r.generated), r.rid))
    rest = reqs[1:]
    random.Random(f"{seed}:sample").shuffle(rest)
    out, n = [reqs[0]], len(reqs[0].generated)
    for r in rest:
        if n >= tokens or len(out) >= most:
            break
        out.append(r)
        n += len(r.generated)
    return out


def _inputs(sample: list, probes: dict):
    seqs = [r.prompt + r.generated[:-1] for r in sample]
    starts = [len(r.prompt) - 1 for r in sample]
    taps = [[p for p, _ in probes.get(r.rid, ())] for r in sample]
    return seqs, starts, taps


def compare(reference, m: dict, views: dict, sample: list, probes: dict,
            quant: str | None = None) -> dict:
    """Readings of one sample: ``logit_gap`` and ``probe_gap`` of the
    program's served tokens and posteriors against ``reference`` (the
    class), or, with ``quant``, of the control's.

    ``probes`` maps a request id to its [(position, posterior)] as the
    program's predictor received them."""
    seqs, starts, taps = _inputs(sample, probes)
    ref = reference(m, views).run(seqs, starts, taps)
    if quant:
        ctl = reference(m, views, quant=quant).run(seqs, starts, taps)
    logit_gap = probe_gap = logit_sum = probe_sum = 0.0
    n_tokens = n_probes = 0
    for i, r in enumerate(sample):
        logits, post = ref[i]
        best = logits.max(dim=-1).values
        if quant:
            pick = ctl[i][0].argmax(dim=-1)
            other = ctl[i][1]
        else:
            pick = torch.tensor(r.generated, device=logits.device)
            got_post = [p for _, p in probes.get(r.rid, ())]
            other = (torch.from_numpy(np.stack(got_post)).float()
                     .to(logits.device) if got_post else post)
        gap = best - logits.gather(1, pick.long()[:, None])[:, 0]
        logit_gap = max(logit_gap, float(gap.max()))
        logit_sum += float(gap.sum())
        n_tokens += len(r.generated)
        if post.numel():
            diff = (other - post).abs().amax(dim=-1)
            probe_gap = max(probe_gap, float(diff.max()))
            probe_sum += float(diff.sum())
            n_probes += post.shape[0]
    return {"logit_gap": logit_gap, "probe_gap": probe_gap,
            "logit_gap_mean": logit_sum / max(n_tokens, 1),
            "probe_gap_mean": probe_sum / max(n_probes, 1),
            "requests": len(sample), "tokens": n_tokens, "probes": n_probes}
