"""Prediction providers: `LengthPredictor` and its strategy family.

Every provider implements the same three-hook protocol (duck-typed; no
ABC so sim-mode providers stay dependency-free):

  initial(req)                 -> r0 (prompt-only prediction, pre-forward)
  on_prefill(req, tap_mean)    -> prediction from the prompt-phase embedding
  on_token(req, probe_probs)   -> updated predicted-remaining length

plus two class-level contracts the engine consults:

  provides_magnitude  — True when predictions are remaining-token
      *magnitudes* (usable for the preemption budget a0, megastep
      lookahead pinning, and the router's predicted-work backlog);
      False for rank-only strategies whose values are ordinal scores
      (the engine then requires the rank-aware scheduler policy and
      falls back to priors for backlog).
  cost accounting     — each strategy declares the FLOPs an external
      implementation of it would spend per call (`flops_initial`,
      `flops_refine`, `flops_per_prompt_token`); calls accumulate into
      ``cost_flops_pending``, which the engine drains every step and
      converts to seconds through `CostModel.predictor_time`, charging
      the simulated clock. The recycled-embedding strategies charge
      zero: their probe rides inside the decode megastep, which is the
      paper's whole point.

Strategy family (``STRATEGIES``; build by name via `make_predictor`):

  * ``trail-probe``  — the existing recycled-embedding probe. In sim
    mode this is `OraclePredictor` (models a trained probe's
    *statistics* around the ground truth — ``temp`` controls probe
    sharpness, ``bert_sigma`` the one-shot prompt-only error); in real
    mode `ProbePredictor` consumes the fused probe outputs.
  * ``oracle``       — `ExactOraclePredictor`: perfect lengths, the
    scheduling-gain upper bound.
  * ``noisy-oracle`` — `NoisyOraclePredictor`: oracle with configurable
    multiplicative lognormal error (the prediction-quality dial).
  * ``bucketed``     — `BucketedOraclePredictor`: the paper's k-bin
    quantization of the oracle (bin-mean predictions).
  * ``prompt-only``  — `PromptOnlyPredictor`: one-shot admission-time
    estimate from an external prompt model (the BERT-baseline regime);
    never refined, charged per prompt token.
  * ``rank-only``    — `RankOnlyPredictor`: learning-to-rank (Fu et
    al., arXiv:2408.15792) — total-order scores, no magnitudes;
    consumed by the scheduler's ``rank`` policy.
  * ``iterative``    — `IterativePredictor`: ELIS-style re-prediction
    (Choi et al., arXiv:2505.09142) every r probe boundaries through a
    proxy estimator; predictions age deterministically in between.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from repro_torch.config import ProbeConfig
from repro_torch.core import predictor as probe_mod
from repro_torch.core.bins import bin_means
from repro_torch.core.smoothing import bayes_update, transition_matrix

#: Strategy names accepted by `make_predictor` (and the CLI/benchmark
#: ``--predictor`` spec syntax ``name[:key=value,...]``).
STRATEGIES = ("trail-probe", "oracle", "noisy-oracle", "bucketed",
              "prompt-only", "rank-only", "iterative")

#: Default proxy-model size for externally-priced strategies: a
#: BERT-base-sized estimator (~110M params), 2*N FLOPs per token.
PROXY_FLOPS_PER_TOKEN = 2.0 * 110e6


class PredictorBase:
    """Shared Bayesian-filter plumbing + `LengthPredictor` defaults.

    The defaults: magnitude predictions, zero charged cost.
    """

    #: predictions are remaining-length magnitudes (tokens); rank-only
    #: strategies override to False and emit ordinal scores instead
    provides_magnitude = True
    #: FLOPs an external implementation would charge per call class;
    #: zero everywhere by default (recycled embeddings / free oracles)
    flops_initial = 0.0
    flops_refine = 0.0
    flops_per_prompt_token = 0.0

    def __init__(self, pc: ProbeConfig):
        self.pc = pc
        self.T = np.asarray(transition_matrix(pc))
        self.means = bin_means(pc)
        self.cost_flops_pending = 0.0   # drained by the engine each step
        self.cost_flops_total = 0.0
        self.cost_calls = 0

    def charge(self, flops: float):
        """Book ``flops`` of predictor work (drained by `take_cost_flops`)."""
        self.cost_calls += 1
        if flops:
            self.cost_flops_pending += flops
            self.cost_flops_total += flops

    def take_cost_flops(self) -> float:
        """Return and clear the FLOPs charged since the last drain."""
        f = self.cost_flops_pending
        self.cost_flops_pending = 0.0
        return f

    def expected(self, q) -> float:
        """Expected remaining length under a bin posterior ``q``."""
        return float(np.dot(np.asarray(q), self.means))

    def _filter(self, req, p_t):
        q = np.asarray(req.posterior)
        prior = self.T @ q
        post = prior * np.asarray(p_t)
        z = post.sum()
        req.posterior = post / z if z > 0 else prior
        return self.expected(req.posterior)


class OraclePredictor(PredictorBase):
    """Sim-mode stand-in for a trained probe.

    Models the probe's *statistics* around the ground-truth remaining
    length (see module docstring).
    """

    def __init__(self, pc: ProbeConfig, *, temp: float = 1.0,
                 bert_sigma: float = 0.9, flip_prob: float = 0.1,
                 seed: int = 0, refine: bool = True):
        super().__init__(pc)
        self.temp = temp
        self.bert_sigma = bert_sigma
        self.flip_prob = flip_prob
        self.refine = refine
        self.rng = random.Random(seed)

    def initial(self, req) -> float:
        """Prompt-only r0 estimate (the paper's one-shot "BERT" regime)."""
        # prompt-only "BERT" prediction: multiplicative lognormal error
        err = self.rng.lognormvariate(0.0, self.bert_sigma)
        r0 = min(max(req.true_out_len * err, 1.0), self.pc.max_len)
        req.posterior = self._probs_around(r0)
        return float(r0)

    def on_prefill(self, req, tap_mean=None) -> float:
        """Prompt-phase probe posterior at the end of prefill."""
        # prefill-phase probe: sharper than BERT (paper Figure 3, t=0 point)
        rem = req.true_out_len
        req.posterior = self._probs_around(self._noisy(rem))
        return self.expected(req.posterior)

    def on_token(self, req, probe_probs=None) -> float:
        """Per-token refinement (or r0 - age when refinement is off)."""
        if not self.refine:
            return max(float(req.entry.r0) - req.entry.age, 0.0)
        rem = max(req.true_out_len - len(req.generated), 0)
        p_t = self._probs_around(self._noisy(rem))
        return self._filter(req, p_t)

    def _noisy(self, rem: float) -> float:
        if self.rng.random() < self.flip_prob:
            rem = rem * self.rng.lognormvariate(0.0, 0.5)
        return rem

    def _probs_around(self, length: float) -> np.ndarray:
        b = min(int(length / self.pc.bin_width), self.pc.num_bins - 1)
        idx = np.arange(self.pc.num_bins)
        logits = -np.abs(idx - b) / max(self.temp, 1e-3)
        e = np.exp(logits - logits.max())
        return e / e.sum()


class ProbePredictor(PredictorBase):
    """Uses the real probe outputs (fused into the decode step).

    ``probe_params`` is the model's probe (``{"w1", "b1", "w2", "b2"}``
    tensors) and ``embed_table`` its token-embedding table; both stay
    where the model keeps them. The pre-forward estimate indexes the
    table on its own device, so only the (d_model,) mean crosses to the
    host, never the table.
    """

    def __init__(self, pc: ProbeConfig, probe_params=None, embed_table=None):
        super().__init__(pc)
        self.probe_params = probe_params
        self.embed_table = embed_table     # for the pre-forward r0 estimate

    def _posterior(self, x) -> np.ndarray:
        w1 = self.probe_params["w1"]
        x = torch.as_tensor(x, dtype=torch.float32).to(w1.device)
        with torch.no_grad():
            logits = probe_mod.apply_probe(self.probe_params, x).cpu().numpy()
        p = np.exp(logits - logits.max())
        return p / p.sum()

    def initial(self, req) -> float:
        """Pre-forward r0 from mean prompt embeddings through the probe."""
        if self.probe_params is None or self.embed_table is None:
            return self.pc.max_len / 2.0       # uninformative prior
        table = self.embed_table
        idx = torch.as_tensor(req.prompt, dtype=torch.long,
                              device=table.device)
        with torch.no_grad():
            emb = table[idx].float().mean(0)
        req.posterior = self._posterior(emb)
        return self.expected(req.posterior)

    def on_prefill(self, req, tap_mean) -> float:
        """Posterior from the prompt-phase tap mean (real probe output)."""
        req.posterior = self._posterior(np.asarray(tap_mean))
        return self.expected(req.posterior)

    def on_token(self, req, probe_probs) -> float:
        """Bayes-update with the device-computed probe posterior."""
        return self._filter(req, np.asarray(probe_probs))


# ---------------------------------------------------------------------------
# the strategy family (sim-mode; see module docstring)
# ---------------------------------------------------------------------------

class ExactOraclePredictor(PredictorBase):
    """Perfect length predictions — the scheduling-gain upper bound.

    Every hook returns the exact ground-truth remaining length; cost is
    zero (nothing real computes this). Any realizable predictor's
    scheduling gain is bounded above by this strategy's.
    """

    def initial(self, req) -> float:
        """Exact total output length."""
        return float(max(req.true_out_len, 1))

    def on_prefill(self, req, tap_mean=None) -> float:
        """Exact remaining length at the end of prefill."""
        return float(max(req.true_out_len - len(req.generated), 0))

    def on_token(self, req, probe_probs=None) -> float:
        """Exact remaining length after each probe boundary."""
        return float(max(req.true_out_len - len(req.generated), 0))


class NoisyOraclePredictor(PredictorBase):
    """Oracle with configurable multiplicative error — the quality dial.

    Every prediction is ``truth * lognormal(0, sigma)`` (a fresh draw
    per call), clipped to the probe range. ``sigma`` sweeps continuously
    from the oracle (0.0) to worse-than-prompt-only (>1.0); at
    ``sigma -> 0`` the induced queue ordering converges to the oracle
    ordering (pinned by a hypothesis property test).
    """

    def __init__(self, pc: ProbeConfig, *, sigma: float = 0.6, seed: int = 0):
        super().__init__(pc)
        self.sigma = float(sigma)
        self.rng = random.Random(seed)

    def _noisy(self, truth: float) -> float:
        err = self.rng.lognormvariate(0.0, self.sigma) if self.sigma else 1.0
        return min(max(truth * err, 0.0), float(self.pc.max_len))

    def initial(self, req) -> float:
        """Noisy total output length."""
        return max(self._noisy(float(req.true_out_len)), 1.0)

    def on_prefill(self, req, tap_mean=None) -> float:
        """Noisy remaining length at the end of prefill."""
        return self._noisy(max(req.true_out_len - len(req.generated), 0))

    def on_token(self, req, probe_probs=None) -> float:
        """Noisy remaining length after each probe boundary."""
        return self._noisy(max(req.true_out_len - len(req.generated), 0))


class BucketedOraclePredictor(PredictorBase):
    """The paper's k-bin quantization of the oracle (Section 3.1 regime).

    Predictions are the bin *means* of equal-width bins over
    ``[0, max_len]`` — exactly the information a perfectly-trained
    k-class probe could express. ``bins`` dials quantization coarseness
    independently of noise (2 bins ≈ short/long classification).
    """

    def __init__(self, pc: ProbeConfig, *, bins: int = 0):
        super().__init__(pc)
        self.bins = int(bins) if bins else pc.num_bins
        if self.bins < 1:
            raise ValueError("bucketed predictor needs >= 1 bin")
        self.width = float(pc.max_len) / self.bins

    def _quantize(self, truth: float) -> float:
        b = min(int(truth / self.width), self.bins - 1)
        return self.width * (b + 0.5)

    def initial(self, req) -> float:
        """Bin mean holding the total output length."""
        return self._quantize(float(max(req.true_out_len, 1)))

    def on_prefill(self, req, tap_mean=None) -> float:
        """Bin mean holding the remaining length at end of prefill."""
        return self._quantize(max(req.true_out_len - len(req.generated), 0))

    def on_token(self, req, probe_probs=None) -> float:
        """Bin mean holding the current remaining length."""
        return self._quantize(max(req.true_out_len - len(req.generated), 0))


class PromptOnlyPredictor(PredictorBase):
    """One-shot admission-time estimate, never refined.

    The paper's BERT-baseline regime: an external prompt model predicts
    once at admission. ``initial`` draws one multiplicative-lognormal estimate (the same
    error model as `OraclePredictor.initial`, so ``sigma`` is comparable)
    and charges a BERT-base-sized forward over the prompt; both later
    hooks just age the estimate deterministically (r0 - tokens served) —
    the information content never improves after admission.
    """

    flops_per_prompt_token = PROXY_FLOPS_PER_TOKEN

    def __init__(self, pc: ProbeConfig, *, sigma: float = 0.9, seed: int = 0):
        super().__init__(pc)
        self.sigma = float(sigma)
        self.rng = random.Random(seed)

    def initial(self, req) -> float:
        """One noisy prompt-model estimate; charged per prompt token."""
        self.charge(self.flops_per_prompt_token * len(req.prompt))
        err = self.rng.lognormvariate(0.0, self.sigma) if self.sigma else 1.0
        return min(max(req.true_out_len * err, 1.0), float(self.pc.max_len))

    def on_prefill(self, req, tap_mean=None) -> float:
        """No refinement: the aged admission estimate."""
        return max(float(req.entry.r0) - req.entry.age, 0.0)

    def on_token(self, req, probe_probs=None) -> float:
        """No refinement: the aged admission estimate."""
        return max(float(req.entry.r0) - req.entry.age, 0.0)


class RankOnlyPredictor(PredictorBase):
    """Learning-to-rank scheduling signal (Fu et al., arXiv:2408.15792):

    a total order over the queue with **no magnitudes**.

    Scores are a strictly monotone, scale-free transform of the (noisy)
    remaining length — ``log1p`` normalized into [0, 1] — so comparing
    two scores reproduces the true ordering but no score is a token
    count: the engine must not use them for preemption budgets,
    lookahead pinning, or backlog sums (``provides_magnitude = False``
    enforces this; only the scheduler's ``rank`` policy consumes them).
    ``noise`` is the ranker-error dial: multiplicative lognormal
    perturbation before scoring, so pairwise inversions grow with it.
    With ``noise=0`` the induced `select_batch` ordering is identical
    to magnitude-SRPT (pinned by tests).
    """

    provides_magnitude = False

    def __init__(self, pc: ProbeConfig, *, noise: float = 0.0, seed: int = 0):
        super().__init__(pc)
        self.noise = float(noise)
        self.rng = random.Random(seed)
        self._norm = math.log1p(float(pc.max_len))

    def _score(self, value: float) -> float:
        if self.noise:
            value = value * self.rng.lognormvariate(0.0, self.noise)
        return math.log1p(max(value, 0.0)) / self._norm

    def initial(self, req) -> float:
        """Ordinal score of the total output length."""
        return self._score(float(max(req.true_out_len, 1)))

    def on_prefill(self, req, tap_mean=None) -> float:
        """Ordinal score of the remaining length at end of prefill."""
        return self._score(max(req.true_out_len - len(req.generated), 0))

    def on_token(self, req, probe_probs=None) -> float:
        """Ordinal score of the current remaining length."""
        return self._score(max(req.true_out_len - len(req.generated), 0))


class IterativePredictor(PredictorBase):
    """ELIS-style iterative re-prediction (Choi et al., arXiv:2505.09142):

    a proxy estimator re-predicts the remaining length every ``period``
    probe boundaries; predictions age deterministically in between.

    ``period`` is the staleness dial (1 = re-predict at every boundary,
    the freshest and most expensive; large = admission-estimate-like).
    Each re-prediction draws a fresh ``sigma``-lognormal error around
    the true remaining length and charges one proxy-token forward.
    """

    flops_initial = PROXY_FLOPS_PER_TOKEN
    flops_refine = PROXY_FLOPS_PER_TOKEN

    def __init__(self, pc: ProbeConfig, *, period: int = 8,
                 sigma: float = 0.3, seed: int = 0):
        super().__init__(pc)
        if period < 1:
            raise ValueError("iterative predictor needs period >= 1")
        self.period = int(period)
        self.sigma = float(sigma)
        self.rng = random.Random(seed)
        self._boundaries: dict[int, int] = {}   # rid -> probe-boundary count

    def _estimate(self, truth: float) -> float:
        err = self.rng.lognormvariate(0.0, self.sigma) if self.sigma else 1.0
        return min(max(truth * err, 0.0), float(self.pc.max_len))

    def initial(self, req) -> float:
        """Admission-time proxy estimate (one charged proxy forward)."""
        self.charge(self.flops_initial)
        self._boundaries[req.rid] = 0
        return max(self._estimate(float(req.true_out_len)), 1.0)

    def on_prefill(self, req, tap_mean=None) -> float:
        """Fresh proxy re-prediction at the end of prefill (charged)."""
        self.charge(self.flops_refine)
        return self._estimate(max(req.true_out_len - len(req.generated), 0))

    def on_token(self, req, probe_probs=None) -> float:
        """Re-predict every ``period``-th boundary, else age the estimate."""
        c = self._boundaries.get(req.rid, 0) + 1
        self._boundaries[req.rid] = c
        if c % self.period:
            return max(float(req.entry.pred_remaining) - 1.0, 0.0)
        self.charge(self.flops_refine)
        return self._estimate(max(req.true_out_len - len(req.generated), 0))


# ---------------------------------------------------------------------------
# strategy factory
# ---------------------------------------------------------------------------

def parse_spec(spec: str) -> tuple[str, dict]:
    """Parse a predictor spec string ``name[:key=value,...]``.

    Values parse as int when possible, else float, else string — e.g.
    ``"noisy-oracle:sigma=0.5"`` -> ``("noisy-oracle", {"sigma": 0.5})``.
    """
    name, _, argstr = spec.partition(":")
    kwargs: dict = {}
    for kv in filter(None, argstr.split(",")):
        if "=" not in kv:
            raise ValueError(f"bad predictor spec argument {kv!r} "
                             f"(want key=value)")
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        kwargs[k.strip()] = v
    return name.strip(), kwargs


def make_predictor(spec: str, pc: ProbeConfig, *, seed: int = 0):
    """Build a sim-mode predictor from a strategy spec string.

    ``spec`` is ``name[:key=value,...]`` with ``name`` in `STRATEGIES`;
    unknown keys raise (strategies are keyword-strict). ``trail-probe``
    returns the engine's legacy default `OraclePredictor` with identical
    constructor arguments, so selecting it explicitly is byte-identical
    to not selecting a strategy at all. Real-mode engines keep building
    `ProbePredictor` directly (it needs live probe params).
    """
    name, kwargs = parse_spec(spec)
    classes = {
        "trail-probe": OraclePredictor,
        "oracle": ExactOraclePredictor,
        "noisy-oracle": NoisyOraclePredictor,
        "bucketed": BucketedOraclePredictor,
        "prompt-only": PromptOnlyPredictor,
        "rank-only": RankOnlyPredictor,
        "iterative": IterativePredictor,
    }
    if name not in classes:
        raise ValueError(f"unknown predictor strategy {name!r}; "
                         f"choose from {STRATEGIES}")
    cls = classes[name]
    if cls in (ExactOraclePredictor, BucketedOraclePredictor):
        return cls(pc, **kwargs)            # deterministic: no seed knob
    return cls(pc, seed=seed, **kwargs)
