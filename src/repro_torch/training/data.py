"""Synthetic instruction-following data and the probe-data harvest (the
reference ``repro.training.data``).

No Alpaca offline, so sequences are synthesized with the same structure:

    [BOS, prompt..., SEP, response..., EOS, PAD...]

Prompt and response lengths follow right-skewed lognormals (responses
clipped at ``max_out``). To make output length learnable, as in real
models where the prompt statistically determines the response length, a
"topic" token at the start of the prompt sets the response-length regime,
plus noise; response tokens repeat topic-conditioned patterns so the tap
embeddings carry state about progress.

``batches`` is numpy and a copy of the reference's (the same seed gives
the same batches). Each batch holds:
  tokens    (B, S) int32
  labels    (B, S) int32   next-token targets, -1 on prompt/pad
  remaining (B, S) int32   remaining response tokens at each position,
                            -1 outside the response span (probe labels)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

BOS, EOS, SEP, PAD = 1, 2, 3, 0
N_TOPICS = 8
TOPIC_BASE = 4                      # token ids [4, 4+N_TOPICS) are topics


@dataclass(frozen=True)
class DataConfig:
    """Shape and distribution knobs for the synthetic data stream."""

    vocab: int = 32000
    seq_len: int = 512
    batch: int = 8
    prompt_mean: float = 44.0
    prompt_sigma: float = 0.6
    out_sigma: float = 0.35         # within-topic length spread
    max_out: int = 448
    seed: int = 0


def topic_median_len(topic: int, dc: DataConfig) -> float:
    """Topic t's median response length: geometric ladder over [8, max_out]."""
    lo, hi = 8.0, float(dc.max_out)
    f = topic / max(N_TOPICS - 1, 1)
    return lo * (hi / lo) ** f


def sample_example(rng: np.random.Generator, dc: DataConfig):
    """Draw one (topic, prompt, response) example from the topic ladder."""
    topic = int(rng.integers(0, N_TOPICS))
    plen = int(np.clip(rng.lognormal(math.log(dc.prompt_mean),
                                     dc.prompt_sigma), 4, dc.seq_len // 3))
    rlen = int(np.clip(rng.lognormal(math.log(topic_median_len(topic, dc)),
                                     dc.out_sigma), 1, dc.max_out))
    room = dc.seq_len - plen - 3
    rlen = max(1, min(rlen, room))
    prompt = rng.integers(16, dc.vocab, size=plen)
    prompt[0] = TOPIC_BASE + topic
    # topic-conditioned periodic response (progress is decodable from context)
    period = 3 + topic
    resp = 16 + ((np.arange(rlen) % period) * 37 + topic * 101) % (dc.vocab - 16)
    return topic, prompt, resp


def batches(dc: DataConfig, n_batches: int):
    """Yield ``n_batches`` token/label/remaining batches (see module doc)."""
    rng = np.random.default_rng(dc.seed)
    for _ in range(n_batches):
        tokens = np.full((dc.batch, dc.seq_len), PAD, np.int32)
        labels = np.full((dc.batch, dc.seq_len), -1, np.int32)
        remaining = np.full((dc.batch, dc.seq_len), -1, np.int32)
        for b in range(dc.batch):
            _, prompt, resp = sample_example(rng, dc)
            seq = np.concatenate([[BOS], prompt, [SEP], resp, [EOS]])
            L = len(seq)
            tokens[b, :L] = seq
            # next-token labels over the response span (incl. EOS)
            start = 1 + len(prompt) + 1            # index of first resp token
            for i in range(start - 1, L - 1):
                labels[b, i] = seq[i + 1]
            # probe labels: remaining response tokens AFTER position i
            for i in range(start - 1, L - 1):
                remaining[b, i] = (L - 1) - (i + 1)
        yield {"tokens": tokens, "labels": labels, "remaining": remaining}


def harvest_probe_data(model, dc: DataConfig, n_batches: int):
    """Run ``model.forward_train`` on ``n_batches`` batches and collect the
    (tap embedding, remaining length) pairs of every response token, as
    float32 and int32 numpy arrays.

    This is the paper's profiling step (Section 3.1 "Focused profiling").
    It runs under ``torch.inference_mode()`` on the model's device and
    selects the response positions there, so only those taps are copied
    to the host.
    """
    xs, ys = [], []
    dev = model.device
    with torch.inference_mode():
        for batch in batches(dc, n_batches):
            _, aux = model.forward_train(
                {"tokens": torch.from_numpy(batch["tokens"]).to(dev),
                 "labels": torch.from_numpy(batch["labels"]).to(dev)})
            rem = batch["remaining"]
            mask = torch.from_numpy(rem >= 0).to(dev)
            xs.append(aux["tap"][mask].float().cpu().numpy())
            ys.append(rem[rem >= 0])
    return np.concatenate(xs), np.concatenate(ys)
