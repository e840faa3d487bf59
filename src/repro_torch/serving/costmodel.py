"""Roofline-derived iteration cost model (simulated clock).

A copy of the reference ``repro.serving.costmodel``. The engine advances a
simulated clock (sim mode, and the latencies of real mode) using the same
three-term roofline as EXPERIMENTS.md section Roofline:

  t_iter = max(compute, memory) + fixed overhead

  compute = FLOPs / peak_flops          (2 * active_params per token
                                         + attention O(ctx) term)
  memory  = bytes / hbm_bw              (params once per iteration batch
                                         + the KV bytes actually touched)

Defaults model one TPU v5e chip (197 bf16 TFLOP/s, 819 GB/s) — substitute
A100 constants to mimic the paper's testbed. The absolute numbers are a
model; every claim we validate is a *ratio* between policies under the same
cost model, matching the paper's relative speedups.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.config import (KIND_LOCAL, KIND_SSM, KIND_SSM_MOE,
                                ModelConfig)
from repro_torch.serving.kv_cache import (bytes_for_context, page_bytes,
                                    paged_bytes_for_context)


@dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants for one accelerator (drives the simulated clock).

    Attributes:
        name: identifier recorded in benchmark artifacts.
        peak_flops: peak bf16 FLOP/s; the compute-roofline term. Lowering
            it models compute-bound serving, where iteration time scales
            with batch tokens (see benchmarks/cluster_curves.py).
        hbm_bw: HBM bytes/s; the memory-roofline term (params + KV).
        dma_bw: device<->host bytes/s (the KV swap path).
        link_bw: replica<->replica interconnect bytes/s (the KV handoff
            hop of prefill/decode disaggregation; ~200 Gb/s Ethernet by
            default).
        overhead_s: fixed per-iteration dispatch overhead in seconds.
    """

    name: str = "tpu-v5e"
    peak_flops: float = 197e12        # bf16
    hbm_bw: float = 819e9             # bytes/s
    dma_bw: float = 32e9              # device<->host (KV swap path)
    link_bw: float = 25e9             # replica<->replica (KV handoff hop)
    overhead_s: float = 2.0e-4        # per-iteration dispatch overhead


A100 = HardwareSpec(name="a100-80g", peak_flops=312e12, hbm_bw=2039e9,
                    overhead_s=1.5e-4)


class CostModel:
    """Evaluates the three-term roofline for engine iterations/megasteps."""

    def __init__(self, cfg: ModelConfig, hw: HardwareSpec = HardwareSpec(),
                 weight_dtype_bytes: int = 2, page_size: int = 0):
        self.cfg = cfg
        self.hw = hw
        self.page_size = page_size          # >0: paged KV — decode streams
                                            # whole pages, not exact tokens
        self.active_params = cfg.active_param_count()
        self.param_bytes = cfg.param_count() * weight_dtype_bytes

    def _cache_bytes(self, ctx: int) -> int:
        if self.page_size:
            return paged_bytes_for_context(self.cfg, ctx, self.page_size)
        return bytes_for_context(self.cfg, ctx)

    def resident_page_bytes(self, n_unique_pages: int) -> int:
        """Page-accurate resident KV footprint for unique physical pages.

        With cross-request prefix caching the
        per-request sum over ``bytes_for`` double-counts shared pages;
        the engine's memory accounting switches to this unique-page form
        (refcounted pages counted once) whenever sharing is enabled.
        """
        if not self.page_size:
            raise ValueError("resident_page_bytes requires a paged layout")
        return n_unique_pages * page_bytes(self.cfg, self.page_size)

    def _attn_flops_per_token(self, ctx: int) -> float:
        """Attention score+value FLOPs for one new token at context ctx."""
        cfg = self.cfg
        f = 0.0
        for kind in cfg.layer_kinds:
            if kind in (KIND_SSM, KIND_SSM_MOE):
                # SSD decode: state update + readout
                f += 4.0 * cfg.ssm_expand * cfg.d_model * cfg.ssm_state
                continue
            eff = min(ctx, cfg.sliding_window) if kind == KIND_LOCAL else ctx
            f += 4.0 * cfg.q_dim * eff
        return f

    def iteration_time(self, decode_ctxs: list[int],
                       prefill_tokens: int = 0,
                       prefill_ctx: int = 0) -> float:
        """One engine iteration: a batch of decode rows + a prefill chunk."""
        return self.megastep_time(decode_ctxs, [1] * len(decode_ctxs),
                                  prefill_tokens, prefill_ctx)

    def megastep_time(self, decode_ctxs: list[int], emitted: list[int],
                      prefill_tokens: int = 0,
                      prefill_ctx: int = 0) -> float:
        """One decode megastep's wall-clock time under the roofline.

        Row i starts at context ``decode_ctxs[i]`` and generates
        ``emitted[i]`` tokens without returning to the host. Per-token compute and cache streaming are unchanged (each of the k
        scanned steps still reads the weights and the growing KV), but the
        fixed dispatch/host overhead is paid ONCE per megastep instead of
        once per token — the amortization the engine's megastep loop buys.
        With all-ones ``emitted`` this is exactly ``iteration_time``.
        """
        flops = 0.0
        steps = max(emitted, default=0)
        mem = float(self.param_bytes) * max(steps, 1)
        for ctx, n in zip(decode_ctxs, emitted):
            for j in range(n):
                flops += (2.0 * self.active_params
                          + self._attn_flops_per_token(ctx + j))
                mem += self._cache_bytes(ctx + j)       # stream the cache
        if prefill_tokens:
            flops += 2.0 * self.active_params * prefill_tokens
            flops += self._attn_flops_per_token(prefill_ctx) * prefill_tokens / 2.0
            mem += self._cache_bytes(prefill_ctx)
        t = max(flops / self.hw.peak_flops, mem / self.hw.hbm_bw)
        return t + self.hw.overhead_s

    def predictor_time(self, flops: float) -> float:
        """Seconds of predictor work for ``flops`` charged FLOPs.

        The length-prediction strategies (`repro_torch.serving.predictors`)
        book the FLOPs an external implementation would spend (a
        BERT-sized prompt model, an ELIS proxy re-prediction); the
        engine drains them every step and charges the simulated clock
        through here — compute-roofline only, since estimator weights
        are tiny next to the serving model's. Zero FLOPs (the recycled
        trail-probe, the analysis oracles) cost exactly 0.0 seconds, so
        legacy results stay byte-identical.
        """
        return flops / self.hw.peak_flops

    def kv_transfer_time(self, nbytes: int) -> float:
        """Seconds to ship ``nbytes`` of paged KV replica-to-replica.

        Host-bounce path, mirroring the swap machinery: one batched
        device->host DMA on the source, the interconnect hop, one batched
        host->device DMA on the destination, plus a single dispatch
        overhead for the whole batch (transfer batching: a handoff is one
        charge, never per-page). The router charges this as *delayed
        availability* of the migrated request on the destination's
        virtual clock — decode megasteps keep running underneath, so the
        transfer overlaps compute instead of stalling the batch the way
        an in-step swap charge would.
        """
        if nbytes <= 0:
            return 0.0
        return (2.0 * nbytes / self.hw.dma_bw + nbytes / self.hw.link_bw
                + self.hw.overhead_s)

    def decode_token_rate(self, ctx: int = 256) -> float:
        """Steady-state decode tokens/s of one lone row at context ``ctx``.

        The per-replica service-rate normalizer for the router's
        seconds-unit backlog (`Engine.backlog_seconds`): predicted
        remaining *tokens* divide by this to become estimated seconds.
        One fixed reference context keeps the conversion strictly
        monotone in tokens — identical replicas rank identically in
        either unit, while heterogeneous hardware specs (the roadmap
        item this preps) scale by their true relative speed.
        """
        return 1.0 / self.iteration_time([ctx])

    def ideal_service_time(self, prompt_len: int, out_len: int) -> float:
        """Isolated completion time for one request on an empty engine.

        A single megastep evaluation: the whole prompt prefilled in one
        chunk plus all ``out_len`` decode tokens, overhead paid once —
        the denominator of the metrics layer's *slowdown* distribution
        (observed completion ÷ this).
        """
        ctx0 = max(prompt_len, 1)
        return self.megastep_time([ctx0 + 1], [max(out_len, 1)],
                                  prefill_tokens=max(prompt_len - 1, 0),
                                  prefill_ctx=ctx0)
