"""Trace ingestion, synthesis, and open-loop replay.

The evaluation path the paper's distributional claims need: load (or
synthesize) an Azure-LLM-inference-style request trace, rescale it with
time-warp/rate-scale knobs, and replay it open-loop into an `Engine` or
cluster `Router` while the metrics layer (`repro_torch.metrics`) captures
per-request events. See ``docs/ARCHITECTURE.md`` § Trace-driven
evaluation.

A copy of the reference package's ``traces``, with its own copy of the
bundled fixture (``data/azure_llm_sample.jsonl``): pure Python and numpy,
so a replayed workload is the reference's request for request.
"""

from repro_torch.traces.loaders import (load_csv, load_jsonl, load_trace,
                                        sample_trace_path, save_jsonl)
from repro_torch.traces.replay import ReplayConfig, replay, requests_from_trace
from repro_torch.traces.schema import Trace, TraceRecord, normalize
from repro_torch.traces.synthesis import (SAMPLE_CONFIG, SynthesisConfig,
                                          TenantTraceSpec, sample_trace,
                                          synthesize)

__all__ = [
    "Trace",
    "TraceRecord",
    "normalize",
    "load_csv",
    "load_jsonl",
    "load_trace",
    "sample_trace_path",
    "save_jsonl",
    "ReplayConfig",
    "replay",
    "requests_from_trace",
    "SynthesisConfig",
    "TenantTraceSpec",
    "SAMPLE_CONFIG",
    "sample_trace",
    "synthesize",
]
