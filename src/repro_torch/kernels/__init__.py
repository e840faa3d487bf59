"""Hand-written CUDA kernels for Hopper (``sm_90a``) on the serving and
training paths.

Each kernel ships three pieces:
  csrc/<name>.cu — the CUDA C++ source with a plain C interface
  <name>.py      — the ctypes binding: checks, launch, launch counter
  ref.py         — the plain PyTorch version (the semantics contract)

``ops.py`` dispatches on the tensor's device: a CPU tensor goes to the
plain version, a meta tensor too (shapes alone, nothing allocated: the
dry run), a CUDA tensor to the kernel (or the call raises).
``build.py`` compiles the sources with ``nvcc`` at first use and keeps
the launch counts.

Kernels:
  paged_decode_attention       — flash-decode, one query per sequence,
                                 over a shared KV page pool
  paged_decode_attention_multi — the same for T queries per sequence
                                 (prefill chunks)
  decode_attention             — flash-decode, one query per sequence,
                                 over a contiguous or ring slot cache
                                 (window, softcap)
  probe_update                 — the TRAIL probe MLP, softmax and one
                                 Bayes-filter step
  flash_attention              — blocked causal or non-causal attention
                                 over full sequences (window, softcap);
                                 the training and profiling forwards
  ssd_scan                     — the chunked Mamba-2 state-space scan
                                 from an initial state (SSM and hybrid
                                 prefill chunks, training forwards)
  ssm_state_update             — the Mamba-2 single-token state update,
                                 in place, rows without a token skipped
                                 (SSM and hybrid decode steps)
  moe_experts                  — the experts of a dropless MoE call over
                                 the live tokens' entries, grouped by
                                 expert; no weight of an expert that no
                                 entry routes to is read (cached path)
"""
