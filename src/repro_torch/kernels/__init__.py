"""Hand-written CUDA kernels for Hopper (``sm_90a``) on the serving path.

Each kernel ships three pieces:
  csrc/<name>.cu — the CUDA C++ source with a plain C interface
  <name>.py      — the ctypes binding: checks, launch, launch counter
  ref.py         — the plain PyTorch version (the semantics contract)

``ops.py`` dispatches on the tensor's device: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel (or the call raises).
``build.py`` compiles the sources with ``nvcc`` at first use.

Kernels:
  paged_decode_attention       — flash-decode, one query per sequence,
                                 over a shared KV page pool
  paged_decode_attention_multi — the same for T queries per sequence
                                 (prefill chunks)
"""
