"""TRAIL serving on PyTorch and CUDA (the port of the ``repro`` JAX package).

The package mirrors ``repro``'s module names so each module's counterpart
is easy to find: ``config``/``configs`` (plain data), ``core`` (bins,
Bayes filter, probe, scheduler), ``models`` (the dense GQA decoder as
``nn.Module``s), ``kernels`` (hand-written CUDA flash-decode kernels for
Hopper beside their plain PyTorch versions) and ``serving`` (the engine,
paged KV pool, predictors and cost model).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Nothing here imports JAX or the ``repro`` package.
"""
