"""Entry points and step functions over the model (the reference
``repro.launch``).

``steps`` holds the fused serve step, the prefill step and the training
step; ``train`` is the training launcher
(``python -m repro_torch.launch.train``).
"""
