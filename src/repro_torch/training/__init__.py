"""Training: the LM trainer, the probe trainer, AdamW and checkpoints (the
reference ``repro.training``).

``optimizer`` (AdamW with warmup and cosine decay on dicts of tensors),
``data`` (the synthetic instruction data and the probe-data harvest),
``train`` (``train_lm``, ``train_probe``, ``probe_mae``) and
``checkpoint`` (the reference's flat ``.npz`` format, both ways).
"""
