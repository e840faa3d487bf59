"""Entry points, step functions and the launch tooling over the model
(the reference ``repro.launch``).

``steps`` holds the fused serve step, the prefill step, the training step
and ``input_specs`` (every step input as a meta tensor); ``train`` is the
training launcher (``python -m repro_torch.launch.train``) and ``serve``
the serving one. ``dryrun`` (``python -m repro_torch.launch.dryrun``)
sizes every (architecture, input shape) for one H100 or the reference's
TPU v5e meshes on meta tensors, from the roofline terms of ``analysis``,
the mesh descriptions of ``mesh`` and the sharding rules of
``sharding``.
"""
