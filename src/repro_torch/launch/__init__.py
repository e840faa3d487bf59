"""Step functions over the serving model (the reference ``repro.launch``).

``steps`` holds the fused serve step and the prefill step; the training
step waits for the training slice of the port.
"""
