"""TRAIL serving runtime: iteration-level continuous batching.

Embedding-based length prediction feeding SPRPT-limited-preemption
scheduling.
"""
