"""TRAIL core: probe, Bayesian refinement, bin geometry and the scheduler.

  predictor   — probe MLP on recycled layer embeddings (Section 3.1)
  smoothing   — Bayesian per-iteration refinement (Section 3.1, Appendix A)
  bins        — length-bin geometry shared by predictor/smoothing
  scheduler   — SPRPT with limited preemption (Section 3.3)
  queueing    — Lemma 1's closed-form M/G/1 response time (Appendix C)
  simulation  — the discrete-event M/G/1 simulator (Appendix D)
"""
