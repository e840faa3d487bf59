"""Per-architecture configs. Each module exports CONFIG (full) and SMOKE (reduced)."""
