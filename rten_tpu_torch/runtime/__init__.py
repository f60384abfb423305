"""Execution engines: interpret (eager, per-op timing) and compile (one
trace-mode run a signature, captured as one CUDA graph on the card)."""
