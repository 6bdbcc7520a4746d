"""Compute ops: losses, sparse-aware optimizers, sampling, scoring, and
the LSTM recurrence kernel."""
