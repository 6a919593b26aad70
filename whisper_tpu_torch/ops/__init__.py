"""Attention ops and the hand-written kernels (``ops/kernels``)."""
