"""Ops: blocks, attention, and the CUDA kernel wrappers."""
