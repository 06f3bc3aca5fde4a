"""Losses of the port (counterpart of tgsr_tpu/losses)."""
