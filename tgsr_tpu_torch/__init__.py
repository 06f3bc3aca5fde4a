"""PyTorch/CUDA port of tgsr_tpu for NVIDIA Hopper (H100).

The layout mirrors tgsr_tpu: config, ops (plain PyTorch ops and the wrappers
of the hand-written CUDA kernels in csrc/), models, engine, checkpoints.
The port imports torch and nothing of JAX or tgsr_tpu. Its entry points run
on the CUDA card unless the caller passes device="cpu".
"""
