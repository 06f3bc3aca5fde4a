"""Scale-out: one process per GPU under torchrun, torch.distributed
(NCCL on the card, gloo on the CPU), the data-parallel step's collectives."""
