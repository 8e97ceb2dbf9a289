"""Multi-device decode over torch.distributed (torch port of
ld_decode_tpu/parallel)."""
