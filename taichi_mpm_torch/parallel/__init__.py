"""Multi-GPU execution over ``torch.distributed`` (torch counterpart of
``taichi_mpm_tpu.parallel``): x-slabs of the domain, one rank each."""
