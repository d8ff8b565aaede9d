"""Data parallelism and the y-sharded spatial decomposition over
torch.distributed (counterparts of solver_in_the_loop_tpu/parallel/)."""
