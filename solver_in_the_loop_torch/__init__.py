"""solver_in_the_loop_torch — the PyTorch + CUDA port of solver_in_the_loop_tpu.

The port runs the serving path `karman-apply` (a trained correction net inside
the karman solver for a recurrent rollout) and the training path
`karman-train` (the net trained through the unrolled solver) on an NVIDIA
H100, with the TPU kernels of those paths rewritten by hand in CUDA C++ for
Hopper (`csrc/`, bound in `kernels/`): the advection tap-sum forward and
backward, and the fused FD-preconditioned CG, which is also the pressure
solve's adjoint. It keeps the JAX package's public layouts at every
function boundary:

* u (B, Y, X+1), v (B, Y+1, X), centered fields (B, Y, X);
* network features channel-last (B, Y, X, C) with channel order [v, u, Re].

Layer map:
  core      — Domain / CenteredGrid / StaggeredGrid, downsampling
  ops       — stencils, diffusion, interpolation, advection, pressure solve
  kernels   — ctypes wrappers of the CUDA kernels, each with its plain twin
  physics   — karman geometry and solver step
  models    — features and the correction networks (MarsMoon, Mercury)
  train     — flax msgpack checkpoints, recurrent rollout, dataset, trainer
  io        — Scene npz I/O in the reference's legacy on-disk layout
  utils     — data statistics, metrics writer, logging
  apps      — the karman-apply and karman-train CLIs

Library functions follow the device of their input tensors; the CLI runs on
CUDA unless `--device cpu` is given.
"""

__version__ = "0.1.0"

from solver_in_the_loop_torch.core.grids import (  # noqa: F401
    Boundary,
    CenteredGrid,
    Domain,
    StaggeredGrid,
)
