"""solver_in_the_loop_torch — the PyTorch + CUDA port of solver_in_the_loop_tpu.

The port runs every command of the JAX package's CLI (the karman and Burgers
data generation, training with `--dp` among its flags, serving and
evaluation, and the PRE workflow) on an NVIDIA H100, with the TPU kernels of those paths
rewritten by hand in CUDA C++ for Hopper (`csrc/`, bound in `kernels/`): the
advection tap-sum forward and backward, the fused FD-preconditioned CG (also
the pressure solve's adjoint), and the fused convolution (forward, input
gradient and weight gradient) that the correction nets use under
`--conv kernel`. It keeps the JAX package's public layouts at every function
boundary:

* u (B, Y, X+1), v (B, Y+1, X), centered fields (B, Y, X);
* network features channel-last (B, Y, X, C) with channel order [v, u, Re]
  (karman) or [v, u, fv, fu] (Burgers).

Layer map:
  core      — Domain / CenteredGrid / StaggeredGrid, resampling, random fields
  ops       — stencils, diffusion, interpolation, advection, pressure solve
  kernels   — ctypes wrappers of the CUDA kernels, each with its plain twin
  physics   — karman geometry and solver step; Burgers step and forces
  models    — features and the correction networks (MarsMoon, Mercury, JupiterMoon)
  pre       — the PRE correction solve (constrained least squares, matrix-free CG)
  train     — flax msgpack checkpoints, recurrent rollouts, datasets, trainer
  parallel  — process groups, data parallelism (`--dp`) and the y-sharded
              karman step over torch.distributed
  io        — Scene npz I/O in the reference's legacy on-disk layout
  utils     — data statistics, metrics writer, logging
  apps      — the karman and Burgers CLIs, SOL and PRE

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
