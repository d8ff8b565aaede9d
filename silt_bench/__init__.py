"""The benchmark of solver_in_the_loop_torch (see run.py)."""
