"""Band-limited random field synthesis (PhiFlow `math.randfreq` equivalent).

A numpy copy of solver_in_the_loop_tpu/core/random_fields.py, with the same
calls on the same `np.random.RandomState` in the same order, so a seed gives
the JAX package's fields: a complex gaussian spectrum shaped by
(1/(|k|+1))^power * power * sqrt(mean(res)), inverse-FFT'd to a real field,
drawn per staggered component (the Burgers initial velocity, reference
burgers.py:121).
"""

from __future__ import annotations

import numpy as np

from solver_in_the_loop_torch.core.grids import Domain, StaggeredGrid


def randfreq(rng: np.random.RandomState, shape, power: int = 8) -> np.ndarray:
    """Random smooth float32 field of shape (B, H, W)."""
    _, h, w = shape
    fft = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    k = np.sqrt(fy**2 + fx**2)
    shape_fac = np.sqrt(0.5 * (h + w))
    fft = fft * ((1.0 / (k + 1.0)) ** power * power * shape_fac)[None]
    return np.real(np.fft.ifft2(fft, axes=(-2, -1))).astype(np.float32)


def randfreq_staggered(rng: np.random.RandomState, domain: Domain, batch: int = 1,
                       scale: float = 2.0, device=None) -> StaggeredGrid:
    """Random initial MAC velocity: independent randfreq per component * scale
    (v drawn first, then u)."""
    v = randfreq(rng, domain.v_shape(batch)) * scale
    u = randfreq(rng, domain.u_shape(batch)) * scale
    return domain.staggered_grid(u=u, v=v, batch=batch, device=device)
