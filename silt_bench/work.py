"""The yardstick's arithmetic: the card's published peaks, the least time
of a piece of work at them (a roofline bound), and the work the cells'
correction net and pressure solve need, counted from their shapes.

The bounds are those `chip_smoke.py` reckons with (`_bound`,
`conv_bound_ms`, `conv_wgrad_bound_ms`, `pcg_bound_ms`), frozen here.
"""

from __future__ import annotations

# H100 SXM, NVIDIA's data sheet (dense): HBM bytes/s, FP32 FLOP/s outside
# the tensor cores, TF32 FLOP/s on them
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
# a float32-accurate product on the tensor cores is three TF32 products
# (3xTF32): the rate the conv bounds and `mfu` reckon with
FP32_ACCURATE_FLOPS = TF32_FLOPS / 3


def bound_ms(nbytes: float, ops: float, flops: float = FP32_FLOPS) -> float:
    """The least time in ms at the peaks: bytes at the HBM rate or operations
    at `flops`, whichever takes longer."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / flops)


def conv_bound_ms(shape, with_skip: bool) -> float:
    """x, w, bias (and skip) read and y written once; 2 M K^2 Cin Cout
    operations as three TF32 products each. shape (b, h, w, cin, cout, k)."""
    b, h, w, cin, cout, k = shape
    m = b * h * w
    nbytes = 4 * (m * cin + k * k * cin * cout + cout + m * cout * (2 if with_skip else 1))
    return bound_ms(nbytes, 3 * 2 * m * k * k * cin * cout, TF32_FLOPS)


def conv_wgrad_bound_ms(shape) -> float:
    """x and dz read and dW written once; operations as conv_bound_ms."""
    b, h, w, cin, cout, k = shape
    m = b * h * w
    return bound_ms(4 * (m * cin + m * cout + k * k * cin * cout),
                    3 * 2 * m * k * k * cin * cout, TF32_FLOPS)


def pcg_bound_ms(shape, iters: int) -> float:
    """One FD-preconditioned solve of `iters` iterations: b, x0, the masks,
    Vy, Vx, invd read and x written once; per element and iteration (and the
    set-up pass) the four preconditioner products 4 H W (H + W) as 3xTF32 and
    about 28 operations a cell at the fp32 rate."""
    b, h, w = shape
    nbytes = 4 * (3 * b * h * w + 2 * h * w + h * (w + 1) + (h + 1) * w + h * h + w * w)
    passes = b * (iters + 1)
    t_ops = passes * (3 * 4 * h * w * (h + w) / TF32_FLOPS + 28 * h * w / FP32_FLOPS)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, t_ops)


def grid(config: dict):
    """The cells (H, W) of a configuration's domain."""
    res = config["res"]
    return (2 * res, res) if config["system"] == "karman" else (res, res)


def mars_moon_convs(net: dict):
    """(cin, cout, k, has_skip) of each conv in order: the stem, two a block
    (the second adds the skip), the head."""
    f, k = net["features"], net["kernel"]
    convs = [(net["in_channels"], f, k, False)]
    for _ in range(net["blocks"]):
        convs += [(f, f, k, False), (f, f, k, True)]
    return convs + [(f, 2, k, False)]


def net_work(config: dict, batch: int, steps: int, train: bool) -> dict:
    """The correction net's operations and the least time of its convs over
    `steps` corrected steps at `batch`: the forward of every conv, and in
    training also each weight gradient and each input gradient but the
    first step's stem's (its input is data)."""
    h, w = grid(config)
    m = batch * h * w
    flops, bound = 0.0, 0.0
    for i, (cin, cout, k, skip) in enumerate(mars_moon_convs(config["net"])):
        ops = 2.0 * m * k * k * cin * cout
        flops += steps * ops
        bound += steps * conv_bound_ms((batch, h, w, cin, cout, k), skip)
        if train:
            dgrad_steps = steps - 1 if i == 0 else steps
            flops += steps * ops + dgrad_steps * ops
            bound += steps * conv_wgrad_bound_ms((batch, h, w, cin, cout, k))
            bound += dgrad_steps * conv_bound_ms((batch, h, w, cout, cin, k), False)
    return {"flops": flops, "bound_ms": bound}


def unit_work(config: dict, workload: dict) -> dict:
    """`net_work` of one unit of a cell: a training iteration (msteps
    steps at the training batch) or a rollout step."""
    if workload["kind"] == "train":
        return net_work(config, config["sbatch"], config["msteps"], True)
    return net_work(config, workload["batch"], 1, False)
