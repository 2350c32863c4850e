"""Device ms a training step of the NCCL kernels (names starting ``nccl``)
in rank 0's traced stretch: the collectives a data-parallel step runs on
the card, the gradient all-reduce and the BN statistics' exchanges."""


def read(ctx):
    s = ctx["trace"]
    if s is None or ctx["driver"].units != "steps" or ctx["chips"] < 2:
        return None
    nccl = s.seconds_matching(r"^nccl")
    return 1e3 * nccl / s.units if nccl > 0 else None
