"""plain_ms: device milliseconds a tick in operations that are not the
program's hand-written kernels: every device operation (kernel, copy or
fill) of the traced slice whose function is not a ``__global__`` of
``fiesta_tpu_torch/kernels/*.cu*`` (their names read from the sources at
run time): the plain PyTorch ops of the depth conversion and filter, the
splat's per-ray prep, and the glue."""


def read(reading):
    s = reading.slice
    if s is None or not s.ticks:
        return None
    plain = sum(v for k, v in s.by_name.items()
                if k not in reading.hand_kernels)
    return plain * 1e3 / s.ticks
