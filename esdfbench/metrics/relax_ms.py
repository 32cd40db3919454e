"""relax_ms: device milliseconds a tick of the incremental engine's
relaxation: the device time of the ``__global__`` kernels of
``fiesta_tpu_torch/kernels/relax.cu`` (their names read from the source
at run time) in the traced slice, over its ticks."""

from esdfbench import trace


def read(reading):
    s = reading.slice
    if s is None or not s.ticks or reading.kernel_dir is None:
        return None
    names = trace.hand_kernel_names(reading.kernel_dir, "relax.cu")
    t = sum(s.by_name.get(k, 0.0) for k in names)
    return t * 1e3 / s.ticks if t > 0 else None
