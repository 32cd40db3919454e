"""dispatch_ms: host milliseconds a tick spends inside the program's tick
call (``fused_batch_step`` / ``fused_depth_batch_step``), on the
benchmark's host clock around each call with no synchronise, averaged
over the traced run's window outside its profiled slice.  What a CUDA
graph or a fused kernel would cut from the host's enqueue.  Where the
card falls behind, a launch that finds the queue full waits inside the
call, and that wait counts too."""


def read(reading):
    ms = reading.dispatch_ms
    return sum(ms) / len(ms) if ms else None
