"""device.idle_share: the share of the profiled stretch of steps in which
no kernel, copy or fill ran on the card (`torch.profiler`, CUDA activity
alone; the union of the device intervals against the host's window)."""


def read(view):
    p = view.profile
    if p is None or p.window_s <= 0 or not p.kernels:
        return None
    return 1.0 - p.busy_s / p.window_s
