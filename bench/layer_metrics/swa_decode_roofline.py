"""swa_decode_roofline: the sliding-window ring decode attention kernel's
share of its roofline over the profiled steps, in percent
(`kernels/swa_decode.py`, `kernels/csrc/swa_decode.cu`).

A call (the architecture module's `swa_attention` calls a decode step)
attends each decoded row over the min(c, window) positions its ring
holds of the c it has: K and V of each position once (the module's
`kv_bytes`) and its ring position (4 bytes), the row's position (4
bytes), and the query and output (heads x head_dim elements each, the
model's dtype); 4 operations a (position, head, element). Its bound is
the larger of the bytes over 3.35 TB/s and the operations over 67
TFLOP/s (H100 SXM data sheet), as `paged_decode_roofline` counts. The
share is the mean bound a call over the mean device time a launch
(`torch.profiler`)."""
from nlbench.yardstick import H100_FP32_FLOPS, roofline_seconds

KERNEL = "swa_split_kernel"


def read(view):
    p = view.profile
    if p is None or not hasattr(view.arch, "swa_attention"):
        return None
    times = [dur / 1e6 for name, _, dur in p.kernels if KERNEL in name]
    rows = view.decode_rows(p.steps)
    if not times or not rows:
        return None
    att = view.arch.swa_attention(view.cfg)
    H, hd, kv, e, W = (att["heads"], att["head_dim"], att["kv_bytes"],
                       att["elem"], att["window"])
    bounds = []
    for ctxs in rows.values():
        nbytes = sum(min(c, W) * (kv + 4) + 4 + 2 * H * hd * e for c in ctxs)
        flops = sum(4 * min(c, W) * H * hd for c in ctxs)
        bounds += [roofline_seconds(flops, nbytes, H100_FP32_FLOPS)] * att["calls"]
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(times) / len(times))
