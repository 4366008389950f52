"""paged_decode_roofline: the paged decode attention kernel's share of its
roofline over the profiled steps, in percent (`kernels/paged_decode.py`,
`kernels/csrc/paged_decode.cu`).

A call (the architecture module's `paged_attention` calls a decode step)
attends each decoded row over the positions it has: K and V of each
position once (the module's `kv_bytes`), the page-table entries naming
its pages (4 bytes a page), its position (4 bytes), and the float32 query
and output (heads x head_dim x 4 bytes each); 4 operations a (position,
head, element). Its bound is the larger of the bytes over 3.35 TB/s and
the operations over 67 TFLOP/s (H100 SXM data sheet). The share is the
mean bound a call over the mean device time a launch (`torch.profiler`)."""
from nlbench.yardstick import H100_FP32_FLOPS, roofline_seconds

KERNEL = "paged_split_kernel"


def read(view):
    p = view.profile
    if p is None:
        return None
    times = [dur / 1e6 for name, _, dur in p.kernels if KERNEL in name]
    rows = view.decode_rows(p.steps)
    if not times or not rows:
        return None
    att = view.arch.paged_attention(view.cfg)
    H, hd, kv = att["heads"], att["head_dim"], att["kv_bytes"]
    page = view.cfg["serving"]["page_size"]
    bounds = []
    for ctxs in rows.values():
        nbytes = sum(c * kv + 4 * -(-c // page) + 4 + 2 * H * hd * 4
                     for c in ctxs)
        flops = sum(4 * c * H * hd for c in ctxs)
        bounds += [roofline_seconds(flops, nbytes, H100_FP32_FLOPS)] * att["calls"]
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(times) / len(times))
