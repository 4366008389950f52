"""moe.expert_roofline: the decode steps' expert products against their
bound over the profiled steps, in percent.

The bound of a step is the bytes of the distinct experts its rows routed
to, each layer's count as the program kept it (the `moe_experts` instant
after the step's end-of-token copy, one count a MoE layer), times the
architecture module's `expert_bytes` (its gate, up and down matrices),
over 3.35 TB/s (H100 SXM data sheet). The time is the device time of the
expert products launched in those steps (`torch.profiler`): the kernels
of CUTLASS's grouped GEMM, which `torch._grouped_mm` runs, and whose
names hold `GroupProblemShape`. A kernel belongs to the decode step
whose span (the serving thread's `decode_step`) holds its start on the
host clock; the prefills' expert products fall outside. The share is
summed bound over summed time. Nothing to read without a profile, a
counted step or a matching kernel."""
from nlbench.serving_spans import serving_spans
from nlbench.yardstick import H100_HBM_BYTES_PER_S

KERNEL = "GroupProblemShape"


def read(view):
    p = view.profile
    if p is None:
        return None
    spans = serving_spans(view)
    steps = [s for s in spans if s.name == "decode_step"
             and p.host_t0 <= s.a and s.b <= p.host_t1]
    counts = [e for e in view.spans or [] if e.get("ph") == "i"
              and e["name"] == "moe_experts"]
    nbytes = 0
    for e in counts:
        t = view.tracer_base + e["ts"] / 1e6
        if any(s.a <= t <= s.b for s in steps):
            nbytes += sum(e["args"]["experts"]) * view.arch.expert_bytes(view.cfg)
    seconds = 0.0
    for name, ts, dur in p.kernels:
        t = p.to_host + ts / 1e6
        if KERNEL in name and any(s.a <= t <= s.b for s in steps):
            seconds += dur / 1e6
    if not nbytes or not seconds:
        return None
    return 100.0 * nbytes / H100_HBM_BYTES_PER_S / seconds
