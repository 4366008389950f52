"""model.mfu: the model's FLOPs in the window over the window's seconds
times the H100's 989 TFLOP/s (bf16 dense, data sheet, 700 W), in percent.

FLOPs of every product at the shapes each step ran, as the configuration's
architecture module counts them (`bench/arch/<arch>.py`): every decoded
row at the positions it attends, with its FFN at every neuron in resident
decode and, in offload decode, at the served union of each layer's step;
every prefill at its prompt's length. The oracle's mask product is not
counted."""
from nlbench.yardstick import H100_BF16_FLOPS


def read(view):
    arch, cfg = view.arch, view.cfg
    steps = view.window_steps
    if not steps:
        return None
    flops = 0.0
    for ctxs in view.decode_rows(steps).values():
        flops += sum(arch.decode_row_flops(cfg, c) for c in ctxs)
        if view.cell.mode == "resident":
            flops += arch.decode_row_ffn_flops(cfg) * len(ctxs)
    if view.cell.mode == "offload":
        flops += sum(arch.ffn_flops(cfg, u) * r for t, layer, r, a, u
                     in view.rec.ffn if view.t0 <= t <= view.t1)
    for T in view.prefills(steps):
        flops += arch.prefill_flops(cfg, T)
    return 100.0 * flops / ((view.t1 - view.t0) * H100_BF16_FLOPS)
