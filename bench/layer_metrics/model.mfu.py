"""model.mfu: the model's FLOPs in the window over the window's seconds
times the H100's 989 TFLOP/s (bf16 dense, data sheet, 700 W), in percent.

FLOPs of every product at the shapes each step ran (KV heads = heads):
a decoded row, a layer: 8 d^2 for q, k, v and o, 4 d (positions it
attends) for the scores and the weighted values, and the FFN at the
neurons it computes (4 d x neurons: all d_ff of them in resident decode,
the served union of the step in offload decode); the LM head 2 d V. A
prefill of T tokens, a layer: 8 d^2 T + 2 d T^2 (causal) + 4 d d_ff T,
and the LM head at its last position. The oracle's mask product is not
counted."""
from nlbench.yardstick import H100_BF16_FLOPS


def read(view):
    cfg = view.cfg
    d, f, L, V = cfg["d_model"], cfg["d_ff"], cfg["n_layers"], cfg["vocab_size"]
    steps = view.window_steps
    if not steps:
        return None
    flops = 0.0
    for ctxs in view.decode_rows(steps).values():
        n = len(ctxs)
        flops += L * (8 * d * d * n + 4 * d * sum(ctxs)) + 2 * d * V * n
        if view.cell.mode == "resident":
            flops += L * 4 * d * f * n
    if view.cell.mode == "offload":
        flops += sum(4 * d * u * r for t, layer, r, a, u in view.rec.ffn
                     if view.t0 <= t <= view.t1)
    for T in view.prefills(steps):
        flops += L * (8 * d * d * T + 2 * d * T * T + 4 * d * f * T) + 2 * d * V
    return 100.0 * flops / ((view.t1 - view.t0) * H100_BF16_FLOPS)
