"""moe.host_ms: the host's time in a decode step's MoE sublayers, in ms:
over the window's `decode_step` spans of the serving thread, the mean of
the summed durations of the `moe` spans inside each (a layer's norm,
routing where it runs after the attention, dispatch, expert products and
combine: `stack_decode_step_layerwise`). Nothing to read when the program
has no `moe` spans. Program spans on the host clock
(`models/transformer.py`)."""
from nlbench.serving_spans import in_window, serving_spans


def read(view):
    spans = serving_spans(view)
    moe = [s for s in spans if s.name == "moe"]
    if not moe:
        return None
    per_step = []
    for step in in_window(view, spans, "decode_step"):
        per_step.append(sum(s.seconds for s in moe
                            if step.a <= s.a and s.b <= step.b))
    if not per_step:
        return None
    return 1e3 * sum(per_step) / len(per_step)
