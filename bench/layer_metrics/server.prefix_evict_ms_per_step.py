"""server.prefix_evict_ms_per_step: the host's time evicting prefix
registry entries once the page pool's free list is dry, in ms a decode
step: the summed durations of the serving thread's `evict` spans of the
window (`PagePool._alloc_page`, under `pool_admit` or `grow_tables`), over
its `decode_step` spans. 0.0 when nothing was evicted; nothing to read
when the program has no page pool spans. Program spans on the host
clock."""
from nlbench.serving_spans import in_window, serving_spans


def read(view):
    spans = serving_spans(view)
    steps = in_window(view, spans, "decode_step")
    if not steps or not in_window(view, spans, "pool_admit", "grow_tables"):
        return None
    evict = in_window(view, spans, "evict")
    return 1e3 * sum(s.seconds for s in evict) / len(steps)
