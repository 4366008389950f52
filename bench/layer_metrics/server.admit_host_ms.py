"""server.admit_host_ms: the host's time an admission outside its forward,
in ms: the summed durations of the serving thread's `admit_gate` (the page
and I/O gates), `pool_admit` (the page table, evictions included),
`write_prompt` (the prompt's page copies) and `register_prefixes` (the
prefix registry) spans of the window, over its `prefill` spans (one an
admission). Program spans on the host clock (`serving/server.py`,
`serving/paging.py`)."""
from nlbench.serving_spans import in_window, serving_spans

PARTS = ("admit_gate", "pool_admit", "write_prompt", "register_prefixes")


def read(view):
    spans = serving_spans(view)
    admissions = in_window(view, spans, "prefill")
    parts = in_window(view, spans, *PARTS)
    if not admissions or not parts:
        return None
    return 1e3 * sum(s.seconds for s in parts) / len(admissions)
