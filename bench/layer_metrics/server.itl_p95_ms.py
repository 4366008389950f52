"""server.itl_p95_ms: the 95th percentile of the gaps between a request's
tokens, over every gap that ends in the traced window, on the host clock
after each step's end-of-token sync. A closed loop that keeps every slot
full runs at capacity: its tails swing with the host's speed and are read
here, beside the end-to-end `out_tok_s`."""
from nlbench.harness import itl_gaps_ms
from nlbench.yardstick import p95


def read(view):
    gaps = itl_gaps_ms(view.rec, view.t0, view.t1)
    return p95(gaps) if gaps else None
