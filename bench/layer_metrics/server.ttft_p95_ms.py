"""server.ttft_p95_ms: the 95th percentile of submit to first token over
every request sent in the traced window, on the host clock. Read beside
the end-to-end `out_tok_s`, as `server.itl_p95_ms` is."""
from nlbench.harness import ttfts_ms
from nlbench.yardstick import p95


def read(view):
    times = ttfts_ms(view.rec, view.t0, view.t1)
    return p95(times) if times else None
