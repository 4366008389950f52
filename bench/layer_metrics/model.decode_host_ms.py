"""model.decode_host_ms: the host's own work in a decode step before its
end-of-token sync, in ms: the mean over the window's `decode_step` spans
of the serving thread of the span's duration less its `logits_sync` child
(the device-to-host read of the logits, which waits for the card). What
is left is the step's inputs and the launches of every layer. Program
spans on the host clock (`serving/server.py`)."""
from nlbench.serving_spans import in_window, serving_spans


def read(view):
    spans = serving_spans(view)
    syncs = [s for s in spans if s.name == "logits_sync"]
    host = []
    for step in in_window(view, spans, "decode_step"):
        inner = [s for s in syncs if step.a <= s.a and s.b <= step.b]
        if inner:
            host.append(step.seconds - sum(s.seconds for s in inner))
    if not host:
        return None
    return 1e3 * sum(host) / len(host)
