"""engine.cache_hit_rate: the share of the activated neurons of the
window's engine steps that the DRAM neuron cache held, from each layer
engine's `history` (`TokenStats.n_hits / n_activated`, program counters)."""


def read(view):
    if not view.history:
        return None
    hits = sum(t.n_hits for layer in view.history for t in layer)
    act = sum(t.n_activated for layer in view.history for t in layer)
    return hits / act if act else None
