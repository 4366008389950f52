"""engine.union_share: the share of a layer's neurons in a decode step's
served union (the activated neurons of all the step's rows), over the
window's steps and layers, counted by the harness at
`OffloadedFFNRuntime.ffn_apply_batch` from the masks the server passes;
a layer's neurons as the architecture module counts them."""


def read(view):
    calls = [(layer, u) for t, layer, r, a, u in view.rec.ffn
             if view.t0 <= t <= view.t1]
    if not calls:
        return None
    neurons = view.arch.ffn_neurons(view.cfg)
    return sum(u for _, u in calls) / sum(neurons[layer] for layer, _ in calls)
