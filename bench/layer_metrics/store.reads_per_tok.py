"""store.reads_per_tok: the extent reads the file stores issued in the
window (the `measured_ops` of the `IOStats` each `FileNeuronStore.read`
call returns), a decode token."""


def read(view):
    ops = sum(o for t, o, b in view.rec.reads if view.t0 <= t <= view.t1)
    if not view.rec.reads or view.decode_tokens <= 0:
        return None
    return ops / view.decode_tokens
