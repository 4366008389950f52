"""store.reads_per_tok: the extent reads the file stores issued in the
window (counted by the harness at `FileNeuronStore._read_extent`), a
decode token."""


def read(view):
    ops = sum(o for t, o, b in view.rec.reads if view.t0 <= t <= view.t1)
    if not view.rec.reads or view.decode_tokens <= 0:
        return None
    return ops / view.decode_tokens
