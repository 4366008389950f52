"""store.kib_per_tok: KiB the file stores read from the pack in the
window's extent reads (counted by the harness at
`FileNeuronStore._read_extent`), a decode token."""


def read(view):
    nbytes = sum(b for t, o, b in view.rec.reads if view.t0 <= t <= view.t1)
    if not view.rec.reads or view.decode_tokens <= 0:
        return None
    return nbytes / 1024 / view.decode_tokens
