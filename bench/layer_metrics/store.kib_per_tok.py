"""store.kib_per_tok: KiB the file stores read from the pack in the
window's extent reads (the `measured_bytes` of the `IOStats` each
`FileNeuronStore.read` call returns), a decode token."""


def read(view):
    nbytes = sum(b for t, o, b in view.rec.reads if view.t0 <= t <= view.t1)
    if not view.rec.reads or view.decode_tokens <= 0:
        return None
    return nbytes / 1024 / view.decode_tokens
