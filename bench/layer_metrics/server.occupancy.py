"""server.occupancy: the mean share of the server's slots that decode a
row in each decode step of the window, from the server's own counters
(`ServerStats.slot_steps_active / (decode_steps x n_slots)`)."""


def read(view):
    s0, s1 = view.stats0, view.stats1
    steps = s1["decode_steps"] - s0["decode_steps"]
    if steps <= 0:
        return None
    return (s1["slot_steps_active"] - s0["slot_steps_active"]) / (
        steps * s1["n_slots"])
