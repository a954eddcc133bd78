"""``device_idle_share``: the share of the traced sub-window (first to last
device event), traced with device activity alone, in which no kernel or
copy ran, in %."""


def read(r: dict, _=None):
    t = r["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
