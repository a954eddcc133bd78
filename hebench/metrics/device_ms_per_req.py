"""``device_ms_per_req``: the profiler's device time of kernels and copies
over the traced sub-window, per request of it."""


def read(r: dict, _=None):
    t = r["trace"]
    return None if t is None else t["device_ms_per_req"]
