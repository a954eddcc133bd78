"""``roofline_share``: the least time of a request's algorithmic work
(``hebench/work.py``: the larger of its bytes over 3.35 TB/s and its
64-bit products over the assumed integer peak) over its device time
(``device_ms_per_req``), in %."""

from hebench import work


def read(r: dict, _=None):
    t = r["trace"]
    if t is None or t["device_ms_per_req"] <= 0:
        return None
    least_s, _by = work.least_seconds(*r["work"])
    return 100.0 * least_s / (t["device_ms_per_req"] * 1e-3)
