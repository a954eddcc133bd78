"""``closed_loop.<metric>``: the closed loop's own numbers (``req_per_s``,
``latency_ms_p50``, ``latency_ms_p95``: host clock, every request of the
window) as per-layer readings. The host nearly or wholly paces the loop,
and its pace differs between machines, so no bound holds on them."""


def read(r: dict, part):
    return r["closed"].get(part)
