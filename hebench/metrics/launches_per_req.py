"""``launches_per_req``: the device operations a request launches (the
program's kernels, PyTorch's own copies and fills) in the traced
sub-window, per request of it; the trace's counts are held to the
calibration name by name, so none is lost. Each costs the host a launch."""


def read(r: dict, _=None):
    t = r["trace"]
    return None if t is None else t["ops_per_req"]
