"""``host_enqueue_ms``: host clock from a request's issue until the
program's last call returns, before any wait; mean per request. A host
number: the entry points' Python and the kernel binding's launches."""


def read(r: dict, _=None):
    return r["host_enqueue_ms"]
