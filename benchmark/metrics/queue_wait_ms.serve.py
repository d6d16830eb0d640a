"""Host milliseconds a request waited past its due time for the request
before it to return, the window's mean."""


def read(r):
    return r.mean("queue_wait")
