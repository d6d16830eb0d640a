"""Images served per second: the images of every request completed in the
window over the window's length."""


def read(r):
    return r.images / r.window_s if r.mode == "serve" else None
