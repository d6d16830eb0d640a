"""Images stepped per second: every image of every step of the window (the
global batch, on several cards) over the window's length, which ends when
the device has finished the last step."""


def read(r):
    return r.images / r.window_s if r.mode == "train" else None
