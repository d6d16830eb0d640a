"""The served requests' share of the card's bf16 peak: the live work of the
trunk, the encoder and the eval forward of every request of the window
(benchmark/work.py) over the window."""


def read(r):
    return r.mfu() if r.mode == "serve" else None
