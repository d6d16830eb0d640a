"""The train steps' share of the cards' bf16 peak: the live work of every
step of the window (benchmark/work.py) over the window and the cards."""


def read(r):
    return r.mfu() if r.mode == "train" else None
