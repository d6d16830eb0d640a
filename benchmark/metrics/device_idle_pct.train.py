"""The share of the traced window of train steps in which no operation ran
on the card."""


def read(r):
    return r.idle_pct() if r.mode == "train" else None
