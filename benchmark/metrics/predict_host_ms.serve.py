"""Host milliseconds of predict after its eval step has finished on the card:
the copy of its outputs to the host, eval/builders.build_candidates, the
ranking and the edge dicts; the window's mean."""


def read(r):
    return r.mean("predict_host")
