"""Device milliseconds of the predictor's eval step per request
(engine.make_eval_step into models/relation_head), by CUDA events, the
window's mean."""


def read(r):
    return r.mean("estep")
