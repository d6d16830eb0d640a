"""Device milliseconds of a train step (engine.make_train_step: the views'
forward, the losses, the backward and SGD.update), by CUDA events around
each call, the mean over the window's steps."""


def read(r):
    return r.mean("train_step")
