"""Host milliseconds a train step waited for its batch from the prefetch
iterator (data/pipeline: the producer thread's copy to the card), the mean
over the window's steps."""


def read(r):
    return r.mean("feed_wait")
