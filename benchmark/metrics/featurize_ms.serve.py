"""Device milliseconds of the predictor's featurize per request (the image
copy to the card, the DETR trunk and encoder: train/loop.make_detr_featurize_fn
into models/detr and models/resnet_fused), by CUDA events, the window's mean."""


def read(r):
    return r.mean("featurize")
