"""Least time of the ResNet-101 trunk of one request: the stem (the float32
images, its kernel and fold read, the pooled map written; 2 x 147 x 64
operations per conv output pixel) and each bottleneck (input read, output
written, its weights and folds read once; conv1 on every input pixel,
conv2, conv3 and the projection on every output pixel), bf16 products at
the tensor-core peak."""

from benchmark import work


def least_s(u, pk):
    if u["kind"] != "serve":
        return None
    b, side = u["B"], u["side"]
    rate = pk["bf16_tensor_flops"]
    stem_bytes = b * side * side * 3 * 4 + 7 * 7 * 3 * 64 * work.BF16 \
        + 2 * 64 * 4 + b * (side // 4) ** 2 * 64 * work.BF16
    total = work.least_s(stem_bytes, work.stem_flops(u), rate, pk)
    for k in work.trunk_blocks(u):
        m, c, co = k["m"], k["c"], k["co"]
        weights = c * m + 9 * m * m + m * co + (c * co if k["proj"] else 0)
        folds = 2 * (2 * m + co + (co if k["proj"] else 0)) * 4
        nbytes = (k["b"] * k["h"] * k["w"] * c
                  + k["b"] * k["ho"] * k["wo"] * co + weights) * work.BF16 \
            + folds
        total += work.least_s(nbytes, work.bottleneck_flops(k), rate, pk)
    return total
