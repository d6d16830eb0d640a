"""Least time of the encoder kernels of one request, per layer: the
attention core (q, k, v read and the output written once in bf16, the key
mask read; 4 B L^2 d operations of products) and the FFN with its residual
and LayerNorm (x read and y written in float32, both weight matrices in
bf16 and the four vectors read once; 4 B L d F operations), products at the
bf16 tensor-core peak.  The q, k, v and output projections run outside
these kernels and are not counted here."""

from benchmark import work


def least_s(u, pk):
    if u["kind"] != "serve":
        return None
    b, d, f = u["B"], u["D"], u["F"]
    length = (u["side"] // 32) ** 2
    flops = work.encoder_layer_flops(u)
    rate = pk["bf16_tensor_flops"]
    attn = work.least_s(4 * b * length * d * work.BF16 + b * length,
                        flops["attention"], rate, pk)
    ffn = work.least_s(2 * b * length * d * 4 + 2 * d * f * work.BF16
                       + (f + 3 * d) * 4, flops["ffn"], rate, pk)
    return u["layers"] * (attn + ffn)
