"""decode_roofline.map (%): the decoder's share of its roofline in a mapping
step.  The least seconds of the decode forward and backward (operations at
the float32-accurate tensor-core rate, or bytes: ``roofline/counts.py``) over
the device seconds of the decode kernel and of everything the decode's
autograd node launched, in the traced window."""

KERNELS = ("mlp_decode_kernel",)
NODE = "_MlpDecodeBackward"


def read(ctx):
    tr, counts = ctx.get("trace"), ctx.get("counts") or {}
    if tr is None or "decode_least_s" not in counts:
        return None
    busy = tr.seconds(lambda o: o.name.startswith(KERNELS) or o.in_scope(NODE))
    if busy <= 0:
        return None
    return 100.0 * counts["decode_least_s"] * tr.steps / busy
