"""map_step_mfu (%): the mapping step's model operations (the interp lerps,
forward and backward, and the decoder's products, forward and backward,
counted from shapes) at the card's peak for them, over the untraced
window's seconds a step.  The peak is the fastest float32-accurate rate of
each: the decoder's products at 3xTF32 on the tensor cores, the lerps at
FP32 on the CUDA cores (``roofline/peaks.json``)."""


def read(ctx):
    counts, step_s = ctx.get("counts") or {}, ctx.get("step_s")
    if "model_flops_least_s" not in counts or not step_s:
        return None
    return 100.0 * counts["model_flops_least_s"] / step_s
