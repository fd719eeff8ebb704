"""interp_roofline.map (%): the interp kernels' share of their roofline in a
mapping step.  The least seconds of every interp call (both levels, forward
and backward, from shapes and touched rows: ``roofline/counts.py``) over the
device seconds of the interp kernels and of everything the interp's
autograd node launched, in the traced window."""

KERNELS = ("grid_interp_forward", "grid_interp_pair_pack", "grid_interp_backward",
           "grid_interp_points_grad", "grid_grad_sum_copies")
NODE = "_GridInterpBackward"


def read(ctx):
    tr, counts = ctx.get("trace"), ctx.get("counts") or {}
    if tr is None or "interp_least_s" not in counts:
        return None
    busy = tr.seconds(lambda o: o.name.startswith(KERNELS) or o.in_scope(NODE))
    if busy <= 0:
        return None
    return 100.0 * counts["interp_least_s"] * tr.steps / busy
