"""slot_interp_roofline.align (%): the slot-id interp kernels' share of
their roofline in an alignment step.  The least seconds of a step's slot-id
calls (every level, the forward and the points-only backward over the
padded pair batch, from shapes and touched rows at the perturbed start:
``roofline/slot_counts.py``) over the device seconds of the kernels picked
by name (a substring: the trace's names begin with ``void ``) and of
everything the slot-id autograd node launched, among the operations that
started inside the program's ``miso.align.steps`` span
(``harness/spans.py``), in the CPU-and-device trace's window, over its
calls' steps.  Nothing where the trace holds no such span."""
from portbench.harness import spans

SPAN = "miso.align.steps"
KERNELS = ("grid_interp_forward", "grid_interp_points_grad")
NODE = "_GridInterpPerPointBackward"


def read(ctx):
    tr, k = ctx.get("trace"), ctx.get("steps_per_call")
    least = (ctx.get("counts") or {}).get("slot_interp_least_s")
    if tr is None or not tr.steps or not k or least is None:
        return None
    inside = spans.within(tr, SPAN)
    if inside is None:
        return None
    busy = tr.seconds(lambda o: inside(o) and (any(n in o.name for n in KERNELS)
                                               or o.in_scope(NODE)))
    if busy <= 0:
        return None
    return 100.0 * least * tr.steps * k / busy
