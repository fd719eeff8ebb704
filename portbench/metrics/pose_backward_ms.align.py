"""pose_backward_ms.align (ms): device milliseconds a step of every kernel,
memset and copy that the by-id pose gathers' autograd nodes launched in an
alignment step: ``IndexBackward0``, the backward of ``R[ids]`` and
``t[ids]`` in ``ops/se3.py::transform_points_by_id`` and
``inverse_transform_points_by_id``, which lands a row of each point's
gradient in the submap's pose row.  The backward runs on the autograd
worker thread, so an operation counts by its node's scope there and by the
time of the program's ``miso.align.steps`` span (``harness/spans.py``), in
the CPU-and-device trace's window, over its calls' steps.  Nothing where
the trace holds no such span, as in a program without it."""
from portbench.harness import spans

SPAN = "miso.align.steps"
NODE = "IndexBackward0"


def read(ctx):
    tr, k = ctx.get("trace"), ctx.get("steps_per_call")
    if tr is None or not tr.steps or not k:
        return None
    inside = spans.within(tr, SPAN)
    if inside is None:
        return None
    picked = [o for o in tr.ops if inside(o) and o.in_scope(NODE)]
    if not picked:
        return None
    return 1e-3 * sum(o.dur for o in picked) / (tr.steps * k)
