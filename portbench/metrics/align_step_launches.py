"""align_step_launches (count): device kernels an alignment step launched,
on any thread: those that started inside the program's ``miso.align.steps``
span (``harness/spans.py``; the pair loss, its backward and masked Adam on
the pose leaves), in the CPU-and-device trace's window, over its calls'
steps.  Nothing where the trace holds no such span, as in a program without
it."""
from portbench.harness import spans

SPAN = "miso.align.steps"


def read(ctx):
    tr, k = ctx.get("trace"), ctx.get("steps_per_call")
    if tr is None or not tr.steps or not k:
        return None
    inside = spans.within(tr, SPAN)
    if inside is None:
        return None
    n = tr.count(lambda o: o.cat == "kernel" and inside(o))
    return n / (tr.steps * k) if n else None
