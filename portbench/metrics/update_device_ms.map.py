"""update_device_ms.map (ms): device milliseconds a mapping step of every
kernel, memset and copy launched inside the program's ``miso.step.update``
span (``train/trainer.py::make_train_step``: the NaN guard and masked Adam
over every leaf), in the CPU-and-device trace's window.  Nothing where no
operation lies in the span, as in a program without it."""

SPAN = "miso.step.update"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.steps:
        return None
    picked = [o for o in tr.ops if SPAN in o.scopes]
    if not picked:
        return None
    return 1e-3 * sum(o.dur for o in picked) / tr.steps
