"""update_launches.map (count): kernels a mapping step launched inside the
program's ``miso.step.update`` span (``train/trainer.py::make_train_step``:
the NaN guard and masked Adam over every leaf), in the CPU-and-device
trace's window.  Nothing where no operation lies in the span, as in a
program without it."""

SPAN = "miso.step.update"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.steps:
        return None
    picked = [o for o in tr.ops if SPAN in o.scopes]
    if not picked:
        return None
    return sum(1 for o in picked if o.cat == "kernel") / tr.steps
