"""loss_launches.map (count): kernels a mapping step launched inside the
program's ``miso.step.loss`` span (``train/trainer.py::make_train_step``:
the pose gather, interp, decode and loss terms), in the CPU-and-device
trace's window.  Nothing where no operation lies in the span, as in a
program without it."""

SPAN = "miso.step.loss"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.steps:
        return None
    picked = [o for o in tr.ops if SPAN in o.scopes]
    if not picked:
        return None
    return sum(1 for o in picked if o.cat == "kernel") / tr.steps
