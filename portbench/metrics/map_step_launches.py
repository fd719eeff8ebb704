"""map_step_launches (count): device kernels launched a mapping step, in the
device-only trace's window."""


def read(ctx):
    tr = ctx.get("device_trace")
    if tr is None or "counts" not in ctx or not tr.steps:
        return None
    return tr.count(lambda o: o.cat == "kernel") / tr.steps
