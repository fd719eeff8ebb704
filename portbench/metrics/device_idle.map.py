"""device_idle.map (%): the share of a mapping step's wall time in which no
kernel, copy or memset ran on the card: one minus the device's busy seconds
a step (the union of the device operations' intervals in the device-only
trace, over its steps) over the untraced window's seconds a step.  Any
profiler slows the host's launches (CUPTI's callbacks too), so the traced
window's own length would count that slowing as idle time; a kernel's
duration it leaves as it is."""


def read(ctx):
    tr, step_s = ctx.get("device_trace"), ctx.get("step_s")
    if tr is None or "counts" not in ctx or not tr.steps or not step_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.steps / step_s)
