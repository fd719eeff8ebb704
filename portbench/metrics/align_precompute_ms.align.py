"""align_precompute_ms.align (ms): device milliseconds an alignment call
spent selecting its coordinates: every kernel, memset and copy launched
inside the program's ``miso.align.precompute`` span
(``models/grid_atlas.py::precompute_coordinates_for_alignment``: every
submap's every vertex read, its norm, the random top-P), in the
CPU-and-device trace's window, over its calls.  Nothing where no operation
lies in the span, as in a program without it."""

SPAN = "miso.align.precompute"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.steps:
        return None
    picked = [o for o in tr.ops if SPAN in o.scopes]
    if not picked:
        return None
    return 1e-3 * sum(o.dur for o in picked) / tr.steps
