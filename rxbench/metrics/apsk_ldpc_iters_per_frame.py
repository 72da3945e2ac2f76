"""LDPC iterations a frame over the profiled calls: the step's counter
``ldpc_frame_iters`` (the iterations each frame of a call ran, summed by
the program) over the frames those calls decoded (steps x channels x
frames a step). None where the program has no such counter."""

NAME = "apsk_ldpc_iters_per_frame"
UNIT = "iterations"
LAYER = "FEC"
PATTERNS = ()
COUNTER = "stats.ldpc_frame_iters"


def frames(view):
    g = view.geometry
    return view.steps * g["channels"] * g["frames_per_step"]


def read(view):
    iters = view.counters.get(COUNTER)
    if iters is None or not frames(view):
        return None
    return iters / frames(view)
