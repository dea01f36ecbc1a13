"""Percent of the traced requests whose prologue replayed the captured grid
prologue: the program's counter ``prologue.replays`` over its ``prologue``
roots (one a request). None for a program without the counter or the
span."""


def read(ctx):
    try:
        from ppr_diffphys_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    summ = spans.summary()
    root = summ["spans"].get("prologue")
    replays = summ["counters"].get("prologue.replays")
    if root is None or replays is None or root["roots"] <= 0:
        return None
    return 100.0 * replays / root["roots"]
