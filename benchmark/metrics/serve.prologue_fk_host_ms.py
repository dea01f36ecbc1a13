"""Host milliseconds per traced request in the program's span
``prologue.fk``: ``eval_fk`` of the initial states, over the requests'
``prologue`` roots."""


def read(ctx):
    try:
        from ppr_diffphys_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    return spans.per_root_ms(spans.summary(), "prologue.fk", "prologue",
                             ctx["work"].get("steps"))
