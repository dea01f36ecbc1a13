"""Host milliseconds per traced request in the program's span
``prologue.mlp``: ``get_batch_input`` on the substep grid (or the per-env
chunks), over the requests' ``prologue`` roots."""


def read(ctx):
    try:
        from ppr_diffphys_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    return spans.per_root_ms(spans.summary(), "prologue.mlp", "prologue",
                             ctx["work"].get("steps"))
