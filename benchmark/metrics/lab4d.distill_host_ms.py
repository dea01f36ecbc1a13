"""Host milliseconds per traced lab4d step in the program's span
``losses.distill``: ``phys_interface._distill_rows`` (the distilled
kinematics, its FK and loss rows), over the steps' ``phys_model.forward``
roots."""


def read(ctx):
    try:
        from ppr_diffphys_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    return spans.per_root_ms(spans.summary(), "losses.distill", "phys_model.forward",
                             ctx["work"].get("steps"))
