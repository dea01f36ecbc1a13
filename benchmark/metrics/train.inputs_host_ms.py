"""Host milliseconds per traced training step in the program's span
``forward.inputs``: ``get_batch_input`` (the mocap targets and the five
time-MLPs), over the steps' ``phys_model.forward`` roots."""


def read(ctx):
    try:
        from ppr_diffphys_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    return spans.per_root_ms(spans.summary(), "forward.inputs", "phys_model.forward",
                             ctx["work"].get("steps"))
