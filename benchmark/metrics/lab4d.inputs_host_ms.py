"""Host milliseconds per traced lab4d step in the program's span
``forward.inputs``: ``phys_interface.get_batch_input`` (the ground-truth
kinematics over the fields, the proxy and its delta MLPs, the three
remaining time-MLPs), over the steps' ``phys_model.forward`` roots."""


def read(ctx):
    try:
        from ppr_diffphys_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    return spans.per_root_ms(spans.summary(), "forward.inputs", "phys_model.forward",
                             ctx["work"].get("steps"))
