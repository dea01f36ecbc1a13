"""Host milliseconds per traced lab4d step in the program's span
``update.grad_read``: the one read of the gradient statistics in
``check_grad``, where the host waits for the device."""


def read(ctx):
    try:
        from ppr_diffphys_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    return spans.per_root_ms(spans.summary(), "update.grad_read", "phys_model.forward",
                             ctx["work"].get("steps"))
