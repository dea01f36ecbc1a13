"""Host milliseconds per traced training step in the program's span
``forward.backward``: ``torch.autograd.grad`` (K3 and the MLP backward),
over the steps' ``phys_model.forward`` roots."""


def read(ctx):
    try:
        from ppr_diffphys_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    return spans.per_root_ms(spans.summary(), "forward.backward", "phys_model.forward",
                             ctx["work"].get("steps"))
