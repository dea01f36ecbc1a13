"""Host milliseconds per traced training step in the program's span
``rollout.interval``: ``DiffInterval.__call__``, the K2 wrapper's checks,
packing and launch, over the steps' ``phys_model.forward`` roots."""


def read(ctx):
    try:
        from ppr_diffphys_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    return spans.per_root_ms(spans.summary(), "rollout.interval", "phys_model.forward",
                             ctx["work"].get("steps"))
