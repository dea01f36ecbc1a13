"""Host milliseconds per traced training step in the program's span
``forward.graph``: staging the step's inputs and replaying its captured CUDA
graph (the forward, its gradient and norms), over the steps'
``phys_model.forward`` roots. None for a program that runs the step
eagerly (no such span)."""


def read(ctx):
    try:
        from ppr_diffphys_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    return spans.per_root_ms(spans.summary(), "forward.graph", "phys_model.forward",
                             ctx["work"].get("steps"))
