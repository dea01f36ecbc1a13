"""Percent of the (env, substep, contact) triples that K3 processed in the
traced steps whose contact penetrates: the program's counters
``k3.active_contacts`` over ``k3.contact_triples``."""


def read(ctx):
    try:
        from ppr_diffphys_torch.utils import spans
    except ImportError:  # a program without the span recorder
        return None
    c = spans.summary()["counters"]
    n = c.get("k3.contact_triples", 0)
    return 100.0 * c.get("k3.active_contacts", 0) / n if n > 0 else None
