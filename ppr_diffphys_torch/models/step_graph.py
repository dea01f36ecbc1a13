"""The imitation training step as one CUDA graph.

``phys_model.forward`` runs its unsharded training step through a
:class:`StepGraph`: the whole forward (``_forward_pure``), the gradient of
its total loss in every tensor (``torch.autograd.grad``) and the gradient
norms, captured once per key (envs, frames, loss weights, noise on or off,
the contact set's generation, whose kernel constants the capture reads by
address) into one ``torch.cuda.CUDAGraph`` and replayed on every later
step. The host then launches one graph a step instead of the ~15k
kernels that the forward and autograd's backward launch one by one, and
makes no blocking copy: the step's two host inputs, the window starts and
the initial state's noise (both drawn on the host from the model's
generator), are copied from pinned memory into static device buffers
before each replay, and every constant table the step reads is made once on
the device.

The graph reads the parameters where they live (the optimizer updates them
in place) and the constant tables it was captured with (the StepGraph keeps
alive the window's, which ``reinit_envs`` replaces), and writes its outputs,
the losses, one gradient per ``named_tensors()`` entry and the norms, into
the same tensors on every replay. Off CUDA the same step runs eagerly on the same static buffers (the
CPU tests hold it to the eager forward bit for bit).

While the profiler records, a step is the span ``forward.graph`` (staging
and the replay call) and counts ``graph.captures`` and ``graph.replays``;
the spans inside the step run only at the capture. K3's contact counters
are summed on the device inside the graph (``DiffInterval.count_sink``) and
counted after each replay (``k3.contact_triples``, ``k3.active_contacts``).
"""

from __future__ import annotations

import torch

from ..sim.soa_grad import ContactCounts
from ..utils import spans


def to_device(src, device, out=None):
    """A host tensor (or None) on ``device``, into ``out`` when given: from
    pinned memory, without making the host wait, on CUDA."""
    if src is None:
        return None
    if device.type == "cuda":
        src = src.pin_memory()
    if out is None:
        return src.to(device, non_blocking=True)
    return out.copy_(src, non_blocking=True)


class StepGraph:
    """One training step of ``model`` on static inputs: ``frame_start``
    (E,) and, with noise, ``noise`` (E, 7 + n_dof), for the step's
    ``weights`` and ``named`` tensors (``model.named_tensors()``). ``key``
    names what the capture fixed; the model makes a new StepGraph when it
    changes."""

    def __init__(self, model, key, weights, named, n_envs, noisy):
        self.model = model
        self.key = key
        self.weights = list(weights)
        self.named = named
        self.tensors = [t for _, t in named]
        dev = model.device
        f32 = dict(dtype=torch.float32, device=dev)
        self.frame_start = torch.zeros((n_envs,), **f32)
        self.noise = torch.zeros((n_envs, 7 + model.n_dof), **f32) if noisy else None
        self.counts = ContactCounts(dev)
        # a captured graph reads these by address; reinit_envs makes new ones
        self.window_tables = (model._frame2step_t, model._steps_idx_fr_t)
        self.graph = None
        self.interval = None
        self.launches = {}  # the interval kernels' launches in one replay
        self.loss_keys = None
        self.outputs = None  # (losses (K,), grads, norms, gnorm), rewritten by each step

    def step(self, frame_start, noise):
        """Stage the host inputs, capture on the first CUDA step, replay:
        returns the outputs, valid until the next step."""
        with spans.span("forward.graph"):
            to_device(frame_start, self.frame_start.device, self.frame_start)
            if self.noise is not None:
                to_device(noise, self.noise.device, self.noise)
            if self.frame_start.device.type != "cuda":
                spans.count("graph.eager_steps", 1)
                self.outputs = self.run()
                return self.outputs
            if self.graph is None:
                self._capture()
            self.graph.replay()
            for k, n in self.launches.items():
                self.interval.launches[k] += n
            spans.count("graph.replays", 1)
            if spans.recording():
                spans.count("k3.contact_triples", self.counts.triples)
                spans.count("k3.active_contacts", self.counts.active.clone())
        return self.outputs

    def run(self):
        """The step on the static buffers: (losses, grads, norms, gnorm),
        the losses stacked in ``loss_keys`` order."""
        m = self.model
        with m._leaves_need_grad(self.tensors):
            out, grads = m._grad_step(None, self.frame_start, self.noise, self.weights,
                                      self.tensors)
        norms, gnorm = m._grad_norms(self.named, grads)
        self.loss_keys = list(out)
        return torch.stack([out[k].detach() for k in self.loss_keys]), grads, norms, gnorm

    def _capture(self):
        """One eager warm-up on a side stream (it builds what the step makes
        at first use and changes no state: no update, no draw from the
        generator), then the capture. The warm-up's kernel launches count;
        the capture's, which run nothing, count at each replay."""
        m = self.model
        dev = self.frame_start.device
        interval = m._interval(False)
        interval.count_sink = self.counts
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.run()
            torch.cuda.current_stream(dev).wait_stream(side)
            before = dict(interval.launches)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.counts.reset()
                self.outputs = self.run()
            self.launches = {k: interval.launches[k] - n for k, n in before.items()}
            interval.launches.update(before)
        finally:
            interval.count_sink = None
        self.graph, self.interval = graph, interval
        spans.count("graph.captures", 1)
