"""Multi-GPU training over ``torch.distributed``, counterpart of
``ppr_diffphys_tpu/parallel/sharding.py``: one process (rank) per card, as
``torchrun --nproc_per_node N -m ppr_diffphys_torch.main ...`` starts them.

- **dp** (environment parallelism): each rank rolls out, differentiates
  and scores its own slice of the envs. ``gather_envs`` collects the
  per-env loss rows on every rank, in rank order, so every rank reduces the
  same rows to the same loss bit for bit; ``sum_grads`` sums the ranks'
  gradients in rank order on every rank, so the replicas never drift.
- **tp** (tensor parallelism): the MLP trunks' and time embeddings' linear
  layers that ``param_shardings`` names compute only this rank's slice of
  their output features and all-gather the rest within the rank's tp group
  (``tp_linear``, active inside ``tp_scope``). The weights stay whole on
  every rank, so the optimizer, the norms and checkpoints see whole tensors.

The JAX package leaves the collectives to XLA; here they are explicit, and
only ``all_gather`` and ``broadcast`` are used, which gloo and NCCL both
take. Sums are taken by gathering every rank's part and adding the parts in
rank order on every rank, never by a float ``all_reduce``, whose order is
the backend's. With gloo, CUDA tensors are staged through host memory.

A rank outside the active ``dp*tp`` ranks (2 envs on 4 ranks) still joins
every collective: it repeats the work of the rank ``r mod dp*tp`` rows above
it, without tp, and contributes zero to every sum and no rows to any
gather. Without a process group (a plain ``python -m ...``) the world is 1
and nothing here calls a collective.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

# how long a rank waits to join the world, and for any collective
DEFAULT_TIMEOUT_S = 300.0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def init_distributed(device=None, backend=None, init_method=None, local_rank=None,
                     timeout_s=DEFAULT_TIMEOUT_S):
    """Join the world that ``torchrun`` describes in ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` (``local_rank``, the CLI's legacy
    ``--local_rank``, when ``LOCAL_RANK`` is unset). Returns (rank, world,
    device): ``device`` (default cuda) resolved to ``cuda:<local rank>``
    when it names no index, made the current device. The backend is nccl
    for cuda and gloo for cpu unless named; ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``). A rank that cannot join
    within ``timeout_s`` seconds raises. With no world (``WORLD_SIZE``
    unset or 1) nothing is initialized and the world is 1."""
    from .. import default_device

    lr = int(os.environ.get("LOCAL_RANK", local_rank if local_rank is not None else 0))
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", lr)
    dev = default_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dev
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1, dev
    r = int(os.environ["RANK"])
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=r,
                            world_size=world, timeout=timedelta(seconds=timeout_s))
    return r, world, dev


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class Mesh:
    """``dp`` x ``tp`` ranks laid out as the JAX mesh lays out devices:
    rank ``d * tp + t`` holds env slice ``d`` and feature slice ``t``.
    ``tp_group`` is this rank's tp process group (None when tp is 1 or the
    rank is outside the mesh)."""

    dp: int
    tp: int
    rank: int
    world: int
    tp_group: object = None

    axis_names = ("dp", "tp")

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def active(self) -> bool:
        return self.rank < self.dp * self.tp

    @property
    def dp_index(self) -> int:
        return (self.rank // self.tp) % self.dp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    def tp_rows(self, n: int) -> slice:
        """This rank's slice of ``n`` features split over tp."""
        k = n // self.tp
        return slice(self.tp_index * k, (self.tp_index + 1) * k)


_mesh_cache = {}


def parse_mesh_shape(mesh_shape) -> dict:
    """A mesh shape given as a dict or in the CLI form ``"dp=4,tp=2"``."""
    if isinstance(mesh_shape, str):
        return {k.strip(): int(v) for k, v in
                (kv.split("=") for kv in mesh_shape.split(",") if kv)}
    return dict(mesh_shape or {})


def mesh_budget(ngpu, mesh_shape, world: int):
    """(device budget, tp, dp cap) from the ``ngpu`` and ``mesh_shape``
    options, as the JAX phys_model reads them: ngpu -1 or 0 is every rank,
    k the first k."""
    ngpu = int(ngpu)
    budget = min(ngpu, world) if ngpu > 0 else world
    ms = parse_mesh_shape(mesh_shape)
    tp = max(1, int(ms.get("tp", 1)))
    return budget, tp, (int(ms["dp"]) if "dp" in ms else None)


def mesh_dims(num_envs: int, budget: int, tp: int, dp_cap=None):
    """(dp, tp) for ``num_envs`` envs, or None for the unsharded path: tp
    only when it divides the budget, dp the largest divisor of num_envs
    within budget // tp (and the dp cap); None when dp * tp <= 1."""
    tp = tp if (tp > 1 and budget % tp == 0) else 1
    cap = budget // tp
    if dp_cap is not None:
        cap = min(cap, dp_cap)
    dp = max((d for d in range(1, cap + 1) if num_envs % d == 0), default=1)
    return None if dp * tp <= 1 else (dp, tp)


def make_mesh(mesh_shape: Optional[dict] = None, devices=None) -> Mesh:
    """mesh_shape e.g. {"dp": 4, "tp": 2}; None puts every rank on dp.
    ``devices`` are the ranks the mesh may take (default: all), the first
    dp * tp of which form it. Every rank must call this with the same shape
    in the same order (the tp groups are made collectively); cached per
    (dp, tp)."""
    n = len(devices) if devices is not None else world_size()
    ms = parse_mesh_shape(mesh_shape) or {"dp": n}
    dp, tp = int(ms.get("dp", 1)), int(ms.get("tp", 1))
    if dp * tp > n:
        raise ValueError("mesh %s needs %d ranks; %d given" % (ms, dp * tp, n))
    key = (dp, tp)
    if key not in _mesh_cache:
        r, group = rank(), None
        if tp > 1:
            for d in range(dp):
                g = dist.new_group(ranks=list(range(d * tp, (d + 1) * tp)))
                if d * tp <= r < (d + 1) * tp:
                    group = g
        _mesh_cache[key] = Mesh(dp, tp, r, world_size(), group)
    return _mesh_cache[key]


@dataclass(frozen=True)
class EnvSharding:
    """The leading env axis split over dp: ``rows(n)`` is this rank's slice
    of n envs, ``gather`` the per-env rows of every dp slice in order."""

    mesh: Optional[Mesh] = None

    def rows(self, n: int) -> slice:
        if self.mesh is None:
            return slice(0, n)
        dp = self.mesh.dp
        if n % dp:
            raise ValueError("%d envs do not split over dp=%d" % (n, dp))
        k = n // dp
        return slice(self.mesh.dp_index * k, (self.mesh.dp_index + 1) * k)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_envs(x, self.mesh)


@dataclass(frozen=True)
class Replicated:
    """The same value on every rank."""

    mesh: Optional[Mesh] = None


def env_sharding(mesh: Optional[Mesh]) -> EnvSharding:
    """Shard the leading env axis over dp."""
    return EnvSharding(mesh)


def replicated(mesh: Optional[Mesh]) -> Replicated:
    return Replicated(mesh)


def _is_tp_kernel(name: str) -> bool:
    """Dense kernels inside the MLP trunks (and time embeddings) get their
    output-feature axis split over tp."""
    return ("trunk" in name or "time_embedding" in name) and name.endswith("kernel")


def param_shardings(mesh: Optional[Mesh], named_tensors) -> dict:
    """JAX name -> the axis tp splits (0: torch's ``nn.Linear.weight`` is
    (out, in), so the output features are axis 0) or None (replicated), for
    every (name, tensor) of ``phys_model.named_tensors()``: MLP trunk
    kernels whose width divides by tp when the mesh has tp > 1."""
    tp = mesh.tp if mesh is not None else 1
    return {n: 0 if (tp > 1 and t.ndim == 2 and _is_tp_kernel(n) and t.shape[0] % tp == 0)
            else None for n, t in named_tensors}


def shard_train_step(fn, mesh: Optional[Mesh], params_template):
    """Wrap a train step ``fn(env_shard, *args) -> (out, grads)``, grads one
    per (name, tensor) of ``params_template``: the step runs on this rank's
    env slice with the tp layers split (``tp_scope``) and returns the
    gradients summed over the mesh (``sum_grads``). Without a mesh it is
    ``fn`` on every env."""
    axes = param_shardings(mesh, params_template)
    axes = [axes[n] for n, _ in params_template]
    shard = env_sharding(mesh)

    def step(*args):
        with tp_scope(mesh):
            out, grads = fn(shard, *args)
        return out, sum_grads(mesh, grads, axes)

    return step


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _all_gather(x: torch.Tensor, group=None) -> list:
    """Every rank's ``x`` of the group, in rank order."""
    stage = x.is_cuda and dist.get_backend(group) == "gloo"
    y = x.detach().contiguous()
    y = y.cpu() if stage else y
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return [p.to(x.device) for p in parts] if stage else parts


def ordered_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group, added in rank order on
    every rank: the same bits everywhere."""
    parts = _all_gather(x, group)
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc


def broadcast_from_rank0(values):
    """Rank 0's float values on every rank (the inputs of host decisions
    that change the model); the values unchanged in a world of 1."""
    if world_size() <= 1:
        return values
    t = torch.tensor(values, dtype=torch.float64)
    stage = dist.get_backend() == "nccl"
    t = t.cuda() if stage else t
    dist.broadcast(t, 0)
    return t.cpu().tolist()


class _GatherEnvs(torch.autograd.Function):
    """Forward: every dp slice's rows in dp order, on every rank. Backward:
    this rank's slice of the incoming gradient, with no communication: every
    rank computes the same loss from the same rows, so summing the
    gradient over ranks (as ``torch.distributed.nn``'s all_gather does)
    would count it world times."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows = env_sharding(mesh).rows(x.shape[0] * mesh.dp)
        parts = _all_gather(x)
        return torch.cat([parts[d * mesh.tp] for d in range(mesh.dp)], 0)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None


def gather_envs(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(E/dp, ...) rows of this rank -> (E, ...) rows of every dp slice, the
    same on every rank; x itself without a mesh."""
    if mesh is None:
        return x
    return _GatherEnvs.apply(x, mesh)


def sum_grads(mesh: Optional[Mesh], grads, axes=None) -> list:
    """The mesh's sum of each gradient, bit-identical on every rank: all of
    them as one flat fp32 vector, all-gathered and added in rank order. A
    replicated tensor counts from tp index 0 only, a tp-split one (axis in
    ``axes``) with its own rows only, a rank outside the mesh with zero.
    The gradients unchanged without a mesh."""
    grads = list(grads)
    if mesh is None:
        return grads
    axes = axes if axes is not None else [None] * len(grads)
    flat = []
    for g, ax in zip(grads, axes):
        c = torch.zeros_like(g, dtype=torch.float32)
        if mesh.active and ax is not None:
            rows = mesh.tp_rows(g.shape[ax])
            c.narrow(ax, rows.start, rows.stop - rows.start).copy_(
                g.narrow(ax, rows.start, rows.stop - rows.start))
        elif mesh.active and mesh.tp_index == 0:
            c.copy_(g)
        flat.append(c.reshape(-1))
    total = ordered_sum(torch.cat(flat))
    out, o = [], 0
    for g in grads:
        out.append(total[o:o + g.numel()].view(g.shape))
        o += g.numel()
    return out


def replicas_agree(tensors) -> bool:
    """True when every rank holds the same bits in ``tensors`` (the
    parameters after an update): a position-weighted checksum of their
    int32 bit patterns, all-gathered."""
    bits = torch.cat([t.detach().to(torch.float32).reshape(-1).view(torch.int32).to(torch.int64)
                      for t in tensors])
    pos = torch.arange(1, bits.numel() + 1, dtype=torch.int64, device=bits.device)
    mine = torch.stack([bits.sum(), (bits * (pos % 65521)).sum()])
    if world_size() <= 1:
        return True
    parts = _all_gather(mine)
    return all(bool(torch.equal(p, parts[0])) for p in parts)


# ---------------------------------------------------------------------------
# tp over the MLP trunks
# ---------------------------------------------------------------------------
_TP_MESH = None


@contextlib.contextmanager
def tp_scope(mesh: Optional[Mesh]):
    """Inside, ``tp_linear`` splits its output features over the mesh's tp
    group (ranks outside the mesh, and tp of 1, compute whole)."""
    global _TP_MESH
    prev = _TP_MESH
    _TP_MESH = mesh if (mesh is not None and mesh.tp > 1 and mesh.active) else None
    try:
        yield
    finally:
        _TP_MESH = prev


class _SplitLinear(torch.autograd.Function):
    """x @ weight[rows].T on this rank's output rows, all-gathered within
    the tp group. Backward: the weight's gradient on its own rows (zero
    elsewhere), and the input's gradient summed over the group in rank
    order (each rank's part flows only through its own rows)."""

    @staticmethod
    def forward(ctx, x, weight, mesh):
        rows = mesh.tp_rows(weight.shape[0])
        ctx.rows, ctx.group = rows, mesh.tp_group
        ctx.save_for_backward(x, weight)
        return torch.cat(_all_gather(F.linear(x, weight[rows]), mesh.tp_group), -1)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        rows = ctx.rows
        gy = gy[..., rows]
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = ordered_sum(gy @ weight[rows], ctx.group)
        if ctx.needs_input_grad[1]:
            gw = torch.zeros_like(weight)
            gw[rows] = gy.reshape(-1, gy.shape[-1]).T @ x.reshape(-1, x.shape[-1])
        return gx, gw, None


def tp_linear(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """``F.linear(x, weight, bias)``; inside ``tp_scope`` with tp > 1 the
    output features split over the tp group when they divide by tp (the
    bias, replicated, is added whole)."""
    mesh = _TP_MESH
    if mesh is None or weight.shape[0] % mesh.tp:
        return F.linear(x, weight, bias)
    y = _SplitLinear.apply(x, weight, mesh)
    return y if bias is None else y + bias
