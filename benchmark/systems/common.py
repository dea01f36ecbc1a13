"""What every system shares: seeds derived from ``--seed``, the
weights the benchmark makes on the device, and the options both sides are
built from."""

from __future__ import annotations

import hashlib
import math
import os

import torch

from ..harness import ROOT


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of draws (``tag``) of a run's seed; any
    whole number, however large, gives one."""
    h = hashlib.sha256(("%d:%s" % (int(seed), tag)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def checkout_path(rel: str) -> str:
    return os.path.join(ROOT, rel)


def opts_from(config: dict, build_opts, **extra) -> dict:
    """The options of a configuration (``config["opts"]``), with its data
    paths made absolute in this checkout. Nothing is written under
    ``logroot``: no run saves a checkpoint."""
    o = dict(config["opts"])
    for k in ("datadir", "urdf_dir"):
        if k in o:
            o[k] = checkout_path(o[k])
    o["logroot"] = checkout_path(".bench_cache/logdir")
    o.update(extra)
    return build_opts(**o)


def seed_weights(named, groups, seed: int, device) -> int:
    """Overwrite the MLP tensors named by ``groups`` from one draw on the
    device: each group is a list of name prefixes whose tensors get the same
    values (copies of one MLP). Weight matrices are LeCun normal
    (1/sqrt(fan_in)), biases normal with std 0.01, embeddings standard
    normal, as the program's own initialization draws them except for the
    biases, which it zeroes; a camera MLP's ``base_quat`` keeps its value.
    Names are JAX paths (``kernel``, ``embedding``) or state-dict keys
    (``weight``, ``inst_embedding.mapping.weight``). Returns the number of
    values drawn."""
    by_name = dict(named)
    leaves = []
    for group in groups:
        first = group[0] + "."
        for n, t in named:
            if n.startswith(first) and not n.endswith("base_quat"):
                suffix = n[len(first):]
                leaves.append((suffix, [t] + [by_name[p + "." + suffix] for p in group[1:]]))
    total = sum(ts[0].numel() for _, ts in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    off = 0
    with torch.no_grad():
        for suffix, ts in leaves:
            t = ts[0]
            v = flat[off:off + t.numel()].view(t.shape)
            off += t.numel()
            if suffix.endswith("bias"):
                v = v * 0.01
            elif not (suffix.endswith(".embedding") or suffix.endswith("embedding.mapping.weight")):
                v = v / math.sqrt(t.shape[-1])
            for x in ts:
                x.copy_(v)
    return total


def check_widths(modules: dict, config: dict):
    """Every built MLP trunk is as wide as the configuration says
    (``config["mlp"]["W"]``)."""
    W = int(config["mlp"]["W"])
    for name, m in modules.items():
        trunk = [getattr(m, "linear_%d" % (i + 1))[0] for i in range(m.D)] + [m.linear_final[0]]
        if m.W != W or any(x.out_features != W for x in trunk):
            raise ValueError("%s is not %d wide" % (name, W))


def fp32_matmuls(tf32: bool):
    """Matrix products in fp32 (TF32 off, as the configurations state) or,
    for the control, in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
