"""The training step that ``phys_model.forward`` captures as one CUDA graph
(``ppr_diffphys_torch/models/step_graph.py``), on the CPU.

A CUDA graph replays what its capture recorded, so the step must read its
per-step inputs from static buffers and must neither copy from the host nor
read a device value back while it runs. Here the capture-ready step runs
eagerly on the CPU, its static buffers refilled each step, against the
eager forward; the constant tables it reads are held to what the per-call
uploads made; and the step is run under a recorder of every call that on a
card would copy from the host or make the host wait. The card tests (the
capture and its replay) are in ``tests/test_torch_cuda.py``.
"""

import collections
import traceback

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from ppr_diffphys_torch.data.amp_loader import DataLoader
from ppr_diffphys_torch.models.phys_model import phys_model
from ppr_diffphys_torch.sim import integrator as tint
from ppr_diffphys_torch.sim import soa
from ppr_diffphys_torch.sim.builder import GEO_MESH, Shape
from ppr_diffphys_torch.sim.integrator import dof_index
from ppr_diffphys_torch.sim.kinematics import fk_tables
from ppr_diffphys_torch.utils import spans

import port_helpers as H

STEPS = 3
NOISE = 0.01


def _model(tmp, E, F, noise_std, graphed):
    o = H.serve_opts(logroot=str(tmp), num_rounds=1, iters_per_round=STEPS + 1,
                     noise_std=noise_std)
    m = phys_model(dict(o), DataLoader(o), device="cpu")
    m.reinit_envs(E, frames_per_wdw=F, is_eval=False)
    m._graphed = graphed
    return m


@pytest.mark.parametrize("E,F", [(2, 3), (3, 2)], ids=["e2f3", "e3f2"])
@pytest.mark.parametrize("noise,progress", [(0.0, 0.0), (NOISE, 0.3), (NOISE, 0.8)],
                         ids=["no_noise", "noise_annealing", "noise_clipped"])
def test_static_step_is_bitwise_the_eager_forward(tmp_path, E, F, noise, progress):
    """Three steps of the capture-ready step (its static buffers refilled
    each step) give the eager forward's losses, every tensor's gradient and,
    after ``update()``, its parameters, bit for bit; the noise ratio is
    clipped at 0 from progress 2/3 on."""
    eager = _model(tmp_path / "a", E, F, noise, graphed=False)
    static = _model(tmp_path / "b", E, F, noise, graphed=True)
    for i in range(STEPS):
        eager.progress = static.progress = progress + 0.01 * i
        a, b = eager.forward(), static.forward()
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (i, k)
        for k, g in eager.last_grads.items():
            assert torch.equal(g, static.last_grads[k]), (i, k)
        eager.update()
        static.update()
    assert static._graph is not None and static._graph.graph is None  # no capture off CUDA
    assert static._graph.frame_start.shape == (E,)
    assert (static._graph.noise is not None) == (noise > 0)
    for (n, x), (_, y) in zip(eager.named_tensors(), static.named_tensors()):
        assert torch.equal(x, y), n


def test_noise_is_the_forward_s_draw(tmp_path):
    """``_draw_noise``: the generator's draw over every env, annealed by
    progress, the root position left alone and its rotation noise x5, as
    the forward computed it on the device."""
    m = _model(tmp_path, 3, 2, NOISE, graphed=False)
    m.progress = 0.2
    state = m.generator.get_state()
    got = m._draw_noise(3)
    m.generator.set_state(state)
    want = torch.randn((3, 7 + m.n_dof), generator=m.generator)
    want = want * m.noise_std * float(np.clip(1.0 - 1.5 * m.progress, 0.0, 1.0))
    want[:, :3] = 0.0
    want[:, 3:7] *= 5.0
    assert torch.equal(got, want)
    m.noise_std = 0.0
    assert m._draw_noise(3) is None


def test_device_tables_equal_the_per_call_uploads(tmp_path):
    """The tables the step reads are made once per device and equal what
    each call uploaded before: eval_fk's, the dof index, the frame
    sampler's offsets, the window's frame and substep tables (rebuilt by
    ``reinit_envs``) and the foot mesh."""
    m = _model(tmp_path, 2, 3, 0.0, graphed=False)
    env = m.env
    tb = fk_tables(env, "cpu")
    assert fk_tables(env, "cpu") is tb
    q_idx = np.clip(env.joint_q_start[:, None] + np.arange(3)[None, :], 0, env.n_q - 1)
    qd_idx = np.clip(env.joint_qd_start[:, None] + np.arange(3)[None, :], 0, env.n_qd - 1)
    np.testing.assert_array_equal(tb["q_idx"].numpy(), q_idx)
    np.testing.assert_array_equal(tb["qd_idx"].numpy(), qd_idx)
    np.testing.assert_array_equal(tb["axis"].numpy(), env.joint_axis)
    np.testing.assert_array_equal(tb["X_p"].numpy(), env.joint_X_p)
    np.testing.assert_array_equal(tb["com"].numpy(), env.body_com)
    np.testing.assert_array_equal(tb["m_rev"].numpy()[:, 0], env.joint_type == 1)
    assert tb["pos"].shape == (env.n_links,) and sorted(tb["pos"].tolist()) == list(
        range(env.n_links))
    np.testing.assert_array_equal(soa.dof_index_table(env, "cpu").numpy(), dof_index(env))
    for s in m.samplers.values():
        off = s._off(torch.zeros(1))
        assert s._off(torch.zeros(1)) is off
        np.testing.assert_array_equal(off.numpy(), np.asarray(s.frame_offset_raw, np.float32))
    np.testing.assert_array_equal(m._foot_verts.numpy(), m._mesh_verts.astype(np.float32))
    np.testing.assert_array_equal(m._foot_vbody.numpy(), m._mesh_vbody)
    for F in (3, 5):
        m.reinit_envs(2, frames_per_wdw=F, is_eval=False)
        assert torch.equal(m._frame2step_t, torch.as_tensor(m.frame2step, dtype=torch.long))
        assert torch.equal(m._steps_idx_fr_t,
                           torch.as_tensor(m.steps_idx_fr, dtype=torch.float32))
        assert m._frame2step_t.shape == (F,)


@pytest.mark.parametrize("fallback", [True, False], ids=["fallback", "no_fallback"])
def test_hull_fallback_changes_the_contact_set_alone(tmp_path, monkeypatch, fallback):
    """An eval that finds the hull assumption violated switches the model's
    own contact set to 'all': the integrator and the window stay, the next
    eval's rollout reads the new set, and the training step's graph is made
    anew for it. With contact_fallback=False the set and the graph stay.
    a1 has no mesh, so a cube mesh (8 hull, 14 contacts in all) goes on its
    last link, which keeps the contacts body-sorted."""
    m = _model(tmp_path, 2, 3, 0.0, graphed=True)
    m.opts["contact_fallback"] = fallback
    env = m.env
    cube = H.cube_with_centres(0.01)
    env.shapes.append(Shape(env.shapes[-1].body, np.array([0, 0, 0, 0, 0, 0, 1.0]), GEO_MESH,
                            np.ones(3), cube, np.array([1e4, 0.0, 1e2, 1.0])))
    env.make_ground_contacts("hull")
    n_hull, gen, integ = env.contact_count, env.contact_generation, m.integrator
    m.forward()
    m.update()
    graph = m._graph
    seen = []
    contacts = tint.eval_body_contacts

    def spy(model, params, state):
        seen.append((model is env, model.contact_count))
        return contacts(model, params, state)

    monkeypatch.setattr(tint, "eval_body_contacts", spy)
    monkeypatch.setattr(env, "validate_hull_contacts", lambda body_q, margin=0.0: 1.0)
    m.reinit_envs(1, frames_per_wdw=3, is_eval=True)
    m.forward()
    window = m._window(3)
    assert set(seen) == {(True, n_hull)}
    n = n_hull + 6 if fallback else n_hull
    assert env.contact_mode == ("all" if fallback else "hull") and env.contact_count == n
    assert env.contact_generation == gen + int(fallback)
    assert m.integrator is integ and m._window(3) is window
    seen.clear()
    m.forward()
    assert set(seen) == {(True, n)}
    m.reinit_envs(2, frames_per_wdw=3, is_eval=False)
    m.forward()
    m.update()
    assert (m._graph is graph) != fallback


def test_inverse_without_its_check_is_inv(tmp_path):
    """``_sim_params`` inverts the inertia with ``linalg.inv_ex``: the same
    factorization as ``linalg.inv`` without the check that reads the
    result on the host; values and gradients are inv's."""
    m = _model(tmp_path, 2, 3, 0.0, graphed=False)
    mass = m.params["body_mass"].detach().clone().requires_grad_(True)
    got = m._sim_params(dict(m.params, body_mass=mass)).body_inv_inertia
    inertia = m.norm_body_inertia * mass[:, None, None]
    want = torch.linalg.inv(inertia)
    assert torch.equal(got, want)
    w = torch.randn(want.shape, generator=torch.Generator().manual_seed(3))
    (g_got,) = torch.autograd.grad((got * w).sum(), mass)
    (g_want,) = torch.autograd.grad((want * w).sum(), mass)
    assert torch.equal(g_got, g_want)


# calls that a CUDA graph cannot capture: a read of a device value on the
# host, an output whose size depends on the data, inv's check
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique2",
              "unique_consecutive", "repeat_interleave", "_linalg_check_errors"}


class _HostTraffic(TorchDispatchMode):
    """Records, by the port's source line, every operation that on a card
    reads a device value back or sizes its output by the data (boolean
    indexing included)."""

    def __init__(self, hits):
        super().__init__()
        self.hits = hits

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        bool_index = name in ("index", "index_put", "index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
            for i in (args[1] if len(args) > 1 else ()) if i is not None)
        if name in HOST_READS or bool_index:
            self.hits[(name, _where())] += 1
        return func(*args, **(kwargs or {}))


def _where():
    """The innermost port line on the stack, or None inside the plain
    interval (``sim/integrator.py``), the CPU's stand-in for the kernels."""
    frames = [f for f in traceback.extract_stack() if "ppr_diffphys_torch" in f.filename]
    if any(f.filename.endswith("sim/integrator.py") for f in frames):
        return None
    return "%s:%d" % (frames[-1].filename.split("ppr_diffphys_torch")[-1], frames[-1].lineno) \
        if frames else "?"


def test_step_copies_nothing_from_the_host_and_reads_nothing_back(tmp_path, monkeypatch):
    """The capture-ready step (forward, gradient, norms) makes no tensor of
    host data (``torch.tensor``, ``as_tensor`` or ``from_numpy`` of a list
    or array: on a card a blocking copy), assigns no Python number into a
    0-d view (a copy from the host), and reads no device value back, outside
    the plain interval that stands in for the kernels on the CPU."""
    m = _model(tmp_path, 2, 3, NOISE, graphed=True)
    m.forward()  # builds every table the step reads
    m.update()
    g = m._graph
    hits = collections.Counter()
    for name in ("tensor", "as_tensor", "from_numpy"):
        orig = getattr(torch, name)

        def made(data, *a, _orig=orig, _name=name, **k):
            if not isinstance(data, torch.Tensor):
                hits[(_name, _where())] += 1
            return _orig(data, *a, **k)

        monkeypatch.setattr(torch, name, made)
    setitem = torch.Tensor.__setitem__

    def set0d(self, idx, value):
        if isinstance(value, (bool, int, float)) and self[idx].dim() == 0:
            hits[("setitem", _where())] += 1
        return setitem(self, idx, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", set0d)
    with _HostTraffic(hits):
        losses, grads, norms, gnorm = g.run()
    monkeypatch.undo()
    hits = {k: n for k, n in hits.items() if k[1] is not None}
    assert hits == {}
    assert losses.shape == (len(g.loss_keys),) and len(grads) == len(m.named_tensors())
    assert torch.isfinite(losses).all() and torch.isfinite(gnorm)


def test_steps_count_what_ran_eagerly(tmp_path):
    """Off CUDA no step is captured: under the profiler every forward, the
    static step's and the eager one's, counts ``graph.eager_steps``, and the
    static step records its span ``forward.graph``."""
    spans.reset()
    try:
        static = _model(tmp_path / "a", 2, 3, 0.0, graphed=True)
        eager = _model(tmp_path / "b", 2, 3, 0.0, graphed=False)
        with profile(activities=[ProfilerActivity.CPU]):
            static.forward()
            static.update()
            eager.forward()
            eager.update()
        s = spans.summary()
        assert s["counters"].get("graph.eager_steps") == 2
        assert "graph.replays" not in s["counters"] and "graph.captures" not in s["counters"]
        assert s["spans"]["forward.graph"]["calls"] == 1
        assert s["spans"]["forward.graph"]["parent"] == "phys_model.forward"
    finally:
        spans.reset()
