"""The port's API surface against the JAX package's, read through
``inspect``: every public method of ``phys_model``, ``phys_interface``,
``KinematicsProxy`` and ``RolloutServer``, every public module-level
function and class of ``ops/``, ``utils/``, ``models/mlp.py``,
``models/torch_adapter.py`` and ``parallel/sharding.py`` (with the public
methods of those classes), and every flag of the training CLI exists in the
port and takes no more required positional arguments there. What is left
out on purpose stands in ``EXCEPTIONS`` with its reason.
"""

import importlib
import importlib.util
import inspect
import os
import pkgutil
import sys

import pytest

import port_helpers as H

# (JAX-side qualified name) -> why the port has no counterpart
EXCEPTIONS = {
    "phys_model.resolve_engine": "picks the TPU engine (Pallas soa or XLA); the port has one "
                                 "engine per device",
    "phys_interface.resolve_engine": "the same, inherited",
    "models.mlp.BaseMLPFlax": "a flax module class; the port's modules are torch nn.Modules "
                              "(TimeMLP, CameraMLP)",
    "models.mlp.TimeEmbeddingFlax": "a flax module class (the port's TimeEmbedding)",
    "models.mlp.TimeMLPFlax": "a flax module class (the port's TimeMLP)",
    "models.mlp.CameraMLPFlax": "a flax module class (the port's CameraMLP)",
    "flag.ckpt_backend": "orbax is a JAX library; the port's checkpoints are pickles",
    "flag.phys_engine": "the TPU engine pick",
    "flag.eval_engine": "the TPU eval engine pick",
    "flag.soa_e_tile": "the Pallas env tile (a TPU VMEM plan)",
    "flag.soa_ksub": "the Pallas substeps per call (a TPU VMEM plan)",
    "flag.rollout_unroll": "the XLA scan unroll factor",
}

CLASSES = [("models.phys_model", "phys_model"), ("models.interface", "phys_interface"),
           ("models.interface", "KinematicsProxy"), ("models.serve", "RolloutServer")]


def _port(name):
    return importlib.import_module("ppr_diffphys_torch." + name)


def _jax(name):
    return importlib.import_module("ppr_diffphys_tpu." + name)


def _required(fn):
    """Required positional parameters (self included for methods)."""
    sig = inspect.signature(fn)
    return sum(p.default is p.empty and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
               for p in sig.parameters.values())


def _check_members(jcls, tcls, label, problems):
    for name, fn in inspect.getmembers(jcls, callable):
        if name.startswith("_") or inspect.isclass(fn):
            continue
        key = "%s.%s" % (label, name)
        if key in EXCEPTIONS:
            continue
        if not hasattr(tcls, name):
            problems.append("missing " + key)
        elif _required(getattr(tcls, name)) > _required(fn):
            problems.append("more required arguments: " + key)


@pytest.mark.parametrize("module, cls", CLASSES)
def test_class_methods_exist(module, cls):
    problems = []
    _check_members(getattr(_jax(module), cls), getattr(_port(module), cls), cls, problems)
    assert not problems, problems


def _modules():
    names = []
    for sub in ("ops", "utils"):
        pkg = _jax(sub)
        names += ["%s.%s" % (sub, m.name) for m in pkgutil.iter_modules(pkg.__path__)]
    return sorted(names + ["models.mlp", "models.torch_adapter", "parallel.sharding"])


def test_unported_package_is_absent():
    """No JAX package is left unported: ``parallel``, the last, exists in
    both, and its module joins the checks below."""
    assert importlib.util.find_spec("ppr_diffphys_tpu.parallel") is not None
    assert importlib.util.find_spec("ppr_diffphys_torch.parallel") is not None


@pytest.mark.parametrize("module", _modules())
def test_module_functions_exist(module):
    jmod = _jax(module)
    tmod = _port(module)
    problems = []
    for name, obj in inspect.getmembers(jmod):
        if name.startswith("_") or getattr(obj, "__module__", None) != jmod.__name__:
            continue
        key = "%s.%s" % (module, name)
        if not (inspect.isfunction(obj) or inspect.isclass(obj)) or key in EXCEPTIONS:
            continue
        if not hasattr(tmod, name):
            problems.append("missing " + key)
        elif inspect.isclass(obj):
            _check_members(obj, getattr(tmod, name), key, problems)
        elif _required(getattr(tmod, name)) > _required(obj):
            problems.append("more required arguments: " + key)
    assert not problems, problems


def test_cli_flags_exist():
    """Every flag of the repository's main.py is a flag of the port's CLI."""
    from absl import flags

    sys.path.insert(0, os.path.dirname(H.TESTS_DIR))
    try:
        import main as jmain
    finally:
        sys.path.pop(0)
    from ppr_diffphys_torch import main as tmain

    jflags = {f.name for f in flags.FLAGS.get_flags_for_module(jmain)}
    assert len(jflags) > 30
    port = tmain.parse_args([])
    missing = sorted(f for f in jflags if f not in port and "flag." + f not in EXCEPTIONS)
    assert not missing, missing
