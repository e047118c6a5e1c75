"""The port covers the JAX package's public API, read from the source.

For every module of ``quantize_tpu/`` (``ops/pallas/<name>.py`` is the
port's ``ops/<name>.py``) the port's module of the same path must give:

* **names**: every public function and class of the JAX module, defined,
  imported or assigned at its top level, and every public method of such a
  class on the port's class of that name (its own or a base class's in the
  port);
* **parameters**: every parameter of a JAX function or method under the
  same name in its counterpart's signature.

The comparison runs on the ``ast`` of both packages and imports neither, so
it runs where JAX is not installed (``python -m pytest --noconftest
tests/test_torch_api_coverage.py``). ``ALIASES`` and ``EXCEPTIONS`` hold
every difference that is idiom rather than a gap, each with its reason; an
exception that no longer matches a difference fails the check too.
"""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "quantize_tpu")
PORT_ROOT = os.path.join(REPO, "quantize_tpu_torch")

# a flax method and the torch method that does its work
ALIASES = {
    "__call__": "forward",  # flax runs a module by ``__call__``; torch by ``forward``
    "setup": "__init__",  # flax builds submodules in ``setup``; torch in ``__init__``
}

# (JAX module, name, the missing parameter or None for the name): the reason
EXCEPTIONS = {
    ("__init__.py", "__getattr__", None):
        "the JAX root imports its exports lazily; the port's root imports them",
    ("__init__.py", "__dir__", None):
        "the JAX root lists its lazy exports; the port's are plain attributes",
    ("api.py", "calibrate_model", "variables"):
        "the port keeps a model's state in its modules, not in a variables tree",
    ("deploy.py", "pack_model", "variables"):
        "the port keeps a model's state in its modules, not in a variables tree",
    ("models/clip/__init__.py", "build_zeroshot", "variables"):
        "the port keeps a model's state in its modules, not in a variables tree",
    ("nn/quantizer.py", "reset_observers", "variables"):
        "the port keeps a model's state in its modules, not in a variables tree",
    ("parallel/scaling.py", "measure_scaling", "devices"):
        "JAX takes a list of its devices; the port takes one torch device a rank",
    ("parallel/scaling.py", "run_multiprocess_scaling", "devices_per_process"):
        "JAX takes a list of its devices; the port takes one torch device a rank",
    ("ops/pallas/qmatmul.py", "set_matmul_backend", None):
        "not ported (ROADMAP §1): on the card the port has one implementation of "
        "K1's math, the hand-written kernel; a switch could only route off it",
    ("ops/pallas/qmatmul.py", "matmul_backend", None):
        "not ported with set_matmul_backend (ROADMAP §1)",
}


def _modules(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if not x.startswith(("_build", "__pycache__")))
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(d, f)
                out[os.path.relpath(path, root)] = path
    return out


JAX_MODULES = _modules(JAX_ROOT)
PORT_MODULES = _modules(PORT_ROOT)


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def _counterpart(rel):
    return rel.replace(f"ops{os.sep}pallas{os.sep}", f"ops{os.sep}")


def _public(name):
    return not name.startswith("_") or name in ("__call__", "__getattr__", "__dir__")


def _params(fn):
    a = fn.args
    return [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)] + [
        x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _top(tree):
    """``(functions, classes, other names)`` bound at a module's top level."""
    fns, classes, names = {}, {}, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fns[node.name] = node
        elif isinstance(node, ast.ClassDef):
            classes[node.name] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update(a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return fns, classes, names


def _port_classes():
    out = {}
    for path in PORT_MODULES.values():
        for node in ast.walk(_tree(path)):
            if isinstance(node, ast.ClassDef):
                out.setdefault(node.name, node)
    return out


PORT_CLASSES = _port_classes()


def _methods(cls, seen=()):
    """A port class's methods, its bases' (the port's classes) included."""
    out = {n.name: n for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for base in cls.bases:
        name = base.id if isinstance(base, ast.Name) else getattr(base, "attr", None)
        if name in PORT_CLASSES and name not in seen:
            for k, v in _methods(PORT_CLASSES[name], (*seen, name)).items():
                out.setdefault(k, v)
    return out


def _differences(rel):
    """Every ``(name, missing parameter or None)`` of JAX module ``rel``
    without a counterpart in the port."""
    port = PORT_MODULES.get(_counterpart(rel))
    if port is None:
        return [("<module>", None)]
    jfns, jclasses, _ = _top(_tree(JAX_MODULES[rel]))
    tfns, tclasses, tnames = _top(_tree(port))
    found = []

    def compare(name, jfn, tfn):
        if tfn is None:
            found.append((name, None))
            return
        have = set(_params(tfn))
        found.extend((name, p) for p in _params(jfn) if p not in have)

    for name, fn in jfns.items():
        if not _public(name):
            continue
        if name in tfns:
            compare(name, fn, tfns[name])
        elif name not in tclasses and name not in tnames:
            found.append((name, None))
    for name, cls in jclasses.items():
        if not _public(name):
            continue
        tcls = tclasses.get(name) or (PORT_CLASSES.get(name) if name in tnames else None)
        if tcls is None:
            found.append((name, None))
            continue
        methods = _methods(tcls)
        for fn in cls.body:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(fn.name):
                tfn = methods.get(fn.name) or methods.get(ALIASES.get(fn.name, ""))
                compare(f"{name}.{fn.name}", fn, tfn)
    return found


@pytest.mark.parametrize("rel", sorted(JAX_MODULES))
def test_port_has_every_public_name_and_parameter(rel):
    gaps = [(name, p) for name, p in _differences(rel)
            if (rel, name, p) not in EXCEPTIONS]
    assert not gaps, f"{rel}: no counterpart in the port for " + ", ".join(
        name if p is None else f"{name}({p}=)" for name, p in gaps)


@pytest.mark.parametrize("key", sorted(EXCEPTIONS, key=str), ids=lambda k: f"{k[0]}::{k[1]}")
def test_every_exception_is_still_a_difference(key):
    rel, name, param = key
    assert EXCEPTIONS[key]
    assert (name, param) in _differences(rel), f"{key} has a counterpart now: drop the row"


def test_the_walk_sees_both_packages():
    assert len(JAX_MODULES) >= 70 and len(PORT_MODULES) >= len(JAX_MODULES)
    assert "ops/pallas/qmatmul.py".replace("/", os.sep) in JAX_MODULES
    assert {"train_step", "merge_updates"} <= set(_methods(PORT_CLASSES["PTQ"]))
