"""The port does all that the reference package does, name for name.

An AST scan, importing nothing: every public top-level ``def``/``class``
of every module of ``rx_tools_tpu/``, and every name a package
``__init__`` imports from the package, must exist under the same name in
the matching module of ``rx_tools_tpu_torch/`` (defined there or imported
into it), or stand in ``OMITTED`` with its reason and the port's
counterpart.  Names are held equal, not signatures: each function's own
tests hold its arguments (the kernel wrappers take no Pallas
``tile_rows``)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "rx_tools_tpu"
PORT = ROOT / "rx_tools_tpu_torch"

#: (module, name) -> (why the port has no such name, its counterpart as
#: (port module, name)); the deliberate omissions, and nothing else
OMITTED = {
    ("models/fmchain.py", "fm_chain_step_impl"): (
        "the jax.jit body of fm_chain_step; the port's steps run eagerly",
        ("models/fmchain.py", "fm_chain_step")),
    ("stream/scan.py", "scan_fm_blocks_impl"): (
        "the jax.jit body of scan_fm_blocks; the port's engine runs eagerly",
        ("stream/scan.py", "scan_fm_blocks")),
    ("ops/fused_frontend.py", "pick_tile_rows"): (
        "the Pallas kernel's tile height, which must divide a block's rows; "
        "the CUDA kernels plan tiles from D alone and take any block",
        ("kernels/plan.py", "plan")),
    ("apps/common.py", "select_platform"): (
        "points JAX at RX_PLATFORM's backend; the port resolves the device "
        "itself",
        ("device.py", "resolve_device")),
    ("models/fmint.py", "patch_seam"): (
        "patches the host float64 seam into a device result; the port's "
        "demod_block computes sample 0 from the seam directly",
        ("models/fmint.py", "seam_value")),
}


def _modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _statements(body):
    """Top-level statements, through the bodies of ``if`` and ``try``."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _statements(node.body)
            yield from _statements(node.orelse)
        elif isinstance(node, ast.Try):
            for part in (node.body, node.orelse, node.finalbody,
                         *(h.body for h in node.handlers)):
                yield from _statements(part)
        else:
            yield node


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _public_defs(tree):
    return {n.name for n in _statements(tree.body)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")}


def _package_imports(tree):
    """Names an ``__init__`` imports from its own package."""
    out = set()
    for n in _statements(tree.body):
        if isinstance(n, ast.ImportFrom) and (
                n.level or (n.module or "").split(".")[0] == "rx_tools_tpu"):
            out.update(a.asname or a.name for a in n.names)
    return out


def _bound_names(tree):
    """Every name a module binds at top level: defs, classes, assignments
    and imports."""
    out = set()
    for n in _statements(tree.body):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                out.update(x.id for x in ast.walk(t)
                           if isinstance(x, ast.Name))
        elif isinstance(n, ast.Import):
            out.update(a.asname or a.name.split(".")[0] for a in n.names)
        elif isinstance(n, ast.ImportFrom):
            out.update(a.asname or a.name for a in n.names)
    return out


def _required(module):
    tree = _tree(REF / module)
    names = _public_defs(tree)
    if module.endswith("__init__.py"):
        names |= _package_imports(tree)
    return names


@pytest.mark.parametrize("module", _modules())
def test_port_has_every_public_name(module):
    port = PORT / module
    assert port.exists(), f"the port has no {port.relative_to(ROOT)}"
    missing = sorted(n for n in _required(module) - _bound_names(_tree(port))
                     if (module, n) not in OMITTED)
    assert not missing, (f"rx_tools_tpu_torch/{module} lacks {missing} of "
                         f"rx_tools_tpu/{module}")


@pytest.mark.parametrize("entry", sorted(OMITTED), ids="::".join)
def test_omissions_are_current(entry):
    """An omission stays only while the reference has the name, the port
    does not, and the port has the named counterpart."""
    module, name = entry
    reason, (c_module, c_name) = OMITTED[entry]
    assert reason
    assert (REF / module).exists() and name in _required(module), (
        f"rx_tools_tpu/{module} no longer has {name}: drop it from OMITTED")
    assert name not in _bound_names(_tree(PORT / module)), (
        f"rx_tools_tpu_torch/{module} now has {name}: drop it from OMITTED")
    assert c_name in _bound_names(_tree(PORT / c_module)), (
        f"the counterpart rx_tools_tpu_torch/{c_module}::{c_name} is gone")


def test_scan_sees_the_package():
    """The scan reads real modules: the reference's ops package exports
    its head and the port's ``ops/__init__`` binds the same names."""
    assert "capture_frontend_planar" in _required("ops/__init__.py")
    assert {"rms_level", "resample_divisible", "CIC_9_TABLES"} <= (
        _required("ops/__init__.py"))
    assert "units" in _required("__init__.py")
    assert len(_modules()) > 40
