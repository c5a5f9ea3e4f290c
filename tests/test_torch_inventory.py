"""The port does all that the reference package does, name for name and
call for call.

An AST scan, importing nothing.  Names: every public top-level
``def``/``class`` of every module of ``rx_tools_tpu/`` (and of the root
``__graft_entry__.py``, whose port is ``rx_tools_tpu_torch/entry.py``),
and every name a package ``__init__`` imports from the package, must
exist under the same name in the matching port module (defined there or
imported into it), or stand in ``OMITTED`` with its reason and the port's
counterpart.

Signatures: every public function, and every public method (with
``__init__``) of a public class, that has a namesake in the port is
called the same way.  The reference's positional parameters are a prefix
of the port's, same names in the same order; its keyword-only parameters
exist in the port; a parameter with a default keeps one, and literal
defaults are equal; every port-only parameter (``device=``, ``fused=``)
has a default.  So a call written for the reference binds the same in
the port, which then runs it or raises ``ValueError`` where it cannot
(the kernel wrappers' ``interpret=True``, a ``tile_rows`` the CUDA tiles
do not use, a precision below HIGHEST).  ``SIGNATURE_DIFFERS`` holds the
documented differences, each with its reason."""

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


#: (module, function or Class.method) -> (why the port differs from the
#: reference, and what shows that it still does: ``None`` where the scan
#: finds the signatures different, else a fragment of the reference
#: function's source that the port does not copy)
SIGNATURE_DIFFERS = {
    ("ops/fused_frontend.py", "fused_capture_fm"): (
        "K2's halo redesign: the TPU grid runs in order and carries each "
        "tile's last sample in SMEM (rx_tools_tpu/ops/fused_frontend.py:"
        "104-118), so it takes one block and leaves seams and per-tile "
        "partials to the caller; the CUDA CTAs run in any order and read a "
        "halo, so the port takes prev_iq and M blocks and returns seams "
        "done, per-block levels and the last sample",
        None),
    ("ops/fused_frontend.py", "fused_eligible"): (
        "the reference's gate also requires the TPU backend; the port's "
        "switch holds on any device, and a CPU tensor runs K2's plain "
        "version",
        'jax.default_backend() == "tpu"'),
}

#: reference modules outside ``rx_tools_tpu/`` -> their port module
ROOT_MODULES = {"__graft_entry__.py": "entry.py"}


def _modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _ref_path(module):
    return ROOT / module if module in ROOT_MODULES else REF / module


def _port_path(module):
    return PORT / ROOT_MODULES.get(module, module)


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
    tree = _tree(_ref_path(module))
    names = _public_defs(tree)
    if module.endswith("__init__.py"):
        names |= _package_imports(tree)
    return names


@pytest.mark.parametrize("module", _modules() + sorted(ROOT_MODULES))
def test_port_has_every_public_name(module):
    port = _port_path(module)
    assert port.exists(), f"the port has no {port.relative_to(ROOT)}"
    missing = sorted(n for n in _required(module) - _bound_names(_tree(port))
                     if (module, n) not in OMITTED)
    assert not missing, (f"{port.relative_to(ROOT)} lacks {missing} of "
                         f"{_ref_path(module).relative_to(ROOT)}")


def _module_file(dotted):
    """The file of ``rx_tools_tpu[_torch].a.b``, or None outside them."""
    if dotted.split(".")[0] not in ("rx_tools_tpu", "rx_tools_tpu_torch"):
        return None
    path = ROOT.joinpath(*dotted.split("."))
    return path.with_suffix(".py") if path.with_suffix(".py").exists() \
        else path / "__init__.py"


def _methods(path, cls_name):
    """``{method: FunctionDef}`` of class ``cls_name`` of ``path``,
    through its bases defined in the module or imported from the
    package (a method of the class itself wins)."""
    tree = _tree(path)
    top = list(_statements(tree.body))
    cls = next((n for n in top if isinstance(n, ast.ClassDef)
                and n.name == cls_name), None)
    if cls is None:
        for n in top:
            if isinstance(n, ast.ImportFrom) and n.module and any(
                    (a.asname or a.name) == cls_name for a in n.names):
                src = _module_file(n.module)
                name = next(a.name for a in n.names
                            if (a.asname or a.name) == cls_name)
                return _methods(src, name) if src else {}
        return {}
    out = {}
    for base in cls.bases:
        if isinstance(base, ast.Name):
            out.update(_methods(path, base.id))
    out.update({m.name: m for m in cls.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))})
    return out


def _callables(path):
    """Public functions and the public methods (with ``__init__``) of
    public classes: ``{name or Class.method: FunctionDef}``."""
    out = {}
    for n in _statements(_tree(path).body):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not n.name.startswith("_"):
            out.setdefault(n.name, n)
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            for name, m in _methods(path, n.name).items():
                if name == "__init__" or not name.startswith("_"):
                    out.setdefault(f"{n.name}.{name}", m)
    return out


def _params(fn):
    """``(positional [(name, default)], keyword-only [(name, default)],
    *args, **kwargs)`` of a ``def``; a missing default is ``None``."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    return ([(x.arg, d) for x, d in zip(pos, defaults)],
            [(x.arg, d) for x, d in zip(a.kwonlyargs, a.kw_defaults)],
            a.vararg, a.kwarg)


def _literal(node):
    try:
        return True, ast.literal_eval(node)
    except ValueError:
        return False, None


def _call_differences(ref_fn, port_fn):
    """How a call written for ``ref_fn`` would bind otherwise in
    ``port_fn``; empty when it binds the same."""
    r_pos, r_kw, r_var, r_varkw = _params(ref_fn)
    p_pos, p_kw, p_var, p_varkw = _params(port_fn)
    out = []
    r_names = [n for n, _ in r_pos]
    if r_names != [n for n, _ in p_pos[:len(r_pos)]]:
        out.append(f"positional {r_names} are not a prefix of "
                   f"{[n for n, _ in p_pos]}")
    port = dict(p_pos + p_kw)
    out += [f"keyword-only {n} missing" for n, _ in r_kw if n not in port]
    known = {n for n, _ in r_pos + r_kw}
    out += [f"port-only {n} has no default"
            for n, d in p_pos[len(r_pos):] + p_kw
            if n not in known and d is None]
    for n, d in r_pos + r_kw:
        if d is None or n not in port:
            continue
        if port[n] is None:
            out.append(f"{n} lost its default")
            continue
        (r_lit, r_val), (p_lit, p_val) = _literal(d), _literal(port[n])
        if r_lit and p_lit and r_val != p_val:
            out.append(f"{n} defaults to {p_val!r}, not {r_val!r}")
    if r_var and not p_var:
        out.append(f"*{r_var.arg} missing")
    if r_varkw and not p_varkw:
        out.append(f"**{r_varkw.arg} missing")
    return out


def _signature_pairs(module):
    """(name, reference def, port def) of every callable both have."""
    ref = _callables(_ref_path(module))
    port = _callables(_port_path(module))
    return [(n, ref[n], port[n]) for n in sorted(ref) if n in port]


@pytest.mark.parametrize("module", _modules() + sorted(ROOT_MODULES))
def test_port_calls_bind_as_in_the_reference(module):
    """A call written for the reference binds the same in the port."""
    ref_names = _callables(_ref_path(module))
    port_names = _callables(_port_path(module))
    unmatched = sorted(n for n in ref_names if n not in port_names
                       and (module, n.split(".")[0]) not in OMITTED)
    assert not unmatched, (f"{_port_path(module).relative_to(ROOT)} defines "
                           f"no {unmatched} to compare")
    wrong = {n: diff for n, r, p in _signature_pairs(module)
             if (diff := _call_differences(r, p))
             and (module, n) not in SIGNATURE_DIFFERS}
    assert not wrong, f"{module}: {wrong}"


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


@pytest.mark.parametrize("entry", sorted(SIGNATURE_DIFFERS), ids="::".join)
def test_signature_differences_are_current(entry):
    """A documented difference stays only while it is there: the scan
    still finds the signatures different, or the reference function still
    holds the clause the port does not copy."""
    module, name = entry
    reason, clause = SIGNATURE_DIFFERS[entry]
    assert reason
    pairs = {n: (r, p) for n, r, p in _signature_pairs(module)}
    assert name in pairs, f"{module}::{name} is not in both packages"
    ref_fn, port_fn = pairs[name]
    if clause is None:
        assert _call_differences(ref_fn, port_fn), (
            f"{module}::{name} now binds as in the reference: drop it from "
            "SIGNATURE_DIFFERS")
    else:
        source = ast.get_source_segment(_ref_path(module).read_text(),
                                        ref_fn)
        assert clause in source, (
            f"rx_tools_tpu/{module}::{name} no longer holds {clause!r}: "
            "drop it from SIGNATURE_DIFFERS")
        assert not _call_differences(ref_fn, port_fn)


def test_signature_rules_catch_each_fault():
    """Each rule of the scan fires on the fault it is for."""
    def fn(src):
        return ast.parse(src).body[0]

    ref = fn("def f(a, b=1, *, c=None): pass")
    assert not _call_differences(ref, fn(
        "def f(a, b=1, e=None, *, c=None, device=None): pass"))
    for port in ("def f(b, a=1, *, c=None): pass",       # order
                 "def f(a, b=1): pass",                  # keyword-only
                 "def f(a, b=2, *, c=None): pass",       # literal default
                 "def f(a, b, *, c=None): pass",         # lost default
                 "def f(a, b=1, *, c=None, device): pass"):  # port-only
        assert _call_differences(ref, fn(port)), port
    assert _call_differences(fn("def f(*xs): pass"), fn("def f(): pass"))


def test_scan_sees_the_package():
    """The scan reads real modules: the reference's ops package exports
    its head and the port's ``ops/__init__`` binds the same names."""
    assert "capture_frontend_planar" in _required("ops/__init__.py")
    assert {"rms_level", "resample_divisible", "CIC_9_TABLES"} <= (
        _required("ops/__init__.py"))
    assert "units" in _required("__init__.py")
    assert len(_modules()) > 40
    assert {"entry", "dryrun_multichip"} <= _required("__graft_entry__.py")
    pairs = sum(len(_signature_pairs(m)) for m in _modules())
    assert pairs > 250, pairs
    assert "ChunkedFmRunner.__init__" in dict(
        (n, r) for n, r, _ in _signature_pairs("stream/chunked.py"))
