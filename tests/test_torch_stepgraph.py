"""The CUDA-graph cache of the time-major steps (``models/stepgraph.py``) on
the CPU: what it keys on, that CPU tensors run the steps themselves, that
the steps keep their signatures, and that a graph's tables outlive their
eviction from ``device_const``'s cache.  The captures themselves run on
the card (``tests/test_torch_cuda.py``)."""

import ast
import gc
import inspect
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves, tree_map

from rx_tools_tpu_torch.models import channelizer, pfb, stepgraph
from rx_tools_tpu_torch.ops import numeric

ROOT = Path(__file__).resolve().parents[1]
FS = 2_400_000


def _setup(kind, d=16):
    """``(step, cfg, init, block_samples)`` at a small size."""
    if kind == "pfb":
        cfg = pfb.PfbConfig(capture_rate=FS, n_channels=d, custom_atan=1,
                            deemph_a=7, rate_out2=32_000)
        return pfb.pfb_step_tmaj, cfg, pfb.init_state_tmaj, 128 * d
    cfg = channelizer.ChannelizerConfig(
        capture_rate=FS, offsets=(-300_000.0, 41_000.0, 520_000.0),
        downsample=d, custom_atan=1, deemph_a=7, rate_out2=32_000)
    return (channelizer.channelize_step_tmaj, cfg,
            channelizer.init_state_tmaj, 128 * d)


def _blocks(n, count, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(-16000, 16000, (count, 2 * n)).astype(np.int16)


@pytest.mark.parametrize("kind", ["pfb", "mixer"])
def test_cpu_steps_capture_nothing(kind):
    """On CPU tensors the decorated step is the step itself: the same bits
    over chained blocks (numpy and tensor blocks), no key kept, no
    capture."""
    step, cfg, init, n = _setup(kind)
    before = step.captures
    st_g, st_e = init(cfg, "cpu"), init(cfg, "cpu")
    for i, blk in enumerate(_blocks(n, 3)):
        blk = blk if i % 2 else torch.from_numpy(blk)
        st_g, a_g, nv_g = step(cfg, st_g, blk)
        st_e, a_e, nv_e = step.__wrapped__(cfg, st_e, blk)
        for x, y in zip(tree_leaves((st_g, a_g, nv_g)),
                        tree_leaves((st_e, a_e, nv_e)), strict=True):
            assert x.device.type == "cpu" and torch.equal(x, y)
    assert step.captures == before and not step.graphs


def _variant(kind, what):
    """A call's ``(step, cfg, state, block)`` after changing ``what``
    (``step`` undecorated, as :func:`stepgraph.graph_key` takes it)."""
    step, cfg, init, n = _setup(kind)
    step = step.__wrapped__
    state = init(cfg, "cpu")
    block = torch.from_numpy(_blocks(n, 1)[0])
    if what == "block_shape":
        block = torch.from_numpy(_blocks(2 * n, 1)[0])
    elif what == "block_dtype":
        block = block.to(torch.int32)
    elif what == "state_shape":
        state = state._replace(deemph_avg=torch.zeros(7))
    elif what == "config":
        cfg = type(cfg)(**{**cfg.__dict__, "deemph_a": 5})
    elif what == "device":
        state = tree_map(lambda t: torch.empty_like(t, device="meta"), state)
    elif what == "block_values":
        block = torch.from_numpy(_blocks(n, 1, seed=8)[0])
    elif what == "state_values":
        state = tree_map(lambda t: t + 1, state)
    elif what == "new_tensors":
        state = tree_map(torch.clone, state)
        block = block.clone()
    elif what == "strided_block":
        block = torch.stack([block, block], dim=1)[:, 0]
    return step, cfg, state, block


@pytest.mark.parametrize("what", ["block_shape", "block_dtype",
                                  "state_shape", "config", "device"])
@pytest.mark.parametrize("kind", ["pfb", "mixer"])
def test_key_changes_with(kind, what):
    assert (stepgraph.graph_key(*_variant(kind, what))
            != stepgraph.graph_key(*_variant(kind, None)))


@pytest.mark.parametrize("what", ["block_values", "state_values",
                                  "new_tensors", "strided_block"])
@pytest.mark.parametrize("kind", ["pfb", "mixer"])
def test_key_ignores(kind, what):
    assert (stepgraph.graph_key(*_variant(kind, what))
            == stepgraph.graph_key(*_variant(kind, None)))


@pytest.mark.parametrize("flags", [(True, False), (False, True)])
@pytest.mark.parametrize("kind", ["pfb", "mixer"])
def test_key_changes_with_each_tf32_flag(kind, flags, monkeypatch):
    """The key reads both TF32 flags as the step module's own
    ``fp32_products`` binding leaves them (the binding the benchmark's
    TF32 control replaces)."""
    step, cfg, state, block = _variant(kind, None)
    plain = stepgraph.graph_key(step, cfg, state, block)

    def some_tf32():
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]

    monkeypatch.setitem(step.__globals__, "fp32_products", some_tf32)
    try:
        key = stepgraph.graph_key(step, cfg, state, block)
    finally:
        numeric.fp32_products()
    assert key != plain and key[-2:] == flags


@pytest.mark.parametrize("kind", ["pfb", "mixer"])
def test_key_under_the_benchmark_tf32_control(kind):
    from bench_torch.workloads import tf32_products
    step, cfg, state, block = _variant(kind, None)
    plain = stepgraph.graph_key(step, cfg, state, block)
    with tf32_products():
        tf32 = stepgraph.graph_key(step, cfg, state, block)
    assert plain[-2:] == (False, False) and tf32[-2:] == (True, True)
    assert stepgraph.graph_key(step, cfg, state, block) == plain


def _def_args(path, name):
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    return fn, [(a.arg, ast.unparse(a.annotation) if a.annotation else None)
                for a in fn.args.args]


@pytest.mark.parametrize("module,name", [
    ("models/pfb.py", "pfb_step_tmaj"),
    ("models/channelizer.py", "channelize_step_tmaj")])
def test_steps_keep_their_signatures(module, name):
    """The decorated steps keep their ``def`` (the inventory's AST reads
    it) with the JAX package's parameters, and ``inspect`` sees the same
    signature through the decorator."""
    fn, port = _def_args(ROOT / "rx_tools_tpu_torch" / module, name)
    _, ref = _def_args(ROOT / "rx_tools_tpu" / module, name)
    assert [a for a, _ in port] == [a for a, _ in ref] == [
        "cfg", "state", "block"]
    assert [ast.unparse(d) for d in fn.decorator_list] == ["graphed"]
    step = getattr({"models/pfb.py": pfb,
                    "models/channelizer.py": channelizer}[module], name)
    assert inspect.signature(step) == inspect.signature(step.__wrapped__)
    assert step.__wrapped__.__name__ == name


def _table(n):
    return np.arange(n, dtype=np.float32)


def test_a_held_table_outlives_its_eviction():
    """A table ``device_const`` returned inside ``holding_consts`` (a graph
    entry keeps that list) stays alive and intact after the cache evicts
    it, and goes when the holder goes; an unheld table goes at eviction."""
    cpu = torch.device("cpu")
    with numeric.holding_consts() as held:     # a graph entry's stand-in
        table = numeric.device_const(_table, 7, device=cpu)
    assert len(held) == 1 and held[0] is table
    unheld = numeric.device_const(_table, 8, device=cpu)
    refs = weakref.ref(table), weakref.ref(unheld)
    del table, unheld
    for k in range(100, 100 + numeric._cached.cache_info().maxsize):
        numeric.device_const(_table, k, device=cpu)         # evicts both
    gc.collect()
    assert refs[1]() is None
    assert refs[0]() is not None
    assert torch.equal(refs[0](), torch.arange(7, dtype=torch.float32))
    del held
    gc.collect()
    assert refs[0]() is None


def test_holding_collects_only_inside_its_block():
    cpu = torch.device("cpu")
    numeric.device_const(_table, 3, device=cpu)
    with numeric.holding_consts() as outer:
        a = numeric.device_const(_table, 3, device=cpu)
        with numeric.holding_consts() as inner:
            b = numeric.device_const(_table, 4, device=cpu)
    numeric.device_const(_table, 5, device=cpu)
    assert [t is a or t is b for t in outer] == [True, True]
    assert len(inner) == 1 and inner[0] is b
    assert not numeric._HOLDERS
