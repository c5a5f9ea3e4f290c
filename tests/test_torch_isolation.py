"""The port stands alone: it imports neither JAX nor the reference package,
and it never drops to the CPU unless asked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "rx_tools_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name):
    return (name == "jax" or name.startswith("jax.")
            or name == "rx_tools_tpu" or name.startswith("rx_tools_tpu."))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import rx_tools_tpu_torch, rx_tools_tpu_torch.ops\n"
            "import rx_tools_tpu_torch.apps.rx_fm, rx_tools_tpu_torch.stream\n"
            "import rx_tools_tpu_torch.models.fmchunk\n"
            "import rx_tools_tpu_torch.models.convert\n"
            "import rx_tools_tpu_torch.models.fmint, rx_tools_tpu_torch.entry\n"
            "import rx_tools_tpu_torch.stream.checkpoint\n"
            "import rx_tools_tpu_torch.stream.pipeline\n"
            "import rx_tools_tpu_torch.kernels.build\n"
            "import rx_tools_tpu_torch.apps.rx_power\n"
            "import rx_tools_tpu_torch.apps.rx_heatmap\n"
            "import rx_tools_tpu_torch.models.powerscan\n"
            "import rx_tools_tpu_torch.models.power_plan\n"
            "import rx_tools_tpu_torch.ops.intfft\n"
            "import rx_tools_tpu_torch.ops.spectrum\n"
            "import rx_tools_tpu_torch.ops.windows\n"
            "import rx_tools_tpu_torch.apps.rx_sdr\n"
            "import rx_tools_tpu_torch.iq.formats, rx_tools_tpu_torch.iq.rtltcp\n"
            "import rx_tools_tpu_torch.iq.soapy, rx_tools_tpu_torch.native\n"
            "import rx_tools_tpu_torch.native.build\n"
            "import rx_tools_tpu_torch.apps.rx_channels\n"
            "import rx_tools_tpu_torch.models.channelizer\n"
            "import rx_tools_tpu_torch.models.pfb, rx_tools_tpu_torch.models.tmaj\n"
            "import rx_tools_tpu_torch.examples.scan_and_demod\n"
            "import rx_tools_tpu_torch.examples.multichannel_fm\n"
            "import rx_tools_tpu_torch.hw_soak\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'rx_tools_tpu.')) or m == 'rx_tools_tpu']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without CUDA and no request for the CPU."""
    monkeypatch.delenv("RX_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_cpu_fallback(no_cuda, tmp_path):
    from rx_tools_tpu_torch.apps import rx_fm
    from rx_tools_tpu_torch.device import resolve_device
    from rx_tools_tpu_torch.iq.sources import make_source
    from rx_tools_tpu_torch.models import convert, fmchain
    from rx_tools_tpu_torch.stream.chunked import ChunkedFmRunner

    cfg = fmchain.FmConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        fmchain.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ChunkedFmRunner(cfg, make_source("synth=fm"), lambda a, lvl: None)
    st = fmchain.init_state(cfg, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.fm_state_from_numpy(convert.fm_state_to_numpy(st))
    from rx_tools_tpu_torch import entry
    from rx_tools_tpu_torch.models import fmint
    with pytest.raises(RuntimeError, match="CUDA"):
        fmint.init_state()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    out = tmp_path / "a.raw"
    with pytest.raises(RuntimeError, match="CUDA"):
        rx_fm.main(["-f", "100.3M", "-M", "wbfm", "-d", "synth=fm",
                    "--blocks", "1", str(out)])
    assert not out.exists()
    from rx_tools_tpu_torch.apps import rx_power
    from rx_tools_tpu_torch.models import powerscan
    pcfg = powerscan.PowerConfig(bin_e=6)
    with pytest.raises(RuntimeError, match="CUDA"):
        powerscan.new_sweep_accum(3, pcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        powerscan.int_sweep_powers(pcfg, np.zeros((1, 16384), np.int16))
    csv = tmp_path / "a.csv"
    with pytest.raises(RuntimeError, match="CUDA"):
        rx_power.main(["-f", "100M:102M:50k", "-1", "-d", "synth=tone",
                       str(csv)])
    assert not csv.exists()


def test_channelizers_refuse_cpu_fallback(no_cuda, tmp_path):
    """rx_channels, the channelizers' states and their converters raise
    without CUDA and without a request for the CPU; no file is written."""
    from rx_tools_tpu_torch.apps import rx_channels
    from rx_tools_tpu_torch.examples import multichannel_fm
    from rx_tools_tpu_torch.models import channelizer, convert, pfb
    out = tmp_path / "ch"
    for sel in (["-n", "16"], ["-k", "100.2M", "-D", "16"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            rx_channels.main(["-f", "100M", "-s", "1024k", *sel, "-d",
                              "synth=fm", str(out)])
    assert not out.exists()
    ccfg = channelizer.ChannelizerConfig(capture_rate=1_024_000,
                                         offsets=(1000.0,), downsample=16)
    pcfg = pfb.PfbConfig(capture_rate=1_024_000, n_channels=16)
    for init, cfg, conv in (
            (channelizer.init_state, ccfg,
             convert.channelizer_state_from_numpy),
            (channelizer.init_state_tmaj, ccfg,
             convert.channelizer_state_tm_from_numpy),
            (pfb.init_state, pcfg, convert.pfb_state_from_numpy),
            (pfb.init_state_tmaj, pcfg, convert.pfb_state_tm_from_numpy)):
        with pytest.raises(RuntimeError, match="CUDA"):
            init(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            conv(convert.state_to_numpy(init(cfg, "cpu")))
    cap = tmp_path / "cap.cs16"
    np.zeros(2 * 65536, np.int16).tofile(cap)
    with pytest.raises(RuntimeError, match="CUDA"):
        multichannel_fm.main([str(cap), "1024k", "100.2M"])


def test_rx_sdr_needs_no_device(no_cuda, tmp_path):
    """rx_sdr converts numpy on the host: it runs without CUDA and without
    RX_PLATFORM, and its bytes are the host conversion of the synth (read
    in the same size: the synth's noise draws follow its reads)."""
    from rx_tools_tpu_torch.apps import rx_sdr
    from rx_tools_tpu_torch.iq import formats
    from rx_tools_tpu_torch.iq.sources import make_source
    out = tmp_path / "cap.cu8"
    assert rx_sdr.main(["-f", "100M", "-s", "2.4M", "-d", "synth=fm",
                        "-n", "5000", "-b", "10000", "-F", "CU8",
                        str(out)]) == 0
    src = make_source("synth=fm")
    src.set_sample_rate(2.4e6)
    src.set_frequency(100e6)
    want = formats.cs16_to_cu8(src.read_stream(5000)[1])
    assert out.read_bytes() == want.tobytes()


def test_kernel_wrappers_refuse_non_cuda_tensors():
    from rx_tools_tpu_torch.ops import frontend_mxu, fused_frontend
    x = torch.zeros(2 * 6 * 8, dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        frontend_mxu._launch_head(x, 6, True, False, "K1")
    with pytest.raises(ValueError, match="CUDA"):
        fused_frontend.fused_capture_fm(torch.zeros(2), x, 6, 8)
    from rx_tools_tpu_torch.ops import intaudio
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        intaudio.deemph_int(torch.zeros((), dtype=torch.int64,
                                        device="meta"), meta, 13)
    before_d = intaudio.deemph_int.launches
    intaudio.deemph_int(torch.zeros((), dtype=torch.int64),
                        torch.arange(4), 13)
    assert intaudio.deemph_int.launches == before_d
    # the plain versions serve CPU tensors: no kernel launch is counted
    before = frontend_mxu.capture_frontend_mm_pallas.launches
    frontend_mxu.capture_frontend_mm_pallas(x, 6)
    assert frontend_mxu.capture_frontend_mm_pallas.launches == before
    assert np.all(frontend_mxu.capture_head_plain(x, 6)[0].numpy() == 0)
