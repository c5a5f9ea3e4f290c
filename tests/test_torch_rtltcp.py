"""The port's rtl_tcp source against an in-process mock server (modelled on
tests/test_rtltcp.py:15-55): the header handshake, the command wire
format, CU8->CS16 conversion, EOF and timeout semantics, bad magic, the
AGC opcode; rx_sdr and rx_fm from the mock against the reference CLIs."""

import socket
import struct
import threading

import numpy as np
import pytest
import torch

from rx_tools_tpu.apps import rx_fm as ref_rx_fm
from rx_tools_tpu.apps import rx_sdr as ref_rx_sdr
from rx_tools_tpu.iq import rtltcp as ref_rtltcp
from rx_tools_tpu_torch.apps import rx_fm, rx_sdr
from rx_tools_tpu_torch.iq import formats, rtltcp, sources
from rx_tools_tpu_torch.iq.sources import make_source

torch.set_num_threads(2)


class MockRtlTcpServer:
    """Speaks the server side of the rtl_tcp protocol: sends the 12-byte
    header, streams ``payload``, records every 5-byte command received.
    ``hold`` keeps the data plane open after the payload (no EOF).  It
    serves ``connections`` clients in turn, each the whole payload."""

    def __init__(self, payload: bytes, tuner_type=5, gain_count=29,
                 hold=False, connections=1):
        self.payload = payload
        self.header = rtltcp.MAGIC + struct.pack(">II", tuner_type, gain_count)
        self.hold = hold
        self.connections = connections
        self.commands: list[tuple[int, int]] = []
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(connections)
        self.port = self._lsock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            for _ in range(self.connections):
                conn, _ = self._lsock.accept()
                self._serve_one(conn)
        finally:
            self._lsock.close()

    def _serve_one(self, conn):
        conn.settimeout(5.0)
        try:
            try:
                conn.sendall(self.header)
                conn.sendall(self.payload)
                if not self.hold:
                    conn.shutdown(socket.SHUT_WR)   # EOF on the data plane
            except OSError:
                pass                 # the client left before the payload
            buf = b""
            while True:                          # drain commands until close
                try:
                    chunk = conn.recv(4096)
                except (socket.timeout, ConnectionResetError):
                    # a client that closes with payload unread resets
                    break
                if not chunk:
                    break
                buf += chunk
                while len(buf) >= 5:
                    op, arg = struct.unpack(">BI", buf[:5])
                    self.commands.append((op, arg))
                    buf = buf[5:]
        finally:
            conn.close()

    def join(self):
        self._thread.join(timeout=10.0)
        assert not self._thread.is_alive()


def test_protocol_constants_match_reference():
    assert rtltcp.MAGIC == ref_rtltcp.MAGIC
    assert rtltcp.DEFAULT_PORT == ref_rtltcp.DEFAULT_PORT
    assert rtltcp.TUNER_NAMES == ref_rtltcp.TUNER_NAMES
    for name in dir(ref_rtltcp):
        if name.startswith("CMD_"):
            assert getattr(rtltcp, name) == getattr(ref_rtltcp, name), name


def test_handshake_stream_and_eof():
    rng = np.random.default_rng(0)
    cu8 = rng.integers(0, 256, 2 * 300, dtype=np.uint8)
    srv = MockRtlTcpServer(cu8.tobytes())

    src = make_source(f"rtltcp=127.0.0.1:{srv.port}")
    assert src.driver == "rtltcp"
    assert src.tuner_type == 5 and src.tuner_gain_count == 29
    assert "R820T" in src.hardware and src.info()["tuner"] == "R820T"

    n1, b1 = src.read_stream(128)
    assert n1 == 128 and b1.dtype == np.int16 and b1.shape == (256,)
    n2, b2 = src.read_stream(512)            # more than remains -> short read
    assert n2 == 300 - 128
    n3, _ = src.read_stream(16)
    assert n3 == 0                           # server EOF

    got = np.concatenate([b1, b2])
    np.testing.assert_array_equal(got, formats.cu8_to_cs16(cu8))
    np.testing.assert_array_equal(got, (cu8.astype(int) - 128) * 256)
    src.close()
    srv.join()


def test_timeout_without_data_is_soft_error():
    """Nothing arrives within the socket timeout: ERR_TIMEOUT, not EOF."""
    srv = MockRtlTcpServer(b"\x80\x80" * 4, hold=True)
    src = make_source(f"rtltcp=127.0.0.1:{srv.port},timeout=0.2")
    assert src.read_stream(16)[0] == 4       # what arrived, then timeout
    n, buf = src.read_stream(16)
    assert n == sources.ERR_TIMEOUT == -1 and buf.size == 0
    src.close()
    srv.join()


def _drive_commands(pkg_make_source, port):
    src = pkg_make_source({"driver": "rtltcp", "host": "127.0.0.1",
                           "port": str(port)})
    src.set_frequency(100_300_000)
    src.set_sample_rate(2_400_000)
    src.set_gain(49.6)                       # dB -> tenths, manual mode first
    src.set_frequency_correction(-12)        # negative ppm wraps to u32
    src.set_gain_element("IF", 3.0)
    src.set_auto_gain()
    for key, value in (("direct_samp", "2"), ("offset_tune", "true"),
                       ("agc", "1"), ("biastee", "1"), ("testmode", "0"),
                       ("gain_index", "7"), ("unknown", "x")):
        src.write_setting(key, value)
    src.close()


def test_command_wire_format():
    from rx_tools_tpu.iq.sources import make_source as ref_make_source
    srv, ref = MockRtlTcpServer(b""), MockRtlTcpServer(b"")
    _drive_commands(make_source, srv.port)
    _drive_commands(ref_make_source, ref.port)
    srv.join()
    ref.join()
    assert srv.commands == ref.commands
    assert srv.commands[:5] == [
        (rtltcp.CMD_SET_FREQ, 100_300_000),
        (rtltcp.CMD_SET_SAMPLE_RATE, 2_400_000),
        (rtltcp.CMD_SET_GAIN_MODE, 1),
        (rtltcp.CMD_SET_GAIN, 496),
        (rtltcp.CMD_SET_FREQ_CORRECTION, (-12) & 0xFFFFFFFF),
    ]
    assert (rtltcp.CMD_SET_IF_GAIN, (1 << 16) | 30) in srv.commands
    assert (rtltcp.CMD_SET_TUNER_GAIN_BY_INDEX, 7) in srv.commands


@pytest.mark.parametrize("out_fmt", formats.FORMATS)
def test_rx_sdr_records_from_rtltcp_like_reference(tmp_path, out_fmt):
    """rx_sdr from a remote rtl_tcp server: the same bytes as the
    reference CLI, and the same protocol commands."""
    # exactly the -n samples: a client that closes with payload unread
    # resets the connection, and the commands it sent may be lost
    cu8 = np.random.default_rng(2).integers(0, 256, 2 * 4096, dtype=np.uint8)
    outs, cmds = [], []
    for main in (ref_rx_sdr.main, rx_sdr.main):
        srv = MockRtlTcpServer(cu8.tobytes())
        out = tmp_path / f"cap{len(outs)}"
        rc = main(["-d", f"rtltcp=127.0.0.1:{srv.port}", "-f", "100M",
                   "-s", "2048k", "-n", "4096", "-b", "2048", "-F", out_fmt,
                   str(out)])
        srv.join()
        assert rc == 0
        outs.append(out.read_bytes())
        cmds.append(srv.commands)
    assert outs[1] == outs[0]
    assert cmds[1] == cmds[0]
    want = formats.convert(formats.cu8_to_cs16(cu8), "CS16", out_fmt)
    assert outs[1] == formats.array_to_bytes(want, out_fmt)
    # the CLI's -f/-s flags reached the server as protocol commands, and
    # auto gain (no -g) applied the RTLSDR 40 dB quirk
    # (verbose_auto_gain, convenience.c:253-262)
    for cmd in ((rtltcp.CMD_SET_FREQ, 100_000_000),
                (rtltcp.CMD_SET_SAMPLE_RATE, 2_048_000),
                (rtltcp.CMD_SET_GAIN_MODE, 1), (rtltcp.CMD_SET_GAIN, 400)):
        assert cmd in cmds[1]


def test_bad_magic_rejected():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def serve():
        conn, _ = lsock.accept()
        conn.sendall(b"HTTP/1.1 400\r\n")
        conn.close()
        lsock.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with pytest.raises(ConnectionError, match="not an rtl_tcp server"):
        rtltcp.RtlTcpSource({"rtltcp": f"127.0.0.1:{port}"})
    t.join(timeout=5.0)


def test_closed_before_header_rejected():
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]

    def serve():
        conn, _ = lsock.accept()
        conn.close()
        lsock.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    with pytest.raises(ConnectionError, match="closed before"):
        rtltcp.RtlTcpSource({"host": "127.0.0.1", "port": str(port)})
    t.join(timeout=5.0)


def test_set_gain_mode_uses_agc_opcode():
    """rx_fm -E rtlagc over rtl_tcp: set_gain_mode sends the native
    CMD_SET_AGC_MODE opcode."""
    srv = MockRtlTcpServer(b"")
    src = make_source({"driver": "rtltcp", "host": "127.0.0.1",
                       "port": str(srv.port)})
    assert src.set_gain_mode(True) == 0
    assert src.set_gain_mode(False) == 0
    src.close()
    srv.join()
    assert srv.commands == [(rtltcp.CMD_SET_AGC_MODE, 1),
                            (rtltcp.CMD_SET_AGC_MODE, 0)]


def test_rx_fm_from_rtltcp_matches_reference_cli(tmp_path, monkeypatch):
    """rx_fm -M wbfm -E agc reading a remote server to its EOF: the port's
    PCM against the reference CLI's (same count, at most 1 LSB), the AGC
    opcode sent by both."""
    monkeypatch.setenv("RX_PLATFORM", "cpu")
    src = make_source("synth=fm,audio=1k,dev=75k,amp=0.8,noise=0.001,"
                      "carrier=100.3M")
    src.set_sample_rate(1_020_000)
    src.set_frequency(100.555e6)
    cu8 = formats.cs16_to_cu8(src.read_stream(9 * 8208)[1])
    pcms, cmds = [], []
    for main in (ref_rx_fm.main, rx_fm.main):
        srv = MockRtlTcpServer(cu8.tobytes())
        out = tmp_path / f"a{len(pcms)}.raw"
        rc = main(["-f", "100.3M", "-M", "wbfm", "-E", "agc", "-b", "4",
                   "-d", f"rtltcp=127.0.0.1:{srv.port}", str(out)])
        srv.join()
        assert rc == 0
        pcms.append(np.fromfile(out, np.int16))
        cmds.append(srv.commands)
    want, pcm = pcms
    assert pcm.size == want.size > 2000
    assert np.abs(pcm.astype(int) - want.astype(int)).max() <= 1
    assert cmds[1] == cmds[0]
    assert (rtltcp.CMD_SET_AGC_MODE, 1) in cmds[1]
