"""``rx_sdr`` — raw I/Q recorder with sample-format conversion.

Counterpart of :mod:`rx_tools_tpu.apps.rx_sdr`, argument-compatible with
the reference tool (``src/rtl_sdr.c:51-71,142-200``): flags ``-d -f -g -c
-a -s -b -n -p -D -S -I -F -t``, positional filename (``-`` = stdout).
Input is read from the source as CS16 and converted to the requested
output wire format with the reference's exact narrowing semantics
(``rtl_sdr.c:348-391`` via ``iq.formats``).  Allowed pairs mirror
``rtl_sdr.c:202-208``: in==out, CS16->anything, CS12->CS16.

rx_sdr does no device work, in this package as in the JAX one: it
converts numpy blocks on the host (the native codecs when built).  So,
unlike every other entry point of the port, it neither resolves nor
requires a CUDA device and runs on a machine without one.

Run: ``python -m rx_tools_tpu_torch.apps.rx_sdr -f 100M -s 2.4M -d
synth=fm -n 2400000 -F CU8 cap.cu8``.
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from rx_tools_tpu_torch.apps import common
from rx_tools_tpu_torch.iq import formats
from rx_tools_tpu_torch.utils.logging import log
from rx_tools_tpu_torch.utils.units import atofs

DEFAULT_SAMPLE_RATE = 2_048_000
DEFAULT_BUF_LENGTH = 16 * 16384

USAGE = """rx_sdr (rx_tools_tpu_torch), an I/Q recorder for SoapySDR-style sources

Usage:\t -f frequency_to_tune_to [Hz]
\t[-s samplerate (default: 2048000 Hz)]
\t[-d device key/value query (ex: file=cap.bin, synth=fm)]
\t[-g tuner gain(s) (ex: 20, 40, LNA=40,VGA=20,AMP=0)]
\t[-c channel number (ex: 0)]
\t[-a antenna (ex: 'Tuner 1 50 ohm')]
\t[-p ppm_error (default: 0)]
\t[-b output_block_size (default: 16 * 16384)]
\t[-n number of samples to read (default: 0, infinite)]
\t[-I input format, CU8|CS8|CS12|CS16|CF32 (default: CS16)]
\t[-F output format, CU8|CS8|CS12|CS16|CF32 (default: CU8)]
\t[-S force sync output (default: async)]
\t[-D direct_sampling_mode, 0 (default/off), 1 (I), 2 (Q), 3 (no-mod)]
\t[-t SDR settings (ex: rfnotch_ctrl=false,dabnotch_ctrlb=true)]
\tfilename (a '-' dumps samples to stdout)
"""


def usage() -> "NoReturn":
    sys.stderr.write(USAGE + "\n")
    raise SystemExit(1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.getopt(argv, "d:f:g:c:a:s:b:n:p:D:SI:F:t:")
    except getopt.GetoptError as e:
        log("%s", str(e))
        usage()

    dev_query = ""
    frequency = 100e6
    samp_rate = float(DEFAULT_SAMPLE_RATE)
    gain_str = None
    channel = 0
    antenna = None
    ppm_error = 0.0
    out_block_size = DEFAULT_BUF_LENGTH
    bytes_to_read = 0           # in output elements *2 like the reference
    input_format = "CS16"
    output_format = "CU8"
    direct_sampling = 0
    settings_str = ""

    for opt, arg in opts:
        if opt == "-d":
            dev_query = arg
        elif opt == "-f":
            frequency = atofs(arg)
        elif opt == "-g":
            gain_str = arg
        elif opt == "-c":
            channel = int(arg)
        elif opt == "-a":
            antenna = arg
        elif opt == "-s":
            samp_rate = atofs(arg)
        elif opt == "-b":
            out_block_size = int(atofs(arg))
        elif opt == "-n":
            bytes_to_read = int(atofs(arg)) * 2
        elif opt == "-p":
            ppm_error = atofs(arg)
        elif opt == "-D":
            direct_sampling = int(arg)
        elif opt == "-S":
            pass  # always-sync, like the reference (rtl_sdr.c:311)
        elif opt == "-I":
            input_format = formats.parse_fmt(arg)
        elif opt == "-F":
            output_format = formats.parse_fmt(arg)
        elif opt == "-t":
            settings_str = arg

    filename = args[0] if args else None
    if filename is None:
        usage()

    # format-pair validation (rtl_sdr.c:202-208)
    if not (input_format == output_format
            or input_format == "CS16"
            or (input_format == "CS12" and output_format == "CS16")):
        log("Unsupported input/output format conversion: %s -> %s",
            input_format, output_format)
        return 1

    # -I names the device wire format (rtl_sdr.c:138,301): for file/stdin
    # sources it selects how the bytes are decoded unless the -d query
    # already pins one
    if ("file=" in dev_query or "stdin" in dev_query) \
            and "format=" not in dev_query:
        dev_query += f",format={input_format}"

    do_exit = [False]
    user_cancel = [False]

    def _on_sig(*a):
        do_exit[0] = True
        user_cancel[0] = True

    common.install_sigint(_on_sig)

    with common.suppress_stdout():
        src = common.verbose_device_search(dev_query,
                                           wire_format=input_format)
        if direct_sampling:
            common.verbose_direct_sampling(src, direct_sampling)
        common.verbose_set_sample_rate(src, samp_rate)
        common.verbose_set_frequency(src, frequency)
        common.verbose_gain_str_set(src, gain_str)
        if antenna:
            common.verbose_antenna_str_set(src, antenna)
        common.verbose_ppm_set(src, ppm_error)
        common.verbose_settings(src, settings_str)
        src.channel = channel

    out = common.open_output(filename)
    # drivers chatter during stream activation; keep stdout suppressed
    # through activate like the reference (rtl_sdr.c:317, convenience.c:447)
    with common.suppress_stdout():
        src.activate()
    log("Reading samples in sync mode...")

    # hardware sources honor -I on the wire (setupStream got input_format):
    # consume the RAW stream and convert input->output exactly like the
    # reference loop (rtl_sdr.c:348-391) — in==out is a byte-for-byte
    # passthrough, CS12->CS16 is the bit-exact unpack.  Framework sources
    # (file/synth/rtltcp) deliver the CS16 contract and take the
    # CS16->output branch.
    raw_wire = (getattr(src, "wire_format", "CS16") == input_format
                and input_format != "CS16"
                and hasattr(src, "read_stream_raw"))
    n_read_total = 0
    rc = 0
    try:
        while not do_exit[0]:
            want = out_block_size // 2  # complex elements per read
            if raw_wire:
                n, buf = src.read_stream_raw(want)
            else:
                n, buf = src.read_stream(want)
            if n == 0:
                break
            if n < 0:
                sys.stderr.write("O")
                sys.stderr.flush()
                continue
            # -n truncation (rtl_sdr.c:341-346); counted in components
            # (2 per complex sample) like the reference's n_read
            if bytes_to_read > 0 and (n_read_total + 2 * n) >= bytes_to_read:
                n = (bytes_to_read - n_read_total) // 2
                do_exit[0] = True
            n_read_total += 2 * n
            if raw_wire:
                samples = buf[: n * formats.ELEM_BYTES[input_format]] \
                    if input_format == "CS12" else buf[: 2 * n]
                converted = formats.convert(samples, input_format,
                                            output_format)
            else:
                samples = buf[: 2 * n]
                converted = formats.convert(samples, "CS16", output_format)
            blob = formats.array_to_bytes(np.asarray(converted), output_format)
            written = out.write(blob)
            if written is not None and written < len(blob):
                log("Short write, samples lost, exiting!")
                rc = 1
                break
    finally:
        if user_cancel[0]:
            log("\nUser cancel, exiting...")
        src.deactivate()
        src.close()
        if out is not sys.stdout.buffer:
            out.close()
        else:
            out.flush()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
