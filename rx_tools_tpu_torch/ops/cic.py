"""CIC droop-compensation FIR coefficient tables.

Counterpart of :mod:`rx_tools_tpu.ops.cic` (a copy: the port imports
nothing of the reference package).  These Q15 rows are calibration data
shared with the reference (``src/rtl_fm.c:285-300`` ==
``src/rtl_power.c:210-225``): row ``p`` compensates the passband droop of
``p`` cascaded fifth-order binomial decimators.  Row 0 is unused (no
cascade); the table caps at 10 passes.
"""

import numpy as np

CIC_TABLE_MAX = 10

#: rows indexed by number of fifth_order passes; 9 symmetric Q15 taps each.
CIC_9_TABLES = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0],
    [-156,  -97, 2798, -15489, 61019, -15489, 2798,  -97, -156],
    [-128, -568, 5593, -24125, 74126, -24125, 5593, -568, -128],
    [-129, -639, 6187, -26281, 77511, -26281, 6187, -639, -129],
    [-122, -612, 6082, -26353, 77818, -26353, 6082, -612, -122],
    [-120, -602, 6015, -26269, 77757, -26269, 6015, -602, -120],
    [-120, -582, 5951, -26128, 77542, -26128, 5951, -582, -120],
    [-119, -580, 5931, -26094, 77505, -26094, 5931, -580, -119],
    [-119, -578, 5921, -26077, 77484, -26077, 5921, -578, -119],
    [-119, -577, 5917, -26067, 77473, -26067, 5917, -577, -119],
    [-199, -362, 5303, -25505, 77489, -25505, 5303, -362, -199],
], dtype=np.int32)


def cic_9_taps(passes: int, dtype=np.float32) -> np.ndarray:
    """Float taps (Q15 / 2**15) for ``passes`` cascade depth."""
    if not (1 <= passes <= CIC_TABLE_MAX):
        raise ValueError(f"no droop table for {passes} passes")
    return (CIC_9_TABLES[passes] / np.float32(1 << 15)).astype(dtype)
