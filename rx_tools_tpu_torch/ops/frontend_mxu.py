"""The capture head as a hand-written CUDA kernel, and its plain versions.

Counterpart of :mod:`rx_tools_tpu.ops.frontend_mxu`.  The head — CS16
rescale (``rtl_fm.c:845-848``), fs/4 derotation (``rtl_fm.c:309-327``) and
boxcar decimate by D (``rtl_fm.c:351-371``) — maps each output sample k to

    z[k] = SCALE * sum_j x[Dk+j] * i**(Dk+j)

over the interleaved int16 stream.  On the TPU it ran as a matrix product
against the {+1, 0, -1} block-banded matrix (:func:`_fs4_decim_matrix`).
Here the kernel ``kernels/csrc/capture_head.cu`` sums the same signed
int16 terms in int32 per output sample and scales once, so the result is
integer-exact and equals :func:`capture_head_plain` bit for bit.  It runs
one resident wave of persistent CTAs over tiles whose size depends on D
alone (``kernels/plan.py``), each fed by a ring of bulk-copied stages.

Entry points (each a wrapper with a ``launches`` count of its CUDA
launches; on a CPU tensor each runs the plain version):

- :func:`capture_frontend_mm_pallas` (K1) — planar ``(zi, zq)``; the
  production head of every engine;
- :func:`capture_frontend_mm_pallas2` (K4) — the two-output twin, the
  same planar result;
- ``ops.pallas_frontend.capture_frontend_pallas`` (K3) — interleaved
  ``(K, 2)``, on the same kernel.

The reference's plain matrix formulations of the same function are here
too, as library products on the input's device (cuBLAS, cuBLASLt's int8
``torch._int_mm``, cuDNN on the card): ``capture_frontend_mm`` (scale,
then one float32 product), ``capture_frontend_mm_i8`` (two exact int8
products), ``capture_frontend_mm_i16`` and ``capture_frontend_mm_i16_2``
(exact integer products), ``capture_frontend_mm_bf16`` (an inexact
probe), ``capture_frontend_t2`` (the thin product) and
``capture_frontend_conv`` (a strided convolution).  None is on the
chain's path, and none counts launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from rx_tools_tpu_torch import kernels
from rx_tools_tpu_torch.kernels import plan
from rx_tools_tpu_torch.ops.numeric import device_const, fp32_products
from rx_tools_tpu_torch.ops.pallas_frontend import _SCALE, _fs4_decim_masks

#: the kernel's ring holds two stages of at least 16 rows of D int16
#: pairs in shared memory (at most 227 KB; ``kernels/plan.py``)
_MAX_D = 1800

#: ``_SCALE`` rounded to bfloat16, the reference's ``bfloat16(_SCALE)``
_BF16_SCALE = float(torch.tensor(float(_SCALE)).to(torch.bfloat16))

#: the largest D whose partial sums (at most 2D int16 terms times +-1)
#: stay within 2**24, so a float32 product of the raw samples is exact
_MAX_F32_EXACT_D = 2 ** 24 // (2 * 32768)


def _highest(precision) -> None:
    """Accept the reference's ``precision=`` keyword: its default
    ``Precision.HIGHEST`` (or ``None``) is what the float32 forms compute;
    any lower precision would round the 15-bit inputs, so it is refused."""
    if precision is not None and str(precision).upper() != "HIGHEST":
        raise ValueError(f"precision {precision!r}: only HIGHEST (float32 "
                         f"products, TF32 off) is computed")


def _pallas_options(what: str, interpret: bool = False,
                    tile_rows: int | None = None,
                    reference_rows: int | None = None) -> None:
    """Accept the reference kernels' Pallas keywords where they change
    nothing, refuse them where they would: the port has no Pallas
    interpreter (a CPU tensor runs the plain version, a CUDA tensor the
    kernel), and its tiles are planned from D alone (``kernels/plan.py``),
    so only the reference's default ``tile_rows`` is accepted."""
    if interpret:
        raise ValueError(f"{what}: interpret=True asks for the Pallas "
                         "interpreter, which the port does not have; a "
                         "CPU tensor runs the plain version")
    if tile_rows != reference_rows:
        raise ValueError(f"{what}: tile_rows={tile_rows!r}: the CUDA kernel "
                         "plans its tiles from D alone (kernels/plan.py); "
                         f"only the reference's {reference_rows} is accepted")


def _group_phase_select(zi, zq, d: int):
    """Apply the per-output-sample group phase ``i**(D*k)`` elementwise."""
    k = torch.arange(zi.shape[0], dtype=torch.int64, device=zi.device)
    p = (k * (d & 3)) & 3
    return (torch.where(p == 0, zi, torch.where(p == 1, -zq,
                        torch.where(p == 2, -zi, zq))),
            torch.where(p == 0, zq, torch.where(p == 1, zi,
                        torch.where(p == 2, -zq, -zi))))


@functools.lru_cache(maxsize=32)
def _fs4_decim_matrix(d: int, p: int, rotate: bool) -> np.ndarray:
    """(P*2D, 2P) block-banded mask matrix, group phase folded per column.

    Column j in [0, P) is Re(z[r*P+j]), column P+j is Im; rows
    [j*2D, (j+1)*2D) carry the fs/4+decimate masks for phase j rotated by
    ``i**(D*j mod 4)`` (valid because P % 4 == 0 tiles the phase pattern).
    """
    if rotate and d % 4 and p % 4:
        raise ValueError(f"phase block {p} does not tile the fs/4 phase")
    a, b = _fs4_decim_masks(d, rotate)
    m = np.zeros((p * 2 * d, 2 * p), np.float32)
    for j in range(p):
        ph = (d * j) & 3 if rotate else 0
        if ph == 0:
            re, im = a, b
        elif ph == 1:
            re, im = -b, a
        elif ph == 2:
            re, im = -a, -b
        else:
            re, im = b, -a
        rows = slice(j * 2 * d, (j + 1) * 2 * d)
        m[rows, j] = re
        m[rows, p + j] = im
    return m


def _pick_p(k: int, d: int, rotate: bool) -> int:
    """Largest supported phase-block size dividing the output length."""
    need4 = rotate and (d & 3) != 0
    for cand in (32, 16, 8, 4):
        if k % cand == 0:
            return cand
    if not need4 and k % 2 == 0:
        return 2
    return 1


def _masks(d: int, rotate: bool, dtype: str) -> np.ndarray:
    """(2, 2D): the Re and Im masks of :func:`_fs4_decim_masks`."""
    return np.stack(_fs4_decim_masks(d, rotate)).astype(dtype)


def _rows(block_i16: torch.Tensor, d: int) -> int:
    if block_i16.dim() != 1 or block_i16.numel() % (2 * d):
        raise ValueError(f"capture head: {tuple(block_i16.shape)} int16 is "
                         f"not a whole number of 2*D={2 * d} groups")
    return block_i16.numel() // (2 * d)


def capture_head_plain(block_i16: torch.Tensor, downsample: int,
                       rotate: bool = True, interleaved: bool = False):
    """The kernel's plain PyTorch version, on any device.

    ``(2N,) int16 -> (zi (K,), zq (K,))`` float32, or ``(K, 2)`` when
    ``interleaved``: int32 masked sums of the raw stream, the group phase
    by select, one float32 multiply by ``_SCALE``.  Integer-exact.
    """
    d = int(downsample)
    k = _rows(block_i16, d)
    g = block_i16.reshape(k, 2 * d).to(torch.int32)
    masks = device_const(_masks, d, bool(rotate), "int32",
                         device=block_i16.device)
    zi = (g * masks[0]).sum(dim=1)
    zq = (g * masks[1]).sum(dim=1)
    if rotate and d % 4:
        zi, zq = _group_phase_select(zi, zq, d)
    scale = float(_SCALE)
    zi = zi.to(torch.float32) * scale
    zq = zq.to(torch.float32) * scale
    if interleaved:
        return torch.stack([zi, zq], dim=-1)
    return zi, zq


# --- the reference's matrix forms: library products, none on the path ---

def _phase_block(block_i16: torch.Tensor, d: int, rotate: bool,
                 p: int | None) -> int:
    """The phase-block size P of a matrix form: ``p``, or the largest of
    the reference's that divides K; 1 means none does."""
    k = _rows(block_i16, d)
    return _pick_p(k, d, rotate) if p is None else p


def _blocks(x: torch.Tensor, d: int, p: int) -> torch.Tensor:
    """The stream as ``(K/P, P*2D)`` rows of P output samples each."""
    return x.reshape(-1, p * 2 * d)


def _planar(out: torch.Tensor, p: int):
    """``(K/P, 2P)`` product columns -> the planar ``(zi, zq)`` streams."""
    return out[:, :p].reshape(-1), out[:, p:].reshape(-1)


def _matrix(block_i16: torch.Tensor, d: int, p: int, rotate: bool):
    return device_const(_fs4_decim_matrix, d, p, bool(rotate),
                        device=block_i16.device)


def capture_frontend_mm(block_i16: torch.Tensor, downsample: int,
                        rotate: bool = True, p: int | None = None,
                        precision=None):
    """``(2N,) int16 -> ((K,), (K,)) float32`` planar, the reference's one
    float32 matrix product: scale first, then ``(K/P, P*2D) @ (P*2D, 2P)``
    against :func:`_fs4_decim_matrix` with TF32 off (``Precision.HIGHEST``).
    Equal to :func:`capture_head_plain` up to float32 sum reassociation;
    ``p == 1`` (no phase block divides K) computes through it."""
    _highest(precision)
    d = int(downsample)
    p = _phase_block(block_i16, d, rotate, p)
    if p == 1:
        return capture_head_plain(block_i16, d, rotate)
    fp32_products()
    g = _blocks(block_i16, d, p).to(torch.float32) * float(_SCALE)
    return _planar(g @ _matrix(block_i16, d, p, rotate), p)


def _int8_matrix(d: int, p: int, rotate: bool, rows: int,
                 cols: int) -> np.ndarray:
    """:func:`_fs4_decim_matrix` as int8, zero-padded to ``(rows, cols)``."""
    m = _fs4_decim_matrix(d, p, rotate)
    out = np.zeros((rows, cols), np.int8)
    out[:m.shape[0], :m.shape[1]] = m
    return out


def _offset_sums(d: int, p: int, rotate: bool) -> np.ndarray:
    """(2P,) int32: 128 times each column sum of the mask matrix, what the
    ``lo - 128`` plane takes off each output."""
    return 128 * _fs4_decim_matrix(d, p, rotate).sum(axis=0).astype(np.int32)


def _int_mm_shape(m: int, k: int, n: int):
    """``(m, k, n)`` padded with zeros to what ``torch._int_mm`` accepts on
    the card: more than 16 rows, ``k`` and ``n`` multiples of 8."""
    return max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8


def _int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b`` of int8 operands into int32: ``torch._int_mm`` on a
    CUDA tensor, an int32 product on the CPU.  The caller pads ``a`` and
    ``b`` to :func:`_int_mm_shape`."""
    if a.device.type == "cuda":
        return torch._int_mm(a, b)
    return a.to(torch.int32) @ b.to(torch.int32)


def capture_frontend_mm_i8(block_i16: torch.Tensor, downsample: int,
                           rotate: bool = True, p: int | None = None):
    """``(2N,) int16 -> ((K,), (K,)) float32`` planar, via two int8
    products: each sample splits into ``hi = x >> 8`` and ``lo = (x & 255)
    - 128``, so ``x = 256 hi + lo + 128``; both planes multiply the int8
    mask matrix with int32 accumulation, and the column sums times 128
    restore the offset.  Integer-exact, one scale at the end: equals
    :func:`capture_head_plain` bit for bit.  On the card the products are
    ``torch._int_mm``; a shape outside its rules (at most 16 rows, or a
    contraction or column count not a multiple of 8) is padded with zeros,
    which add nothing, and the result sliced back.  ``p == 1`` computes
    through :func:`capture_head_plain`."""
    d = int(downsample)
    p = _phase_block(block_i16, d, rotate, p)
    if p == 1:
        return capture_head_plain(block_i16, d, rotate)
    x = _blocks(block_i16, d, p)
    rows, width = x.shape
    mp, kp, cols = _int_mm_shape(rows, width, 2 * p)
    dev = block_i16.device
    m8 = device_const(_int8_matrix, d, p, bool(rotate), kp, cols, device=dev)
    csum = device_const(_offset_sums, d, p, bool(rotate), device=dev)
    hi = (x >> 8).to(torch.int8)
    lo = (torch.bitwise_and(x, 255) - 128).to(torch.int8)
    if (mp, kp) != (rows, width):
        pad = (0, kp - width, 0, mp - rows)
        hi, lo = F.pad(hi, pad), F.pad(lo, pad)
    zhi = _int8_product(hi, m8)[:rows, :2 * p]
    zlo = _int8_product(lo, m8)[:rows, :2 * p]
    out = (zhi * 256 + zlo + csum).to(torch.float32) * float(_SCALE)
    return _planar(out, p)


def _exact_product(block_i16: torch.Tensor, d: int, p: int, rotate: bool,
                   cols: slice = slice(None)) -> torch.Tensor:
    """``(K/P, P*2D) @ (P*2D, 2P)[:, cols]`` of the raw samples against
    :func:`_fs4_decim_matrix`, accumulated exactly: in float32 (TF32 off)
    while D <= 256, where every partial sum is an integer within 2**24,
    and in float64 above that."""
    if d <= _MAX_F32_EXACT_D:
        fp32_products()
        dt = torch.float32
    else:
        dt = torch.float64
    g = _blocks(block_i16, d, p).to(dt)
    return g @ _matrix(block_i16, d, p, rotate)[:, cols].to(dt)


def capture_frontend_mm_i16(block_i16: torch.Tensor, downsample: int,
                            rotate: bool = True, p: int | None = None):
    """``(2N,) int16 -> ((K,), (K,)) float32`` planar, the plain integer
    head in the reference's matrix form: the raw samples times
    :func:`_fs4_decim_matrix` in one exact product
    (:func:`_exact_product`), then one float32 scale.  Equals
    :func:`capture_head_plain` bit for bit; ``p == 1`` (no usable phase
    block) computes through it directly."""
    d = int(downsample)
    p = _phase_block(block_i16, d, rotate, p)
    if p == 1:
        return capture_head_plain(block_i16, d, rotate)
    out = _exact_product(block_i16, d, p, rotate)
    return _planar(out.to(torch.float32) * float(_SCALE), p)


def capture_frontend_mm_i16_2(block_i16: torch.Tensor, downsample: int,
                              rotate: bool = True, p: int | None = None):
    """Two-product twin of :func:`capture_frontend_mm_i16`: the Re and Im
    halves of the mask matrix in separate exact products, so each
    ``(K/P, P)`` result is already its planar stream.  Equals
    :func:`capture_frontend_mm_i16` bit for bit."""
    d = int(downsample)
    p = _phase_block(block_i16, d, rotate, p)
    if p == 1:
        return capture_head_plain(block_i16, d, rotate)
    scale = float(_SCALE)
    return tuple(_exact_product(block_i16, d, p, rotate, half).to(
        torch.float32).reshape(-1) * scale
        for half in (slice(None, p), slice(p, None)))


def capture_frontend_mm_bf16(block_i16: torch.Tensor, downsample: int,
                             rotate: bool = True, p: int | None = None):
    """``(2N,) int16 -> ((K,), (K,)) float32`` planar, a traffic probe and
    inexact by design: the scaled input is rounded to bfloat16 (8 mantissa
    bits against the 15 the head needs) and multiplies the bfloat16 mask
    matrix with float32 accumulation.  Both bfloat16 operands are upcast
    to float32 before one float32 product (TF32 off): every bfloat16
    product is exact in float32, as the reference's
    ``preferred_element_type=float32`` gives.  Within a relative error of
    0.05 of :func:`capture_head_plain` on the reference test's input
    (tests/test_frontend_mxu.py:187-198); ``p == 1`` computes through it."""
    d = int(downsample)
    p = _phase_block(block_i16, d, rotate, p)
    if p == 1:
        return capture_head_plain(block_i16, d, rotate)
    fp32_products()
    y = block_i16.to(torch.bfloat16) * _BF16_SCALE
    g = _blocks(y, d, p).to(torch.float32)
    return _planar(g @ _matrix(block_i16, d, p, rotate), p)


def capture_frontend_t2(block_i16: torch.Tensor, downsample: int,
                        rotate: bool = True, precision=None):
    """``(2N,) int16 -> ((K,), (K,)) float32`` planar, the thin product
    ``(2, 2D) @ (K, 2D)^T`` in float32 (TF32 off): its two rows are the
    planar streams, the group phase applied by select.  Equal to
    :func:`capture_head_plain` up to float32 sum reassociation."""
    _highest(precision)
    d = int(downsample)
    k = _rows(block_i16, d)
    fp32_products()
    g = (block_i16.to(torch.float32) * float(_SCALE)).reshape(k, 2 * d)
    m2 = device_const(_masks, d, bool(rotate), "float32",
                      device=block_i16.device)
    zi, zq = m2 @ g.T
    if rotate and d % 4:
        zi, zq = _group_phase_select(zi, zq, d)
    return zi, zq


def capture_frontend_conv(block_i16: torch.Tensor, downsample: int,
                          rotate: bool = True, precision=None):
    """``(2N,) int16 -> ((K,), (K,)) float32`` planar, one strided
    convolution (window = stride = 2D, two output channels: the Re and Im
    masks) over the flat interleaved stream, TF32 off; the group phase by
    select.  Equal to :func:`capture_head_plain` up to float32 sum
    reassociation."""
    _highest(precision)
    d = int(downsample)
    _rows(block_i16, d)
    fp32_products()
    y = (block_i16.to(torch.float32) * float(_SCALE))[None, None, :]
    w = device_const(_masks, d, bool(rotate), "float32",
                     device=block_i16.device)[:, None, :]
    zi, zq = F.conv1d(y, w, stride=2 * d)[0]
    if rotate and d % 4:
        zi, zq = _group_phase_select(zi, zq, d)
    return zi, zq


def _launch_head(block_i16: torch.Tensor, downsample: int, rotate: bool,
                 interleaved: bool, what: str, grid: int | None = None):
    """Launch ``capture_head.cu`` on a CUDA tensor; returns the outputs.
    ``grid`` forces the number of CTAs (default: one resident wave)."""
    kernels.require_cuda_int16(block_i16, what)
    d = int(downsample)
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"{what}: downsample {d} outside 1..{_MAX_D}")
    k = _rows(block_i16, d)
    dev = block_i16.device
    if interleaved:
        out_a = torch.empty((k, 2), dtype=torch.float32, device=dev)
        out_b = None
    else:
        out_a = torch.empty(k, dtype=torch.float32, device=dev)
        out_b = torch.empty(k, dtype=torch.float32, device=dev)
    p = plan.plan("capture_head", d)
    if grid is None:
        grid = kernels.grid(p, plan.head_tiles(p, k), dev)
    with torch.cuda.device(dev):
        err = kernels.lib("capture_head").rx_capture_head(
            block_i16.data_ptr(), out_a.data_ptr(),
            None if out_b is None else out_b.data_ptr(), k, d, int(rotate),
            int(interleaved), float(_SCALE), p.rows, p.stages, p.stage_bytes,
            int(grid), kernels.stream_handle(dev))
    kernels.check(err, what)
    return out_a if interleaved else (out_a, out_b)


def capture_frontend_mm_pallas(block_i16: torch.Tensor, downsample: int,
                               rotate: bool = True, p: int = 32,
                               tile_rows: int = 128, precision=None,
                               interpret: bool = False):
    """K1: ``(2N,) int16 -> ((K,), (K,)) float32`` planar capture head.

    Launches ``capture_head.cu`` for a CUDA tensor (any K; the TPU's
    ``K % P`` gate does not apply) and counts the launch; a CPU tensor
    runs :func:`capture_head_plain`.  The reference's keywords: ``p`` (the
    TPU product's column block) changes nothing and is ignored;
    ``precision`` below HIGHEST, ``tile_rows`` other than 128 and
    ``interpret=True`` raise ``ValueError``."""
    _highest(precision)
    _pallas_options("capture_frontend_mm_pallas", interpret, tile_rows, 128)
    if block_i16.device.type == "cpu":
        return capture_head_plain(block_i16, downsample, rotate)
    out = _launch_head(block_i16, downsample, rotate, False,
                       "capture_frontend_mm_pallas")
    capture_frontend_mm_pallas.launches += 1
    return out


capture_frontend_mm_pallas.launches = 0


def capture_frontend_mm_pallas2(block_i16: torch.Tensor, downsample: int,
                                rotate: bool = True, p: int = 32,
                                tile_rows: int = 256,
                                interpret: bool = False):
    """K4: the two-output twin of K1 — separate Re and Im planes, which
    are K1's planar layout; same kernel, its own launch count.  ``p`` is
    ignored; ``tile_rows`` other than 256 and ``interpret=True`` raise
    ``ValueError``, as for K1."""
    _pallas_options("capture_frontend_mm_pallas2", interpret, tile_rows, 256)
    if block_i16.device.type == "cpu":
        return capture_head_plain(block_i16, downsample, rotate)
    out = _launch_head(block_i16, downsample, rotate, False,
                       "capture_frontend_mm_pallas2")
    capture_frontend_mm_pallas2.launches += 1
    return out


capture_frontend_mm_pallas2.launches = 0
