"""Time-axis sharding of the FM chain: overlap-save halos between shards.

Counterpart of :mod:`rx_tools_tpu.parallel.timeshard`, with its boundary
semantics (that module's docstring has the algebra):

- A long recording is split into ``S`` contiguous time shards, shard ``s``
  on ``mesh.devices[s]``.  Each shard receives the trailing ``warmup``
  blocks of its left neighbour (the halo: a copy of those blocks onto the
  shard's device, in place of the reference's ``ppermute`` ring), replays
  them through the chain from zero state and only then emits its own
  blocks.  FIR state (fifth-order hists, droop, discriminator seam,
  boxcar) is a function of the last few input samples, so the seams are
  exact.
- The linear post-demod IIR state — deemphasis average, audio DC EMA
  (``-E dc``) and the rational resampler's window remainder — is carried
  in closed form: every shard publishes ``6 + 2*warmup`` float32 scalars,
  one gather stacks them (``S`` vectors), and a static affine recurrence
  gives every shard its exact initial state.  Sharded output equals the
  unsharded run to float rounding on every shard.
- The raw DC block (``-E rdc``) feeds the nonlinear discriminator and
  keeps the warm-up approximation (:func:`exact_iir_supported`).

Shard 0 replays zeros and resets to the initial state (its resampler phase
and window sum forced to 0) unless ``cont``: a continuation super-chunk
gives it the previous super-chunk's trailing blocks (``halo0``) and exact
carry (``iir_carry``).

The shards run in turn, each on its own device; the K1 capture-head kernel
launches once for every shard and once for every halo replay (the scan
engine's chunk-wide front).  Across processes (a mesh from
``multihost.global_mesh``) every process holds the whole super-chunk on the
host and runs its own shards; a halo whose left neighbour lives elsewhere
comes from that host copy, the scalar gather and the output gather are the
only collectives.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from rx_tools_tpu_torch import ops
from rx_tools_tpu_torch.models import fmchain
from rx_tools_tpu_torch.ops.numeric import device_const, fp32_products
from rx_tools_tpu_torch.ops.resample import (ResampleState,
                                             resample_rational,
                                             resample_rows_blocks,
                                             rows_path_eligible)
from rx_tools_tpu_torch.parallel import multihost
from rx_tools_tpu_torch.parallel.mesh import EXCHANGES, Mesh
from rx_tools_tpu_torch.stream.scan import scan_fm_blocks, stack_blocks


@functools.lru_cache(maxsize=32)
def _ema0_matrix(m: int, a: float) -> np.ndarray:
    """(m, m) lower-triangular EMA-from-zero operator: row k of ``E @ b``
    is ``sum_{j<=k} a**(k-j) * b[j]`` — the per-block DC EMA
    (``rtl_fm.c:684-697``) unrolled as one small product."""
    i = np.arange(m)
    e = i[:, None] - i[None, :]
    return np.where(e >= 0, np.float64(a) ** np.maximum(e, 0),
                    0.0).astype(np.float32)


def _powers(base: float, n: int) -> np.ndarray:
    """``base ** arange(1, n + 1)`` in float64, cast to float32."""
    return (np.float64(base) ** np.arange(1, n + 1)).astype(np.float32)


def shard_recording(iq: np.ndarray, n_shards: int, block_size: int
                    ) -> np.ndarray:
    """Split interleaved CS16 into (S, M, 2*block_size) contiguous shards."""
    blocks = stack_blocks(iq, block_size)
    m = blocks.shape[0] // n_shards
    return blocks[: n_shards * m].reshape(n_shards, m, -1)


def _fast_slow(cfg: fmchain.FmConfig) -> tuple[int, int]:
    if cfg.rate_out2 <= 0:
        return 1, 0
    g = math.gcd(cfg.rate_out, cfg.rate_out2)
    return cfg.rate_out // g, cfg.rate_out2 // g


def _resampler_phase(cfg: fmchain.FmConfig, audio_in_before: int) -> int:
    """Deterministic resampler phase after ``audio_in_before`` input
    samples."""
    if cfg.rate_out2 <= 0:
        return 0
    fast, slow = _fast_slow(cfg)
    return (audio_in_before * slow) % fast


def exact_iir_supported(cfg: fmchain.FmConfig) -> bool:
    """Configs whose shard seams are exact: the cross-shard IIR state
    (deemph average, audio-DC EMA, resampler window remainder) is linear
    post-demod and carried in closed form.  The raw DC block's EMA feeds
    the nonlinear discriminator and stays on the warm-up path."""
    return (not cfg.dc_block_raw
            and cfg.mode in ("fm", "am", "usb", "lsb")
            and (cfg.deemph_a > 0 or cfg.rate_out2 > 0
                 or cfg.dc_block_audio))


def resampler_modulus(cfg: fmchain.FmConfig) -> int:
    """The modulus the global block index is reduced by when seeding a
    continuation super-chunk's resampler phase (``fast`` in the
    reference's accumulate-and-dump resampler, ``rtl_fm.c:389-409``)."""
    return _fast_slow(cfg)[0] if cfg.rate_out2 > 0 else 1


def _scalar(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev).reshape(())


def time_sharded_fm(cfg: fmchain.FmConfig, sharded_blocks, *, mesh: Mesh,
                    warmup: int = 2, cont: bool = False, halo0=None,
                    block_offset_mod=None, iir_carry=None):
    """Process (S, M, 2N) int16 blocks (numpy on the host, or a tensor),
    shard ``s`` on ``mesh.devices[s]``.

    Returns ``(audio (S, M, cap), n_valid (S, M), carry (S, 3))`` on
    ``mesh.devices[0]`` (host tensors on a mesh that spans processes, every
    process's shards gathered); ``carry[s] = [deemph_avg_end,
    resampler_acc_end, dc_avg_end]`` of shard ``s`` (exact-path configs;
    zeros otherwise) — a continuation super-chunk passes ``iir_carry =
    carry[-1]``.  Outputs are aligned to each shard's own M blocks (the
    warm-up replay's output is dropped).

    ``cont=True`` chains super-chunks of a capture too long to hold at once
    (rx_fm's ``-E shard``): ``halo0`` is the previous super-chunk's
    trailing ``warmup`` blocks and ``block_offset_mod`` the global index of
    this super-chunk's first block modulo :func:`resampler_modulus`.
    """
    fmchain.check_supported(cfg)
    s_n, m, twon = sharded_blocks.shape
    if s_n != mesh.size:
        raise ValueError(f"{s_n} shards on a mesh of {mesh.size}")
    if not 1 <= warmup <= m:
        raise ValueError(f"warmup {warmup} outside 1..{m} blocks a shard")
    rank = multihost.process_index()
    mine = mesh.local(rank)
    spans = len(set(mesh.ranks)) > 1
    fast, slow = _fast_slow(cfg)
    apb = twon // 2 // cfg.downsample // cfg.post_downsample
    off_mod = int(block_offset_mod) if cont else 0
    carry_in = (np.zeros(3, np.float32) if iir_carry is None else
                np.asarray(torch.as_tensor(iir_carry).detach().cpu(),
                           np.float32).reshape(3))
    exact = exact_iir_supported(cfg)
    # the front chain of the exact path stops before the deemph / audio DC
    # / resampler tail, which runs below with the closed-form state
    cfg_front = (dataclasses.replace(cfg, deemph_a=0, rate_out2=-1,
                                     dc_block_audio=False)
                 if exact else cfg)
    fp32_products()

    # --- halo hand-off: the left neighbour's trailing blocks, copied onto
    #     each shard's device (from its device when this process owns it,
    #     else from the host copy every process holds) --------------------
    own = {s: fmchain.as_block(sharded_blocks[s], mesh.devices[s])
           for s in mine}
    EXCHANGES["halo"] += 1
    shards = {}
    for s in mine:
        dev = mesh.devices[s]
        if s == 0:
            halo = (fmchain.as_block(halo0, dev) if cont else
                    torch.zeros((warmup, twon), dtype=torch.int16,
                                device=dev))
        elif s - 1 in own:
            halo = own[s - 1][-warmup:].to(dev)
        else:
            halo = fmchain.as_block(sharded_blocks[s - 1][-warmup:], dev)
        # seed: zero state + the analytic resampler phase at the halo's
        # start, reduced factor by factor (exact in Python integers)
        f = max(fast, 1)
        start_block = off_mod + s * m - warmup
        phase0 = (((start_block % f) * (apb % f)) % f * (slow % f)) % f
        if s == 0 and not cont:
            phase0 = 0
        st = fmchain.init_state(cfg_front, dev)
        if not exact:
            st = st._replace(resamp=st.resamp._replace(
                phase=torch.tensor(phase0, dtype=torch.int32, device=dev)))
        st, halo_a, _, _ = scan_fm_blocks(cfg_front, st, halo)
        if s == 0 and not cont:
            # shard 0 replayed zeros: back to the initial state
            st = fmchain.init_state(cfg_front, dev)
        st, audio_s, nv_s, _ = scan_fm_blocks(cfg_front, st, own[s])
        shards[s] = dict(dev=dev, audio=audio_s, nv=nv_s, halo_a=halo_a,
                         phase0=phase0)

    if exact:
        _exact_tail(cfg, shards, mesh, m, apb, warmup, cont, carry_in,
                    spans)
    else:
        for sh in shards.values():
            sh["carry"] = torch.zeros(3, dtype=torch.float32,
                                      device=sh["dev"])

    dev0 = mesh.devices[0]
    if not spans:
        return (torch.stack([shards[s]["audio"].to(dev0) for s in mine]),
                torch.stack([shards[s]["nv"].to(dev0) for s in mine]),
                torch.stack([shards[s]["carry"].to(dev0) for s in mine]))
    # every process's shards, gathered in one float32 collective (the
    # counts are small integers, exact in float32)
    packed = np.stack([np.concatenate([
        shards[s]["audio"].reshape(-1).cpu().numpy(),
        shards[s]["nv"].cpu().numpy().astype(np.float32),
        shards[s]["carry"].cpu().numpy()]) for s in mine])
    EXCHANGES["output"] += 1
    glob = multihost.allgather(packed).reshape(s_n, -1)
    cap = shards[mine[0]]["audio"].shape[-1]
    audio = torch.from_numpy(glob[:, : m * cap].reshape(s_n, m, cap).copy())
    nv = torch.from_numpy(
        glob[:, m * cap: m * cap + m].astype(np.int32).copy())
    carry = torch.from_numpy(glob[:, m * cap + m:].copy())
    return audio, nv, carry


def _exact_tail(cfg, shards, mesh, m, apb, warmup, cont, carry_in, spans):
    """The closed-form linear tail (deemph + audio DC + rational resampler)
    of every local shard; sets ``shards[s]["audio" | "nv" | "carry"]``."""
    l_own = m * apb
    l_part = (m - warmup) * apb
    m_part = m - warmup
    dc_on = bool(cfg.dc_block_audio)
    deemph = bool(cfg.deemph_a)
    c = 1.0 - 1.0 / cfg.deemph_a if deemph else 0.0
    a_full = float(np.float32(np.float64(c) ** l_own)) if deemph else 0.0
    a_part = float(np.float32(np.float64(c) ** l_part)) if deemph else 0.0
    adc_full = float(np.float32(np.float64(0.9) ** m)) if dc_on else 0.0
    adc_part = float(np.float32(np.float64(0.9) ** m_part)) if dc_on else 0.0

    # -- each shard's from-zero ends, published as 6 + 2*warmup scalars ---
    pubs = {}
    for s, sh in shards.items():
        dev = sh["dev"]
        x = sh["audio"].reshape(-1)                  # (L,) own front audio
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if deemph:
            # y0[n] is the from-zero state after n+1 samples
            _, y0 = ops.deemph_filter(zero, x, cfg.deemph_a)
            b_full = y0[l_own - 1]
            b_part = y0[l_part - 1] if l_part > 0 else zero
            cvec = device_const(_powers, c, l_own, device=dev)
        else:
            y0, b_full, b_part, cvec = x, zero, zero, None
        if dc_on:
            # the EMA of per-block means of y = y0 + init_d * cvec is
            # affine in the deemph init: A0 + init_d * A1 (+ adc^(k+1) *
            # init_dc); adc = 9/10 (rtl_fm.c:684-697)
            ema0 = device_const(_ema0_matrix, m, 0.9, device=dev)
            mean0 = torch.mean(y0.reshape(m, apb), dim=1)
            a0vec = ema0 @ (mean0 * 0.1)
            if deemph:
                cmean = torch.mean(cvec.reshape(m, apb), dim=1)
                a1vec = ema0 @ (cmean * 0.1)
            else:
                cmean = torch.zeros(m, dtype=torch.float32, device=dev)
                a1vec = torch.zeros(m, dtype=torch.float32, device=dev)
            a0_full, a1_full = a0vec[m - 1], a1vec[m - 1]
            a0_part = a0vec[m_part - 1] if m_part > 0 else zero
            a1_part = a1vec[m_part - 1] if m_part > 0 else zero
            # the exact block means of the last `warmup` blocks: the right
            # neighbour's halo DC trajectory (its replayed halo audio
            # carries a from-zero front transient a mean never forgets)
            tail_means = torch.cat([mean0[-warmup:], cmean[-warmup:]])
            sh.update(a0vec=a0vec, a1vec=a1vec)
        else:
            a0_full = a1_full = a0_part = a1_part = zero
            tail_means = torch.zeros(2 * warmup, dtype=torch.float32,
                                     device=dev)
        sh.update(y0=y0, cvec=cvec)
        pubs[s] = torch.cat([torch.stack([b_part, b_full, a0_part, a0_full,
                                          a1_part, a1_full]),
                             tail_means]).to(torch.float32)

    # -- the one gather: a stack of every shard's vector (S, 6+2*warmup) --
    EXCHANGES["gather"] += 1
    mine = sorted(pubs)
    if spans:
        local = np.stack([pubs[s].cpu().numpy() for s in mine])
        gat = torch.from_numpy(
            multihost.allgather(local).reshape(mesh.size, -1).copy())
    else:
        gat = torch.stack([pubs[s].to(mesh.devices[0]) for s in mine])
    gd = gat.device

    # -- static cross-shard affine recurrences: every shard's deemph init,
    #    then (depending on those) every shard's DC init -------------------
    zero = torch.zeros((), dtype=torch.float32, device=gd)
    d_inits = [_scalar(carry_in[0], gd) if cont else zero]
    d_halo = [zero]
    for k in range(1, mesh.size):
        d_inits.append(gat[k - 1, 1] + a_full * d_inits[k - 1])
        d_halo.append(gat[k - 1, 0] + a_part * d_inits[k - 1])
    if dc_on:
        dc_inits = [_scalar(carry_in[2], gd) if cont else zero]
        dc_halo = [zero]
        halo_means = [torch.zeros(warmup, dtype=torch.float32, device=gd)]
        for k in range(1, mesh.size):
            b_dc_full = gat[k - 1, 3] + gat[k - 1, 5] * d_inits[k - 1]
            b_dc_part = gat[k - 1, 2] + gat[k - 1, 4] * d_inits[k - 1]
            dc_inits.append(b_dc_full + adc_full * dc_inits[k - 1])
            dc_halo.append(b_dc_part + adc_part * dc_inits[k - 1])
            halo_means.append(gat[k - 1, 6: 6 + warmup] + d_inits[k - 1]
                              * gat[k - 1, 6 + warmup: 6 + 2 * warmup])

    fast, slow = _fast_slow(cfg)
    for s in mine:
        sh = shards[s]
        dev = sh["dev"]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        init_own = d_inits[s].to(dev)
        init_halo = d_halo[s].to(dev)
        g = gat[s].to(dev)
        if deemph:
            y = sh["y0"] + init_own * sh["cvec"]
            avg_end = g[1] + a_full * init_own
        else:
            y, avg_end = sh["y0"], zero
        if dc_on:
            init_dc = dc_inits[s].to(dev)
            adcvec = device_const(_powers, 0.9, m, device=dev)
            avg_blocks = (sh["a0vec"] + init_own * sh["a1vec"]
                          + init_dc * adcvec)
            y = (y.reshape(m, apb) - avg_blocks[:, None]).reshape(-1)
            dc_end = g[3] + g[5] * init_own + adc_full * init_dc
        else:
            dc_end = zero

        if cfg.rate_out2 > 0:
            # the resampler's window remainder at the shard seam, recovered
            # exactly by replaying the halo's corrected audio from the
            # halo-start phase
            xh = sh["halo_a"].reshape(-1)
            if deemph:
                _, yh = ops.deemph_filter(zero, xh, cfg.deemph_a)
                yh = yh + init_halo * device_const(_powers, c, xh.shape[0],
                                                   device=dev)
            else:
                yh = xh
            if dc_on:
                # block means from the neighbour's exact published pairs
                emah = device_const(_ema0_matrix, warmup, 0.9, device=dev)
                avgh = (emah @ (halo_means[s].to(dev) * 0.1)
                        + dc_halo[s].to(dev)
                        * device_const(_powers, 0.9, warmup, device=dev))
                yh = (yh.reshape(warmup, apb) - avgh[:, None]).reshape(-1)
            st_rh, _, _ = resample_rational(
                ResampleState(zero, torch.tensor(sh["phase0"],
                                                 dtype=torch.int32,
                                                 device=dev)),
                yh, cfg.rate_out, cfg.rate_out2)
            if s == 0 and not cont:
                st_r = ResampleState(zero, torch.zeros(
                    (), dtype=torch.int32, device=dev))
            elif s == 0:
                st_r = ResampleState(_scalar(carry_in[1], dev), st_rh.phase)
            else:
                st_r = ResampleState(st_rh.acc.to(torch.float32),
                                     st_rh.phase)
            yb = y.reshape(m, apb)
            if (rows_path_eligible(apb, fast, slow, dev)
                    and l_own * slow + fast < 2 ** 31):
                # the per-block resampler calls batched, with their values
                st_r, out_a, out_nv = resample_rows_blocks(
                    st_r, yb, cfg.rate_out, cfg.rate_out2)
            else:
                outs, nvs = [], []
                for i in range(m):
                    st_r, yo, nv = resample_rational(
                        st_r, yb[i], cfg.rate_out, cfg.rate_out2)
                    outs.append(yo)
                    nvs.append(nv)
                out_a, out_nv = torch.stack(outs), torch.stack(nvs)
            acc_end = st_r.acc
        else:
            out_a = y.reshape(m, apb)
            out_nv = torch.full((m,), apb, dtype=torch.int32, device=dev)
            acc_end = zero
        sh["audio"], sh["nv"] = out_a, out_nv.to(torch.int32)
        sh["carry"] = torch.stack([avg_end, acc_end, dc_end]).to(
            torch.float32)
