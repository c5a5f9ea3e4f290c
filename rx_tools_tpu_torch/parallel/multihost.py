"""Several processes: ``torch.distributed`` over gloo.

Counterpart of :mod:`rx_tools_tpu.parallel.multihost`.  The reference has
no distributed layer (SURVEY.md §2.6: "no sockets, no MPI/NCCL/Gloo"); the
port rides the stock ``torch.distributed`` runtime with the **gloo**
backend only.  Everything that crosses a process boundary is host data —
rx_power's flush accumulators and control flags, rx_fm's time-shard
scalars and audio — and gloo carries it on any machine.  NCCL is not used:
it cannot put two ranks on one card, so on a one-card machine it could
never be checked.

The job is set up from the variables the reference package reads, so one
launch line runs either package::

    JAX_COORDINATOR_ADDRESS=host:port JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \\
        python -m rx_tools_tpu_torch.apps.rx_power ...

The coordinator address becomes the rendezvous of rank 0's ``TCPStore``.
A pod's worker list with no coordinator (``TPU_WORKER_HOSTNAMES=a,b``)
cannot be set up by torch and raises.  Set-up has a bounded timeout,
``RX_DIST_TIMEOUT`` seconds (default 60): a missing peer fails the job
instead of hanging it, and a job the environment configures never carries
on as one process.

Failure semantics: fail-fast.  A lost process aborts the step; resume from
the last checkpoint (``stream.checkpoint``), the reference's
at-most-one-interval loss (``SURVEY.md §5 checkpoint/resume``).
"""

from __future__ import annotations

import atexit
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from rx_tools_tpu_torch.device import local_devices
from rx_tools_tpu_torch.parallel.mesh import Mesh


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def multi_process_env() -> bool:
    """True when the environment configures a job of more than one
    process, by the reference package's variables: a coordinator address
    or a pod's worker list, unless ``JAX_NUM_PROCESSES`` says 1 (a
    one-name worker list is a single host)."""
    env = os.environ
    configured = bool(env.get("JAX_COORDINATOR_ADDRESS")
                      or "," in env.get("TPU_WORKER_HOSTNAMES", "")
                      or env.get("MEGASCALE_COORDINATOR_ADDRESS"))
    n = env.get("JAX_NUM_PROCESSES", "").strip()
    return configured and not (n.isdigit() and int(n) <= 1)


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(
        seconds=float(os.environ.get("RX_DIST_TIMEOUT", "60")))


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> int:
    """Set up the process group; returns this process's rank.

    A no-op returning 0 when nothing configures a job of several processes
    (:func:`multi_process_env`).  Raises ``RuntimeError`` when the job is
    configured but cannot be set up: no coordinator, a missing peer within
    the set-up timeout, a rank out of range.
    """
    if _active():
        return dist.get_rank()
    env = os.environ
    coordinator_address = (coordinator_address
                           or env.get("JAX_COORDINATOR_ADDRESS") or None)
    if num_processes is None and env.get("JAX_NUM_PROCESSES", "").strip():
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and env.get("JAX_PROCESS_ID", "").strip():
        process_id = int(env["JAX_PROCESS_ID"])
    if coordinator_address is None:
        if multi_process_env():
            raise RuntimeError(
                "a pod worker list without a coordinator address cannot be "
                "set up by torch.distributed: set JAX_COORDINATOR_ADDRESS, "
                "JAX_NUM_PROCESSES and JAX_PROCESS_ID")
        return 0
    if num_processes is not None and num_processes <= 1:
        return 0
    if num_processes is None or process_id is None:
        raise RuntimeError(
            "JAX_COORDINATOR_ADDRESS needs JAX_NUM_PROCESSES and "
            "JAX_PROCESS_ID")
    if not 0 <= process_id < num_processes:
        raise RuntimeError(f"process id {process_id} outside a job of "
                           f"{num_processes} processes")
    addr = coordinator_address.removeprefix("tcp://")
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise RuntimeError(f"coordinator address {coordinator_address!r} "
                           "is not host:port")
    try:
        # the store waits at most the set-up timeout for every peer; the
        # collectives afterwards fail as soon as a peer's socket closes
        store = dist.TCPStore(host, int(port), world_size=num_processes,
                              is_master=process_id == 0,
                              timeout=_timeout(), wait_for_workers=True)
        dist.init_process_group("gloo", store=store,
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(minutes=30))
    except (RuntimeError, ValueError, OSError) as e:
        raise RuntimeError(
            f"process {process_id}/{num_processes} could not join the job "
            f"at {coordinator_address}: {e}") from e
    atexit.register(_shutdown)
    return process_id


def _shutdown() -> None:
    if _active():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 when single-process)."""
    return dist.get_rank() if _active() else 0


def is_primary() -> bool:
    """True on the process that owns stdout and CSV emission."""
    return process_index() == 0


def process_count() -> int:
    """Number of processes in the job (1 when single-process)."""
    return dist.get_world_size() if _active() else 1


def allgather(arr) -> np.ndarray:
    """Gather a host array from every process: ``(P, *arr.shape)``, dtype
    kept (gloo carries int64 and float32 exactly).  Single-process:
    ``arr[None]`` without a collective."""
    a = np.ascontiguousarray(np.asarray(arr))
    if process_count() == 1:
        return a[None]
    t = torch.from_numpy(a.copy())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def allgather_exact_i64(arr) -> np.ndarray:
    """int64-exact cross-process gather: ``(P, *arr.shape)``.  The
    reference package splits the operand into two uint32 planes because
    its collective path narrows int64 to int32; gloo gathers int64 as it
    is, so this is :func:`allgather` of the int64 array (bit-exact at any
    ``--int-fft`` accumulator magnitude)."""
    return allgather(np.asarray(arr, np.int64))


def broadcast_flags(flags) -> np.ndarray:
    """Broadcast a small int array from the primary to every process, so
    control decisions (flush now? stop now?) are single-sourced and every
    process enters the next collective in lockstep (the reference's
    controller-thread pattern, ``rtl_fm.c:999-1050``).  Single-process:
    identity."""
    a = np.asarray(flags)
    if process_count() == 1:
        return a
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    dist.broadcast(t, src=0)
    return t.numpy()


def global_mesh(axis: str = "t") -> Mesh:
    """The job's mesh, rank-major: all of process 0's local devices, then
    process 1's, and so on (every process must have the same count).  An
    entry of another process stands for that process's device and is never
    used here: a process runs only the entries it owns."""
    devs = local_devices()
    counts = allgather(np.array([len(devs)], np.int64))[:, 0]
    if len(set(counts.tolist())) != 1:
        raise RuntimeError(f"processes have unequal device counts {counts}")
    n_proc = len(counts)
    return Mesh(tuple(devs) * n_proc, axis,
                tuple(p for p in range(n_proc) for _ in devs))
