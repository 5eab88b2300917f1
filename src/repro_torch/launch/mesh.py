"""Meshes over a ``torch.distributed`` world: the port of the JAX package's
``launch/mesh.py``.

Each process is one rank.  :func:`init_distributed` starts this process's
rank of a world; the ``make_*mesh`` functions then return a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
the axis names the collectives (``repro_torch.dist``) and the planner
(``mesh_axes=``) use.  Axes: 'data' = data parallel (fast ICI), 'model' =
tensor / expert / sequence parallel (fast ICI), 'pod' = the slow axis
between pods (DCN).  The device type is the card's unless the caller asks
for the CPU.

:func:`run_world` starts a world of ranks on this host with
``torch.multiprocessing`` (spawn) and a ``FileStore`` — how tests and the
chip smoke test start one.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from ..device import resolve_device

# gloo on CUDA tensors stages each collective through the host; a rank
# that waits longer than this for its peers fails its collective
DEFAULT_TIMEOUT_S = 300.0


def init_distributed(backend: str, rank: int, world: int, store, *,
                     device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Start this process's rank of a ``world``-rank process group.

    ``store`` (a ``torch.distributed.Store``, e.g. a ``FileStore`` every
    rank opens) is where the ranks meet.  ``device`` (a CUDA device) is
    made this process's current device first, as NCCL needs; NCCL refuses
    two ranks of one communicator on the same card, gloo does not.
    """
    if device is not None:
        device = resolve_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
    tdist.init_process_group(
        backend, rank=rank, world_size=world, store=store,
        timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device="cuda"):
    """A DeviceMesh of ``shape`` over the world's ranks (row-major: rank r
    sits at the coordinates of r in ``shape``), named ``axes``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(model: Optional[int] = None, *, device="cuda"):
    """Mesh over the whole world (tests / single host): (data, model)."""
    n = tdist.get_world_size()
    model = model or 1
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    return make_mesh((n // model, model), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 = one 256-rank pod; (2, 16, 16) = two pods over DCN.  Gradients
    cross the 'pod' axis once per step via the hierarchical monoid
    reduction."""
    shape: Tuple[int, ...] = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


# ---------------------------------------------------------------------------
# a world of ranks on this host
# ---------------------------------------------------------------------------

def _result_path(store_path: str, rank: int) -> str:
    return f"{store_path}.rank{rank}.pt"


def _rank_main(target, rank, world, store_path, args, results) -> None:
    try:
        torch.set_num_threads(1)
        # by value through a file: tensors sent through the queue would be
        # shared through this process, which exits
        torch.save(target(rank, world, store_path, *args),
                   _result_path(store_path, rank))
        results.put((rank, True, ""))
    except BaseException:                       # reported, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def run_world(target: Callable[..., Any], world: int, *,
              args: Sequence[Any] = (), timeout_s: float = 600.0,
              store_dir: Optional[str] = None) -> List[Any]:
    """Run ``target(rank, world, store_path, *args)`` in ``world`` spawned
    processes and return the ranks' results in rank order.

    ``target`` must be importable (a module-level function); it starts its
    rank with ``init_distributed(..., store=FileStore(store_path, world))``
    and returns something ``torch.save`` takes; it comes back on the CPU.
    A rank that raises, exits without a
    result or is still running after ``timeout_s`` fails the world: every
    rank still alive is killed and ``RuntimeError`` says which failed.
    """
    tmp = tempfile.mkdtemp(prefix="world-", dir=store_dir)
    try:
        return _run_in(target, world, tuple(args), timeout_s,
                       os.path.join(tmp, "store"))
    finally:        # the store and the ranks' result files
        shutil.rmtree(tmp, ignore_errors=True)


def _run_in(target, world, args, timeout_s, store_path) -> List[Any]:
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, store_path, args,
                               results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got, failed = {}, {}
    deadline = time.monotonic() + timeout_s
    while len(got) + len(failed) < world and time.monotonic() < deadline:
        try:
            rank, ok, value = results.get(timeout=0.5)
        except queue.Empty:
            if any(p.exitcode not in (None, 0) for p in procs) and \
                    results.empty():
                time.sleep(0.5)       # let a failing rank's report land
                if results.empty():
                    break
            continue
        (got if ok else failed)[rank] = value
        if not ok:    # its peers would wait in a collective: stop soon
            deadline = min(deadline, time.monotonic() + 10.0)
    for p in procs:
        p.join(max(0.0, min(5.0, deadline - time.monotonic())))
        if p.is_alive():
            p.kill()
            p.join()
    missing = [r for r in range(world) if r not in got and r not in failed]
    if failed or missing:
        detail = "".join(f"\n--- rank {r} ---\n{tb}"
                         for r, tb in sorted(failed.items()))
        raise RuntimeError(
            f"world of {world}: ranks {sorted(failed)} failed, ranks "
            f"{missing} gave no result within {timeout_s:.0f}s (exit codes "
            f"{[p.exitcode for p in procs]}){detail}")
    return [torch.load(_result_path(store_path, r), map_location="cpu",
                       weights_only=False) for r in range(world)]
