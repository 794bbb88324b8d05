"""Meshes over processes (the port of the reference's
``repro/launch/mesh.py``): serving, host and production meshes.

The reference builds a ``jax`` mesh over the devices one controller
sees; the port runs ONE PROCESS PER DEVICE (SPMD over processes): every
rank runs the same host program on the same requests, seeds and
configuration, and its device holds that rank's shard.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, with the reference's axis names: ``("data",)`` for data
parallelism, ``("data", "model")`` for data x tensor parallelism, and
the production meshes of training, ``("data", "model")`` of (16, 16) or
``("pod", "data", "model")`` of (2, 16, 16).

``init_serving_processes`` joins the process group first: an explicit
backend (``nccl`` on CUDA, ``gloo`` when the caller asks: the CPU tests,
or two processes sharing one card) and a timeout, so a rank that dies
fails its peers' collectives instead of hanging them.  ``run_spmd``
spawns a whole group in one call (tests, ``chip_smoke.py``), with a join
timeout, every rank's process group destroyed on every exit path, and
the first failure raised.

Nothing here runs when the module is imported.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import serving_tp_issues

BACKENDS = ("nccl", "gloo")


def init_serving_processes(coordinator: str, num_processes: int,
                           process_id: int, local_device_ids=None, *,
                           backend: str = "nccl",
                           timeout_s: float = 600.0) -> None:
    """Join the process group (serving or training):
    ``init_process_group`` with the explicit ``backend`` and
    ``timeout_s``.  ``coordinator``: "host:port" of rank 0 (TCP), or an
    ``init_method`` URL ("file:///path" for a FileStore, "env://" under
    torchrun).  ``local_device_ids``: this
    process's card (an int, or a one-entry sequence); on the nccl backend
    the default is the process's local rank, on gloo none is pinned
    unless asked.  A rank asked for nccl that finds no card raises, it
    does not carry on on the CPU.  Call once per process, before any
    mesh."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs a CUDA device and this "
                           "process sees none: pass backend='gloo' to "
                           "serve on the CPU")
    if isinstance(local_device_ids, (list, tuple)):
        if len(local_device_ids) != 1:
            raise ValueError("one device per process: local_device_ids "
                             f"{local_device_ids}")
        local_device_ids = local_device_ids[0]
    if local_device_ids is None and backend == "nccl":
        local_device_ids = int(os.environ.get("LOCAL_RANK",
                                              process_id % max(
                                                  1, torch.cuda.device_count())))
    if local_device_ids is not None:
        torch.cuda.set_device(int(local_device_ids))
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_over(shape, names):
    """A DeviceMesh of ``shape`` with axes ``names`` over every process
    (rank-major: rank = row-major index), on the group's device type."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def _production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh: one pod of 16 x 16, or
    two pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def check_production_world(world: int, multi_pod: bool = False) -> None:
    """ValueError unless ``world`` processes make the production mesh."""
    shape, _ = _production_shape(multi_pod)
    need = math.prod(shape)
    if world != need:
        raise ValueError(
            f"the {'multipod' if multi_pod else 'production'} mesh "
            f"{shape} needs {need} processes, one a device; the world has "
            f"{world}")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the processes: ("data",
    "model") of (16, 16), or ("pod", "data", "model") of (2, 16, 16) with
    ``multi_pod``.  A world of another size raises ``ValueError`` naming
    both (256 or 512 processes; 1 when no process group is running)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    check_production_world(world, multi_pod)
    return mesh_over(*_production_shape(multi_pod))


def make_serving_mesh(dp: int = 0, tp: int = 1, cfg=None):
    """Serving mesh: ``("data",)`` over ``dp`` ranks (0 = all) when
    ``tp`` is 1, else ``("data", "model")`` of (dp, tp) (dp 0: world /
    tp).  The serving engines shard their batch (slots) axis over "data"
    and, under tensor parallelism, weights and KV heads over "model"
    (``sharding.make_serving_rules``).

    ``cfg``: an ArchConfig validated up front, before any rank is asked:
    an axis that ``tp`` does not divide raises ``ValueError`` naming it
    (``sharding.serving_tp_issues``: heads, KV heads, d_ff, Mamba's inner
    width, the experts and the shared experts).  The mesh spans every
    process: dp x tp must be the world size."""
    tp = max(1, int(tp))
    if cfg is not None and tp > 1:
        issues = serving_tp_issues(cfg, tp)
        if issues:
            raise ValueError(
                f"tp={tp} does not divide arch {cfg.name!r} on axis "
                + "; ".join(issues)
                + " — pick a tp that divides, or serve dp-only "
                "(replicated weights)")
    n = dist.get_world_size()
    if tp == 1:
        dp = dp or n
        if dp != n:
            raise ValueError(f"dp={dp}: the serving mesh spans all {n} "
                             f"processes")
        return mesh_over((dp,), ("data",))
    if n % tp:
        raise ValueError(f"tp={tp} does not divide the {n} processes")
    dp = dp or n // tp
    if dp * tp > n:
        raise ValueError(f"dp={dp} x tp={tp} needs {dp * tp} processes, "
                         f"only {n} running")
    if dp * tp != n:
        raise ValueError(f"dp={dp} x tp={tp} = {dp * tp}: the serving mesh "
                         f"spans all {n} processes")
    return mesh_over((dp, tp), ("data", "model"))


def make_host_mesh(model: int = 1):
    """A ("data", "model") mesh of (world / model, model) over every
    process (tests, examples; at one process and model 1, the sharded
    code path on one device)."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model={model} does not divide the {n} "
                         f"processes")
    return mesh_over((n // model, model), ("data", "model"))


# -- spawning a group (tests, chip_smoke.py) ---------------------------------


def _spmd_entry(fn, rank: int, world: int, url: str, backend: str,
                timeout_s: float, device_ids, args, results) -> None:
    try:
        torch.set_num_threads(1)
        dev = None if device_ids is None else device_ids[rank]
        init_serving_processes(url, world, rank, dev, backend=backend,
                               timeout_s=timeout_s)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:           # reported to the parent, then exit 1
        results.put((rank, False, traceback.format_exc()))
        raise


def run_spmd(fn: Callable, world: int, *, store_dir: str,
             backend: str = "gloo", timeout_s: float = 300.0,
             device_ids: Optional[Sequence[int]] = None,
             args: tuple = ()) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes that form
    one process group (rendezvous through a FileStore file under
    ``store_dir``, no TCP port).  ``fn`` must be importable (a module's
    top-level function) and return something picklable.  Returns the
    ranks' results in rank order.  Raises RuntimeError with the failing
    rank's traceback if any rank fails, exits without a result, or the
    group outlives ``timeout_s`` (the others are terminated then)."""
    os.makedirs(store_dir, exist_ok=True)
    path = os.path.join(store_dir, f"store-{os.getpid()}-{time.time_ns()}")
    url = "file://" + os.path.abspath(path)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_spmd_entry,
                         args=(fn, r, world, url, backend, timeout_s,
                               device_ids, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout_s
    failure = None
    try:
        while len(got) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"the group outlived its {timeout_s} s timeout"
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got
                        and p.exitcode not in (0, None)]
                if dead:
                    # a rank may have reported just before it died
                    try:
                        rank, ok, out = results.get(timeout=1.0)
                    except queue.Empty:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no "
                                   f"result")
                        break
                else:
                    continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
    finally:
        for p in procs:
            p.join(timeout=5 if failure is None else 0.5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        if os.path.exists(path):
            os.remove(path)
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(world)]
