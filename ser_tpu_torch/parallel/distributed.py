"""Multi-process runtime initialization over ``torch.distributed``.

Counterpart of ``ser_tpu/parallel/distributed.py``. Every process that joins
a mesh of more than one process calls :func:`initialize_distributed` once,
before :func:`ser_tpu_torch.parallel.mesh.build_mesh`. It is driven by the
explicit ``SER_DIST_*`` triple (coordinator ``host:port``, process count,
process id), which becomes ``init_process_group(init_method="tcp://...",
world_size=..., rank=...)``, or by torchrun's environment (``WORLD_SIZE`` above
1 with ``MASTER_ADDR``, read through ``init_method="env://"``), the
counterpart of the JAX package's Cloud-TPU auto-detection.

The backend follows the device every entry point resolves
(``SER_TORCH_DEVICE``, ``runtime_policy.resolve_device``): NCCL on the CUDA
card, gloo on the CPU. With no card and no CPU request, resolving the device
raises; an NCCL group that fails to form raises too. Nothing falls back to
gloo or to the CPU.
"""

from __future__ import annotations

import os
import threading

import torch
import torch.distributed as dist

from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

_initialized = False
_INIT_LOCK = threading.Lock()


def _torchrun_world(env: dict[str, str]) -> int:
    try:
        return int(env.get("WORLD_SIZE", "").strip() or 1)
    except ValueError:
        return 1


def is_multi_host_env(env: dict[str, str] | None = None) -> bool:
    """Explicit ``SER_DIST_*`` config, or torchrun's environment of more than one process."""
    env = env if env is not None else dict(os.environ)
    if env.get("SER_DIST_COORDINATOR"):
        return True
    return _torchrun_world(env) > 1 and bool(env.get("MASTER_ADDR", "").strip())


def resolve_distributed_kwargs(env: dict[str, str] | None = None) -> dict:
    """Pure ``SER_DIST_*`` → ``torch.distributed.init_process_group`` kwargs.

    Explicit overrides need the full triple (coordinator, process count,
    process id); a partial set is a configuration error, not a silent
    fallback to the environment. An empty dict means torchrun's environment
    (``init_method="env://"``).
    """
    env = env if env is not None else dict(os.environ)
    coordinator = env.get("SER_DIST_COORDINATOR", "").strip()
    if not coordinator:
        return {}
    missing = [
        name
        for name in ("SER_DIST_NUM_PROCESSES", "SER_DIST_PROCESS_ID")
        if not env.get(name, "").strip()
    ]
    if missing:
        raise ValueError(
            f"SER_DIST_COORDINATOR is set but {', '.join(missing)} is missing; "
            "explicit multi-host config needs all three variables."
        )
    try:
        num_processes = int(env["SER_DIST_NUM_PROCESSES"])
        process_id = int(env["SER_DIST_PROCESS_ID"])
    except ValueError as err:
        raise ValueError("SER_DIST_NUM_PROCESSES / SER_DIST_PROCESS_ID must be integers.") from err
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(
            f"Invalid process topology: id {process_id} of {num_processes} processes."
        )
    return {
        "init_method": f"tcp://{coordinator}",
        "world_size": num_processes,
        "rank": process_id,
    }


def init_group(device: torch.device, **kwargs) -> None:
    """``init_process_group`` on ``device``'s backend (NCCL on the card, gloo on the CPU).

    On the card the process takes the card of its local rank (``LOCAL_RANK``,
    else its rank modulo the cards it sees), and the communicator is created
    eagerly (``device_id``), so that an NCCL failure raises now, not at the
    first collective.
    """
    if device.type == "cuda":
        rank = int(kwargs.get("rank", os.environ.get("RANK", 0)))
        index = device.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend="nccl" if device.type == "cuda" else "gloo", **kwargs)


def initialize_distributed(*, force: bool = False) -> bool:
    """Initializes ``torch.distributed`` for multi-process execution when configured.

    Returns True when the process group is (now) initialized. Safe to call
    unconditionally: a single-process environment returns False. Idempotent
    under concurrency (a lock serializes racing callers) and against external
    initialization: a default group that someone else already formed
    (``dist.is_initialized()``) is adopted as success.
    """
    global _initialized
    with _INIT_LOCK:
        if _initialized:
            return True
        if not force and not is_multi_host_env():
            return False
        if dist.is_initialized():
            logger.debug("torch.distributed already initialized externally; adopting.")
        else:
            kwargs = resolve_distributed_kwargs() or {"init_method": "env://"}
            init_group(resolve_device(os.environ.get("SER_TORCH_DEVICE", "auto")), **kwargs)
        _initialized = True
        logger.info(
            "torch.distributed initialized (%s): process %d/%d",
            dist.get_backend(),
            dist.get_rank(),
            dist.get_world_size(),
        )
        return True


def shutdown_distributed() -> None:
    """Destroys the default process group, if any; :func:`initialize_distributed` may then run again."""
    global _initialized
    with _INIT_LOCK:
        if dist.is_initialized():
            dist.destroy_process_group()
        _initialized = False


__all__ = [
    "init_group",
    "initialize_distributed",
    "is_multi_host_env",
    "resolve_distributed_kwargs",
    "shutdown_distributed",
]
