"""Attempt execution with compute-only timeouts: in-process and in a spawned worker.

Counterpart of ``ser_tpu/_internal/runtime/worker_lifecycle.py``: setup runs
first and untimed (model load), then compute runs under the timeout budget;
a worker's errors cross the process boundary typed (``errors.error_kind``
and ``rehydrate_error``); a timed-out worker is terminated, then killed.

Workers start from the ``spawn`` context only, never ``fork``: a forked
child would inherit the parent's CUDA context, which CUDA does not support.
The transcript lane isolates only runs on the CPU
(``_internal/transcript/process_isolation.py``).
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import pickle
from collections.abc import Callable
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any

from ser_tpu_torch._internal.runtime.errors import (
    InferenceError,
    InferenceExecutionError,
    InferenceTimeoutError,
    error_kind,
    rehydrate_error,
)

logger = logging.getLogger(__name__)

_SETUP_COMPLETE = ("phase", "setup_complete")
_KILL_GRACE_SECONDS = 2.0


def run_attempt_in_process(
    *,
    setup: Callable[[], Any],
    compute: Callable[[Any], Any],
    timeout_seconds: float,
    profile: str,
) -> Any:
    """Runs setup untimed, then compute under a soft thread timeout.

    A thread cannot be killed, so on timeout the attempt is abandoned (the
    thread runs on) and ``InferenceTimeoutError`` raised.
    """
    context = setup()
    if timeout_seconds <= 0:
        return compute(context)
    # Not a ``with`` block: its exit joins the still-running thread, and the timeout would bound nothing.
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(compute, context)
    try:
        result = future.result(timeout=timeout_seconds)
    except FutureTimeoutError:
        future.cancel()
        pool.shutdown(wait=False)
        raise InferenceTimeoutError(f"Inference compute exceeded {timeout_seconds:.1f}s budget.", profile=profile) from None
    pool.shutdown(wait=True)
    return result


def _worker_main(conn, setup_compute_payload: bytes) -> None:
    """Spawned worker: run setup, signal, run compute, send the result or the error."""
    try:
        setup, compute = pickle.loads(setup_compute_payload)
        context = setup()
        conn.send(_SETUP_COMPLETE)
        result = compute(context)
        conn.send(("ok", result))
    except BaseException as err:  # noqa: BLE001 - everything must cross the pipe typed
        try:
            conn.send(("err", error_kind(err), f"{type(err).__name__}: {err}"))
        except Exception:  # pragma: no cover - the pipe is already broken
            pass
    finally:
        conn.close()


def run_attempt_in_spawned_process(
    *,
    setup: Callable[[], Any],
    compute: Callable[[Any], Any],
    timeout_seconds: float,
    setup_timeout_seconds: float = 300.0,
    profile: str,
) -> Any:
    """Runs one attempt in a spawned worker with a one-way pipe handshake.

    The worker sends ``("phase", "setup_complete")``, then ``("ok", result)``
    or ``("err", kind, message)``. Setup and compute have timeouts of their
    own; the compute timeout starts when setup completes. ``setup`` and
    ``compute`` must pickle (module-level functions or ``partial``s of them).
    """
    ctx = mp.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe(duplex=False)
    payload = pickle.dumps((setup, compute))
    process = ctx.Process(target=_worker_main, args=(child_conn, payload), daemon=True)
    process.start()
    child_conn.close()
    try:
        if not parent_conn.poll(setup_timeout_seconds):
            raise InferenceTimeoutError(f"Worker setup exceeded {setup_timeout_seconds:.1f}s.", profile=profile)
        message = parent_conn.recv()
        if message != _SETUP_COMPLETE:
            raise _parse_error(message, profile)
        if not parent_conn.poll(timeout_seconds if timeout_seconds > 0 else None):
            raise InferenceTimeoutError(f"Inference compute exceeded {timeout_seconds:.1f}s budget.", profile=profile)
        message = parent_conn.recv()
        if isinstance(message, tuple) and len(message) == 2 and message[0] == "ok":
            return message[1]
        raise _parse_error(message, profile)
    except (EOFError, ConnectionError) as err:
        raise InferenceExecutionError(f"Worker pipe closed unexpectedly: {err}", profile=profile) from err
    finally:
        parent_conn.close()
        _shutdown_worker(process)


def _parse_error(message: Any, profile: str) -> InferenceError:
    """Validates and rehydrates one worker error message."""
    if (
        isinstance(message, tuple)
        and len(message) == 3
        and message[0] == "err"
        and isinstance(message[1], str)
        and isinstance(message[2], str)
    ):
        return rehydrate_error(message[1], message[2], profile=profile)
    return InferenceExecutionError(f"Malformed worker message: {message!r}", profile=profile)


def _shutdown_worker(process: mp.process.BaseProcess) -> None:
    """terminate, then kill if the worker outlives its grace period."""
    if not process.is_alive():
        process.join(timeout=0.1)
        return
    process.terminate()
    process.join(timeout=_KILL_GRACE_SECONDS)
    if process.is_alive():
        logger.warning("Worker did not terminate; killing.")
        process.kill()
        process.join(timeout=_KILL_GRACE_SECONDS)


__all__ = ["run_attempt_in_process", "run_attempt_in_spawned_process"]
