"""Retry policy with separate timeout and transient budgets.

Counterpart of ``ser_tpu/_internal/runtime/policy.py``: an
``InferenceTimeoutError`` draws on the timeout budget, a
``TransientInferenceError`` on the transient budget, and a fixed backoff
separates attempts. A spent budget raises the last error to the caller
(a ``TransientInferenceError`` with ``hard_oom`` kept). The JAX package can
run a hook there instead, its CPU attempt, at once on a hard device OOM
(``on_exhausted_transient``, ``hard_oom_failover_now``); the port runs on the
CPU only when the settings ask for it, so it has neither.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from dataclasses import dataclass
from typing import TypeVar

from ser_tpu_torch._internal.runtime.errors import InferenceTimeoutError, TransientInferenceError
from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

T = TypeVar("T")


@dataclass(frozen=True)
class RetryPolicy:
    """Budgets for one profile's inference attempts."""

    max_timeout_retries: int = 0
    max_transient_retries: int = 0
    retry_backoff_seconds: float = 0.0


def run_with_retry_policy(
    attempt: Callable[[], T],
    *,
    policy: RetryPolicy,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Runs ``attempt`` until it returns, or raises its last error once that error's budget is spent."""
    timeout_budget = max(0, policy.max_timeout_retries)
    transient_budget = max(0, policy.max_transient_retries)
    while True:
        try:
            return attempt()
        except InferenceTimeoutError:
            if timeout_budget <= 0:
                raise
            timeout_budget -= 1
            logger.warning("Inference attempt timed out; retrying (%d timeout retries left).", timeout_budget)
        except TransientInferenceError as err:
            if transient_budget <= 0:
                raise
            transient_budget -= 1
            logger.warning(
                "Transient inference failure (%s); retrying (%d transient retries left).", err, transient_budget
            )
        if policy.retry_backoff_seconds > 0:
            sleep(policy.retry_backoff_seconds)


__all__ = ["RetryPolicy", "run_with_retry_policy"]
