"""Shared transient-failure retry: exponential backoff with decorrelated

Port of ``deepspeed_tpu/utils/retry.py``, host logic unchanged.
jitter, a per-call deadline budget, and retryable-error classification.

Every non-collective transport in the tree (heartbeat beacons over the
object store, the on-disk plan cache, the snapshot manifest commit) used to
fail hard on the first transient error — one EAGAIN on a shared bucket and
a healthy host read as dead. This module is the one retry loop they all
share, so the policy (and its observability) lives in one place:

- **backoff** — decorrelated jitter (``sleep = min(cap, uniform(base,
  prev*3))``): concurrent retriers de-synchronize instead of hammering the
  store in lockstep;
- **deadline budget** — a call gives up when either ``max_attempts`` or
  ``deadline_s`` runs out, whichever comes first, and the final failure is
  a :class:`RetryError` (an ``OSError`` subclass, so existing I/O-failure
  handling degrades the same way it always did);
- **classification** — only ``retryable`` exception classes are retried,
  and ``non_retryable`` subclasses (``FileNotFoundError``, ``KeyError`` —
  an *absent* object is a fact, not a transient) pass straight through;
- **observability** — every retry is logged, counted into the telemetry
  registry as ``dstpu_retry_total{site=...}``, appended to a bounded
  in-process log that rides crash flight dumps (``retries`` in
  ``flightdump-<rank>.json`` — the doctor can then show "host X retried
  the bucket 14x before the dead verdict"), and forwarded to an optional
  monitor sink (``Resilience/retry/*`` events when a ResilienceManager is
  live).

Stdlib-only at import time; the telemetry registry is imported lazily so
standalone drill scripts can use the loop without the package.
"""

import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

try:
    from .logging import logger
except ImportError:  # loaded standalone (file-path import in drill scripts)
    import logging

    logger = logging.getLogger("deepspeed_tpu_torch.retry")


class RetryError(OSError):
    """Retries exhausted (attempts or deadline). ``last`` carries the final
    underlying error; subclassing OSError keeps existing I/O-failure
    handling (plan-cache miss, beacon-absent) working unchanged."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(f"{site}: gave up after {attempts} attempt(s): "
                         f"{last!r}")
        self.site = site
        self.attempts = attempts
        self.last = last


@dataclass(frozen=True)
class RetryPolicy:
    """One transport's retry envelope. ``base_s``..``cap_s`` bound the
    decorrelated-jitter sleeps; ``deadline_s`` caps the whole call (None =
    attempts-only)."""
    max_attempts: int = 5
    base_s: float = 0.05
    cap_s: float = 2.0
    deadline_s: Optional[float] = 30.0
    retryable: Tuple[type, ...] = (OSError, ConnectionError, TimeoutError)
    non_retryable: Tuple[type, ...] = (FileNotFoundError, KeyError,
                                       IsADirectoryError)


DEFAULT_POLICY = RetryPolicy()

# bounded in-process retry log: rides flight dumps so the doctor can show
# the retry storm that preceded a dead-host verdict
_LOG_MAX = 256
_log: "deque" = deque(maxlen=_LOG_MAX)
_log_lock = threading.Lock()
# optional monitor sinks, keyed by the callable itself so several owners
# (e.g. a live engine's ResilienceManager AND an autotuner probe engine's)
# can coexist and each remove only its own: fn(site, attempt, error_repr,
# final) -> None. Registration happens on engine-init/finalizer threads
# while retriers iterate — lock-guarded like the retry log.
_monitor_sinks: Dict[int, Callable[[str, int, str, bool], None]] = {}
_sinks_lock = threading.Lock()


def add_retry_monitor(fn: Callable[[str, int, str, bool], None]) -> None:
    """Register a retry event sink — the ResilienceManager forwards these
    as ``Resilience/retry/*`` monitor events. Idempotent per callable
    OBJECT: sinks key by ``id(fn)``, so pass the SAME object to
    :func:`remove_retry_monitor` later (materialize a bound method once —
    ``obj.method`` builds a fresh object on every attribute access)."""
    with _sinks_lock:
        _monitor_sinks[id(fn)] = fn


def remove_retry_monitor(fn: Callable[[str, int, str, bool], None]) -> None:
    """Remove one owner's sink (the same object passed to
    :func:`add_retry_monitor`); other registered sinks keep receiving
    (closing a probe engine must not silence the live engine's events)."""
    with _sinks_lock:
        _monitor_sinks.pop(id(fn), None)


def retry_log_snapshot():
    """The bounded retry log as a list of dicts (newest last) — what the
    flight recorder folds into ``flightdump-<rank>.json``."""
    with _log_lock:
        return list(_log)


def clear_retry_log() -> None:
    with _log_lock:
        _log.clear()


def _note(site: str, attempt: int, err: BaseException, final: bool) -> None:
    entry = {"site": site, "attempt": attempt, "error": repr(err)[:200],
             "final": final, "wall_time": time.time()}
    with _log_lock:
        _log.append(entry)
    try:  # telemetry registry is optional (standalone loads, broken installs)
        from ..telemetry.registry import get_registry

        get_registry().counter(
            "dstpu_retry_total",
            "transient-transport retries by call site").inc(site=site)
    except Exception:
        pass
    with _sinks_lock:
        sinks = tuple(_monitor_sinks.values())
    for sink in sinks:
        try:
            sink(site, attempt, repr(err)[:200], final)
        except Exception:
            pass
    if final:
        logger.warning(f"retry[{site}]: giving up after {attempt} "
                       f"attempt(s): {err!r}")
    else:
        logger.warning(f"retry[{site}]: attempt {attempt} failed ({err!r}); "
                       f"backing off")


def retry_call(fn: Callable, *, site: str,
               policy: RetryPolicy = DEFAULT_POLICY,
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None,
               clock: Callable[[], float] = time.monotonic):
    """Call ``fn()`` under ``policy``; returns its value or raises
    :class:`RetryError` once attempts/deadline run out. Non-retryable
    errors (absent object, programming errors) pass through untouched.
    ``sleep``/``rng``/``clock`` are injectable so tests run instantly and
    deterministically."""
    rng = rng or random
    t0 = clock()
    delay = policy.base_s
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except policy.retryable as e:
            if isinstance(e, policy.non_retryable):
                raise
            out_of_budget = (policy.deadline_s is not None
                             and clock() - t0 >= policy.deadline_s)
            if attempt >= policy.max_attempts or out_of_budget:
                _note(site, attempt, e, final=True)
                raise RetryError(site, attempt, e) from e
            _note(site, attempt, e, final=False)
            # decorrelated jitter: next sleep is uniform over [base, 3*prev],
            # capped — concurrent retriers drift apart instead of thundering
            delay = min(policy.cap_s, rng.uniform(policy.base_s, delay * 3.0))
            if policy.deadline_s is not None:
                delay = min(delay, max(0.0, policy.deadline_s
                                       - (clock() - t0)))
            sleep(delay)
