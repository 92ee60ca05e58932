"""Retry policy engine: exponential backoff + full jitter (a copy of
``veles_tpu/resilience/retry.py``, which imports no JAX).

The reference's I/O paths assumed a LAN (single ``urlopen``, no
timeout, Twisted reconnect loops hidden in the transport); production
multi-host runs retry instead. One policy object carries the whole
contract — attempt cap, backoff curve, deadline, retryable-exception
predicate — and is applied as a decorator, via :meth:`RetryPolicy.call`,
or as the context-manager loop :meth:`RetryPolicy.attempts`:

    policy = RetryPolicy(name="download", max_attempts=5)

    @policy
    def fetch(): ...

    policy.call(fetch)

    for attempt in policy.attempts():
        with attempt:
            fetch()

Backoff before retry ``n`` (1-based) is ``min(max_delay,
base_delay * 2**(n-1))``, scaled by full jitter — uniform in [0, raw)
drawn from the PRNG-seeded ``retry`` stream, so herds decorrelate but
seeded runs reproduce. Every performed retry increments
``veles_retries_total``; exhaustion re-raises the last exception
unchanged (callers keep their own error types).
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional, Tuple, Type

from ..config import root
from ..error import VelesError
from ..logger import Logger
from ..telemetry.counters import inc


class TransientError(VelesError):
    """An error the raiser knows is safe to retry (e.g. a truncated
    download whose .part file was already deleted) — default policies
    treat it as retryable alongside OSError."""


DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (OSError,
                                                      TransientError)


class RetryPolicy(Logger):
    """See module doc. ``sleep``/``clock``/``rng`` are injectable for
    deterministic tests (fake clock, pinned jitter)."""

    def __init__(self, max_attempts: Optional[int] = None,
                 base_delay: Optional[float] = None,
                 max_delay: Optional[float] = None,
                 deadline: Optional[float] = None,
                 retryable: Tuple[Type[BaseException], ...]
                 = DEFAULT_RETRYABLE,
                 retry_if: Optional[Callable[[BaseException], bool]]
                 = None,
                 jitter: bool = True, name: str = "retry",
                 sleep: Optional[Callable[[float], None]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 rng: Optional[Callable[[], float]] = None) -> None:
        super().__init__()
        cfg = root.common.resilience.retry
        self.max_attempts = int(max_attempts if max_attempts is not None
                                else cfg.get("max_attempts", 4))
        self.base_delay = float(base_delay if base_delay is not None
                                else cfg.get("base_delay", 0.5))
        self.max_delay = float(max_delay if max_delay is not None
                               else cfg.get("max_delay", 30.0))
        #: wall-clock budget from the FIRST attempt; a retry whose
        #: backoff would overrun it re-raises instead of sleeping
        self.deadline = deadline
        self.retryable = tuple(retryable)
        self.retry_if = retry_if
        self.jitter = jitter
        self.name = name
        self._sleep = sleep if sleep is not None else time.sleep
        self._clock = clock if clock is not None else time.monotonic
        self._rng = rng

    # -- math ----------------------------------------------------------------
    def _random(self) -> float:
        if self._rng is not None:
            return float(self._rng())
        from .. import prng
        return float(prng.get("retry", ephemeral=True).rand())

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (1-based)."""
        raw = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        return raw * self._random() if self.jitter else raw

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable) and (
            self.retry_if is None or bool(self.retry_if(exc)))

    def _admit_retry(self, attempt: int, start: float,
                     exc: BaseException) -> bool:
        """Decide+perform the wait before retry ``attempt``; False means
        the caller must re-raise (budget exhausted / not retryable)."""
        if not self.is_retryable(exc):
            return False
        if attempt >= self.max_attempts:
            return False
        delay = self.backoff(attempt)
        if self.deadline is not None and \
                self._clock() - start + delay > self.deadline:
            return False
        inc("veles_retries_total")
        self.warning("%s: attempt %d/%d failed (%s: %s) — retrying in "
                     "%.2fs", self.name, attempt, self.max_attempts,
                     type(exc).__name__, exc, delay)
        self._sleep(delay)
        return True

    # -- application forms ---------------------------------------------------
    def call(self, fn: Callable, *args, **kwargs):
        start = self._clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except Exception as exc:   # noqa: BLE001 — filtered below
                if not self._admit_retry(attempt, start, exc):
                    raise

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        wrapped.retry_policy = self
        return wrapped

    def attempts(self):
        """Context-manager loop: each yielded attempt swallows a
        retryable exception (after the backoff sleep) until the budget
        runs out, then lets it propagate; a clean exit ends the loop."""
        start = self._clock()
        state = {"done": False}
        for number in range(1, self.max_attempts + 1):
            yield _Attempt(self, number, start, state)
            if state["done"]:
                return


class _Attempt:
    __slots__ = ("_policy", "number", "_start", "_state")

    def __init__(self, policy: RetryPolicy, number: int, start: float,
                 state: dict) -> None:
        self._policy = policy
        self.number = number
        self._start = start
        self._state = state

    def __enter__(self) -> "_Attempt":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self._state["done"] = True
            return False
        return self._policy._admit_retry(self.number, self._start, exc)
