"""Wall-clock phase timing (reference: include/common/timer.h:5-41 and the
Log::StartLog/EndLog banners, include/common/log.h:9-31).

On an async backend a Timer must fence the device to be meaningful —
`stop(x)` takes an optional array to block_until_ready before reading the
clock (the reference's CUDA_SYNC_CHECK analogue)."""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("henjou")


class Timer:
    def __init__(self):
        self._t0 = None
        self._elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, fence=None):
        if fence is not None:
            import jax

            jax.block_until_ready(fence)
        self._elapsed = time.perf_counter() - self._t0
        return self._elapsed

    @property
    def seconds(self) -> float:
        return self._elapsed

    @property
    def ms(self) -> float:
        return self._elapsed * 1e3

    @property
    def us(self) -> float:
        return self._elapsed * 1e6


@contextlib.contextmanager
def phase_log(name: str, fence_value=None):
    """StartLog/EndLog-style phase banner with timing."""
    log.info("---- %s start ----", name)
    t = Timer().start()
    try:
        yield t
    finally:
        t.stop(fence_value)
        log.info("---- %s end: %.3fs ----", name, t.seconds)
