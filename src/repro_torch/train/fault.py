"""Fault tolerance: preemption handling and elastic restarts.

The port of the JAX package's ``train/fault.py`` (which imports no JAX;
the port keeps its own copy).

  * :class:`PreemptionGuard` — SIGTERM/SIGINT → finish the in-flight step,
    checkpoint, exit cleanly.  The training loop polls ``should_stop``.
  * :func:`elastic_restore` — restore the latest checkpoint onto whatever
    device or mesh the caller now trains on, of any rank count:
    checkpoints hold whole, device-free arrays (``train/checkpoint.py``).
"""

from __future__ import annotations

import signal
import threading

from . import checkpoint as ckpt_lib


class PreemptionGuard:
    """Install signal handlers; training loops poll ``should_stop``."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = threading.Event()
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:  # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def trigger(self) -> None:  # test hook: simulate a preemption
        self._stop.set()

    def restore_handlers(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)


def elastic_restore(ckpt_dir: str, like, device=None):
    """Restore the latest committed step onto ``device``, or onto the mesh
    of ``like``'s DTensors (the reference's ``shardings=``), which may
    differ from the device or mesh that saved it → (state, step) or
    (None, -1)."""
    return ckpt_lib.restore_latest(ckpt_dir, like, device=device)
