"""Graceful SIGINT handling (the port's copy of the JAX package's
`utils/stop.py`; matrix-util `stop/mod.rs:1-40` parity).

One process-wide stop flag: first Ctrl-C sets it (training loops poll
at epoch-chunk boundaries and FINALIZE partial outputs — the
reference's SIGINT-ordering contract, `vae/topic.rs:140-163`); a
second Ctrl-C restores the default handler, so a third aborts.
"""

from __future__ import annotations

import signal
import threading

_stop = threading.Event()
_installed = False


def stop_requested() -> bool:
    return _stop.is_set()


def reset():
    _stop.clear()


def install_sigint_handler():
    """Idempotent; safe to call from any CLI entry."""
    global _installed
    if _installed:
        return

    def handler(sig, frame):
        if _stop.is_set():
            signal.signal(signal.SIGINT, signal.SIG_DFL)
            raise KeyboardInterrupt
        _stop.set()

    signal.signal(signal.SIGINT, handler)
    _installed = True
