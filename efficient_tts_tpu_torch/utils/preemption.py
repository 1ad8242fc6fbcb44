"""Preemption-safe training: SIGTERM takes the Ctrl-C checkpoint path.

Counterpart of `efficient_tts_tpu/utils/preemption.py`. Schedulers and
preemptible machines send SIGTERM with a grace window before SIGKILL. The
trainer wraps its loop in `convert_sigterm()`, so SIGTERM raises
KeyboardInterrupt in the main thread and the trainer's interrupt handler
writes a resumable checkpoint.

Signal handlers are process-global and only installable from the main
thread; called elsewhere (a test worker thread) this is a no-op.
"""

from __future__ import annotations

import contextlib
import logging
import signal
import threading

log = logging.getLogger(__name__)


@contextlib.contextmanager
def convert_sigterm():
    """Within the context, SIGTERM raises KeyboardInterrupt in the main
    thread (once; a second SIGTERM falls through to the default handler so
    a stuck save cannot block eviction). Restores the previous handler on
    exit."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    fired = False

    def handler(signum, frame):
        nonlocal fired
        if fired:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.raise_signal(signal.SIGTERM)
            return
        fired = True
        log.warning("SIGTERM received: checkpointing before shutdown")
        raise KeyboardInterrupt

    prev = signal.signal(signal.SIGTERM, handler)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)
