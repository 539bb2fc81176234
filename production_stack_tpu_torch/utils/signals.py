"""Shared graceful-termination scaffolding for the server mains.

The port's copy of ``production_stack_tpu/utils/signals.py``;
it imports neither the JAX package nor torch.

Both the engine API server and the router drain on SIGTERM/SIGINT (K8s pod
rotation); the signal choreography — install handlers, wake on the first
signal, deregister so a SECOND Ctrl-C/SIGTERM gets default handling (force
quit) — is identical and easy to let drift, so it lives here once.
"""

from __future__ import annotations

import asyncio
import signal


async def wait_for_termination() -> None:
    """Block until the first SIGTERM/SIGINT. The handlers deregister
    themselves on delivery, so a repeat signal force-quits instead of
    re-setting an already-set event."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()

    def on_signal():
        stop.set()
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.remove_signal_handler(s)
            except (NotImplementedError, ValueError):
                pass

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, on_signal)
        except NotImplementedError:  # non-unix
            pass
    await stop.wait()
