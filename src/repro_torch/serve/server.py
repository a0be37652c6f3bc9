"""Asyncio serving frontend over the event-driven engine protocol.

The port of the reference ``serve/server.py`` (standard-library ``asyncio``
only).  :class:`AsyncServer` wraps any *core* speaking the event protocol —
one :class:`~repro_torch.serve.engine.Engine` or a
:class:`~repro_torch.serve.router.ReplicaRouter` — and exposes per-request
async streams:

* ``await server.submit(req)`` returns a :class:`StreamHandle`;
  ``async for tok in handle`` yields tokens as the engine emits them.
* Backpressure: a semaphore bounds the requests in flight through the
  server, and a router's bounded queue underneath turns hard overload into
  ``RouterBusy``.
* ``handle.cancel()`` and a per-request wall-clock ``timeout`` both go
  through ``core.cancel()``, so the stream ends with its terminal event and
  the request's pages are freed by the ordinary eviction path.

The server never threads or forks: ``serve_forever`` calls ``core.poll()``
on the event loop, one tick per iteration, and fans the events out to the
streams.  The asyncio layer only decides *when* the same ``submit`` /
``poll`` / ``cancel`` run, so it changes latency, never tokens.
"""
from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.engine import Request, TokenEvent


class StreamHandle:
    """One request's live output stream.  Async-iterate for tokens; after
    exhaustion ``result()`` gives the full output or raises for a cancelled
    or failed request."""

    def __init__(self, server: "AsyncServer", rid: int, request: Request):
        self.rid = rid
        self.request = request
        self._server = server
        self._queue: asyncio.Queue = asyncio.Queue()
        self._done = False
        self._timeout_handle: Optional[asyncio.TimerHandle] = None

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        if self._done:
            raise StopAsyncIteration
        ev: TokenEvent = await self._queue.get()
        if ev.final:
            self._done = True
        if ev.token is None:        # token-less terminal (cancel/shed/fail)
            raise StopAsyncIteration
        return ev.token

    async def tokens(self) -> List[int]:
        """Drain the stream to its end and return every token."""
        return [t async for t in self]

    def cancel(self) -> bool:
        """Client-side cancellation; the stream still ends with its terminal
        event (delivered by the poll loop)."""
        return self._server._cancel(self)

    def result(self) -> np.ndarray:
        """See ``Request.result``."""
        return self.request.result()


class AsyncServer:
    """Drive an event-protocol core (``submit`` / ``cancel`` / ``poll`` /
    ``has_work``) from an asyncio event loop.  ``max_inflight`` bounds the
    requests admitted into the core at once (further ``submit`` callers
    await); ``idle_sleep`` is the loop's sleep while the core has no work
    (seconds)."""

    def __init__(self, core, *, max_inflight: int = 64, idle_sleep: float = 0.001):
        self.core = core
        self.idle_sleep = idle_sleep
        self._sem = asyncio.Semaphore(max_inflight)
        self._streams: Dict[int, StreamHandle] = {}
        self._stopped = False

    async def submit(self, request: Request, timeout: Optional[float] = None) -> StreamHandle:
        """Admit a request (awaiting the in-flight semaphore) and return its
        stream.  ``timeout`` arms a wall-clock timer that cancels the
        request through the core.  A ``RouterBusy`` from the core releases
        the slot and propagates."""
        await self._sem.acquire()
        try:
            rid = self.core.submit(request)
        except BaseException:
            self._sem.release()
            raise
        handle = StreamHandle(self, rid, request)
        self._streams[rid] = handle
        if timeout is not None:
            handle._timeout_handle = asyncio.get_running_loop().call_later(
                timeout, self._cancel, handle)
        return handle

    def _cancel(self, handle: StreamHandle) -> bool:
        if handle.rid not in self._streams:
            return False                   # already terminal
        return self.core.cancel(handle.rid)

    def _settle(self, handle: StreamHandle):
        self._streams.pop(handle.rid, None)
        if handle._timeout_handle is not None:
            handle._timeout_handle.cancel()
            handle._timeout_handle = None
        self._sem.release()

    async def serve_forever(self):
        """The poll loop: one core tick per iteration while there is work,
        its events fanned out to their streams, yielding to the loop
        between ticks; sleeps when idle.  Run it as a task; ``stop()`` ends
        it after the current iteration."""
        while not self._stopped:
            if not self.core.has_work:
                await asyncio.sleep(self.idle_sleep)
                continue
            for ev in self.core.poll():
                handle = self._streams.get(ev.rid)
                if handle is None:
                    continue               # not submitted through this server
                handle._queue.put_nowait(ev)
                if ev.final:
                    self._settle(handle)
            await asyncio.sleep(0)

    def stop(self):
        self._stopped = True
