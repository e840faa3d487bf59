"""Online serving front door: an asyncio HTTP/SSE server over the engine.

Stdlib-only (``asyncio`` plus a minimal HTTP/1.1 + SSE layer in
`repro_torch.server.http`) — no web framework. `EngineServer` owns one
steppable `Engine`, paces it against wall time (optionally time-warped),
admits socket requests continuously via ``Engine.submit()``, and streams
each request's token events back as SSE chunks through the O(1)
``Engine.on_token`` subscription added for exactly this purpose.
Backpressure reuses the existing machinery: the predicted-work admission
watermark answers 429 + Retry-After at the door, per-request deadlines
become engine timeouts, and a dropped socket flows through
``Engine.cancel()``.

A copy of the reference package's ``server`` over the port's `Engine`.
"""

from repro_torch.server.app import EngineServer, ServerConfig

__all__ = ["EngineServer", "ServerConfig"]
