"""FastAPI transport over :class:`ServerCore` (an optional dependency,
imported inside :func:`create_app` only; the JAX package's
``server/app.py``).

Endpoints: /generate, /stream_generate, /stream_chat, /stream_chat_beam,
/generate_batch, /metrics, /healthz. Streaming is newline-JSON by
default, SSE with ``?sse=1``. Bodies are validated by ``schema.py``'s
types (an invalid one answers 422). Without fastapi,
``server.basic.BasicServer`` serves the same surface with the stdlib.
"""

from __future__ import annotations

from typing import Optional

from ..config import FrameworkConfig
from .core import ServerCore
from .schema import (BatchGenerateRequest, BeamStreamRequest,
                     GenerateRequest, StreamChatRequest, ValidationError)


def create_app(config: Optional[FrameworkConfig] = None, engine=None,
               reranker=None, core: Optional[ServerCore] = None):
    from fastapi import Body, FastAPI, HTTPException
    from fastapi.responses import JSONResponse, StreamingResponse

    core = core or ServerCore(config, engine=engine, reranker=reranker)
    app = FastAPI(title="pagedattention-torch", version="0.1")
    app.state.core = core

    def media(sse: bool) -> str:
        return "text/event-stream" if sse else "application/x-ndjson"

    def parse(schema, payload: dict):
        try:
            return schema(**payload)
        except ValidationError as e:
            raise HTTPException(status_code=422, detail=str(e))

    @app.get("/healthz")
    def healthz():
        return core.healthz()

    @app.get("/metrics")
    def metrics():
        return JSONResponse(core.get_metrics())

    @app.post("/generate")
    def generate(payload: dict = Body(...)):
        return core.generate(parse(GenerateRequest, payload))

    @app.post("/generate_batch")
    def generate_batch(payload: dict = Body(...)):
        return core.generate_batch(parse(BatchGenerateRequest, payload))

    @app.post("/stream_generate")
    def stream_generate(payload: dict = Body(...), sse: bool = False):
        return StreamingResponse(core.stream_generate(
            parse(GenerateRequest, payload), sse), media_type=media(sse))

    @app.post("/stream_chat")
    def stream_chat(payload: dict = Body(...), sse: bool = False):
        return StreamingResponse(core.stream_chat(
            parse(StreamChatRequest, payload), sse), media_type=media(sse))

    @app.post("/stream_chat_beam")
    def stream_chat_beam(payload: dict = Body(...), sse: bool = False):
        return StreamingResponse(core.stream_chat_beam(
            parse(BeamStreamRequest, payload), sse), media_type=media(sse))

    return app
