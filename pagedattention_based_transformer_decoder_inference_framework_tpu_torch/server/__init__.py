"""The serving frontends: :class:`ServerCore` (the endpoints' logic),
:class:`BasicServer` (stdlib HTTP) and ``create_app`` (FastAPI, imported
on call)."""

from .basic import BasicServer
from .core import ServerCore

__all__ = ["BasicServer", "ServerCore", "create_app"]


def create_app(*args, **kwargs):
    """FastAPI app factory (requires fastapi; see ``BasicServer`` for the
    dependency-free transport)."""
    from .app import create_app as _create

    return _create(*args, **kwargs)
