"""HTTP service layer of the port (aiohttp): API surface, resilience,
chat UI."""

from .app import ServiceState, create_app

__all__ = ["create_app", "ServiceState"]
