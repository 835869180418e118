"""Serving in PyTorch: multi-tenant coalesced retrieval (``tenancy``) and
the serving engine's memory sidecar (``engine``)."""
from .engine import ServeEngine
from .tenancy import RetrievalRequest, TenantRegistry, coalesced_retrieve

__all__ = ["RetrievalRequest", "ServeEngine", "TenantRegistry",
           "coalesced_retrieve"]
