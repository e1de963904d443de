"""Serving layer: continuous-batching engine over the prefill/decode steps."""
from .engine import EngineStats, Request, ServeEngine  # noqa: F401
