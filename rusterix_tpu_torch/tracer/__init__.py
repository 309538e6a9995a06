"""The progressive path tracer (reference src/tracer/), in plain torch."""

from .tracer import AccumBuffer, Tracer

__all__ = ["AccumBuffer", "Tracer"]
