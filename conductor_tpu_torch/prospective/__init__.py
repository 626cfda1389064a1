"""Serving audio of any length (`unseen`)."""

from .unseen import cached_mel, generate_long  # noqa: F401
