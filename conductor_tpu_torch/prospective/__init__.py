"""Serving audio of any length (`unseen`) and the Prospective Cup scorer
(`evaluator`)."""

from .evaluator import ProspectiveEvaluator, ProspectiveResult  # noqa: F401
from .unseen import cached_mel, generate_long  # noqa: F401
