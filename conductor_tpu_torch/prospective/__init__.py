"""Serving audio of any length (`unseen`), the Prospective Cup scorer
(`evaluator`) and its starter models (`baselines`)."""

from .baselines import CNNLSTMGenerator, PlainGenerator  # noqa: F401
from .evaluator import ProspectiveEvaluator, ProspectiveResult  # noqa: F401
from .unseen import cached_mel, generate_long  # noqa: F401
