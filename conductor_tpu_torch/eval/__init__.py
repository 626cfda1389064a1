"""Evaluation: the stage-2 evaluator (`evaluator`), the replicated
retrieval protocol (`protocol`), the stage-1 harnesses (`stage1`) and the
numpy metrics (`metrics`, `beat`)."""

from .evaluator import DiffusionEvaluator, EvalResult  # noqa: F401
