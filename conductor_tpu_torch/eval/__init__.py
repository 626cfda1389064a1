"""Evaluation: the stage-1 harnesses (`stage1`) and the numpy metrics
(`metrics`, `beat`)."""
