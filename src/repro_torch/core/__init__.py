"""The paper's logic: predictors, regressions, pipeline, use cases."""
