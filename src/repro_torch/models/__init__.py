"""Models of the port: the declarative parameter tables (``params``), the
shared layers (``layers``), the dense decoder-only LM (``causal_lm``)
and the facade the serving engine calls (``model``)."""
