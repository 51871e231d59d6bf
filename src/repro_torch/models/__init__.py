"""Models of the port: the declarative parameter tables (``params``), the
shared layers (``layers``), the MoE feed-forward (``moe``), Mamba2's
mixer (``ssm``), the decoder-only LM of the ported families
(``causal_lm``) and the facade the serving engine calls (``model``)."""
