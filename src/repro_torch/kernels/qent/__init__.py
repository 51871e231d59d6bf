"""Fused multi-eps quantize + hashed histogram (the q-ent predictor)."""
