"""Synthetic stand-ins for the paper's scientific fields, and the
synthetic token stream LM training reads (``tokens``)."""
