"""Synthetic stand-ins for the paper's scientific fields."""
