"""Batched Gram matrix (X^T X / X X^T per slice)."""
