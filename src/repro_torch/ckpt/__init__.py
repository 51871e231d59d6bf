"""Checkpoints of training state, in the reference's on-disk layout."""
