"""Checkpoints in the reference trainer's format and weight import."""
