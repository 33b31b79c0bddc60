"""Checkpoint evaluation."""
