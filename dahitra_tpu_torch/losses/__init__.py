"""Losses."""
