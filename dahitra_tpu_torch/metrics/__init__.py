"""Confusion-matrix metrics on the device."""
