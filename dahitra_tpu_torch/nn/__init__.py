"""Blocks, ResNet trunk and the decoder stack of the port."""
