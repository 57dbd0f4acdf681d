"""Flux routing: the attention modes and the Layer Router."""
