"""Kinds of scene: one file a kind, found by the name a configuration gives it."""
