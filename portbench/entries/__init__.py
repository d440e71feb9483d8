"""Entries: one file an entry, found by the name a traffic mix gives it."""
