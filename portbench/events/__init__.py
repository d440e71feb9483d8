"""Event families: one file a family, found by the name a mix gives it."""
